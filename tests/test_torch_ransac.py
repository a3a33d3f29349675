"""Parity of the port's Procrustes solvers, RANSAC and snap filter with `vfmreg_tpu`.

Tolerances, each with its reason:
* Procrustes rotations within 1e-5 of the reference: the same f32
  formulas, but PyTorch's and XLA's f32 atan2 / sin / cos / SVD differ by
  an ulp or so, which the 6-sweep Jacobi carries to ~2e-6. Translations
  t = c_tgt - R c_src carry that rotation gap times the lever arm |c_src|
  (up to ~17 m here), so they are held within 3e-5 of the reference, and
  the port's error against a float64 SVD solution to at most twice the
  reference's own (both are ~1.2e-5 on these samples);
* RANSAC with the reference's own picks injected: pose within 1e-5 and the
  winner's RMSE within a relative 1e-5, on data near the origin where the
  best hypothesis beats the second by 100x the ~1e-4 m^2 f32 score noise
  (checked in float64 first), so both packages must pick the same one. Without injected picks
  the raw poses differ by design: the port's generator is not threefry;
* snap: equal masks and bit-equal snapped points (a snapped point is a
  gathered input row).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.spatial.transform import Rotation as Rot  # noqa: E402

from vfmreg_tpu.ops import matching as jmatch  # noqa: E402
from vfmreg_tpu.parallel import mesh as jmesh  # noqa: E402
from vfmreg_tpu.registration import procrustes as jproc  # noqa: E402
from vfmreg_tpu.registration import ransac as jransac  # noqa: E402
from vfmreg_tpu_torch.ops import matching as tmatch  # noqa: E402
from vfmreg_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from vfmreg_tpu_torch.registration import procrustes as tproc  # noqa: E402
from vfmreg_tpu_torch.registration import ransac as transac  # noqa: E402


def _pose(rng, max_deg=30.0, max_t=20.0):
    T = np.eye(4)
    T[:3, :3] = Rot.from_euler("xyz", rng.uniform(-max_deg, max_deg, 3), degrees=True).as_matrix()
    T[:3, 3] = rng.uniform(-max_t, max_t, 3)
    return T


def _corrs(seed, n=200, outliers=0.3, noise=0.0):
    """The reference test's correspondences (`tests/test_ransac.py:9`): the
    first `outliers` share of targets replaced by uniform junk."""
    rng = np.random.RandomState(seed)
    T = _pose(rng)
    src = rng.uniform(-15, 15, (n, 3)).astype(np.float32)
    tgt = (src @ T[:3, :3].T + T[:3, 3] + rng.normal(0, noise, (n, 3))).astype(np.float32)
    k = int(n * outliers)
    if k:
        tgt[:k] = (rng.uniform(-40, 40, (k, 3)) + src[:k].mean(0)).astype(np.float32)
    return src, tgt, T


def test_procrustes_match_jax():
    rng = np.random.RandomState(0)
    src = rng.uniform(-10, 10, (64, 5, 3)).astype(np.float32)
    T = np.stack([_pose(rng) for _ in range(64)])
    tgt = (np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
           + rng.normal(0, 0.05, src.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (64, 5)).astype(np.float32)
    ts, tt, tw = (torch.from_numpy(a) for a in (src, tgt, w))
    js, jt, jw = (jnp.asarray(a) for a in (src, tgt, w))

    def close(got, ref):
        np.testing.assert_allclose(got[:, :3, :3], ref[:, :3, :3], atol=1e-5)
        np.testing.assert_allclose(got[:, :3, 3], ref[:, :3, 3], atol=3e-5)
        np.testing.assert_array_equal(got[:, 3], ref[:, 3])

    close(tproc.kabsch(ts, tt).numpy(), np.asarray(jproc.kabsch(js, jt)))
    close(tproc.weighted_kabsch(ts, tt, tw).numpy(), np.asarray(jproc.weighted_kabsch(js, jt, jw)))
    # Minimal 3-point samples, as RANSAC draws them.
    got = tproc.kabsch_horn(ts[:, :3], tt[:, :3]).numpy()
    ref = np.asarray(jproc.kabsch_horn(js[:, :3], jt[:, :3]))
    close(got, ref)
    exact = np.stack([_kabsch64(a, b) for a, b in zip(src[:, :3], tgt[:, :3])])
    err_got, err_ref = np.abs(got - exact).max(), np.abs(ref - exact).max()
    assert err_got <= 2 * err_ref + 1e-6, (err_got, err_ref)
    np.testing.assert_allclose(got[:, :3, :3] @ got[:, :3, :3].transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-5)
    vals, vecs = tproc._jacobi_eigh4(torch.from_numpy((src[:, :4, :] @ src[:, :4, :].transpose(0, 2, 1))))
    jvals, jvecs = jproc._jacobi_eigh4(jnp.asarray(src[:, :4, :] @ src[:, :4, :].transpose(0, 2, 1)))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-4, atol=1e-3)


def _kabsch64(a, b):
    """Least-squares rigid transform of b onto a by SVD, in float64."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    ca, cb = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((a - ca).T @ (b - cb))
    R = Vt.T @ np.diag([1, 1, np.linalg.det(Vt.T @ U.T)]) @ U.T
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, cb - R @ ca
    return T


def _mse64(src, tgt, mask, picks):
    """Every hypothesis' mean squared residual in float64."""
    order = np.argsort(~mask, kind="stable")
    s, t = src[order].astype(np.float64), tgt[order].astype(np.float64)
    m = mask[order]
    out = []
    for p in picks:
        T = _kabsch64(s[p], t[p])
        r = s[m] @ T[:3, :3].T + T[:3, 3] - t[m]
        out.append(np.mean(np.sum(r * r, axis=1)))
    return np.array(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_with_jax_picks_matches_jax(seed):
    src, tgt, _ = _corrs(seed, n=300, outliers=0.3, noise=0.3)
    mask = np.ones(300, bool)
    mask[np.random.RandomState(seed + 10).choice(300, 40, replace=False)] = False
    K = 300
    key = jax.random.PRNGKey(seed)
    picks = np.asarray(jax.random.randint(key, (K, 3), 0, int(mask.sum())))
    mse = _mse64(src, tgt, mask, picks)
    best2 = np.sort(mse)[:2]
    assert best2[1] - best2[0] > 1e-2, best2  # a winner 100x clear of the f32 score noise
    ref = jransac.ransac_registration(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), key,
                                      num_hypotheses=K)
    got = transac.ransac_registration(torch.from_numpy(src), torch.from_numpy(tgt),
                                      torch.from_numpy(mask), picks=torch.from_numpy(picks.copy()))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-5)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-5)
    assert int(got.n_corr) == int(ref.n_corr) == int(mask.sum())
    np.testing.assert_allclose(float(got.rmse) ** 2, best2[0], rtol=1e-3)

    # The batched stage with the same picks per scan gives each scan's result.
    b_src = torch.from_numpy(np.stack([src, src[::-1].copy()]))
    b_tgt = torch.from_numpy(np.stack([tgt, tgt[::-1].copy()]))
    b_mask = torch.from_numpy(np.stack([mask, mask[::-1].copy()]))
    poses = tmesh.batched_ransac(b_src, b_tgt, b_mask, seeds=[0, 1], num_hypotheses=K,
                                 picks=torch.from_numpy(np.stack([picks, picks])))
    np.testing.assert_array_equal(poses[0].numpy(), got.pose.numpy())


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_ransac_own_generator_finds_the_optimum(seed):
    """With the port's own generator, the reference test's invariant
    (`tests/test_ransac.py:22`): the winner's RMSE over all correspondences
    is at least as good as the true pose's. (With 30 % outliers that
    least-squares winner need not align the inliers, in either package.)"""
    src, tgt, T = _corrs(seed, n=200, outliers=0.3)
    mask = torch.ones(200, dtype=torch.bool)

    def run():
        return transac.ransac_registration(torch.from_numpy(src), torch.from_numpy(tgt), mask,
                                           generator=torch.Generator().manual_seed(seed),
                                           num_hypotheses=4000)

    res = run()
    rmse_true = np.sqrt(np.mean(np.sum((src @ T[:3, :3].T + T[:3, 3] - tgt) ** 2, axis=1)))
    assert float(res.rmse) <= rmse_true + 1e-3
    assert torch.equal(res.pose, run().pose)  # seeded: the same run twice


def test_ransac_probes():
    """The probes of the verify recipe: all-masked, NaN rows behind the mask,
    exactly three correspondences."""
    src, tgt, T = _corrs(4, n=64, outliers=0.0)
    s, t = torch.from_numpy(src), torch.from_numpy(tgt)
    g = torch.Generator().manual_seed(0)

    res = transac.ransac_registration(s, t, torch.zeros(64, dtype=torch.bool), generator=g,
                                      num_hypotheses=256)
    assert int(res.n_corr) == 0 and np.isinf(float(res.rmse))
    np.testing.assert_array_equal(res.pose.numpy(), np.eye(4, dtype=np.float32))

    mask = torch.ones(64, dtype=torch.bool)
    mask[:10] = False
    s_nan, t_nan, s_big, t_big = s.clone(), t.clone(), s.clone(), t.clone()
    s_nan[:10], t_nan[:10] = float("nan"), float("nan")
    s_big[:10], t_big[:10] = 1e3, -1e3
    a = transac.ransac_registration(s_nan, t_nan, mask, generator=torch.Generator().manual_seed(1),
                                    num_hypotheses=256)
    b = transac.ransac_registration(s_big, t_big, mask, generator=torch.Generator().manual_seed(1),
                                    num_hypotheses=256)
    assert torch.equal(a.pose, b.pose) and int(a.n_corr) == 54
    np.testing.assert_allclose(a.pose.numpy(), T, atol=1e-3)

    three = transac.ransac_registration(s[:3], t[:3], torch.ones(3, dtype=torch.bool),
                                        generator=torch.Generator().manual_seed(2), num_hypotheses=64)
    assert int(three.n_corr) == 3 and np.isfinite(float(three.rmse))
    np.testing.assert_allclose(three.pose.numpy(), T, atol=1e-3)


def test_chunked_argmin_l2_matches_jax():
    rng = np.random.RandomState(5)
    q = rng.uniform(-30, 30, (300, 3)).astype(np.float32)
    db = rng.uniform(-30, 30, (1000, 3)).astype(np.float32)
    dm = rng.rand(1000) > 0.2
    jd2, jidx = jmatch._chunked_argmin_l2(jnp.asarray(q), jnp.asarray(db), jnp.asarray(dm), 256)
    d2, idx = tmatch._chunked_argmin_l2(torch.from_numpy(q), torch.from_numpy(db),
                                        torch.from_numpy(dm), 256)
    exact = np.sum((q[:, None] - db[None]) ** 2, axis=-1, dtype=np.float64)
    exact[:, ~dm] = np.inf
    top2 = np.sort(exact, axis=1)[:, :2]
    decisive = top2[:, 1] - top2[:, 0] > 1e-2
    assert decisive.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[decisive], np.asarray(jidx)[decisive])
    assert dm[idx.numpy()].all()
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-2)


def _snap_case(seed, world=300.0):
    rng = np.random.RandomState(seed)
    scan = (rng.uniform(-20, 20, (600, 3)) + world).astype(np.float32)
    mp = (rng.uniform(-20, 20, (3000, 3)) + world).astype(np.float32)
    n = 256
    src = scan[rng.choice(600, n, replace=False)].copy()
    tgt = mp[rng.choice(3000, n, replace=False)].copy()
    src[:40] += 0.5  # far from every scan point: dropped
    tgt[40:60] += np.float32(2e-3)  # just outside the 1e-3 m tolerance
    mask = rng.rand(n) > 0.1
    smask = rng.rand(600) > 0.05
    return src, tgt, mask, scan, smask, mp, np.ones(3000, bool)


def test_snap_correspondences_match_jax():
    cases = [_snap_case(s) for s in (0, 1)]
    for case in cases:
        ref = jransac.snap_correspondences(*(jnp.asarray(a) for a in case))
        got = transac.snap_correspondences(*(torch.from_numpy(a) for a in case))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert 0 < int(got[2].sum()) < int(case[2].sum())
    # Both scans in one batched call against the shared map, as the
    # reference's `batched_snap` stage runs them.
    stack = [np.stack([c[i] for c in cases]) for i in range(5)]
    ref_b = jmesh.batched_snap(*(jnp.asarray(a) for a in stack), jnp.asarray(cases[0][5]),
                               jnp.asarray(cases[0][6]))
    got_b = transac.snap_correspondences(*(torch.from_numpy(a) for a in stack),
                                         torch.from_numpy(cases[0][5]), torch.from_numpy(cases[0][6]))
    for g, r in zip(got_b, ref_b):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
