"""Parity of the port's GN machinery with `vfmreg_tpu`.

* Kernel B2's plain version (what the port's wrapper runs for CPU tensors)
  against the Pallas `gn_moments_from_cache` in interpret mode, on one
  champion cache, at rtol 1e-5 of each moment's scale (the sum of the
  absolute values of its terms);
* `assemble_gn_system`, `build_linear_system` and the unrolled Cholesky
  `gn_step` against the reference's;
* `geometric_icp_loop` ("slabs" mode) against the reference's, from an offset
  large enough for several slab re-gathers and champion rebuilds: equal
  iteration counts and the same pose.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vfmreg_tpu.ops import gn_kernel as jgn  # noqa: E402
from vfmreg_tpu.ops import hash_grid as jhg  # noqa: E402
from vfmreg_tpu.registration import icp as jicp  # noqa: E402
from vfmreg_tpu_torch.convert import grid_from_numpy  # noqa: E402
from vfmreg_tpu_torch.ops import gn_kernel as tgn  # noqa: E402
from vfmreg_tpu_torch.registration import icp as ticp  # noqa: E402

KERNEL, MAX_DIST = 0.667, 1.5


@jax.jit
def _jax_cache(pts, q, qmask):
    grid = jhg.build_hash_grid(pts, 1.0)
    return jhg.build_nn_cache(jhg.gather_candidate_slabs(grid, q, qmask), q, qmask)


def _cache_case(seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-10, 10, (900, 3)).astype(np.float32)
    q = rng.uniform(-10, 10, (130, 3)).astype(np.float32)
    qmask = rng.rand(130) > 0.1
    cache = _jax_cache(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(qmask))
    center = np.mean(q, axis=0).astype(np.float32)
    return [np.array(c) for c in (cache.cx, cache.cy, cache.cz)], q, center


def _moment_scale(cx, cy, cz, q, center):
    """Per moment, the sum over queries of |term| (float64)."""
    c = np.stack([cx, cy, cz]).astype(np.float64)  # [3, K, N]
    with np.errstate(over="ignore", invalid="ignore"):
        d2 = np.sum((c - q.T[:, None, :]) ** 2, axis=0)
    k = np.argmin(d2, axis=0)
    best = d2[k, np.arange(q.shape[0])]
    b = c[:, k, np.arange(q.shape[0])].T
    acc = best < np.float32(MAX_DIST) ** 2
    w = np.where(acc, KERNEL**2 / (KERNEL + best) ** 2, 0.0)
    r = np.where(acc[:, None], q - b, 0.0)
    p = np.where(acc[:, None], q - center, 0.0)
    terms = [acc * 1.0, w, *(w * p.T), w * p[:, 0] ** 2, w * p[:, 1] ** 2, w * p[:, 2] ** 2,
             w * p[:, 0] * p[:, 1], w * p[:, 0] * p[:, 2], w * p[:, 1] * p[:, 2], *(w * r.T),
             *(w * np.cross(p, r).T)]
    return np.array([np.abs(t).sum() for t in terms])


@pytest.mark.parametrize("seed", [0, 1])
def test_gn_moments_plain_matches_pallas_interpret(seed):
    (cx, cy, cz), q, center = _cache_case(seed)
    ref = np.asarray(jgn.gn_moments_from_cache(
        *(jnp.asarray(a) for a in (cx, cy, cz, q, center)), KERNEL, MAX_DIST,
        block_q=64, interpret=True,
    ))
    got = tgn.gn_moments_from_cache(
        *(torch.from_numpy(a) for a in (cx, cy, cz, q)), center, KERNEL, MAX_DIST
    ).numpy()
    assert got[0] == ref[0] and got[0] > 0  # the accepted count is exact
    scale = _moment_scale(cx, cy, cz, q, center)
    assert np.all(np.abs(got - ref) <= 1e-5 * scale), (got - ref) / scale

    JTJ, JTr, n = tgn.assemble_gn_system(torch.from_numpy(got))
    jJTJ, jJTr, jn = jgn.assemble_gn_system(jnp.asarray(got))
    np.testing.assert_array_equal(JTJ.numpy(), np.asarray(jJTJ))
    np.testing.assert_array_equal(JTr.numpy(), np.asarray(jJTr))
    assert int(n) == int(jn)


def test_build_linear_system_and_gn_step_match_jax():
    rng = np.random.RandomState(2)
    src = rng.uniform(-30, 30, (400, 3)).astype(np.float32)
    tgt = src + rng.normal(0, 0.2, (400, 3)).astype(np.float32)
    wmask = rng.rand(400) > 0.3
    center = src.mean(axis=0).astype(np.float32)
    jJTJ, jJTr, jn = jicp.build_linear_system(
        *(jnp.asarray(a) for a in (src, tgt, wmask)), jnp.float32(KERNEL), jnp.asarray(center)
    )
    JTJ, JTr, n = ticp.build_linear_system(
        *(torch.from_numpy(a) for a in (src, tgt, wmask)), KERNEL, torch.from_numpy(center)
    )
    assert int(n) == int(jn)
    np.testing.assert_allclose(JTJ.numpy(), np.asarray(jJTJ), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(JTr.numpy(), np.asarray(jJTr), rtol=1e-5, atol=1e-4)

    # The unrolled Cholesky on one system: the reference's f32 arithmetic.
    dx_ref = np.asarray(jicp.gn_step(jJTJ, jJTr, jn))
    dx, n_host = ticp.gn_step(torch.from_numpy(np.array(jJTJ)), torch.from_numpy(np.array(jJTr)),
                              torch.tensor(int(jn)))
    assert n_host == int(jn)
    np.testing.assert_allclose(dx, dx_ref, rtol=1e-5, atol=1e-7)
    # An empty or singular system gives a zero step.
    zero, n0 = ticp.gn_step(torch.zeros(6, 6), torch.ones(6), torch.tensor(0))
    assert n0 == 0 and not zero.any()


def _offset_scan(seed, n_map=6000, n_scan=1500):
    rng = np.random.RandomState(seed)
    mp = np.c_[rng.uniform(-15, 15, (n_map, 2)), rng.uniform(0, 4, (n_map, 1))].astype(np.float32)
    src = mp[rng.choice(n_map, n_scan, replace=False)] + rng.normal(0, 0.02, (n_scan, 3))
    ang = np.deg2rad(4.0)
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    src = (src @ R.T + np.array([0.6, -0.4, 0.1])).astype(np.float32)
    mask = rng.rand(n_scan) > 0.05
    return mp, src, mask


@pytest.mark.parametrize("max_iterations", [1000, 9])
def test_geometric_icp_loop_matches_jax(max_iterations):
    mp, src, mask = _offset_scan(3)
    jgrid = jhg.build_hash_grid(jnp.asarray(mp), 1.0)
    center = (src[mask].sum(axis=0) / mask.sum()).astype(np.float32)

    @jax.jit
    def run(grid, src, mask, center):
        s = jicp.geometric_icp_loop(
            grid, src, mask, jnp.eye(4, dtype=jnp.float32), center, jnp.float32(MAX_DIST),
            jnp.float32(KERNEL), max_iterations, jicp.ESTIMATION_THRESHOLD, it0=0,
        )
        return s.T_icp, s.it, s.confirmed

    jT, jit, jconf = run(jgrid, jnp.asarray(src), jnp.asarray(mask), jnp.asarray(center))
    grid = grid_from_numpy(
        np.asarray(jgrid.table), np.asarray(jgrid.points), np.asarray(jgrid.bucket_slab), None,
        np.asarray(jgrid.valid), 1.0, jgrid.max_points_per_voxel, device="cpu",
    )
    s = ticp.geometric_icp_loop(
        grid, torch.from_numpy(src), torch.from_numpy(mask), torch.eye(4), torch.from_numpy(center),
        MAX_DIST, KERNEL, max_iterations, ticp.ESTIMATION_THRESHOLD, it0=0,
    )
    assert s.it == int(jit) and s.confirmed == bool(jconf)
    assert int(jit) > ticp.REFRESH_INTERVAL or max_iterations < 1000  # several rebuilds
    np.testing.assert_allclose(s.T_icp.numpy(), np.asarray(jT), atol=2e-5, rtol=0)
