"""Parity of the port's multi-device `parallel/mesh.py` with `vfmreg_tpu`.

The port's functions run in gloo process groups of 2 and 4 ranks
(`tests/torch_mesh_workers.py`, spawned once per world size); the JAX
functions run on as many of the 8 virtual CPU devices (`tests/conftest.py`).
Each case takes its inputs, contract and tolerance from the reference's
own test in `tests/test_parallel.py`:

* `sharded_ransac` (`:72`) with the reference's per-device picks injected
  (`split(PRNGKey(scan), n_dev)` streams): on tests/test_torch_ransac.py's
  correspondences at a 512-hypothesis budget, where the best hypothesis
  is clear of the f32 score noise (checked in float64 first), the pose
  within 1e-5 and the RMSE within a relative 1e-5 of the reference's (that
  file's bar); on the reference test's own data (4,096 hypotheses, where
  near-tied hypotheses of two packages' f32 scores may swap), equal to one
  device scoring every rank's picks in rank order, and seeded
  (`rank_seed`) its contract, RMSE <= the true pose's + 1e-4;
* `hypothesis_sharded_batched_ransac` (`:416`) with the reference's picks:
  within 1e-5 of the reference's batched poses on the clear-winner scans;
  on the reference test's scans within 1e-6 of the serial `sharded_ransac`
  loop (its bar), the winner's RMSE within a relative 1e-5 of the
  reference's, and its sanity gate wherever the reference's own pose passes
  it (at 2 and 4 devices the reference's draws give one coarse winner);
  seeded, each scan's RMSE no worse than its true pose's + 1e-4;
* `map_sharded_icp` at refresh_interval=1 (`:127`) and with masked padding
  rows (`:196`): within 1e-5 of the one-grid program (the reference's bar)
  and of the reference's sharded pose, and the planted offset within 5 cm;
  at the default refresh (`:165`), the reference's recovery gate on both
  the sharded and the one-grid pose;
* `get_vfm_correspondences_map_sharded` (`:296`, duplicates planted across
  the shards): mask and targets equal to the single-device search and
  similarities within 1e-6; against the reference's sharded search, the
  same mask and targets and similarities within tests/test_torch_matching's
  SIM_ATOL;
* `map_sharded_vfm_register` (`:240`) and `dp_map_sharded_vfm_register` on
  2 x 2 (`:352`; 2 x 1 at world size 2): every correspondence counted, the planted pose within
  0.1 m / 0.5 deg, and within 5e-4 of the single-device flow and of the
  reference's sharded pose;
* `sharded_registration_step` (`:56`, slow in the JAX suite): the group's
  total equal to the sum of every rank's counts, each pose within 0.1 m of
  its planted offset and equal to `batched_registration_step` on the rank's
  own pairs.

Every rank must return the same replicated results; the tests read rank 0's
and check the others against it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tests import torch_mesh_workers as W  # noqa: E402
from vfmreg_tpu.ops import matching as jmatching  # noqa: E402
from vfmreg_tpu.parallel import mesh as jmesh  # noqa: E402

HYPOTHESES = 4096  # the reference tests' budget
CLEAR_HYPOTHESES = 512  # the budget of the winner-for-winner comparison
SIM_ATOL = 1e-5  # tests/test_torch_matching.py


def _mesh(n, axes=("model",), shape=None):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape or (n,)), axes)


def _picks(key, n_dev, count, budget=HYPOTHESES):
    """The reference's per-device picks: `ransac_registration`'s randint
    under each device's key of `split(key, n_dev)`."""
    per_dev = -(-budget // n_dev)
    keys = jax.random.split(key, n_dev)
    return np.stack([np.asarray(jax.random.randint(k, (per_dev, 3), 0, count)) for k in keys])


def _scan_picks(masks, n_dev, budget):
    """[n_dev, scans, K, 3]: scan j's picks under PRNGKey(j)."""
    return np.stack([_picks(jax.random.PRNGKey(j), n_dev, int(m.sum()), budget) for j, m in enumerate(masks)],
                    axis=1)


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    """The ranks of one world size, started before the reference runs."""
    n = request.param
    _, _, mask, _ = W.ransac_pair()
    picks = {"pair": _picks(jax.random.PRNGKey(0), n, int(mask.sum())),
             "batch": _scan_picks(W.ransac_batch()[2], n, HYPOTHESES),
             "clear": _scan_picks([W.ransac_clear(j)[2] for j in range(3)], n, CLEAR_HYPOTHESES)}
    ranks = W.start(n, W.mesh_checks, tmp_path_factory.mktemp(f"world{n}"), picks)
    state = {"n": n, "ranks": ranks, "results": None}
    yield state
    if state["results"] is None:
        ranks.results()


def _results(world):
    if world["results"] is None:
        res = world["ranks"].results()
        for r in res[1:]:
            for k in ("ransac_picks", "ransac_seeded", "batch", "batch_seeded", "icp_r1", "icp_default",
                      "icp_padded", "corr", "vfm"):
                a, b = res[0][k], r[k]
                for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
                    np.testing.assert_array_equal(x, y, err_msg=f"{k}: rank results differ")
        world["results"] = res
    return world["results"][0], world["results"]


def _kabsch64(a, b):
    """tests/test_torch_ransac.py's float64 SVD solution of b onto a."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    ca, cb = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((a - ca).T @ (b - cb))
    R = Vt.T @ np.diag([1, 1, np.linalg.det(Vt.T @ U.T)]) @ U.T
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, cb - R @ ca
    return T


def _clear_margin(src, tgt, mask, picks):
    """Second-best minus best float64 MSE over every device's hypotheses."""
    order = np.argsort(~mask, kind="stable")
    s, t, m = src[order].astype(np.float64), tgt[order].astype(np.float64), mask[order]
    mse = []
    for p in picks.reshape(-1, 3):
        T = _kabsch64(s[p], t[p])
        r = s[m] @ T[:3, :3].T + T[:3, 3] - t[m]
        mse.append(np.mean(np.sum(r * r, axis=1)))
    best2 = np.sort(mse)[:2]
    return best2[1] - best2[0]


def _clear_scans(world):
    """The `ransac_clear` scans, each checked to have a clear winner over
    the pooled picks (100x the ~1e-4 m^2 f32 score noise)."""
    scans = [W.ransac_clear(j) for j in range(3)]
    for j, (src, tgt, mask) in enumerate(scans):
        picks = _picks(jax.random.PRNGKey(j), world["n"], int(mask.sum()), CLEAR_HYPOTHESES)
        assert _clear_margin(src, tgt, mask, picks) > 1e-2, j
    return scans


def test_sharded_ransac(world):
    n = world["n"]
    run = jmesh.sharded_ransac(_mesh(n, ("data",)), num_hypotheses=CLEAR_HYPOTHESES)
    ref = [run(*(jnp.asarray(a) for a in scan), jax.random.PRNGKey(j)) for j, scan in enumerate(_clear_scans(world))]
    src, tgt, mask, T = W.ransac_pair()
    out, _ = _results(world)
    poses, rmses = out["clear_serial"]
    np.testing.assert_allclose(poses, np.stack([np.asarray(p) for p, _ in ref]), atol=1e-5)
    np.testing.assert_allclose(rmses, [float(r) for _, r in ref], rtol=1e-5)
    pose, rmse = out["ransac_picks"]
    np.testing.assert_array_equal(pose, out["ransac_single"][0])
    np.testing.assert_array_equal(rmse, out["ransac_single"][1])
    true_rmse = np.sqrt(np.mean(np.sum((src @ T[:3, :3].T + T[:3, 3] - tgt) ** 2, -1)))
    seeded_pose, seeded_rmse = out["ransac_seeded"]
    assert float(seeded_rmse) <= true_rmse + 1e-4 and np.isfinite(seeded_pose).all()


def test_hypothesis_sharded_batched_ransac(world):
    n = world["n"]
    csrc, ctgt, cmask = (np.stack(a) for a in zip(*_clear_scans(world)))
    keys = jnp.stack([jax.random.PRNGKey(j) for j in range(3)])
    jposes = np.asarray(jmesh.hypothesis_sharded_batched_ransac(_mesh(n, ("data",)), num_hypotheses=CLEAR_HYPOTHESES)(
        jnp.asarray(csrc), jnp.asarray(ctgt), jnp.asarray(cmask), keys))
    src, tgt, mask, gts = W.ransac_batch()
    ref = np.asarray(jmesh.hypothesis_sharded_batched_ransac(_mesh(n, ("data",)), num_hypotheses=HYPOTHESES)(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), keys))
    out, _ = _results(world)
    np.testing.assert_allclose(out["clear_batch"], jposes, atol=1e-5)
    np.testing.assert_allclose(out["batch"], out["batch_serial"], atol=1e-6)
    from vfmreg_tpu_torch.geometry.metrics import compute_errors

    def rmse(T, j):
        r = src[j].astype(np.float64) @ T[:3, :3].T + T[:3, 3] - tgt[j]
        return np.sqrt(np.mean(np.sum(r * r, axis=1)))

    for j in range(3):
        # The reference's picks: the winner's RMSE is the reference's within
        # the f32 score noise (near-tied hypotheses may swap), and the
        # reference test's sanity gate holds wherever it holds for the
        # reference's own pose (at 2 and 4 devices its draws give a coarse
        # winner on some scans).
        got, want = out["batch"][j].astype(np.float64), ref[j].astype(np.float64)
        np.testing.assert_allclose(rmse(got, j), rmse(want, j), rtol=1e-5)
        gate = [compute_errors(p, gts[j].astype(np.float64)) for p in (got, want)]
        if gate[1][0] < 2.0 and gate[1][1] < 10.0:
            assert gate[0][0] < 2.0 and gate[0][1] < 10.0, (j, gate)
        # Seeded: test_parallel.py:72's contract, no worse than the true pose.
        assert rmse(out["batch_seeded"][j].astype(np.float64), j) <= rmse(gts[j].astype(np.float64), j) + 1e-4


def _rte_rre(pose, T):
    rte = np.linalg.norm(pose[:3, 3] - T[:3, 3])
    rre = np.degrees(np.arccos(np.clip((np.trace(pose[:3, :3].T @ T[:3, :3]) - 1) / 2, -1, 1)))
    return rte, rre


def test_map_sharded_icp(world):
    n = world["n"]
    jm = _mesh(n)
    eye = jnp.eye(4, dtype=jnp.float32)
    pts, scan, T = W.icp_refresh1()
    jr1 = jmesh.map_sharded_icp(jm, voxel_size=1.0, refresh_interval=1)(
        jnp.asarray(pts), jnp.ones(len(pts), bool), jnp.asarray(scan), jnp.ones(len(scan), bool), eye, 2.0, 0.5)
    pts_r, mp, mmask, scan_p, _ = W.icp_padded(n)
    jpad = jmesh.map_sharded_icp(jm, voxel_size=1.0, refresh_interval=1)(
        jnp.asarray(mp), jnp.asarray(mmask), jnp.asarray(scan_p), jnp.ones(len(scan_p), bool), eye, 2.0, 0.5)
    out, _ = _results(world)
    for key, ref in (("icp_r1", jr1), ("icp_padded", jpad)):
        np.testing.assert_allclose(out[key], out[key + "_single"], atol=1e-5, err_msg=key)
        np.testing.assert_allclose(out[key], np.asarray(ref), atol=1e-5, err_msg=key)
    assert _rte_rre(out["icp_r1"], T)[0] < 0.05
    _, _, T = W.icp_default_refresh()
    for key in ("icp_default", "icp_default_single"):
        rte, rre = _rte_rre(out[key], T)
        assert rte < 0.05 and rre < 0.5, (key, rte, rre)


def test_map_sharded_correspondences(world):
    n = world["n"]
    cp, cf, cm, sp, sf = W.corr_case(n)
    run = jax.jit(jax.shard_map(
        lambda mp, mf, mmask, q, qf, qm: jmatching.get_vfm_correspondences_map_sharded(
            mp, mf, mmask, q, qf, qm, "model"),
        mesh=_mesh(n), in_specs=(P("model"), P("model"), P("model"), P(), P(), P()), out_specs=P(),
        check_vma=False))
    ref = run(*(jnp.asarray(a) for a in (cp, cf, cm, sp, sf)), jnp.ones(len(sp), bool))
    out, _ = _results(world)
    mask, sim, target = out["corr"]
    s_mask, s_sim, s_target = out["corr_single"]
    np.testing.assert_array_equal(mask, s_mask)
    np.testing.assert_allclose(sim, s_sim, atol=1e-6)
    np.testing.assert_array_equal(target, s_target)
    np.testing.assert_array_equal(mask, np.asarray(ref.mask))
    np.testing.assert_allclose(sim, np.asarray(ref.similarity), atol=SIM_ATOL)
    np.testing.assert_array_equal(target, np.asarray(ref.target))


def test_map_sharded_vfm_register(world):
    n = world["n"]
    pts, feats, scan, sfeats, T = W.vfm_case()
    jpose, jcount = jmesh.map_sharded_vfm_register(_mesh(n), voxel_size=1.0)(
        jnp.asarray(pts), jnp.asarray(feats), jnp.ones(len(pts), bool), jnp.asarray(scan), jnp.asarray(sfeats),
        jnp.ones(len(scan), bool), jnp.eye(4, dtype=jnp.float32), 3.0, 0.5)
    out, _ = _results(world)
    pose, count = out["vfm"]
    assert count == len(scan) == int(jcount)
    rte, rre = _rte_rre(pose, T)
    assert rte < 0.1 and rre < 0.5, (rte, rre)
    np.testing.assert_allclose(pose, out["vfm_single"], atol=5e-4)
    np.testing.assert_allclose(pose, np.asarray(jpose), atol=5e-4)


def test_dp_map_sharded_vfm_register(world):
    """On (data, model) = 2 x 2, and 2 x 1 at world size 2 (one-rank model
    groups)."""
    pts, feats, scans, sfeats, gts = W.dp_case()
    jm = _mesh(world["n"], ("data", "model"), (2, world["n"] // 2))
    b, n = scans.shape[:2]
    jposes, jcounts = jmesh.dp_map_sharded_vfm_register(jm, voxel_size=1.0)(
        jnp.asarray(pts), jnp.asarray(feats), jnp.ones(len(pts), bool), jnp.asarray(scans), jnp.asarray(sfeats),
        jnp.ones((b, n), bool), jnp.tile(jnp.eye(4, dtype=jnp.float32), (b, 1, 1)), 3.0, 0.5)
    _, res = _results(world)
    got = {}
    for r in res:
        poses, counts, scan_ids = r["dp"]
        for p, c, j in zip(poses, counts, scan_ids):
            if j in got:  # the two model ranks of a data row agree
                np.testing.assert_array_equal(p, got[j][0])
            got[int(j)] = (p, int(c))
    assert sorted(got) == list(range(b))
    for j in range(b):
        pose, count = got[j]
        assert count == n == int(np.asarray(jcounts)[j])
        rte, rre = _rte_rre(pose, gts[j])
        assert rte < 0.1 and rre < 0.5, (j, rte, rre)
        np.testing.assert_allclose(pose, np.asarray(jposes)[j], atol=5e-4)


def test_sharded_registration_step(world):
    n = world["n"]
    *_, poses_t = W.pairs(n, 512, 128)
    _, res = _results(world)
    totals = {r["pairs"][2] for r in res}
    assert totals == {int(sum(int(r["pairs"][1].sum()) for r in res))}
    for rank, r in enumerate(res):
        poses, counts, _, one_poses, one_counts = r["pairs"]
        np.testing.assert_array_equal(poses, one_poses)
        np.testing.assert_array_equal(counts, one_counts)
        assert (counts > 0).all()
        err = np.linalg.norm(poses[0][:3, 3] - poses_t[rank][:3, 3])
        assert err < 0.1, (rank, err)
