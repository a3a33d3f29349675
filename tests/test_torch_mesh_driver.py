"""The port's multi-device evaluation driver: `precompute_scene_batched(mesh=)`
and `RegistrationNode` under a process group.

Two gloo ranks (`tests/torch_mesh_workers.py:driver_checks`, spawned once)
against the single-device path in this process:

* the scan-sharded row on `tests/test_harness_multichip.py`'s scene at 3
  scans (more than the ranks: each rank runs its scans' whole RANSAC
  budget, the batch padded by repeating scan 0) and at 1 (fewer: the
  hypotheses split over the ranks), the split that file pins (`:51-104`):
  the same correspondence, snap and retry decisions, GT ICP within 1e-4 of
  the single-device row, the refined row within 1e-4 at 3 scans and, at
  both widths, every refined lane within the recall gate (0.3 m, 1.5 deg)
  of its true pose;
* the node with `map_sharding=True` (the map's rows split over the ranks)
  on `tests/test_harness.py`'s scene against the single-device node whose
  RANSAC draws the same stream (each scan's budget split over the ranks),
  the baseline and the tolerances of `tests/test_harness.py:545` (the
  errors within 2e-3, the vanilla row's within a relative 0.05 and 1e-3);
  the scan-sharded node within 1e-4 of the single-device node; the serial columns' hypothesis-sharded RANSAC
  (`tests/test_parallel.py:99`'s scene and contract: vfm RANSAC recall
  1.0 at 0.6 m / 1.5 deg);
* rank 0 alone prints and writes the error pickle.

And at world size 1 (a one-rank gloo group in this process) every sharded
function equal bit for bit to its single-device row: the driver row
scan-sharded and map-sharded (its vanilla row, one full-budget loop as the
reference's map-sharded row runs it, against the single-device row under
`VFMREG_PROFILE_ICP_ITERS=1`, which runs it the same way), RANSAC, the ICP
and VFM registrations, dp x tp on 1 x 1, the map-sharded correspondences and
snap, and the registration steps (with `tests/test_parallel.py:42`'s
contract); and the XD path refusing the merge hook.
"""

import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from tests import torch_mesh_workers as W  # noqa: E402
from vfmreg_tpu_torch.geometry.metrics import compute_errors  # noqa: E402
from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid  # noqa: E402
from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences  # noqa: E402
from vfmreg_tpu_torch.parallel import mesh as M  # noqa: E402
from vfmreg_tpu_torch.pipeline import registration_node as rn  # noqa: E402
from vfmreg_tpu_torch.pipeline.synthetic import make_synthetic_scene  # noqa: E402
from vfmreg_tpu_torch.registration.icp import register_frame_icp, register_frames_icp_stats  # noqa: E402
from vfmreg_tpu_torch.registration.ransac import ransac_registration, snap_correspondences  # noqa: E402
from vfmreg_tpu_torch.registration.vfm_icp import register_frame_vfm  # noqa: E402

GATE = (0.3, 1.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_driver")
    W.write_harness_scene(d / "harness")
    W.write_mesh_ransac_scene(d / "ransac")
    return d / "harness", d / "ransac"


@pytest.fixture(scope="module")
def ranks(folders, tmp_path_factory):
    r = W.start(2, W.driver_checks, tmp_path_factory.mktemp("ranks"), folders)
    state = {"ranks": r, "results": None}
    yield state
    if state["results"] is None:
        r.results()


def _results(ranks):
    if ranks["results"] is None:
        ranks["results"] = ranks["ranks"].results()
    return ranks["results"]


def test_scan_sharded_rows(ranks):
    scene, local_map = W.multichip_scene(3)
    single = {b: rn.precompute_scene_batched({k: v[:b] for k, v in scene.items()}, local_map, device="cpu")
              for b in (3, 1)}
    res = _results(ranks)
    for b in (3, 1):
        got, want = res[0][f"rows_{b}"], single[b]
        for k in W.ROW_KEYS:
            np.testing.assert_array_equal(res[1][f"rows_{b}"][k], got[k], err_msg=f"ranks differ: {k}")
        for k in ("corr_counts", "snap_counts", "retried", "map_size"):
            assert got[k] == want[k], (b, k)
        np.testing.assert_allclose(got["gt"], want["gt"], atol=1e-4)
        if b >= 2:
            np.testing.assert_allclose(got["vfm_ransac_icp"], want["vfm_ransac_icp"], atol=1e-4)
        for j in range(b):
            rte, rre = compute_errors(got["vfm_ransac_icp"][j], scene["scene_poses"][j])
            assert rte < GATE[0] and rre < GATE[1], (b, j, rte, rre)


def _errors_close(got, want, exact=False):
    assert list(got["trans"]) == list(want["trans"])
    for method in want["trans"]:
        for kind in ("trans", "rot"):
            a, b = got[kind][method], want[kind][method]
            if exact:
                np.testing.assert_allclose(a, b, atol=1e-4, err_msg=method)
            elif method == "icp":
                np.testing.assert_allclose(a, b, rtol=0.05, atol=1e-3, err_msg=method)
            else:
                np.testing.assert_allclose(a, b, atol=2e-3, err_msg=method)


def test_sharded_nodes(ranks, folders):
    single = W.run_node(folders[0], 0, "single", batch_scans=True, **W.NODE_METHODS)
    assert not (single["mesh"] or single["map_sharded"] or single["sharded_ransac"])
    res = _results(ranks)
    for r in res:
        assert r["map_sharded"]["mesh"] and r["map_sharded"]["map_sharded"]
        assert not r["map_sharded"]["sharded_ransac"]
        assert r["scan_sharded"]["mesh"] and r["scan_sharded"]["sharded_ransac"]
        assert not r["scan_sharded"]["map_sharded"]
    _errors_close(res[0]["map_sharded"], res[0]["baseline"])
    _errors_close(res[0]["scan_sharded"], single, exact=True)
    for mode in ("map_sharded", "scan_sharded"):
        assert res[1][mode]["trans"] == res[0][mode]["trans"] and res[1][mode]["rot"] == res[0][mode]["rot"]
    assert "Mesh: sharding the MAP over 2 devices" in res[0]["map_sharded"]["log"]
    assert "Mesh: sharding driver stages over 2 devices" in res[0]["scan_sharded"]["log"]


def test_serial_columns_shard_ransac(ranks):
    """`tests/test_parallel.py:99`: the serial vfm RANSAC column with its
    hypotheses split over the ranks registers the scan."""
    for r in _results(ranks):
        out = r["serial"]
        assert out["sharded_ransac"] and not out["map_sharded"]
        t, q = out["trans"]["vfm_ransac"], out["rot"]["vfm_ransac"]
        assert np.mean((np.asarray(t) < 0.6) & (np.asarray(q) < 1.5)) == 1.0, (t, q)


def test_rank0_alone_prints_and_writes(ranks):
    res = _results(ranks)
    for mode in ("map_sharded", "scan_sharded", "serial"):
        assert res[0][mode]["pickle"] and "Current scene ID: 0" in res[0][mode]["log"], mode
        assert not res[1][mode]["pickle"] and res[1][mode]["log"] == "", mode


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo group in this process, and a 1-D mesh over it."""
    assert not dist.is_initialized()
    d = tmp_path_factory.mktemp("world1")
    dist.init_process_group("gloo", init_method=f"file://{d}/store", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield M.make_mesh(("model",))
    finally:
        dist.destroy_process_group()


def _equal_rows(a, b, keys):
    for k in keys:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_world1_driver_rows_equal_single(world1, monkeypatch):
    scene, local_map, _ = make_synthetic_scene(2, 8192, 512, 16, seed=1, extent=40.0)
    monkeypatch.delenv("VFMREG_PROFILE_ICP_ITERS", raising=False)
    plain = rn.precompute_scene_batched(scene, local_map, device="cpu")
    scan = rn.precompute_scene_batched(scene, local_map, device="cpu", mesh=world1)
    rows = rn.precompute_scene_batched(scene, local_map, device="cpu", mesh=world1, map_sharded=True)
    monkeypatch.setenv("VFMREG_PROFILE_ICP_ITERS", "1")
    one_loop = rn.precompute_scene_batched(scene, local_map, device="cpu")
    monkeypatch.delenv("VFMREG_PROFILE_ICP_ITERS")
    keys = W.ROW_KEYS + ("vfm_ransac_ortho", "scan_sizes")
    _equal_rows(scan, plain, keys)
    _equal_rows(rows, plain, [k for k in keys if k != "icp"])
    _equal_rows(rows, one_loop, keys)
    for k in ("iterations", "settled", "rebuilds", "loop"):
        assert scan["stats"][k] == plain["stats"][k], k
    for k in ("iterations", "settled", "rebuilds"):
        assert rows["stats"][k] == one_loop["stats"][k], k


def test_world1_functions_equal_single(world1):
    t = torch.from_numpy
    eye = torch.eye(4)
    group = world1.get_group("model")

    src, tgt, mask, _ = W.ransac_pair()
    pose, rmse = M.sharded_ransac(world1, 2048, axis="model")(t(src), t(tgt), t(mask), 5)
    ref = ransac_registration(t(src), t(tgt), t(mask), torch.Generator().manual_seed(5), 2048)
    assert torch.equal(pose, ref.pose) and torch.equal(rmse, ref.rmse)
    bsrc, btgt, bmask, _ = W.ransac_batch()
    poses = M.hypothesis_sharded_batched_ransac(world1, 2048, axis="model")(t(bsrc), t(btgt), t(bmask), [4, 5, 6])
    assert torch.equal(poses, M.batched_ransac(t(bsrc), t(btgt), t(bmask), [4, 5, 6], 2048))

    pts, scan, _ = W.icp_default_refresh()
    ones = torch.ones(len(scan), dtype=torch.bool)
    got = M.map_sharded_icp(world1, 1.0, axis="model")(t(pts), torch.ones(len(pts), dtype=torch.bool), t(scan),
                                                       ones, eye, 2.0, 0.5)
    assert torch.equal(got, register_frame_icp(build_hash_grid(t(pts), 1.0), t(scan), ones, eye, 2.0, 0.5))
    # The XD path refuses a merge hook, as the reference's (`icp.py:241-242`).
    with pytest.raises(ValueError, match="XD weighted path"):
        register_frames_icp_stats(build_hash_grid(t(pts), 1.0), t(scan)[None], ones[None], eye[None], 2.0, 0.5,
                                  qfeats=torch.zeros((1, len(scan), 4)), merge_cache=M.CacheMerge(group))

    pts, feats, scan, sfeats, _ = W.vfm_case()
    mm, sm = torch.ones(len(pts), dtype=torch.bool), torch.ones(len(scan), dtype=torch.bool)
    pose, count = M.map_sharded_vfm_register(world1, 1.0, axis="model")(t(pts), t(feats), mm, t(scan), t(sfeats),
                                                                        sm, eye, 3.0, 0.5)
    corr = get_vfm_correspondences(t(pts), t(feats), mm, t(scan), t(sfeats), sm)
    ref = register_frame_vfm(build_hash_grid(t(pts), 1.0), t(scan), sm, corr, eye, 3.0, 0.5)
    assert torch.equal(pose, ref.pose) and int(count) == int(corr.count)
    mesh2 = M.make_mesh(("data", "model"), (1, 1))
    poses, counts = M.dp_map_sharded_vfm_register(mesh2, 1.0)(t(pts), t(feats), mm, t(scan)[None], t(sfeats)[None],
                                                             sm[None], eye[None], 3.0, 0.5)
    assert torch.equal(poses[0], ref.pose) and int(counts[0]) == int(corr.count)

    cp, cf, cm, sp, sf = W.corr_case(1)
    sm = torch.ones(len(sp), dtype=torch.bool)
    got = M.get_vfm_correspondences_map_sharded(t(cp), t(cf), t(cm), t(sp), t(sf), sm, group)
    ref = get_vfm_correspondences(t(cp), t(cf), t(cm), t(sp), t(sf), sm)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # The snap with the map side merged over the group: the scan's own
    # points as correspondence sources, the map's nearest rows as targets.
    tgt_pts = t(cp[:256] + np.float32(5e-4))
    args = (t(sp)[None], tgt_pts[None], sm[None], t(sp)[None], sm[None], t(cp), t(cm))
    for a, b in zip(snap_correspondences(*args, group=group), snap_correspondences(*args)):
        assert torch.equal(a, b)

    mp, mf, mm, sp, sf, sm, poses_t = W.pairs(2, 1024, 256)
    args = [t(a) for a in (mp, mf, mm, sp, sf, sm)]
    poses, counts = M.batched_registration_step(*args)
    for i in range(2):  # tests/test_parallel.py:42
        assert np.linalg.norm(poses[i, :3, 3].numpy() - poses_t[i][:3, 3]) < 0.1
    assert (counts > 0).all()
    got, got_counts, total = M.sharded_registration_step(world1, axis="model")(*args)
    assert torch.equal(got, poses) and torch.equal(got_counts, counts) and int(total) == int(counts.sum())
