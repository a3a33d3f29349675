"""Parity of the port's evaluation scene loop (`RegistrationNode`) with `vfmreg_tpu`.

The fixture is `tests/test_harness.py`'s scene (two posed map clouds, two
query scans, 24-d descriptors), written with the reference's `save_scene`.
The reference's node runs it serially (its CPU default) on one device, the
port's node serially (its CPU default) and batched, with
`methods_ransac=[("vfm", True)]`, `methods_teaser=[("vfm", True)]` and no
PointDSC:

* `read_scenes` gives the reference's arrays;
* against the reference, per scan: GT ICP poses within 1e-3 m and 1e-2 deg
  (chord) and vanilla ICP errors within 1e-3 m and 1e-2 deg (the packages
  differ in the order of f32 sums), and equal recall tables at the three
  thresholds of `_print_summary` for every method. RANSAC draws its picks
  from a `torch.Generator` in the port and from threefry in the reference
  (a deliberate divergence, ROADMAP queue C), so for this comparison the
  port's picks are the reference's (`jax.random.randint` under
  `PRNGKey(scan)`, injected): on this sparse scene the two generators' raw
  RANSAC poses fall on either side of the 1.5 deg threshold;
* the port's batched node against its serial node, each with its own
  generator: GT and vanilla ICP bit for bit, the RANSAC rows within 2e-3
  (`tests/test_harness.py`'s bar), the TEASER rows (serial in both) equal;
* the RobotCar GT fixes follow the file name, in both paths; the
  map-descriptor cache resets per scene; `dump_errors`' pickle reads to the
  same text with both packages' `print_errors`; the options that are not
  ported raise; the CLI runs the folder and writes the pickle;
* `dump_viz_dir` (the reference, the port serial with the reference's
  picks, the port batched): the same files; the map's bytes equal; every
  file parses with the vertex and edge counts of its header
  (`tests/test_harness.py:589-630`); the correspondence segments the
  reference's within 1e-3 m serially and the serial ones batched; and the
  CLI's `--dump-viz` writes them;
* `pipeline.synthetic.scene_file_layout` keeps one map point per occupied
  0.25 m voxel through `_accumulate_map`.
"""

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from vfmreg_tpu import config as jconfig  # noqa: E402
from vfmreg_tpu.data import h5io as jh5  # noqa: E402
from vfmreg_tpu.kiss.voxelization import _voxel_keys  # noqa: E402
from vfmreg_tpu.models import pointdsc as jpd  # noqa: E402
from vfmreg_tpu.pipeline import print_errors as jprint  # noqa: E402
from vfmreg_tpu.pipeline.registration_node import RegistrationNode as JNode  # noqa: E402
from vfmreg_tpu_torch import convert  # noqa: E402
from vfmreg_tpu_torch.config import load_config  # noqa: E402
from vfmreg_tpu_torch.data import h5io as th5  # noqa: E402
from vfmreg_tpu_torch.pipeline import print_errors as tprint  # noqa: E402
from vfmreg_tpu_torch.pipeline import registration_node as trn  # noqa: E402
from vfmreg_tpu_torch.pipeline.synthetic import make_synthetic_scene, scene_file_layout  # noqa: E402
from vfmreg_tpu_torch.registration import ransac as transac  # noqa: E402

METHODS = dict(methods_ransac=[("vfm", True)], methods_teaser=[("vfm", True)], methods_pointdsc=[])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its torch operations are small,
    gain nothing from more threads, and slow to a crawl when the suite's
    workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotation_gap_deg(pa, pb):
    chord = np.linalg.norm(pa[:3, :3] - pb[:3, :3])
    return float(np.rad2deg(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0))))


def _make_world(rng, n=6000, d=24, extent=60.0):
    pts = np.c_[rng.uniform(-extent, extent, (n, 2)), rng.uniform(0, 8, (n, 1))].astype(np.float32)
    W = rng.normal(size=(3, d)).astype(np.float32)
    return pts, np.sin(pts @ W * 0.08).astype(np.float32)


@pytest.fixture(scope="module")
def scene_h5(tmp_path_factory):
    """`tests/test_harness.py:25-52`."""
    tmp = tmp_path_factory.mktemp("scenes")
    rng = np.random.RandomState(0)
    pts, feats = _make_world(rng)
    map_poses, map_clouds = [], []
    for cx in (-15.0, 15.0):
        T = np.eye(4)
        T[0, 3] = cx
        keep = np.abs(pts[:, 0] - cx) < 40.0
        map_poses.append(T)
        map_clouds.append(np.c_[pts[keep] - T[:3, 3], feats[keep]])
    seq_poses, seq_clouds = [], []
    for cx in (-5.0, 8.0):
        T = np.eye(4)
        T[:3, 3] = [cx, 3.0, 0.0]
        keep = np.linalg.norm(pts[:, :2] - T[:2, 3], axis=1) < 30.0
        local = pts[keep] - T[:3, 3]
        sub = rng.choice(local.shape[0], min(3000, local.shape[0]), replace=False)
        seq_poses.append(T)
        seq_clouds.append(np.c_[local[sub], feats[keep][sub]])
    jh5.save_scene(tmp / "scene_000.h5", ["seq_map", "seq_a", "seq_b"], map_poses, map_clouds, seq_poses,
                   seq_clouds)
    return tmp


def _run(node):
    """make_step, recording each scan's GT pose (the first argument of its
    error calls)."""
    gts = {}
    score = node.compute_errors

    def recording(gt_pose, pose, method):
        gts.setdefault(node.scan_idx, np.array(gt_pose))
        return score(gt_pose, pose, method)

    node.compute_errors = recording
    node.make_step()
    return node, [gts[i] for i in sorted(gts)]


def _reference_picks(valid_count, generators, num_hypotheses):
    """The reference's picks for each scan: threefry under PRNGKey(scan)
    (the port seeds each scan's generator with the scan index)."""
    return torch.stack([
        torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(g.initial_seed()), (num_hypotheses, 3), 0, int(c)))).to(torch.int64)
        for g, c in zip(generators, valid_count.tolist())
    ])


@pytest.fixture(scope="module")
def viz_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("viz")
    return {k: d / k for k in ("jax", "serial_reference_picks", "batched")}


@pytest.fixture(scope="module")
def runs(scene_h5, viz_dirs):
    ref = JNode(scene_h5, dump_viz_dir=viz_dirs["jax"], **METHODS)
    # The single-device reference: the test session's 8-device CPU mesh
    # would shard its RANSAC hypotheses over per-device key streams.
    ref._sharded_ransac = ref._sharded_ransac_batched = ref._sharded_stages = None
    out = {"jax": _run(ref)}
    out["serial"] = _run(trn.RegistrationNode(scene_h5, device="cpu", batch_scans=False, **METHODS))
    out["batched"] = _run(trn.RegistrationNode(scene_h5, device="cpu", batch_scans=True,
                                               dump_viz_dir=viz_dirs["batched"], **METHODS))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transac, "_draw_picks", _reference_picks)
        out["serial_reference_picks"] = _run(trn.RegistrationNode(
            scene_h5, device="cpu", dump_viz_dir=viz_dirs["serial_reference_picks"], **METHODS))
    return out


def _recall(node):
    return {m: [node.compute_success_rate(m, *t) for t in trn.THRESHOLDS] for m in node.rot_errors}


def test_read_scenes_matches_jax(scene_h5):
    ref = jh5.read_scenes(scene_h5 / "scene_000.h5")
    got = th5.read_scenes(scene_h5 / "scene_000.h5")
    assert set(got) == set(ref)
    for k in ref:
        assert len(got[k]) == len(ref[k]), k
        for a, b in zip(got[k], ref[k]):
            np.testing.assert_array_equal(a, b)
    assert got["map_point_clouds"][0].shape[1] == 27


def test_node_matches_jax(runs, capsys):
    (ref, ref_gt), (got, got_gt) = runs["jax"], runs["serial_reference_picks"]
    assert len(got_gt) == len(ref_gt) == 2
    for a, b in zip(got_gt, ref_gt):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-3 and _rotation_gap_deg(a, b) < 1e-2, (a, b)
    assert list(got.rot_errors) == list(ref.rot_errors) == [
        "vfm_ransac", "vfm_ransac_icp", "vfm_teaser", "vfm_teaser_icp", "icp"]
    np.testing.assert_allclose(got.trans_errors["icp"], ref.trans_errors["icp"], atol=1e-3)
    np.testing.assert_allclose(got.rot_errors["icp"], ref.rot_errors["icp"], atol=1e-2)
    assert _recall(got) == _recall(ref)
    assert _recall(got)["vfm_teaser_icp"] == [1.0, 1.0, 1.0]
    # The printed summary has the reference's rows.
    got._print_summary()
    rows = [ln.split(":")[0].strip() for ln in capsys.readouterr().out.splitlines() if " | " in ln]
    assert rows[1:] == list(ref.rot_errors)


def test_batched_node_equals_serial(runs):
    (serial, serial_gt), (batched, batched_gt) = runs["serial"], runs["batched"]
    for a, b in zip(batched_gt, serial_gt):
        np.testing.assert_array_equal(a, b)
    assert list(batched.rot_errors) == list(serial.rot_errors)
    for method in serial.rot_errors:
        for errs in ("trans_errors", "rot_errors"):
            a, b = getattr(batched, errs)[method], getattr(serial, errs)[method]
            if "ransac" in method:
                np.testing.assert_allclose(a, b, atol=2e-3, err_msg=method)
            else:
                np.testing.assert_array_equal(a, b, err_msg=method)
    assert batched.batched_stats is not None and serial.batched_stats is None
    assert serial.vfm_searches == 4 and batched.vfm_searches == 2  # RANSAC + TEASER per scan, or TEASER only
    assert {"accumulate_map", "batched_row", "teaser", "errors"} <= set(batched.stage_seconds)


def _stubbed_node(folder, **kw):
    """A node whose ICP is a recording stub and whose method lists are empty."""
    node = trn.RegistrationNode(folder, device="cpu", methods_ransac=[], methods_teaser=[],
                                methods_pointdsc=[], **kw)
    calls = []

    def icp(voxel_map, raw_scan, initial_pose=None, dist=3, two_phase=False):
        calls.append((None if initial_pose is None else np.array(initial_pose), dist))
        return np.eye(4)

    node.icp_registration = icp
    return node, calls


def test_robotcar_gt_fix_and_descriptor_cache(scene_h5, tmp_path, monkeypatch):
    scene = th5.read_scenes(scene_h5 / "scene_000.h5")
    fixed = [np.array(p) for p in scene["scene_poses"]]
    for p in fixed:
        p[:3, 3] += trn.RegistrationNode._ROBOTCAR_GT_FIX[0]
    robotcar = tmp_path / "robotcar"
    robotcar.mkdir()
    (robotcar / "scene_000.h5").symlink_to(scene_h5 / "scene_000.h5")

    for folder, want in ((robotcar, fixed), (scene_h5, scene["scene_poses"])):
        node, calls = _stubbed_node(folder)
        node.map_descriptor_cache = {"fpfh": ("stale", "map")}
        node.make_step()
        gt = [c[0] for c in calls if c[1] == 3]
        assert len(gt) == 2 and all(np.array_equal(a, b) for a, b in zip(gt, want))
        assert node.map_descriptor_cache == {}

    # The batched row gets the fixed poses too.
    seen = []

    def capture(scene, local_map, **kw):
        seen.extend(scene["scene_poses"])
        raise KeyboardInterrupt

    monkeypatch.setattr(trn, "precompute_scene_batched", capture)
    node, _ = _stubbed_node(robotcar, batch_scans=True)
    with pytest.raises(KeyboardInterrupt):
        node.make_step()
    assert len(seen) == 2 and all(np.array_equal(a, b) for a, b in zip(seen, fixed))


def test_dump_errors_reads_the_same_in_both_packages(runs, tmp_path, capsys):
    node = runs["serial"][0]
    pkl = tmp_path / "errors" / "mode.pkl"
    node.dump_errors(pkl)
    with open(pkl, "rb") as f:
        data = pickle.load(f)
    assert set(data) == {"rot", "trans", "points_in_map"} and data["rot"] == node.rot_errors
    out = {}
    for name, fn in (("jax", jprint.main), ("torch", tprint.main)):
        d = tmp_path / name
        d.mkdir()
        capsys.readouterr()
        recalls = fn(pkl, error_txt_dir=d)
        out[name] = (recalls, (d / "error.txt").read_text(), capsys.readouterr().out)
    assert out["torch"] == out["jax"]
    assert "vfm_teaser" in out["torch"][1] and out["torch"][0]["vfm_teaser_icp"][(0.6, 1.5)] == 100.0
    tprint.cli([str(pkl)])
    assert "Rotation error" in capsys.readouterr().out


def test_unported_options_raise(scene_h5, tmp_path, monkeypatch):
    """The A15 options raise; the visualization dump (class and CLI) and the
    fcgf PointDSC column, which raised before they were ported, run."""
    for kw, item in (({"cluster_removal_prob": 0.5}, "A15"), ({"cluster_insertion_dir": scene_h5}, "A15"),
                     ({"scan_to_scan": "data"}, "A15"), ({"map_sharding": True}, "A15")):
        with pytest.raises(NotImplementedError, match=item):
            trn.RegistrationNode(scene_h5, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="A15"):
        trn.main([str(scene_h5), "--device", "cpu", "--cluster-removal-sweep"])
    node = trn.RegistrationNode(scene_h5, device="cpu", dump_viz_dir=tmp_path / "viz", **METHODS)
    assert node.dump_viz_dir == tmp_path / "viz"
    # A YAML config now reads as the reference reads it.
    basic = Path(__file__).resolve().parent.parent / "configs" / "basic.yaml"
    assert dataclasses.asdict(load_config(basic)) == dataclasses.asdict(jconfig.load_config(basic))
    node = trn.RegistrationNode(scene_h5, device="cpu", methods_teaser=[("vfm", True)])
    assert node.methods_ransac == [(m, True) for m in ("fpfh", "dip", "gedi", "fcgf", "gcl", "spinnet", "vfm")]
    assert node.methods_pointdsc == [("fpfh", True), ("fcgf", True)]
    params = jpd.init_pointdsc_params(jax.random.PRNGKey(0))
    torch.save(convert.pointdsc_params_from_numpy(jax.tree.map(np.asarray, params)), tmp_path / "pointdsc.pt")
    monkeypatch.setenv("VFMREG_POINTDSC_WEIGHTS", str(tmp_path / "pointdsc.pt"))
    scene = th5.read_scenes(scene_h5 / "scene_000.h5")
    local_map = node._accumulate_map(scene)
    scan = scene["scene_point_clouds"][0][:, :3]
    raw, refined = node.pointsdc_registration(local_map, scan, "fcgf", 10000, run_icp=True)
    for p in (raw, refined):
        assert np.all(np.isfinite(p)) and np.abs(p[:3, :3].T @ p[:3, :3] - np.eye(3)).max() < 1e-5
    with pytest.raises(ValueError, match="Invalid method"):
        node.pointsdc_registration(local_map, scan, "gcl", 10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trn.RegistrationNode(scene_h5)


def test_cli_runs_the_folder(scene_h5, tmp_path, capsys, monkeypatch):
    folder = tmp_path / "cli"
    folder.mkdir()
    (folder / "scene_000.h5").symlink_to(scene_h5 / "scene_000.h5")
    # The CLI's default matrix, cut to the vfm columns, fcgf RANSAC, and
    # fcgf PointDSC without weights (skipped, as the reference); the baseline
    # columns' own tests are tests/test_torch_baselines_node.py.
    monkeypatch.delenv("VFMREG_POINTDSC_WEIGHTS", raising=False)
    monkeypatch.setattr(trn, "DEFAULT_RANSAC", [("fcgf", True), ("vfm", True)])
    monkeypatch.setattr(trn, "DEFAULT_TEASER", [("vfm", True)])
    monkeypatch.setattr(trn, "DEFAULT_POINTDSC", [("fcgf", True)])
    trn.main([str(folder), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[pointdsc:fcgf] skipped" in out and "Average time per step" in out
    pkls = list(folder.glob("errors_*/mode.pkl"))
    assert len(pkls) == 1
    with open(pkls[0], "rb") as f:
        data = pickle.load(f)
    assert set(data["rot"]) == {"fcgf_ransac", "fcgf_ransac_icp", "vfm_ransac", "vfm_ransac_icp", "vfm_teaser",
                                "vfm_teaser_icp", "icp"}


def _parse_ply(path):
    """(vertices [n, 3], edges [e, 2]) of a PLY the dump writes; the body
    holds exactly the rows its header counts."""
    with open(path) as f:
        n_v = n_e = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element edge"):
                n_e = int(line.split()[-1])
            elif line == "end_header":
                break
        body = [ln.split() for ln in f]
    assert len(body) == n_v + n_e, path
    verts = np.asarray([[float(x) for x in r[:3]] for r in body[:n_v]]).reshape(-1, 3)
    edges = np.asarray([[int(x) for x in r] for r in body[n_v:]], dtype=np.int64).reshape(-1, 2)
    assert np.isfinite(verts).all()
    return verts, edges


def test_dump_viz_files_match_reference(runs, viz_dirs):
    trees = {k: sorted(p.relative_to(d).as_posix() for p in d.rglob("*.ply")) for k, d in viz_dirs.items()}
    want = ["scene_000/map.ply"] + [f"scene_000/scan_{i:02d}_{kind}.ply" for i in range(2)
                                    for kind in ("correspondences", "est_vfm_ransac_icp", "gt")]
    assert trees["jax"] == trees["serial_reference_picks"] == trees["batched"] == sorted(want)
    maps = {k: (d / "scene_000" / "map.ply").read_bytes() for k, d in viz_dirs.items()}
    assert maps["serial_reference_picks"] == maps["jax"] == maps["batched"]
    assert _parse_ply(viz_dirs["batched"] / "scene_000" / "map.ply")[0].shape[0] > 100
    for i in range(2):
        parsed = {k: _parse_ply(d / "scene_000" / f"scan_{i:02d}_correspondences.ply") for k, d in viz_dirs.items()}
        for verts, edges in parsed.values():
            n = edges.shape[0]
            assert n > 10 and verts.shape[0] == 2 * n
            np.testing.assert_array_equal(edges, np.c_[np.arange(n), np.arange(n) + n])
        for a, b in (("serial_reference_picks", "jax"), ("batched", "serial_reference_picks")):
            assert parsed[a][0].shape == parsed[b][0].shape, (a, b, i)
            np.testing.assert_allclose(parsed[a][0], parsed[b][0], atol=1e-3)
        for kind in ("gt", "est_vfm_ransac_icp"):
            verts = {k: _parse_ply(d / "scene_000" / f"scan_{i:02d}_{kind}.ply")[0] for k, d in viz_dirs.items()}
            assert verts["jax"].shape[0] > 100
            for k in ("serial_reference_picks", "batched"):
                np.testing.assert_allclose(verts[k], verts["jax"], atol=2e-2)  # poses within 1e-3 m, 1e-2 deg


def test_cli_dump_viz(scene_h5, tmp_path, monkeypatch):
    monkeypatch.setattr(trn, "DEFAULT_RANSAC", [("vfm", True)])
    monkeypatch.setattr(trn, "DEFAULT_TEASER", [])
    monkeypatch.setattr(trn, "DEFAULT_POINTDSC", [])
    folder = tmp_path / "cli"
    folder.mkdir()
    (folder / "scene_000.h5").symlink_to(scene_h5 / "scene_000.h5")
    trn.main([str(folder), "--device", "cpu", "--dump-viz", str(tmp_path / "viz")])
    scene_dir = tmp_path / "viz" / "scene_000"
    names = sorted(p.name for p in scene_dir.iterdir())
    assert names == sorted(["map.ply"] + [f"scan_{i:02d}_{k}.ply" for i in range(2)
                                          for k in ("correspondences", "est_vfm_ransac_icp", "gt")])
    for name in names:
        verts, edges = _parse_ply(scene_dir / name)
        assert verts.shape[0] > 10 and (edges.shape[0] == 0) == ("correspondences" not in name)


def test_scene_file_layout_keeps_every_map_point():
    scene, local_map, _ = make_synthetic_scene(2, 16384, 1024, 24, seed=0, extent=60.0)
    layout = scene_file_layout(scene, local_map)
    node = trn.RegistrationNode(Path("."), device="cpu", **METHODS)
    occupied = np.unique(_voxel_keys(local_map[:, :3], 0.25)).size
    acc = node._accumulate_map(layout)
    assert acc.shape == (occupied, 27)
    for cloud in layout["scene_point_clouds"] + layout["map_point_clouds"]:
        assert (cloud[:, 3:].sum(axis=1) > 0).all()
    for got, raw in zip(layout["scene_point_clouds"], scene["scene_point_clouds"]):
        np.testing.assert_array_equal(np.abs(got), np.abs(raw))
    # As they come, about half the map's rows would be dropped as descriptor-less.
    raw = dict(layout, map_point_clouds=[local_map[local_map[:, 0] < 0], local_map[local_map[:, 0] >= 0]])
    assert node._accumulate_map(raw).shape[0] < 0.7 * occupied
