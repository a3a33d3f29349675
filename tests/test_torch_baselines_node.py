"""The port's scene loop with the baseline columns, against `vfmreg_tpu`'s node.

A small structured scene (ground, boxes and poles; two posed map clouds,
two query scans; 8-d positive descriptors) goes through the reference's
`RegistrationNode` and the port's, serially, on the CPU:

* the default matrix: the reference's (FCGF and GCL included);
* `compute_correspondences("fpfh")` fed the reference's FPFH: with the
  5,000 nearest, the reference's pairs in its order; with the mutual
  filter, every pair a mutual 1-NN in f64 up to 1e-4 of the squared
  norms (many ground descriptors are near-equal, and f32 rounding picks
  among ties) and as many pairs within 10 %; the map descriptors computed
  once per scene (the per-method cache);
* given the same correspondences (the reference's, injected), the fpfh
  RANSAC column with the reference's picks and the fpfh TEASER column:
  raw poses within 1e-4 and the ICP-refined poses within 1e-3 m and 1e-2
  deg (`tests/test_torch_node.py`'s bar for ICP rows);
* the fpfh PointDSC column with the same weights (the reference's random
  12-layer parameters in a checkpoint named by VFMREG_POINTDSC_WEIGHTS)
  and the same FPFH inputs: poses within 1e-4 raw, 1e-3 m / 1e-2 deg
  refined; without the variable the column is skipped with the
  reference's message;
* `make_step` over fpfh RANSAC, TEASER and PointDSC: the reference's error
  keys in its order, finite rigid poses, and seconds per method and stage;
* the learned extractors' branches (dip, gedi, spinnet) through
  `compute_correspondences` on small clouds: pairs drawn from the clouds'
  own points, the map's descriptors cached;
* the fcgf and gcl RANSAC columns' correspondences, both packages loading
  one checkpoint file (the golden's state dict, nested under 'state_dict'):
  the same scan points with the same map partner, apart from scan
  descriptors whose two nearest map descriptors tie within 1e-5 of the
  squared distance in f64 (the ResUNets agree within ~3e-7); the fcgf
  PointDSC column fed the reference's FCGF within the PointDSC bars above;
  `make_step` over the fcgf / gcl RANSAC and fcgf PointDSC columns.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from pathlib import Path  # noqa: E402

from vfmreg_tpu.data import h5io as jh5  # noqa: E402
from vfmreg_tpu.descriptors import fcgf as jfcgf  # noqa: E402
from vfmreg_tpu.descriptors import fpfh as jfpfh  # noqa: E402
from vfmreg_tpu.descriptors import gcl as jgcl  # noqa: E402
from vfmreg_tpu.models import pointdsc as jpd  # noqa: E402
from vfmreg_tpu.pipeline import registration_node as jrn  # noqa: E402
from vfmreg_tpu.kiss.voxelization import voxel_down_sample  # noqa: E402
from vfmreg_tpu_torch import convert  # noqa: E402
from vfmreg_tpu_torch.pipeline import registration_node as trn  # noqa: E402
from vfmreg_tpu_torch.registration import ransac as transac  # noqa: E402

FPFH_ONLY = dict(methods_ransac=[("fpfh", True)], methods_teaser=[("fpfh", True)],
                 methods_pointdsc=[("fpfh", True)])


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _world(rng):
    ground = np.c_[rng.uniform(-14, 14, (7000, 2)), rng.normal(0, 0.02, (7000, 1))]
    parts = [ground]
    for cx, cy, w, h in ((-6, 4, 3, 2.5), (5, -5, 2, 3), (7, 6, 4, 1.5), (-4, -7, 2.5, 2)):
        m = 900
        face = rng.randint(0, 4, m)
        u, z = rng.uniform(-w / 2, w / 2, m), rng.uniform(0, h, m)
        x = np.where(face < 2, cx + np.where(face == 0, -w / 2, w / 2), cx + u)
        y = np.where(face < 2, cy + u, cy + np.where(face == 2, -w / 2, w / 2))
        parts.append(np.c_[x, y, z])
    for px, py in ((0, 9), (-9, 0), (10, 0), (2, -10)):
        t = rng.uniform(0, 2 * np.pi, 300)
        parts.append(np.c_[px + 0.3 * np.cos(t), py + 0.3 * np.sin(t), rng.uniform(0, 4, 300)])
    pts = np.concatenate(parts).astype(np.float32)
    feats = np.abs(np.sin(pts @ rng.normal(size=(3, 8)).astype(np.float32))) + 0.05
    return pts, feats.astype(np.float32)


@pytest.fixture(scope="module")
def scene_h5(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("baseline_scene")
    rng = np.random.RandomState(0)
    pts, feats = _world(rng)
    map_poses, map_clouds = [], []
    for cx in (-4.0, 4.0):
        T = np.eye(4)
        T[0, 3] = cx
        keep = np.abs(pts[:, 0] - cx) < 12.0
        map_poses.append(T)
        map_clouds.append(np.c_[pts[keep] - T[:3, 3], feats[keep]])
    seq_poses, seq_clouds = [], []
    for cx, yaw in ((-2.0, 0.2), (3.0, -0.3)):
        T = np.eye(4)
        c, s = np.cos(yaw), np.sin(yaw)
        T[:2, :2] = [[c, -s], [s, c]]
        T[:3, 3] = [cx, 1.0, 0.0]
        keep = np.linalg.norm(pts[:, :2] - T[:2, 3], axis=1) < 11.0
        local = (pts[keep] - T[:3, 3]) @ T[:3, :3]
        sub = rng.choice(local.shape[0], min(3000, local.shape[0]), replace=False)
        seq_poses.append(T)
        seq_clouds.append(np.c_[local[sub] + rng.normal(0, 0.005, (len(sub), 3)), feats[keep][sub]])
    jh5.save_scene(tmp / "scene_000.h5", ["seq_map", "seq_a", "seq_b"], map_poses, map_clouds, seq_poses,
                   seq_clouds)
    return tmp


@pytest.fixture(scope="module")
def pair(scene_h5):
    """(the accumulated map, scan 0 as make_step hands it to the columns)."""
    ref = jrn.RegistrationNode(scene_h5, methods_ransac=[], methods_teaser=[], methods_pointdsc=[])
    scene = jh5.read_scenes(scene_h5 / "scene_000.h5")
    local_map = ref._accumulate_map(scene)
    scan = voxel_down_sample(scene["scene_point_clouds"][0], 0.1).astype(np.float32)
    return local_map, scan


@pytest.fixture(scope="module")
def pointdsc_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("pointdsc") / "pointdsc.pt"
    params = jpd.init_pointdsc_params(jax.random.PRNGKey(0))
    torch.save(convert.pointdsc_params_from_numpy(jax.tree.map(np.asarray, params)), path)
    return path


def _nodes(scene_h5, **kw):
    ref = jrn.RegistrationNode(scene_h5, **kw)
    ref._sharded_ransac = ref._sharded_ransac_batched = ref._sharded_stages = None
    return ref, trn.RegistrationNode(scene_h5, device="cpu", **kw)


def _close(a, b, atol_m, atol_deg):
    assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < atol_m, (a, b)
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3])
    assert np.rad2deg(2 * np.arcsin(min(chord / (2 * np.sqrt(2)), 1.0))) < atol_deg, (a, b)


def test_default_matrix_drops_fcgf_and_gcl(scene_h5):
    """Since FCGF and GCL are ported, nothing drops: the port's default
    matrix is the reference's, and every extractor is the port's."""
    ref, got = _nodes(scene_h5)
    for col in ("methods_ransac", "methods_teaser", "methods_pointdsc"):
        assert getattr(got, col) == getattr(ref, col), col
    assert [m for m, _ in got.methods_ransac] == ["fpfh", "dip", "gedi", "fcgf", "gcl", "spinnet", "vfm"]
    assert got.methods_teaser == [("fpfh", True), ("vfm", True)]
    assert got.methods_pointdsc == [("fpfh", True), ("fcgf", True)]
    for m in ("fpfh", "dip", "gedi", "fcgf", "gcl", "spinnet"):
        assert trn.get_extractor(m).__module__ == f"vfmreg_tpu_torch.descriptors.{m}"
    with pytest.raises(KeyError):
        trn.get_extractor("nope")


@pytest.fixture(scope="module")
def reference_correspondences(scene_h5, pair):
    local_map, scan = pair
    ref = jrn.RegistrationNode(scene_h5, **FPFH_ONLY)
    return {mutual: ref.compute_correspondences(local_map[:, :3], scan[:, :3], "fpfh", mutual_filter=mutual)
            for mutual in (False, True)}


@pytest.mark.parametrize("mutual", [False, True])
def test_compute_correspondences_matches_reference(scene_h5, pair, reference_correspondences, mutual, monkeypatch):
    """Fed the reference's FPFH (on this scene's flat ground many
    descriptors are near-equal, so the 1-NN turns on the last ulp of the
    features, `tests/test_torch_fpfh.py`), the pairs are the reference's."""
    local_map, scan = pair
    want_src, want_tgt = reference_correspondences[mutual]
    node = trn.RegistrationNode(scene_h5, device="cpu", **FPFH_ONLY)
    calls = []

    def reference_fpfh(name):
        def extract(pcl, voxel_size, device=None):
            calls.append(pcl.shape[0])
            return jfpfh.extract_fpfh_features(pcl, voxel_size)

        return extract

    monkeypatch.setattr(trn, "get_extractor", reference_fpfh)
    for _ in range(2):
        src, tgt = node.compute_correspondences(local_map[:, :3], scan[:, :3], "fpfh", mutual_filter=mutual)
        if not mutual:
            np.testing.assert_array_equal(src, want_src)
            np.testing.assert_array_equal(tgt, want_tgt)
    assert calls == [local_map.shape[0], scan.shape[0], scan.shape[0]]  # the map once per scene
    assert set(node.map_descriptor_cache) == {"fpfh"}
    assert len(src) > 100
    if mutual:
        # The mutual filter reads both directions' 1-NN among many near-equal
        # ground descriptors, where the expansion's f32 rounding (XLA's dot
        # or MKL's) picks among ties. Every pair the port keeps is a mutual
        # 1-NN in f64 up to 1e-4 of the squared norms, and the two keep as
        # many pairs within 10 %.
        down_map, f_map = node.map_descriptor_cache["fpfh"]
        down_scan, f_scan = jfpfh.extract_fpfh_features(scan[:, :3], 0.1)
        i = np.array([np.flatnonzero((down_scan == r).all(1))[0] for r in src])
        j = np.array([np.flatnonzero((down_map == r).all(1))[0] for r in tgt])
        d = ((f_scan[i][:, None, :] - f_map[None, :, :]) ** 2).sum(-1)  # [pairs, M]
        eps = 1e-4 * np.mean((f_map**2).sum(1))
        assert np.all(d[np.arange(len(i)), j] <= d.min(1) + eps)
        back = ((f_map[j][:, None, :] - f_scan[None, :, :]) ** 2).sum(-1)
        assert np.all(back[np.arange(len(j)), i] <= back.min(1) + eps)
        assert abs(len(src) - len(want_src)) <= 0.1 * len(want_src), (len(src), len(want_src))


def _reference_picks(valid_count, generators, num_hypotheses):
    return torch.stack([
        torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(g.initial_seed()), (num_hypotheses, 3), 0, int(c)))).to(torch.int64)
        for g, c in zip(generators, valid_count.tolist())
    ])


def test_ransac_and_teaser_columns_match_reference(scene_h5, pair, reference_correspondences, monkeypatch):
    local_map, scan = pair
    ref, got = _nodes(scene_h5, **FPFH_ONLY)
    ref.scan_idx = got.scan_idx = 0
    for node in (ref, got):
        monkeypatch.setattr(node, "compute_correspondences",
                            lambda vm, rs, method, mutual_filter=False, **kw: reference_correspondences[mutual_filter])
    monkeypatch.setattr(transac, "_draw_picks", _reference_picks)
    for col in ("ransac_registration", "teaser_registration"):
        want_raw, want_icp = getattr(ref, col)(local_map, scan, "fpfh", True)
        got_raw, got_icp = getattr(got, col)(local_map, scan, "fpfh", True)
        np.testing.assert_allclose(got_raw, want_raw, atol=1e-4, err_msg=col)
        _close(got_icp, want_icp, 1e-3, 1e-2)


def test_pointdsc_column_matches_reference(scene_h5, pair, pointdsc_weights, monkeypatch):
    local_map, scan = pair
    monkeypatch.setenv("VFMREG_POINTDSC_WEIGHTS", str(pointdsc_weights))
    ref, got = _nodes(scene_h5, **FPFH_ONLY)
    # The same FPFH inputs on both sides: the reference's features.
    monkeypatch.setattr(trn, "get_extractor", lambda name: (
        lambda pcl, v, normalize=False, device=None: jfpfh.extract_fpfh_features(pcl, v, normalize=normalize)))
    want_raw, want_icp = ref.pointsdc_registration(local_map, scan, "fpfh", 10000, True)
    got_raw, got_icp = got.pointsdc_registration(local_map, scan, "fpfh", 10000, True)
    np.testing.assert_allclose(got_raw, want_raw, atol=1e-4)
    _close(got_icp, want_icp, 1e-3, 1e-2)


def test_make_step_runs_the_baseline_columns(scene_h5, pointdsc_weights, monkeypatch, capsys):
    monkeypatch.delenv("VFMREG_POINTDSC_WEIGHTS", raising=False)
    node = trn.RegistrationNode(scene_h5, device="cpu", methods_ransac=[], methods_teaser=[],
                                methods_pointdsc=[("fpfh", True)])
    node.make_step()
    out = capsys.readouterr().out
    assert "[pointdsc:fpfh] skipped: PointDSC weights not found" in out
    assert list(node.rot_errors) == ["icp"]

    monkeypatch.setenv("VFMREG_POINTDSC_WEIGHTS", str(pointdsc_weights))
    node = trn.RegistrationNode(scene_h5, device="cpu", **FPFH_ONLY)
    poses = []
    score = node.compute_errors

    def recording(gt_pose, pose, method):
        poses.append(pose)
        return score(gt_pose, pose, method)

    node.compute_errors = recording
    node.make_step()
    assert list(node.rot_errors) == ["fpfh_ransac", "fpfh_ransac_icp", "fpfh_teaser", "fpfh_teaser_icp",
                                     "fpfh_pointdsc", "fpfh_pointdsc_icp", "icp"]
    assert all(len(v) == 2 for v in node.rot_errors.values())
    for p in poses:
        assert np.all(np.isfinite(p)) and np.abs(p[:3, :3].T @ p[:3, :3] - np.eye(3)).max() < 1e-5
    stages = set(node.stage_seconds)
    for col in ("fpfh_ransac", "fpfh_teaser", "fpfh_pointdsc"):
        assert {f"{col}_scan_descriptors", f"{col}_match", f"{col}_solve", f"{col}_refine"} <= stages, stages
    assert "fpfh_ransac_map_descriptors" in stages and "fpfh_pointdsc_map_descriptors" in stages
    node._print_summary()
    rows = [ln.split(":")[0].strip() for ln in capsys.readouterr().out.splitlines() if " | " in ln]
    assert rows[-7:] == list(node.rot_errors)


@pytest.mark.parametrize("method,n_map,n_scan", [("dip", 300, 200), ("gedi", 120, 80), ("spinnet", 300, 200)])
def test_learned_branches_run(scene_h5, method, n_map, n_scan):
    rng = np.random.RandomState(3)
    cloud, _ = _world(rng)
    cloud = cloud[np.abs(cloud[:, :2]).max(1) < 4]  # an 8 m square
    map_pts = cloud[rng.choice(len(cloud), n_map, replace=False)]
    scan = cloud[rng.choice(len(cloud), n_scan, replace=False)] + rng.normal(0, 0.01, (n_scan, 3)).astype(np.float32)
    node = trn.RegistrationNode(scene_h5, device="cpu", methods_ransac=[(method, True)], methods_teaser=[],
                                methods_pointdsc=[])
    if method == "spinnet":
        node._EXTRACT_ARG = dict(node._EXTRACT_ARG, spinnet=4)  # 4 keypoints: the CPU's budget
    src, tgt = node.compute_correspondences(map_pts, scan, method)
    assert method in node.map_descriptor_cache and src.shape == tgt.shape and len(src) > 0
    map_rows = {tuple(r) for r in node.map_descriptor_cache[method][0]}
    assert all(tuple(r) in map_rows for r in tgt)
    scan_rows = {tuple(r) for r in np.asarray(scan, np.float64)}
    assert all(tuple(r) in scan_rows for r in src) if method == "spinnet" else len(src) <= len(scan)


@pytest.fixture(scope="module")
def resunet_checkpoints(tmp_path_factory):
    """One MinkowskiEngine-layout checkpoint file per model, from its golden."""
    d = tmp_path_factory.mktemp("resunet")
    out = {}
    for name in ("fcgf", "gcl"):
        g = np.load(Path(__file__).resolve().parent / "golden" / f"{name}_reference_golden.npz")
        out[name] = d / f"{name}.pth"
        torch.save({"state_dict": {k[4:]: torch.from_numpy(np.array(g[k])) for k in g.files if k.startswith("sd::")}},
                   out[name])
    return out


@pytest.fixture
def resunet_weights(resunet_checkpoints, monkeypatch):
    for name, mod in (("fcgf", jfcgf), ("gcl", jgcl)):
        monkeypatch.setenv(f"VFMREG_{name.upper()}_WEIGHTS", str(resunet_checkpoints[name]))
        monkeypatch.setattr(mod, "_PARAMS", None)


@pytest.mark.parametrize("method", ["fcgf", "gcl"])
def test_fcgf_gcl_correspondences_match_reference(scene_h5, pair, resunet_weights, method):
    local_map, scan = pair
    kw = dict(methods_ransac=[(method, True)], methods_teaser=[], methods_pointdsc=[])
    ref, got = _nodes(scene_h5, **kw)
    want_src, want_tgt = ref.compute_correspondences(local_map[:, :3], scan[:, :3], method)
    got_src, got_tgt = got.compute_correspondences(local_map[:, :3], scan[:, :3], method)
    down_map, f_map = got.map_descriptor_cache[method]
    down_scan, f_scan = trn.get_extractor(method)(scan[:, :3], 0.3, device="cpu")
    np.testing.assert_array_equal(down_map, ref.map_descriptor_cache[method][0])
    np.testing.assert_array_equal(got_src, want_src)  # the same scan voxels, in order
    assert len(down_scan) >= len(got_src) > 100
    differ = np.flatnonzero((got_tgt != want_tgt).any(1))
    row = {tuple(r): i for i, r in enumerate(down_map.astype(np.float32))}
    f_scan, f_map = f_scan.astype(np.float64), f_map.astype(np.float64)
    for k in differ:
        d = ((f_scan[k] - f_map) ** 2).sum(1)
        a, b = row[tuple(got_tgt[k])], row[tuple(want_tgt[k])]
        assert abs(d[a] - d[b]) <= 1e-5 and min(d[a], d[b]) <= d.min() + 1e-5, (k, d[a], d[b], d.min())
    assert len(differ) <= 0.02 * len(got_src), len(differ)


def test_fcgf_pointdsc_column_matches_reference(scene_h5, pair, pointdsc_weights, resunet_weights, monkeypatch):
    local_map, scan = pair
    monkeypatch.setenv("VFMREG_POINTDSC_WEIGHTS", str(pointdsc_weights))
    kw = dict(methods_ransac=[], methods_teaser=[], methods_pointdsc=[("fcgf", True)])
    ref, got = _nodes(scene_h5, **kw)
    # The same FCGF inputs on both sides: the reference's descriptors.
    monkeypatch.setattr(trn, "get_extractor", lambda name: (
        lambda pcl, v, device=None: jfcgf.extract_fcgf_features(pcl, v)))
    want_raw, want_icp = ref.pointsdc_registration(local_map, scan, "fcgf", 10000, True)
    got_raw, got_icp = got.pointsdc_registration(local_map, scan, "fcgf", 10000, True)
    np.testing.assert_allclose(got_raw, want_raw, atol=1e-4)
    _close(got_icp, want_icp, 1e-3, 1e-2)


def test_make_step_runs_the_fcgf_gcl_columns(scene_h5, pointdsc_weights, resunet_weights, monkeypatch):
    monkeypatch.setenv("VFMREG_POINTDSC_WEIGHTS", str(pointdsc_weights))
    node = trn.RegistrationNode(scene_h5, device="cpu", methods_ransac=[("fcgf", True), ("gcl", True)],
                                methods_teaser=[], methods_pointdsc=[("fcgf", True)])
    poses = []
    score = node.compute_errors

    def recording(gt_pose, pose, method):
        poses.append(pose)
        return score(gt_pose, pose, method)

    node.compute_errors = recording
    node.make_step()
    assert list(node.rot_errors) == ["fcgf_ransac", "fcgf_ransac_icp", "gcl_ransac", "gcl_ransac_icp",
                                     "fcgf_pointdsc", "fcgf_pointdsc_icp", "icp"]
    assert all(len(v) == 2 for v in node.rot_errors.values())
    for p in poses:
        assert np.all(np.isfinite(p)) and np.abs(p[:3, :3].T @ p[:3, :3] - np.eye(3)).max() < 1e-5
    stages = set(node.stage_seconds)
    for col in ("fcgf_ransac", "gcl_ransac", "fcgf_pointdsc"):
        assert {f"{col}_map_descriptors", f"{col}_scan_descriptors", f"{col}_match", f"{col}_solve",
                f"{col}_refine"} <= stages, stages
