"""The scene loop's experiment modes in the port (`RegistrationNode`'s cluster
removal, cluster insertion, scan-to-scan on the scene's data and on KITTI
frames, and the removal sweep of the CLI) against `vfmreg_tpu`.

The fixture is `tests/test_torch_node.py`'s scene (two posed map clouds, two
query scans, 24-d descriptors) with six trees planted: vertical clusters
whose first three descriptor columns are the reference's tree colours over
255. Both packages' `ImageFeatureGenerator`s get the same PCA fit, the
projection onto those three columns; two anchor points with those columns
at 0 and 1 fix the min-max normalisation, and every other point's colour
lies more than 50 from both tree colours. Beside it: five tree clusters as
`.npy` files for the insertion, and twelve KITTI-style `.bin` frames (x, y,
z, intensity as float32) of the same world seen from a sensor moving 1 m a
frame.

* removal at p = 0.2, 0.5 and 1.0, twice on one map (the scans' draws
  continue one generator): the same rows in the same order and the same
  `points_in_map` as the reference; HDBSCAN finds the six trees, and the
  trees left are those whose draw lies above the normal quantile of p
  (p = 0.5 takes three, 1.0 all, 0.2 none); the generator's PCA fit is the one it was given (`run_pca`
  reuses a fit, never refits);
* insertion at p = 0.05: the same rows (five clusters);
* the empty selections raise as the reference's do (no point in a tree
  colour: the KD-tree's k >= 1 check; tree points but no cluster: numpy's
  empty reduction), with the same exception and message;
* `make_step` in each mode (removal 0.5, insertion 0.05, scan-to-scan
  "data", "kitti") on the port (asked for the batched row, which an
  experiment turns off) and on the reference, `np.random` seeded alike
  before each: the same error keys (KITTI skips the vfm columns), equal
  recall tables at the three thresholds, the same `points_in_map`, GT poses
  within 1e-3 m / 1e-2 deg, and where the reference's row registered (RTE
  < 2 m) the vanilla ICP's errors within 1e-3 m / 1e-2 deg, the RANSAC and
  TEASER rows' within 1e-2 m / 5e-2 deg (f32 solves); the scans registered
  against the removal's and the insertion's maps; the pickles of
  `dump_errors` hold the same keys and map sizes. RANSAC takes the
  reference's picks (`_draw_picks` patched, as in `tests/test_torch_node.py`);
* `--cluster-removal-sweep`: the reference's 11 `mode_<NNN>.pkl` names, its
  probabilities in its order, one generator for every mode, and each mode's
  `points_in_map` equal to the reference's removal run on the same map with
  the same draws.
"""

import dataclasses
import pickle
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tests_vit_config import SMALL_VIT  # noqa: E402
from vfmreg_tpu.data import h5io as jh5  # noqa: E402
from vfmreg_tpu.models import image_features as jif  # noqa: E402
from vfmreg_tpu.pipeline import registration_node as jrn  # noqa: E402
from vfmreg_tpu_torch.data import h5io as th5  # noqa: E402
from vfmreg_tpu_torch.models import image_features as tif  # noqa: E402
from vfmreg_tpu_torch.models.vit import ViTConfig  # noqa: E402
from vfmreg_tpu_torch.pipeline import registration_node as trn  # noqa: E402
from vfmreg_tpu_torch.registration import ransac as transac  # noqa: E402

METHODS = dict(methods_ransac=[("vfm", True)], methods_teaser=[("vfm", True)], methods_pointdsc=[])
PORT_SMALL = ViTConfig(**{f.name: getattr(SMALL_VIT, f.name) for f in dataclasses.fields(ViTConfig)
                          if hasattr(SMALL_VIT, f.name)})
D = 24
TREE_COLORS = np.array([[217, 60, 165], [118, 105, 57]], dtype=np.float64) / 255.0
TREE_XY = np.array([[-30.0, -20.0], [-10.0, 20.0], [10.0, -20.0], [30.0, 20.0], [-25.0, 5.0], [25.0, -5.0]])
MODES = {
    "removal": dict(cluster_removal_prob=0.5),
    "insertion": dict(cluster_removal_prob=0.05, cluster_insertion_dir="clusters"),
    "data": dict(scan_to_scan="data"),
    "kitti": dict(scan_to_scan="kitti", kitti_dir="kitti"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, center_xy, n=300):
    """A trunk (r 0.25 m, 0-3 m) under a crown (r 1.5 m at 4.5 m)."""
    n_trunk = n // 3
    ang = rng.uniform(0, 2 * np.pi, n_trunk)
    rad = 0.25 * np.sqrt(rng.uniform(0, 1, n_trunk))
    trunk = np.c_[rad * np.cos(ang), rad * np.sin(ang), rng.uniform(0, 3, n_trunk)]
    v = rng.normal(size=(n - n_trunk, 3))
    v *= (1.5 * rng.uniform(0, 1, (n - n_trunk, 1)) ** (1 / 3)) / np.linalg.norm(v, axis=1, keepdims=True)
    crown = v + [0.0, 0.0, 4.5]
    return np.r_[trunk, crown] + [center_xy[0], center_xy[1], 0.0]


def _colours_away_from_trees(rng, n):
    """Colour columns in [0, 1]^3 more than 0.35 (89 over 255) from both tree colours."""
    out = np.empty((0, 3))
    while out.shape[0] < n:
        c = rng.uniform(0, 1, (2 * n, 3))
        far = np.min(np.linalg.norm(c[:, None] - TREE_COLORS[None], axis=-1), axis=1) > 0.35
        out = np.r_[out, c[far]]
    return out[:n]


@pytest.fixture(scope="module")
def world():
    """(points [n, 3], descriptors [n, D], tree id per point (-1 off trees))."""
    rng = np.random.RandomState(0)
    n = 6000
    pts = np.c_[rng.uniform(-60, 60, (n, 2)), rng.uniform(0, 8, (n, 1))]
    colour = _colours_away_from_trees(rng, n)
    trees = [_tree(rng, xy) for xy in TREE_XY]
    tree_id = np.r_[np.full(n + 2, -1), np.repeat(np.arange(len(trees)), [t.shape[0] for t in trees])]
    pts = np.r_[pts, [[0.0, -2.0, 1.0], [0.0, 2.0, 1.0]], *trees]
    colour = np.r_[colour, [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]],
                   *[np.repeat(TREE_COLORS[k % 2][None], t.shape[0], 0) for k, t in enumerate(trees)]]
    W = rng.normal(size=(3, D - 3))
    sines = np.sin(pts @ W * 0.08)
    # Rows summing to <= 0 would be dropped by the map accumulation as points
    # without a descriptor: negate their sines (the colours stay).
    sines[colour.sum(1) + sines.sum(1) <= 0] *= -1
    feats = np.c_[colour, sines]
    return pts.astype(np.float32), feats.astype(np.float32), tree_id


def _write_scene(path, pts, feats):
    """`tests/test_torch_node.py`'s layout: two map clouds in their own
    frames, two scans of up to 3,000 points within 30 m."""
    rng = np.random.RandomState(1)
    map_poses, map_clouds, seq_poses, seq_clouds = [], [], [], []
    for cx in (-15.0, 15.0):
        T = np.eye(4)
        T[0, 3] = cx
        keep = np.abs(pts[:, 0] - cx) < 40.0
        map_poses.append(T)
        map_clouds.append(np.c_[pts[keep] - T[:3, 3], feats[keep]].astype(np.float32))
    for cx in (-5.0, 8.0):
        T = np.eye(4)
        T[:3, 3] = [cx, 3.0, 0.0]
        keep = np.flatnonzero(np.linalg.norm(pts[:, :2] - T[:2, 3], axis=1) < 30.0)
        sub = rng.choice(keep, min(3000, keep.size), replace=False)
        seq_poses.append(T)
        seq_clouds.append(np.c_[pts[sub] - T[:3, 3], feats[sub]].astype(np.float32))
    jh5.save_scene(path, ["seq_map", "seq_a", "seq_b"], map_poses, map_clouds, seq_poses, seq_clouds)


@pytest.fixture(scope="module")
def folders(world, tmp_path_factory):
    root = tmp_path_factory.mktemp("experiments")
    pts, feats, _ = world
    (root / "scenes").mkdir()
    _write_scene(root / "scenes" / "scene_000.h5", pts, feats)
    rng = np.random.RandomState(2)
    (root / "clusters").mkdir()
    for k in range(5):
        t = _tree(rng, rng.uniform(-5, 5, 2), n=200)
        c = np.c_[t, np.repeat(TREE_COLORS[k % 2][None], t.shape[0], 0), rng.normal(size=(t.shape[0], D - 3))]
        np.save(root / "clusters" / f"tree_{k}.npy", c.astype(np.float32))
    (root / "kitti").mkdir()
    for i in range(12):
        origin = np.array([-10.0 + i, 0.0, 0.0])
        keep = np.linalg.norm(pts[:, :2] - origin[:2], axis=1) < 25.0
        frame = np.c_[pts[keep] - origin, np.zeros(int(keep.sum()))].astype(np.float32)
        frame.tofile(root / "kitti" / f"{i:06d}.bin")
    return root


def _set_fit(gen, pca_cls):
    fit = pca_cls(3)
    fit.mean_ = np.zeros((1, D), np.float32)
    fit.components_ = np.eye(D, 3, dtype=np.float32)
    gen.fit_pca[3] = fit
    return gen


def _jax_generator():
    gen = jif.ImageFeatureGenerator("dinov2", config=SMALL_VIT)
    return _set_fit(gen, jif.TorchPCA)


def _port_generator(cls=tif.ImageFeatureGenerator):
    gen = cls("dinov2", config=PORT_SMALL, device="cpu")
    return _set_fit(gen, tif.TorchPCA)


def _jax_node(folder, **kw):
    node = jrn.RegistrationNode(folder, **kw)
    # The single-device reference (the tests' 8-device CPU mesh
    # would shard its RANSAC hypotheses over per-device key streams).
    node._sharded_ransac = node._sharded_ransac_batched = node._sharded_stages = None
    return node


def _reference_picks(valid_count, generators, num_hypotheses):
    """The reference's picks for each scan: threefry under PRNGKey(scan)."""
    return torch.stack([
        torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(g.initial_seed()), (num_hypotheses, 3), 0, int(c)))).to(torch.int64)
        for g, c in zip(generators, valid_count.tolist())
    ])


@pytest.fixture(scope="module")
def local_map(folders):
    scene = th5.read_scenes(folders / "scenes" / "scene_000.h5")
    node = trn.RegistrationNode(folders, device="cpu", **METHODS)
    got = node._accumulate_map(scene)
    np.testing.assert_array_equal(got, _jax_node(folders, **METHODS)._accumulate_map(scene))
    return got


def _trees_left(m):
    """How many planted trees still have a point of their trunk in map m."""
    return sum(bool(np.any((np.linalg.norm(m[:, :2] - xy, axis=1) < 0.3) & (m[:, 2] < 2.5))) for xy in TREE_XY)


@pytest.mark.parametrize("p", [0.2, 0.5, 1.0])
def test_cluster_removal_matches_reference(p, folders, local_map, capsys):
    jgen, tgen = _jax_generator(), _port_generator()
    fit = tgen.fit_pca[3]
    ref = _jax_node(folders, cluster_removal_prob=p, feature_generator=jgen, **METHODS)
    got = trn.RegistrationNode(folders, cluster_removal_prob=p, feature_generator=tgen, device="cpu", **METHODS)
    rngs = np.random.RandomState(42), np.random.RandomState(42)
    capsys.readouterr()
    for _ in range(2):  # two scans: the draws go on in one generator
        want = ref._apply_cluster_removal(local_map, rngs[0])
        m = got._apply_cluster_removal(local_map, rngs[1])
        np.testing.assert_array_equal(m, want)
    assert got.points_in_map == ref.points_in_map and len(got.points_in_map) == 2
    assert tgen.fit_pca[3] is fit
    clusters = [int(c) for c in re.findall(r"Clusters: (\d+)", capsys.readouterr().out)]
    assert clusters == [len(TREE_XY)] * 4, clusters  # two runs a package, one per scan
    # One cluster per tree; the second scan's six draws decide its map: a
    # tree goes where its draw is at most the normal quantile of p.
    import scipy.stats

    draws = np.random.RandomState(42).standard_normal(12)[6:]
    assert _trees_left(local_map) == len(TREE_XY)
    assert _trees_left(m) == np.sum(draws > scipy.stats.norm.ppf(p))


def test_cluster_insertion_matches_reference(folders, local_map):
    ref = _jax_node(folders, cluster_removal_prob=0.05, cluster_insertion_dir=folders / "clusters", **METHODS)
    got = trn.RegistrationNode(folders, cluster_removal_prob=0.05, cluster_insertion_dir=folders / "clusters",
                               device="cpu", **METHODS)
    gt = np.eye(4)
    gt[:3, 3] = [-5.0, 3.0, 0.0]
    rngs = np.random.RandomState(42), np.random.RandomState(42)
    for _ in range(2):
        want = ref._apply_cluster_insertion(local_map, gt, rngs[0])
        m = got._apply_cluster_insertion(local_map, gt, rngs[1])
        np.testing.assert_array_equal(m, want)
    assert m.shape[0] == local_map.shape[0] + 5 * 200 and m.dtype == local_map.dtype
    assert got.points_in_map == ref.points_in_map == []


def test_empty_selections_raise_as_the_reference(folders, local_map):
    """No tree-coloured point, or tree points but no cluster of 100: the
    reference has no guard and raises; so does the port, alike."""
    no_trees = local_map[np.min(np.linalg.norm(local_map[:, 3:6, None] - TREE_COLORS.T[None], axis=1), 1) > 0.2]
    small = np.r_[no_trees, local_map[np.linalg.norm(local_map[:, :2] - TREE_XY[0], axis=1) < 1.6][:60]]
    for m in (no_trees, small):
        errors = []
        for node in (_jax_node(folders, cluster_removal_prob=0.5, feature_generator=_jax_generator(), **METHODS),
                     trn.RegistrationNode(folders, cluster_removal_prob=0.5, feature_generator=_port_generator(),
                                          device="cpu", **METHODS)):
            with pytest.raises(ValueError) as err:
                node._apply_cluster_removal(m, np.random.RandomState(42))
            errors.append(str(err.value))
        assert errors[0] == errors[1], errors
    node = trn.RegistrationNode(folders, cluster_removal_prob=0.5, device="cpu", **METHODS)
    with pytest.raises(ValueError, match="feature_generator"):
        node._apply_cluster_removal(local_map, np.random.RandomState(42))


def _mode_kwargs(mode, folders, generator):
    kw = {k: (folders / v if k.endswith("_dir") else v) for k, v in MODES[mode].items()}
    if mode == "removal":
        kw["feature_generator"] = generator
    return kw


def _run(node, seed):
    """make_step with `np.random` seeded first, recording each scan's GT pose."""
    gts = {}
    score = node.compute_errors

    def recording(gt_pose, pose, method):
        gts.setdefault(node.scan_idx, np.array(gt_pose))
        return score(gt_pose, pose, method)

    node.compute_errors = recording
    np.random.seed(seed)
    node.make_step()
    return node, [gts[i] for i in sorted(gts)]


@pytest.fixture(scope="module")
def mode_runs(folders):
    scenes = folders / "scenes"
    out = {}
    map_hash = trn.RegistrationNode._map_hash

    def recording_map_hash(self, local_map, with_descriptors):
        self.hashed_sizes.add(local_map.shape[0])
        return map_hash(self, local_map, with_descriptors)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transac, "_draw_picks", _reference_picks)
        mp.setattr(trn.RegistrationNode, "_map_hash", recording_map_hash)
        for mode in MODES:
            ref = _jax_node(scenes, **_mode_kwargs(mode, folders, _jax_generator()), **METHODS)
            got = trn.RegistrationNode(scenes, device="cpu", batch_scans=True,
                                       **_mode_kwargs(mode, folders, _port_generator()), **METHODS)
            got.hashed_sizes = set()
            out[mode] = _run(ref, 7), _run(got, 7)
    return out


def _rotation_gap_deg(pa, pb):
    chord = np.linalg.norm(pa[:3, :3] - pb[:3, :3])
    return float(np.rad2deg(2.0 * np.arcsin(min(chord / (2.0 * np.sqrt(2.0)), 1.0))))


@pytest.mark.parametrize("mode", list(MODES))
def test_run_scene_modes_match_reference(mode, mode_runs, local_map, tmp_path):
    (ref, ref_gt), (got, got_gt) = mode_runs[mode]
    assert got.batched_stats is None  # an experiment runs every scan serially
    assert len(got_gt) == len(ref_gt) == 2
    for a, b in zip(got_gt, ref_gt):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 1e-3 and _rotation_gap_deg(a, b) < 1e-2, (a, b)
    want_keys = ["icp"] if mode == "kitti" else [
        "vfm_ransac", "vfm_ransac_icp", "vfm_teaser", "vfm_teaser_icp", "icp"]
    assert list(got.rot_errors) == list(ref.rot_errors) == want_keys
    recall = {m: [got.compute_success_rate(m, *t) for t in trn.THRESHOLDS] for m in got.rot_errors}
    assert recall == {m: [ref.compute_success_rate(m, *t) for t in trn.THRESHOLDS] for m in ref.rot_errors}
    assert got.points_in_map == ref.points_in_map
    assert len(got.points_in_map) == (2 if mode == "removal" else 0)
    # Each scan registered against its own map (the hash is keyed by the
    # map object, so a new map builds a new grid).
    if mode == "removal":
        assert set(got.points_in_map) <= got.hashed_sizes
    if mode == "insertion":
        assert local_map.shape[0] + 5 * 200 in got.hashed_sizes
    for m in want_keys:
        # GT and vanilla ICP within test_torch_node's bar; the RANSAC and
        # TEASER rows' f32 solves and refines within 1e-2 m and 5e-2 deg.
        atol = (1e-3, 1e-2) if m == "icp" else (1e-2, 5e-2)
        ok = np.asarray(ref.trans_errors[m]) < 2.0
        np.testing.assert_allclose(np.asarray(got.trans_errors[m])[ok], np.asarray(ref.trans_errors[m])[ok],
                                   atol=atol[0], err_msg=m)
        np.testing.assert_allclose(np.asarray(got.rot_errors[m])[ok], np.asarray(ref.rot_errors[m])[ok],
                                   atol=atol[1], err_msg=m)
    if mode != "kitti":
        assert recall["vfm_ransac_icp"][0] == 1.0, recall
    pickles = []
    for node in (got, ref):
        path = tmp_path / f"{len(pickles)}.pkl"
        node.dump_errors(path)
        with open(path, "rb") as f:
            pickles.append(pickle.load(f))
    assert set(pickles[0]) == set(pickles[1]) == {"rot", "trans", "points_in_map"}
    assert list(pickles[0]["rot"]) == list(pickles[1]["rot"])
    assert pickles[0]["points_in_map"] == pickles[1]["points_in_map"]


def test_cluster_removal_sweep_cli(folders, local_map, tmp_path, monkeypatch, capsys):
    """The port's sweep on the scene with no method columns and its ICP a
    stand-in (the modes' registration is test_run_scene_modes_match_reference's),
    and the reference's CLI with a recording stand-in for its node: the same
    file names, probabilities in the same order, one generator for all."""
    # Each mode's map sizes: the reference's removal on the same map with the
    # same draws (one generator of seed 42 for the scene's two scans).
    want = {}
    for prob in [p for _, p in trn.SWEEP_MODES if p > 0]:
        ref = _jax_node(folders, cluster_removal_prob=prob, feature_generator=_jax_generator(), **METHODS)
        rng = np.random.RandomState(42)
        for _ in range(2):
            ref._apply_cluster_removal(local_map, rng)
        want[prob] = ref.points_in_map

    data = tmp_path / "sweep"
    data.mkdir()
    (data / "scene_000.h5").symlink_to(folders / "scenes" / "scene_000.h5")
    made = []
    cls = tif.ImageFeatureGenerator

    def port_generator(name, device=None):
        assert name == "dinov2" and device == "cpu"
        made.append(_port_generator(cls))
        return made[-1]

    monkeypatch.setattr(tif, "ImageFeatureGenerator", port_generator)
    for name in ("DEFAULT_RANSAC", "DEFAULT_TEASER", "DEFAULT_POINTDSC"):
        monkeypatch.setattr(trn, name, [])
    monkeypatch.setattr(trn.RegistrationNode, "icp_registration", lambda self, *a, **kw: np.eye(4))
    seen = []
    init = trn.RegistrationNode.__init__

    def recording_init(self, folder, interactive, prob, scan_to_scan, feature_generator=None, **kw):
        seen.append((prob, scan_to_scan, feature_generator))
        init(self, folder, interactive, prob, scan_to_scan, feature_generator=feature_generator, **kw)

    monkeypatch.setattr(trn.RegistrationNode, "__init__", recording_init)
    trn.main([str(data), "--device", "cpu", "--cluster-removal-sweep"])
    assert "Average time per step" in capsys.readouterr().out
    (run_dir,) = data.glob("errors_*")
    got_names = sorted(p.name for p in run_dir.iterdir())

    ref_seen = []

    class RecordingNode:
        def __init__(self, folder, interactive, prob, scan_to_scan, feature_generator=None, **kw):
            ref_seen.append((prob, scan_to_scan, feature_generator))
            self.stop_publishing, self.filenames, self.scene_idx = False, [], 0

        def make_step(self):
            self.stop_publishing = True

        def dump_errors(self, path):
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(b"")

    ref_data = tmp_path / "reference"
    ref_data.mkdir()
    monkeypatch.setattr(jrn, "RegistrationNode", RecordingNode)
    monkeypatch.setattr(jif, "ImageFeatureGenerator", lambda name: ("generator", name))
    monkeypatch.setattr("sys.argv", ["registration_node", str(ref_data), "--cluster-removal-sweep"])
    jrn.main()
    (ref_dir,) = ref_data.glob("errors_*")
    assert got_names == sorted(p.name for p in ref_dir.iterdir())
    assert len(got_names) == 11 and "mode_000.pkl" in got_names and "mode_100.pkl" in got_names
    assert [s[:2] for s in seen] == [s[:2] for s in ref_seen]
    assert len(made) == 1 and all(s[2] is made[0] for s in seen)
    assert len({id(s[2]) for s in ref_seen}) == 1

    for prob, _, _ in seen:
        with open(run_dir / f"mode_{int(round(prob * 100)):03d}.pkl", "rb") as f:
            assert pickle.load(f)["points_in_map"] == want.get(prob, []), prob
