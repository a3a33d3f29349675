"""Parity of the port's KISS layer (`vfmreg_tpu_torch/kiss/`) with `vfmreg_tpu.kiss`.

* `voxel_down_sample`: the same rows in the same order, bit for bit, on
  clouds with and without descriptor columns, at the driver's voxel sizes;
* `VoxelHashMap`: `point_cloud` bit for bit (the same capped store in the
  grid's hash order), `point_cloud_n` likewise, and
  `get_vfm_correspondences` with the same accepted queries and the same
  matched map points (queries whose best map row is decisive);
* `register_frame` on the 3-D path, the `two_phase` replay (with a phase-1
  budget of 8 iterations in both packages, so the lanes that do not settle
  resume) and the VFM path: poses within 1e-3 m and 1e-2 deg (chord) of the
  reference's, as `tests/test_torch_driver.py` holds them (the packages
  differ in the order of f32 sums), and the `src_` / `tgt_` return with
  the same number of correspondences;
* an empty map returns the guess; the XD path (`force_xd`, or a descriptor
  dim other than `vfm_descriptor_size`) gives the reference's pose within
  the same 1e-3 m and 1e-2 deg; `update` with descriptors keeps the
  reference's rows bit for bit (`tests/test_torch_{odometry,xd}.py` hold
  the rest of the odometry).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scipy.spatial.transform import Rotation  # noqa: E402

from vfmreg_tpu.kiss import mapping as jmapping  # noqa: E402
from vfmreg_tpu.kiss import registration as jreg  # noqa: E402
from vfmreg_tpu.kiss.voxelization import voxel_down_sample as jvoxel  # noqa: E402
from vfmreg_tpu.registration import icp as jicp  # noqa: E402
from vfmreg_tpu_torch.config import load_config  # noqa: E402
from vfmreg_tpu_torch.kiss import mapping as tmapping  # noqa: E402
from vfmreg_tpu_torch.kiss import registration as treg  # noqa: E402
from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample as tvoxel  # noqa: E402
from vfmreg_tpu_torch.registration import icp as ticp  # noqa: E402

D = 24


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


def _close(got, ref, m=1e-3, deg=1e-2):
    assert np.linalg.norm(got[:3, 3] - ref[:3, 3]) < m and _rotation_gap_deg(got, ref) < deg, (got, ref)


def _pose(t, deg):
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("xyz", deg, degrees=True).as_matrix()
    T[:3, 3] = t
    return T


@pytest.fixture(scope="module")
def world():
    """A 40 m ground-dominated world with smooth descriptors (200 points in
    one 1 m voxel), its two maps (one per package, descriptors in both) and
    a scan of it in its own frame."""
    rng = np.random.RandomState(0)
    n = 20000
    xy = rng.uniform(-40, 40, (n, 2))
    z = np.where(rng.rand(n) < 0.7, rng.uniform(0, 0.3, n), rng.uniform(0, 8, n))
    pts = np.c_[xy, z].astype(np.float32)
    pts[:200] = rng.uniform(10.05, 10.95, (200, 3))  # one crowded voxel: the per-voxel cap
    feats = np.sin(pts @ rng.normal(size=(3, D)).astype(np.float32) * 0.1).astype(np.float32)
    cloud = np.c_[pts, feats]
    cfg = load_config(None, deskew=False, max_range=None)
    jm = jmapping.VoxelHashMap(cfg.mapping.voxel_size, cfg.data.max_range, use_native=False)
    tm = tmapping.get_voxel_hash_map(cfg, device="cpu")
    jm.add_points(cloud)
    tm.add_points(cloud)
    true = _pose([3.0, -2.0, 0.1], [0.5, -0.3, 4.0])
    sel = rng.choice(n, 4000, replace=False)
    inv = np.linalg.inv(true)
    scan_xyz = (pts[sel] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    scan_xyz += rng.normal(0, 0.01, scan_xyz.shape).astype(np.float32)
    scan = np.c_[scan_xyz, feats[sel]]
    return cloud, jm, tm, scan, true


@pytest.mark.parametrize("cols", [3, 3 + D])
def test_voxel_down_sample_matches_jax(cols):
    rng = np.random.RandomState(cols)
    pts = np.c_[rng.uniform(-30, 30, (5000, 3)), rng.normal(size=(5000, cols - 3))].astype(np.float32)
    pts[:50, :3] = np.round(pts[:50, :3] * 4) / 4  # points on voxel boundaries
    for size in (0.1, 0.25, 0.5, 1.0, 5.0):
        got, ref = tvoxel(pts, size), jvoxel(pts, size)
        assert got.shape == ref.shape and got.shape[1] == cols
        np.testing.assert_array_equal(got, ref)
    assert tvoxel(pts[:0], 1.0).shape == (0, cols)


def test_voxel_hash_map_matches_jax(world):
    cloud, jm, tm, scan, _ = world
    np.testing.assert_array_equal(tm.point_cloud(), jm.point_cloud())
    np.testing.assert_array_equal(tm.point_cloud_n(), jm.point_cloud_n())
    assert tm.point_cloud().shape[0] < cloud.shape[0]  # the per-voxel cap ran
    q = tvoxel(scan, 5.0)
    js, jt = jm.get_vfm_correspondences(q, 0.8)
    ts, tt = tm.get_vfm_correspondences(q, 0.8)
    assert 50 < ts.shape[0] == js.shape[0]
    np.testing.assert_array_equal(ts, js)
    # Every matched map point is a map point; most are the reference's.
    assert (np.abs(tt - jt).max(axis=1) == 0).mean() > 0.95


@pytest.mark.parametrize("path", ["3d", "two_phase", "vfm"])
def test_register_frame_matches_jax(world, path, monkeypatch):
    _, jm, tm, scan, true = world
    sigma = 2.0
    if path == "vfm":
        guess = _pose([2.6, -2.3, 0.0], [0.0, 0.0, 2.5])
        kw = dict(max_correspondance_distance=3 * sigma, kernel=sigma / 3,
                  src_=np.zeros((1, 3)), tgt_=np.zeros((1, 3)))
        pts = scan
    else:
        pts = tvoxel(tvoxel(scan[:, :3], 0.5), 1.0)
        guess = _pose([2.7, -2.2, 0.0], [0.0, 0.0, 3.5]) if path == "3d" else np.eye(4)
        dist = 3 if path == "3d" else 7
        kw = dict(max_correspondance_distance=dist * sigma, kernel=sigma / dist, two_phase=path == "two_phase")
    if path == "two_phase":
        monkeypatch.setattr(jicp, "FAR_FIELD_PHASE1_ITERATIONS", 8)
        monkeypatch.setattr(treg, "FAR_FIELD_PHASE1_ITERATIONS", 8)
    ref = jreg.register_frame(pts, jm, guess, **kw)
    with ticp.recording_loops() as calls:
        got = treg.register_frame(pts, tm, guess, **kw)
    # The far-field lane does not settle in 8 iterations: phase 1, then the resume.
    assert len(calls) == (2 if path == "two_phase" else 1)
    if path == "vfm":
        (ref, rs, rt), (got, gs, gt) = ref, got
        assert gs.shape == rs.shape and gt.shape == rt.shape and gs.shape[0] > 20
        assert np.linalg.norm(got[:3, 3] - true[:3, 3]) < 0.1
    _close(got, ref)
    assert got.dtype == np.float64


def test_register_frame_empty_map_and_xd(world):
    cloud, jm, tm, scan, true = world
    cfg = load_config(None)
    empty = tmapping.get_voxel_hash_map(cfg, device="cpu")
    guess = _pose([1.0, 2.0, 0.0], [0.0, 0.0, 10.0])
    assert np.array_equal(treg.register_frame(scan[:, :3], empty, guess, 6.0, 2 / 3), guess)
    pose, s, t = treg.register_frame(scan, empty, guess, 6.0, 2 / 3, src_=scan[:1, :3], tgt_=scan[:1, :3])
    assert np.array_equal(pose, guess) and s.shape == (1, 3)
    guess = _pose([2.7, -2.2, 0.0], [0.0, 0.0, 3.5])
    for kw in ({"force_xd": True}, {"vfm_descriptor_size": 384}):
        got = treg.register_frame(scan, tm, guess, 6.0, 2 / 3, **kw)
        _close(got, jreg.register_frame(scan, jm, guess, 6.0, 2 / 3, **kw))
        assert np.linalg.norm(got[:3, 3] - true[:3, 3]) < 0.1
    fresh_t = tmapping.VoxelHashMap(1.0, 100.0, device="cpu")
    fresh_j = jmapping.VoxelHashMap(1.0, 100.0, use_native=False)
    for m in (fresh_t, fresh_j):
        m.add_points(cloud)
        m.update(scan, true)
    np.testing.assert_array_equal(fresh_t.point_cloud_n(), fresh_j.point_cloud_n())
