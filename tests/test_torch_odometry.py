"""Parity of the port's KISS odometry (`vfmreg_tpu_torch/kiss/`) with `vfmreg_tpu.kiss`.

The same numpy inputs from a seed go through both packages on the CPU.
Tolerances, each with its reason:

* grids and maps are exact: `build_hash_grid` with eviction and
  `extend_hash_grid` give the reference's table, points, descriptors and
  validity bit for bit; every `VoxelHashMap` store (host, device-resident,
  with a merge interval) exports the reference's rows in the reference's
  order, bit for bit, and `get_correspondences` accepts the same queries
  with the same map points. Both packages transform each frame on the host
  in float64 before it enters the map, and sort stably by the same hash;
* threshold and preprocessing are numpy copies: exact; deskew 1e-4 m at
  points within 50 m (the reference takes the twists in f32, the port in
  float64, and both are within that of a float64 oracle);
* `seq_error` and the ATE take the same float64 numpy steps: rtol 1e-12;
* `KissICP` over the reference's 8-frame corridor
  (`examples/odometry_corridor.py`): every pose within 2e-3 m and 2e-2 deg
  of the reference's. The packages sum the GN moments in another f32 order,
  so a frame may stop one GN step earlier or later (|dx| < 1e-4 per step),
  and the next frame starts from that pose; the corridor's x is the weakly
  held direction. The map is then held exact: the reference's poses
  replayed into the port's map (host and resident) give the reference's
  map rows bit for bit;
* `OdometryPipeline` writes the reference's files, with the poses it ran,
  and the CLI runs a GenericDataset folder of .bin scans; the readers give
  the reference's frames (KITTI's scan correction within 1e-5 m: both in
  f32, summed in another order).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vfmreg_tpu import config as jconfig  # noqa: E402
from vfmreg_tpu.geometry import metrics as jmetrics  # noqa: E402
from vfmreg_tpu.kiss import datasets as jdatasets  # noqa: E402
from vfmreg_tpu.kiss import deskew as jdeskew  # noqa: E402
from vfmreg_tpu.kiss import mapping as jmapping  # noqa: E402
from vfmreg_tpu.kiss import preprocess as jpre  # noqa: E402
from vfmreg_tpu.kiss import threshold as jthr  # noqa: E402
from vfmreg_tpu.kiss.kiss_icp import KissICP as JKissICP  # noqa: E402
from vfmreg_tpu.ops import hash_grid as jhg  # noqa: E402
from vfmreg_tpu_torch import config as tconfig  # noqa: E402
from vfmreg_tpu_torch.geometry import metrics as tmetrics  # noqa: E402
from vfmreg_tpu_torch.kiss import cli as tcli  # noqa: E402
from vfmreg_tpu_torch.kiss import datasets as tdatasets  # noqa: E402
from vfmreg_tpu_torch.kiss import deskew as tdeskew  # noqa: E402
from vfmreg_tpu_torch.kiss import mapping as tmapping  # noqa: E402
from vfmreg_tpu_torch.kiss import preprocess as tpre  # noqa: E402
from vfmreg_tpu_torch.kiss import threshold as tthr  # noqa: E402
from vfmreg_tpu_torch.kiss.kiss_icp import KissICP as TKissICP  # noqa: E402
from vfmreg_tpu_torch.kiss.pipeline import OdometryPipeline  # noqa: E402
from vfmreg_tpu_torch.ops import hash_grid as thg  # noqa: E402

import jax.numpy as jnp  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "examples"))
from odometry_corridor import CorridorDataset  # noqa: E402

POSE_M, POSE_DEG = 2e-3, 2e-2


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


def _pose(t, yaw_deg):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("z", yaw_deg, degrees=True).as_matrix()
    T[:3, 3] = t
    return T


def _cloud(rng, n, d, extent=40.0):
    """Ground and walls around the origin, a crowded voxel (the per-voxel
    cap), and d descriptor columns (every 7th row zero) when d > 0."""
    pts = np.c_[rng.uniform(-extent, extent, (n, 2)), rng.uniform(0, 4, (n, 1))].astype(np.float32)
    pts[:60] = rng.uniform(3.05, 3.95, (60, 3))
    if not d:
        return pts
    feats = rng.normal(size=(n, d)).astype(np.float32)
    feats[::7] = 0.0
    return np.c_[pts, feats]


# ----------------------------------------------------------------- the grid
@pytest.mark.parametrize("d", [0, 8])
def test_evicting_build_and_extend_match_jax(d):
    rng = np.random.RandomState(d)
    cloud = _cloud(rng, 3000, d)
    mask = np.ones(3000, bool)
    mask[-40:] = False
    origin = np.array([3.0, 2.0, 0.0], np.float32)
    feats = cloud[:, 3:] if d else None

    def both(fn_j, fn_t, *arrays, **kw):
        j = fn_j(*[None if a is None else jnp.asarray(a) for a in arrays[:-1]], arrays[-1], **kw)
        t = fn_t(*[None if a is None else torch.from_numpy(a) for a in arrays[:-1]], arrays[-1], **kw)
        return j, t

    def build_j(p, m, f, o, vs):
        return jhg.build_hash_grid(p, vs, mask=m, feats=f, evict_origin=o, max_distance=25.0)

    def build_t(p, m, f, o, vs):
        return thg.build_hash_grid(p, vs, mask=m, feats=f, evict_origin=o, max_distance=25.0)

    jg, tg = both(build_j, build_t, cloud[:, :3], mask, feats, origin, 1.0)
    keys = ["table", "points", "valid"] + (["feats"] if d else [])
    for k in keys:
        np.testing.assert_array_equal(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)), err_msg=k)
    np.testing.assert_array_equal(tg.bucket_slab[:-1].numpy(), np.asarray(jg.bucket_slab)[:-1])
    n_valid = int(tg.valid.sum())
    assert 0 < n_valid < mask.sum() - 60  # the cap and the eviction both ran

    new = _cloud(rng, 900, d)
    nm = np.ones(900, bool)
    nm[-25:] = False
    o2 = np.array([9.0, 2.0, 0.0], np.float32)
    nf = new[:, 3:] if d else None
    je = jhg.extend_hash_grid(jg.points, jg.valid, jg.feats, jnp.asarray(new[:, :3]), jnp.asarray(nm),
                              None if nf is None else jnp.asarray(nf), 1.0, jnp.asarray(o2), 25.0, cap=4096)
    te = thg.extend_hash_grid(tg.points, tg.valid, tg.feats, torch.from_numpy(new[:, :3]), torch.from_numpy(nm),
                              None if nf is None else torch.from_numpy(nf), 1.0, torch.from_numpy(o2), 25.0,
                              cap=4096)
    for k in keys:
        np.testing.assert_array_equal(getattr(te, k).numpy(), np.asarray(getattr(je, k)), err_msg=k)
    jp, jf, jv = jhg.export_pointcloud(je)
    tp, tv = te.points, te.valid
    np.testing.assert_array_equal(tp.numpy()[tv.numpy()], np.asarray(jp)[np.asarray(jv)])

    # nearest_neighbors: the same neighbours and found flags (distances to
    # one ulp: PyTorch's CPU sqrt, `tests/test_torch_voxel_grid.py`).
    q = _cloud(rng, 512, 0, extent=20.0)
    qm = np.arange(512) < 500
    a = jhg.nearest_neighbors(je, jnp.asarray(q), jnp.asarray(qm))
    b = thg.nearest_neighbors(te, torch.from_numpy(q), torch.from_numpy(qm))
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
    np.testing.assert_array_equal(b[2].numpy(), np.asarray(a[2]))
    f = np.asarray(a[2])
    np.testing.assert_allclose(b[1].numpy()[f], np.asarray(a[1])[f], rtol=2**-23, atol=0)


# ------------------------------------------------------------------ the map
def _jmap(resident, merge_interval=1):
    return jmapping.VoxelHashMap(1.0, 30.0, 20, use_native=False, device_resident=resident,
                                 merge_interval=merge_interval)


def _tmap(resident, merge_interval=1):
    return tmapping.VoxelHashMap(1.0, 30.0, 20, merge_interval=merge_interval, device="cpu",
                                 device_resident=resident)


def _frames(d, n=5, seed=3):
    """A drive of `n` frames 4 m apart with up to 3 deg of yaw each, each
    frame a cloud in its own sensor frame."""
    rng = np.random.RandomState(seed)
    poses = [_pose([4.0 * i, 0.3 * i, 0.0], 3.0 * np.sin(i)) for i in range(n)]
    return [_cloud(rng, 2500, d) for _ in range(n)], poses


@pytest.mark.parametrize("d", [0, 6])
@pytest.mark.parametrize("store", ["host", "resident", "merge3"])
def test_voxel_hash_map_update_matches_jax(store, d):
    """`update` frame by frame (the reference's host map as the oracle,
    and its resident map where it has the same store), then
    `remove_far_away_points`; every export and correspondence query equal."""
    frames, poses = _frames(d)
    resident = store != "host"
    k = 3 if store == "merge3" else 1
    jm, tm = _jmap(resident, k), _tmap(resident, k)
    jhost = _jmap(False)
    for i, (fr, pose) in enumerate(zip(frames, poses)):
        jm.update(fr, pose)
        tm.update(fr, pose)
        jhost.update(fr, pose)
        # Between merges the grid the loop searches is the last merged one.
        tg, jg = tm.device_grid(), jm.device_grid()
        np.testing.assert_array_equal(tg.points[tg.valid].numpy(), np.asarray(jg.points)[np.asarray(jg.valid)])
        assert tm.empty() is False
    got = tm.point_cloud()
    np.testing.assert_array_equal(got, jm.point_cloud())
    if k == 1:  # merged frames evict from the last origin only
        np.testing.assert_array_equal(got, jhost.point_cloud())
    if d:
        np.testing.assert_array_equal(tm.point_cloud_n(), jm.point_cloud_n())
    # Eviction happened: the first frame's far side is gone.
    assert got.shape[0] < sum(f.shape[0] for f in frames)

    # remove_far_away_points against the reference's host map holding the
    # same rows (the reference's resident map drops its grid here).
    origin = np.array([12.0, 25.0, 0.0])
    oracle = _jmap(False)
    oracle.add_points(tm.point_cloud_n() if d else got)
    oracle.remove_far_away_points(origin)
    tm.remove_far_away_points(origin)
    np.testing.assert_array_equal(tm.point_cloud(), oracle.point_cloud())
    assert tm.point_cloud().shape[0] < got.shape[0]

    rng = np.random.RandomState(7)
    q = _cloud(rng, 700, d, extent=30.0)
    for xd in (False, True):
        js, jt = oracle.get_correspondences(q, 1.0, xd=xd)
        ts, tt = tm.get_correspondences(q, 1.0, xd=xd)
        assert ts.shape[0] > 50
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tt, jt)


def test_resident_map_first_merge_and_clear():
    """The resident store's first frame is a plain build without eviction
    for `add_points`; `clear` empties both stores."""
    frames, poses = _frames(0, n=2)
    for resident in (False, True):
        tm, jm = _tmap(resident), _jmap(False)
        tm.add_points(frames[0])
        jm.add_points(frames[0])
        np.testing.assert_array_equal(tm.point_cloud(), jm.point_cloud())
        tm.update(frames[1], poses[1])
        jm.update(frames[1], poses[1])
        np.testing.assert_array_equal(tm.point_cloud(), jm.point_cloud())
        tm.clear()
        assert tm.empty() and tm.point_cloud().shape == (0, 3)


# -------------------------------------------------- threshold, crop, deskew
def test_threshold_preprocess_deskew_match_jax():
    rng = np.random.RandomState(11)
    jc, tc = jconfig.load_config(None), tconfig.load_config(None)
    ja, ta = jthr.get_threshold_estimator(jc), tthr.get_threshold_estimator(tc)
    assert isinstance(ta, tthr.AdaptiveThreshold)
    for i in range(6):
        dev = _pose(rng.normal(0, 0.3, 3), rng.normal(0, 2.0))
        assert ta.get_threshold() == ja.get_threshold()
        ja.update_model_deviation(dev)
        ta.update_model_deviation(dev)
    tc.adaptive_threshold.fixed_threshold = 0.3
    fixed = tthr.get_threshold_estimator(tc)
    fixed.update_model_deviation(np.eye(4))
    assert fixed.get_threshold() == 0.3

    frame = np.c_[rng.uniform(-120, 120, (4000, 3)), rng.normal(size=(4000, 4))]
    np.testing.assert_array_equal(tpre.get_preprocessor(tc)(frame), jpre.get_preprocessor(jc)(frame))
    tc.data.preprocess = False
    assert tpre.get_preprocessor(tc)(frame) is frame

    pts = np.c_[rng.uniform(-50, 50, (3000, 2)), rng.uniform(0, 5, (3000, 1)), rng.normal(size=(3000, 2))]
    ts = rng.uniform(0, 1, 3000)
    poses = [np.eye(4), _pose([0.5, 0.0, 0.0], 0.5), _pose([1.6, 0.1, 0.02], 2.0)]
    got = tdeskew.MotionCompensator().deskew_scan(pts, poses, ts)
    ref = jdeskew.MotionCompensator().deskew_scan(pts, poses, ts)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[:, 3:], pts[:, 3:])
    assert not np.allclose(got[:, :3], pts[:, :3])
    assert tdeskew.MotionCompensator().deskew_scan(pts, poses[:2], ts) is pts
    tc.data.deskew = False
    assert isinstance(tdeskew.get_motion_compensator(tc), tdeskew.StubCompensator)


# ------------------------------------------------------- metrics and config
def test_trajectory_metrics_and_config_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    gt, est = [], []
    for i in range(160):  # 1.5 m a frame: segments of 100 and 200 m
        g = _pose([1.5 * i, 0.2 * np.sin(i / 9.0), 0.0], 0.3 * i)
        gt.append(g)
        est.append(g @ _pose(rng.normal(0, 0.02, 3), rng.normal(0, 0.05)))
    np.testing.assert_allclose(tmetrics.seq_error(gt, est), jmetrics.seq_error(gt, est), rtol=1e-12)
    np.testing.assert_allclose(tmetrics.absolute_trajectory_error(gt, est),
                               jmetrics.absolute_trajectory_error(gt, est), rtol=1e-12)
    assert np.isnan(tmetrics.seq_error(gt[:20], est[:20])).all()

    for name in ("basic.yaml", "advanced.yaml"):
        path = REPO / "configs" / name
        got, ref = tconfig.load_config(path), jconfig.load_config(path)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref), name
        out = tmp_path / f"{name}.yml"
        tconfig.write_config(got, str(out))
        assert dataclasses.asdict(tconfig.load_config(out)) == dataclasses.asdict(got)
    over = tconfig.load_config(REPO / "configs" / "basic.yaml", deskew=True, max_range=3.0)
    assert over.data.deskew and over.data.min_range == 0.0 and over.mapping.voxel_size == 0.03


# ------------------------------------------------------------------ readers
def test_dataset_readers_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    gen = tmp_path / "generic"
    gen.mkdir()
    clouds = [rng.uniform(-9, 9, (50 + i, 3)) for i in range(4)]
    np.c_[clouds[0], np.zeros(50)].astype(np.float32).tofile(gen / "scan_10.bin")
    np.save(gen / "scan_2.npy", clouds[1])
    np.savetxt(gen / "scan_1.txt", clouds[2])
    with open(gen / "scan_3.ply", "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {clouds[3].shape[0]}\nproperty float y\n"
                "property float x\nproperty float z\nend_header\n")
        np.savetxt(f, clouds[3][:, [1, 0, 2]])
    got, ref = tdatasets.dataset_factory("generic", gen), jdatasets.dataset_factory("generic", gen)
    assert [p.name for p in got.scan_files] == ["scan_1.txt", "scan_2.npy", "scan_3.ply", "scan_10.bin"]
    assert len(got) == len(ref) == 4 and got.sequence_id == "generic"
    for i in range(4):
        np.testing.assert_array_equal(got[i], ref[i])

    # KITTI odometry: two scans, calibration, times and camera-frame poses.
    seq = tmp_path / "kitti" / "sequences" / "03"
    (seq / "velodyne").mkdir(parents=True)
    (tmp_path / "kitti" / "poses").mkdir()
    for i in range(2):
        np.c_[rng.uniform(-60, 60, (300, 3)), np.zeros(300)].astype(np.float32).tofile(
            seq / "velodyne" / f"{i:06d}.bin")
    tr = "Tr: " + " ".join(str(v) for v in _pose([0.3, -0.1, 0.2], 4.0)[:3].reshape(-1))
    seq.joinpath("calib.txt").write_text("P0: 0\nP1: 0\nP2: " + " ".join(["1.0"] * 12) + "\nP3: 0\n" + tr + "\n")
    seq.joinpath("times.txt").write_text("0.0\n0.1\n")
    (tmp_path / "kitti" / "poses" / "03.txt").write_text(
        "\n".join(" ".join(str(v) for v in _pose([i, 0, 0], i)[:3].reshape(-1)) for i in range(2)) + "\n")
    got = tdatasets.dataset_factory("kitti", tmp_path / "kitti", 3)
    from vfmreg_tpu.data.kitti_odometry import KittiOdometry

    ref = KittiOdometry(3, tmp_path / "kitti")
    assert got.sequence_id == "03" and len(got) == 2
    np.testing.assert_allclose(got.gt_poses, np.stack(ref.gt_poses), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.get_frames_timestamps(), ref.timestamps)
    for i in range(2):
        np.testing.assert_allclose(got[i], ref.read_pcl(i), rtol=0, atol=1e-5)

    # NCLT: int16 scans named by timestamp and a ground-truth CSV.
    vel = tmp_path / "nclt" / "velodyne_data" / "2012-01-08" / "velodyne_sync"
    vel.mkdir(parents=True)
    (tmp_path / "nclt" / "ground_truth").mkdir()
    for t in (50, 150, 250, 400):
        rng.randint(15000, 25000, (80, 4)).astype(np.int16).tofile(vel / f"{t}.bin")
    csv = np.c_[np.arange(100, 360, 20), rng.normal(size=(13, 6))]
    np.savetxt(tmp_path / "nclt" / "ground_truth" / "groundtruth_2012-01-08.csv", csv, delimiter=",")
    got = tdatasets.dataset_factory("nclt", tmp_path / "nclt", "2012-01-08")
    ref = jdatasets.dataset_factory("nclt", tmp_path / "nclt", "2012-01-08")
    assert len(got) == len(ref) == 2
    np.testing.assert_array_equal(got.gt_poses, ref.gt_poses)
    for i in range(2):
        np.testing.assert_array_equal(got[i], ref[i])

    # The readers ported after these three: a MulRan scan and a TUM depth
    # frame read as the reference reads them; the container readers raise
    # the reference's ImportError without their packages.
    (tmp_path / "mulran" / "Ouster").mkdir(parents=True)
    np.c_[clouds[0], np.ones(50)].astype(np.float32).tofile(tmp_path / "mulran" / "Ouster" / "1566534558000000.bin")
    got, ref = (m.dataset_factory("mulran", tmp_path / "mulran") for m in (tdatasets, jdatasets))
    assert len(got) == len(ref) == 1 and got.gt_poses is None and ref.gt_poses is None
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    image = pytest.importorskip("PIL.Image")
    (tmp_path / "tum" / "depth").mkdir(parents=True)
    image.fromarray(rng.randint(0, 30000, (6, 8)).astype(np.uint16)).save(tmp_path / "tum" / "depth" / "0.png")
    (tmp_path / "tum" / "depth.txt").write_text("1.00 depth/0.png\n")
    (tmp_path / "tum" / "groundtruth.txt").write_text("1.01 1 2 3 0 0 0 1\n")
    got, ref = (m.dataset_factory("tum", tmp_path / "tum") for m in (tdatasets, jdatasets))
    np.testing.assert_array_equal(got.gt_poses, ref.gt_poses)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[0].shape[0] > 0
    for name in ("ouster", "rosbag"):
        errors = []
        for factory in (tdatasets.dataset_factory, jdatasets.dataset_factory):
            with pytest.raises(ImportError) as e:
                factory(name, gen / "scan_10.bin")
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="Unknown dataloader"):
        tdatasets.dataset_factory("nope", tmp_path)


# --------------------------------------------------------- KissICP, pipeline
@pytest.fixture(scope="module")
def corridor_runs():
    """The reference's and the port's KissICP over the 8-frame corridor
    (xyz), both with their default configs; the port's map host-side."""
    ds = CorridorDataset(n_frames=8)
    jk = JKissICP(jconfig.load_config(None))
    jk.local_map._use_native = False
    tk = TKissICP(tconfig.load_config(None), device="cpu")
    assert not tk.local_map.device_resident
    for i in range(len(ds)):
        jk.register_frame(ds[i], np.zeros(ds[i].shape[0]))
        tk.register_frame(ds[i], np.zeros(ds[i].shape[0]))
    return ds, jk, tk


def test_kiss_icp_corridor_matches_jax(corridor_runs):
    ds, jk, tk = corridor_runs
    assert len(tk.poses) == len(jk.poses) == 8
    for got, ref in zip(tk.poses, jk.poses):
        assert got.dtype == np.float64
        assert np.linalg.norm(got[:3, 3] - ref[:3, 3]) < POSE_M and _rotation_gap_deg(got, ref) < POSE_DEG
    assert abs(tk.poses[-1][0, 3] - 7.0) < 0.5  # the example's own drift gate
    # The reference's poses replayed into the port's maps: its rows exactly.
    for resident in (False, True):
        tm = tmapping.VoxelHashMap(1.0, 100.0, 20, device="cpu", device_resident=resident)
        for i, pose in enumerate(jk.poses):
            down = jk.voxelize(jpre.get_preprocessor(jk.config)(ds[i]))[1]
            tm.update(down, pose)
        np.testing.assert_array_equal(tm.point_cloud(), jk.local_map.point_cloud())


def test_odometry_pipeline_files_and_cli(corridor_runs, tmp_path, monkeypatch):
    ds, jk, tk = corridor_runs
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"out_dir: {tmp_path}/results\n")
    pipe = OdometryPipeline(ds, config=cfg, n_scans=6, jump=1, device="cpu")
    results = pipe.run()
    latest = tmp_path / "results" / "latest"
    names = ("corridor_poses.npy", "corridor_poses_kitti.txt", "corridor_poses_tum.txt", "corridor_gt.npy",
             "corridor_gt_kitti.txt", "config.yml", "result_metrics.log")
    for name in names:
        assert (latest / name).exists(), name
    poses = np.load(latest / "corridor_poses.npy")
    assert poses.shape == (6, 4, 4)
    np.testing.assert_array_equal(poses, np.stack(pipe.poses))
    np.testing.assert_allclose(np.loadtxt(latest / "corridor_poses_kitti.txt"), poses[:, :3].reshape(6, 12),
                               rtol=1e-15)
    tum = np.loadtxt(latest / "corridor_poses_tum.txt")
    np.testing.assert_allclose(tum[:, 1:4], poses[:, :3, 3], atol=5e-5)
    np.testing.assert_array_equal(np.load(latest / "corridor_gt.npy"), np.stack(ds.gt_poses[1:7]))
    descs = [d for d, _, _ in results.items()]
    assert "Absolute Trajectory Error (ATE)" in descs and "Average Frequency" in descs
    ref = jmetrics.absolute_trajectory_error(ds.gt_poses[1:7], pipe.poses)
    assert dict((d, v) for d, _, v in results.items())["Absolute Trajectory Error (ATE)"] == ref[1]

    # The CLI on a GenericDataset folder of .bin scans (xyzi), on the CPU.
    data = tmp_path / "scans"
    data.mkdir()
    for i in range(3):
        np.c_[ds[i], np.zeros(ds[i].shape[0])].astype(np.float32).tofile(data / f"{i:06d}.bin")
    cfg.write_text(f"out_dir: {tmp_path}/cli\n")
    out = tcli.main([str(data), "--config", str(cfg), "--device", "cpu"])
    assert "Average Frequency" in str(out)
    kitti = np.loadtxt(tmp_path / "cli" / "latest" / "scans_poses_kitti.txt")
    assert kitti.shape == (3, 12)
    # The .bin scans are f32, the corridor's own frames f32 too: the first
    # three poses are the port's corridor run's.
    np.testing.assert_allclose(kitti, np.stack(tk.poses[:3])[:, :3].reshape(3, 12), atol=1e-6)
    # Without a card the entry points raise unless asked for the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OdometryPipeline(ds, config=cfg)
