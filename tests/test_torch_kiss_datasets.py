"""Parity of the port's odometry readers (`vfmreg_tpu_torch/kiss/datasets.py`,
`kiss/point_cloud2.py`) with `vfmreg_tpu.kiss`.

One counterpart for each test of `tests/test_kiss_datasets.py`: the same
synthetic files (that file's helpers build the poses), read by the port and
by the JAX package's reader. Tolerances, each with its reason:

* frames, per-point timestamps, frame timestamps, `gt_poses`, sequence ids
  and lengths are exact: both readers take the same numpy steps on the same
  bytes (poses in float64, Boreas's stored in float32 by both);
* KITTI raw's corrected scans within atol 1e-5 m and their yaw timestamps
  within atol 1e-5 (both correct in f32, the reference through XLA, which
  contracts multiply-adds on the CPU, as `tests/test_torch_loaders.py`
  holds KITTI odometry; the timestamps follow the points' yaw at ~1 m);
* the container readers (ouster, mcap, rosbag) raise the reference's
  ImportError, message included, when their package is missing; Ouster's
  column timestamps are read through the reference test's stub sdk.

The readers are numpy only; no torch work runs here.
"""

import json
import sys
import types
import unittest.mock as mock

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as _R

from test_kiss_datasets import _quat_from_matrix, _rot_z, _se3
from vfmreg_tpu.data import cloud_io as jio
from vfmreg_tpu.kiss import datasets as jds
from vfmreg_tpu.kiss import metrics as jmetrics
from vfmreg_tpu.kiss import point_cloud2 as jpc2
from vfmreg_tpu_torch.data import cloud_io as tio
from vfmreg_tpu_torch.kiss import datasets as tds
from vfmreg_tpu_torch.kiss import metrics as tmetrics
from vfmreg_tpu_torch.kiss import point_cloud2 as tpc2

_PCD_HEADER = "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\nWIDTH {n}\nHEIGHT 1\nPOINTS {n}\n"
_PLY_HEADER = (
    "ply\nformat binary_little_endian 1.0\nelement vertex 2\n"
    "property float x\nproperty float y\nproperty float z\n"
    "property double timestamp\nend_header\n"
)


def _equal(got, want):
    """Exactly equal, values and dtypes, through tuples, lists and dicts."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            _equal(got[key], want[key])
        return
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _both(name, path, *args, **kwargs):
    """The port's and the reference's reader of `name` on `path`, checked to
    agree on everything but the frames."""
    got = tds.dataset_factory(name, path, *args, **kwargs)
    ref = jds.dataset_factory(name, path, *args, **kwargs)
    assert type(got).__name__ == type(ref).__name__
    assert len(got) == len(ref) and got.sequence_id == ref.sequence_id
    if getattr(ref, "gt_poses", None) is not None:
        _equal(got.gt_poses, ref.gt_poses)
    if hasattr(ref, "get_frames_timestamps"):
        _equal(got.get_frames_timestamps(), ref.get_frames_timestamps())
    return got, ref


def _same_frames(got, ref):
    for i in range(len(ref)):
        _equal(got[i], ref[i])


# --------------------------------------------------------------------- io
def test_pcd_reader_ascii_and_binary(tmp_path):
    pts = np.array([[1.0, 2.0, 3.0], [-4.0, 0.5, 9.0]], np.float32)
    header = "# .PCD v0.7\n" + _PCD_HEADER.format(n=2).replace("POINTS", "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS")
    a, b = tmp_path / "a.pcd", tmp_path / "b.pcd"
    a.write_text(header + "DATA ascii\n" + "\n".join(" ".join(map(str, p)) for p in pts))
    b.write_bytes((header + "DATA binary\n").encode() + pts.tobytes())
    for path in (a, b):
        _equal(tio.read_pcd_xyz(path), jio.read_pcd_xyz(path))
        _equal(tio.read_pcd(path), jio.read_pcd(path))
        np.testing.assert_allclose(tio.read_pcd_xyz(path), pts, atol=1e-6)


def test_ply_reader_binary_with_timestamp(tmp_path):
    pts = np.array([[0.5, 1.5, -2.0], [3.0, 4.0, 5.0]], np.float32)
    ts = np.array([100.0, 200.0], np.float64)
    p = tmp_path / "f.ply"
    p.write_bytes(_PLY_HEADER.encode() + b"".join(pts[i].tobytes() + ts[i].tobytes() for i in range(2)))
    got = tio.read_ply(p)
    assert list(got) == ["x", "y", "z", "timestamp"]
    _equal(got, jio.read_ply(p))


def _cloud2_message(xyz, t, big_endian=False):
    n, point_step = xyz.shape[0], 16
    order = ">" if big_endian else "<"
    buf = np.zeros((n, point_step), np.uint8)
    buf[:, 0:12] = xyz.astype(order + "f4").view(np.uint8).reshape(n, 12)
    buf[:, 12:16] = t.astype(order + "f4")[:, None].view(np.uint8)

    def field(name, offset):
        return types.SimpleNamespace(name=name, offset=offset, datatype=7, count=1)

    return types.SimpleNamespace(
        fields=[field("x", 0), field("y", 4), field("z", 8), field("time", 12)],
        width=n, height=1, point_step=point_step, row_step=n * point_step,
        data=buf.tobytes(), is_bigendian=big_endian,
    )


@pytest.mark.parametrize("big_endian", [False, True])
def test_point_cloud2_decoder(big_endian):
    n = 5
    xyz = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    xyz[2, 1] = np.nan  # dropped from the points, not from the timestamps
    msg = _cloud2_message(xyz, np.linspace(10, 20, n).astype(np.float32), big_endian)
    got, want = tpc2.read_point_cloud(msg), jpc2.read_point_cloud(msg)
    _equal(got, want)
    assert got[0].shape == (n - 1, 3) and got[1].shape == (n,)
    _equal(tpc2.read_points(msg, ["x", "time"]), jpc2.read_points(msg, ["x", "time"]))


# ----------------------------------------------------------------- loaders
def test_apollo_loader(tmp_path):
    (tmp_path / "pcds").mkdir()
    (tmp_path / "poses").mkdir()
    pts = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
    header = _PCD_HEADER.format(n=2) + "DATA binary\n"
    for i in range(3):
        (tmp_path / "pcds" / f"{i}.pcd").write_bytes(header.encode() + pts.tobytes())
    rows = []
    for i in range(3):
        w, x, y, z = _quat_from_matrix(_rot_z(0.1 * i))
        rows.append([i, 0.0, 1.0 * i, 2.0 * i, 0.0, x, y, z, w])
    np.savetxt(tmp_path / "poses" / "gt_poses.txt", np.array(rows))
    got, ref = _both("apollo", tmp_path)
    assert len(got) == 3
    _same_frames(got, ref)


def test_apollo_loader_nontrivial_attitude(tmp_path):
    (tmp_path / "pcds").mkdir()
    (tmp_path / "poses").mkdir()
    header = _PCD_HEADER.format(n=1) + "DATA binary\n"
    rows = []
    for i, (e, t) in enumerate(zip([[0.3, -0.2, 0.1], [-0.8, 0.5, 1.2]], [[1.0, -2.0, 0.5], [3.0, 4.0, -1.0]])):
        (tmp_path / "pcds" / f"{i}.pcd").write_bytes(header.encode() + np.zeros((1, 3), np.float32).tobytes())
        rows.append([i, 0.0, *t, *_R.from_euler("ZYX", e).as_quat()])
    np.savetxt(tmp_path / "poses" / "gt_poses.txt", np.array(rows))
    got, ref = _both("apollo", tmp_path)
    _same_frames(got, ref)
    _equal(tds._quat_wxyz_to_matrix(0.3, -0.1, 0.7, 0.2), jds._quat_wxyz_to_matrix(0.3, -0.1, 0.7, 0.2))


def test_boreas_loader(tmp_path):
    (tmp_path / "lidar").mkdir()
    (tmp_path / "applanix").mkdir()
    scan = np.random.RandomState(0).randn(10, 6).astype(np.float32)
    rows = np.zeros((3, 13))
    for i, (r, p, ya) in enumerate([(0.1, -0.2, 0.3), (-0.5, 0.25, -1.2), (0.9, -0.6, 2.0)]):
        (tmp_path / "lidar" / f"{i}.bin").write_bytes(scan.tobytes())
        rows[i, 1:4] = [1.0 + i, 2.0 - i, 3.0 * i]
        rows[i, 7:10] = [r, p, ya]
    np.savetxt(tmp_path / "applanix" / "lidar_poses.csv", rows, delimiter=",",
               header="t,x,y,z,vx,vy,vz,r,p,ya,wz,wy,wx")
    got, ref = _both("boreas", tmp_path)
    assert got.gt_poses.dtype == np.float32
    _same_frames(got, ref)


def test_kitti_raw_loader(tmp_path):
    drive = tmp_path / "2011_09_30" / "2011_09_30_drive_0016_sync"
    (drive / "velodyne_points" / "data").mkdir(parents=True)
    (drive / "oxts" / "data").mkdir(parents=True)
    scan = np.random.RandomState(1).randn(50, 4).astype(np.float32)
    rpys = [(0.0, 0.0, 0.0), (0.1, -0.05, 0.4), (-0.3, 0.2, 1.1), (0.25, 0.15, -0.7)]
    for i in range(4):
        (drive / "velodyne_points" / "data" / f"{i:010d}.bin").write_bytes(scan.tobytes())
        vals = np.zeros(30)
        vals[:3] = [49.0 + 1e-5 * i, 8.43 + 1e-5 * i, 112.0]
        vals[3:6] = rpys[i]
        np.savetxt(drive / "oxts" / "data" / f"{i:010d}.txt", vals[None])
    with open(tmp_path / "2011_09_30" / "calib_imu_to_velo.txt", "w") as f:
        f.write("calib_time: x\nR: 1 0 0 0 1 0 0 0 1\nT: 0.1 0.2 0.3\n")
    got, ref = _both("kitti_raw", tmp_path, sequence=4)
    assert got.sequence_id == "04" and len(got) == 4
    _equal(got.T_velo_imu, ref.T_velo_imu)
    for i in range(4):
        (pts, ts), (ref_pts, ref_ts) = got[i], ref[i]
        assert pts.dtype == np.float64 and pts.shape == ref_pts.shape == (50, 3)
        np.testing.assert_allclose(pts, ref_pts, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ts, ref_ts, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pts, tds.correct_kitti_scan(scan[:, :3]), rtol=0, atol=0)


def test_ncd_loader(tmp_path):
    scans, gt = tmp_path / "raw_format" / "ouster_scan", tmp_path / "ground_truth"
    scans.mkdir(parents=True)
    gt.mkdir()
    pts = np.random.RandomState(2).randn(7, 3).astype(np.float32)
    for name in ("cloud_1583836591_182590976.pcd", "cloud_1583836592_182590976.pcd"):
        (scans / name).write_bytes((_PCD_HEADER.format(n=7) + "DATA binary\n").encode() + pts.tobytes())
    rows = np.zeros((2, 9))
    for i, (e, t) in enumerate(zip([[0.4, -0.1, 0.2], [-0.7, 0.3, 1.0]], [[0.5, -1.0, 2.0], [1.5, 0.0, -0.5]])):
        rows[i, 2:5] = t
        rows[i, 5:9] = _R.from_euler("ZYX", e).as_quat()
    np.savetxt(gt / "registered_poses.csv", rows, delimiter=",", header="sec,nsec,x,y,z,qx,qy,qz,qw")
    got, ref = _both("ncd", tmp_path)
    assert got.scan_files == ref.scan_files
    _same_frames(got, ref)
    _equal(got.get_timestamps(), ref.get_timestamps())


def test_ncd_filename_sort_is_numeric():
    names = ["cloud_101_18000000.pcd", "cloud_101_9000000.pcd", "cloud_100_500000000.pcd"]
    with mock.patch("os.listdir", return_value=list(names)):
        got = tds.NewerCollegeDataset.get_pcd_filenames("ignored")
        want = jds.NewerCollegeDataset.get_pcd_filenames("ignored")
    assert got == want == ["cloud_100_500000000.pcd", "cloud_101_9000000.pcd", "cloud_101_18000000.pcd"]


def _mulran_tree(root, scan):
    """MulRan's layout: Ouster/<ns>.bin (x y z i float32) and global_pose.csv
    (t, then the 3 x 4 pose row-major), one CSV row closest to no scan."""
    (root / "Ouster").mkdir()
    for name in ("1566534558000000.bin", "1566534559000000.bin"):
        (root / "Ouster" / name).write_bytes(scan.tobytes())
    P = [_se3(_R.from_euler("ZYX", e).as_matrix(), t)
         for e, t in zip([[0.2, -0.3, 0.15], [1.1, 0.4, -0.6]], [[10.0, -5.0, 1.0], [12.0, -4.0, 1.2]])]
    rows = [[t] + list(T[:3, :4].reshape(-1)) for t, T in [
        (1566534558000100.0, P[0]), (1566534558600000.0, _se3(np.eye(3), [99.0, 99.0, 99.0])),
        (1566534558999900.0, P[1])]]
    np.savetxt(root / "global_pose.csv", np.array(rows), delimiter=",")


@pytest.mark.parametrize("n_points", [100, 64 * 1024])
def test_mulran_loader(tmp_path, n_points):
    """The reference test's 100-point scan (all-ones timestamps) and a full
    64 x 1024 one (the column-index timestamps)."""
    _mulran_tree(tmp_path, np.random.RandomState(4).randn(n_points, 4).astype(np.float32))
    got, ref = _both("mulran", tmp_path)
    assert len(got) == 2 and got.scan_timestamps == ref.scan_timestamps
    _same_frames(got, ref)
    _equal(tds.MulranDataset.T_LIDAR_TO_BASE, jds.MulranDataset.T_LIDAR_TO_BASE)
    _equal(got.get_timestamps(), ref.get_timestamps())


def _ouster_stub(monkeypatch, h, w):
    """The reference test's stub ouster sdk: a 2-scan pcap of an (h, w) range
    image whose point (r, c) lies at (r, c, 0), two returns of range 0."""

    class FakeScan:
        def __init__(self):
            self.h, self.w = h, w
            self.timestamp = np.arange(w) * 1000 + 5_000_000_000

        def field(self, f):
            assert f == "RANGE"
            rng = np.ones((h, w), np.uint32)
            rng[0, 0] = rng[2, 5] = 0
            return rng

    class FakeScans:
        def __init__(self, source):
            pass

        def __iter__(self):
            return iter([FakeScan(), FakeScan()])

    class FakeLut:
        def __init__(self, info):
            pass

        def __call__(self, scan):
            xyz = np.zeros((h, w, 3))
            xyz[..., 0] = np.arange(h)[:, None]
            xyz[..., 1] = np.arange(w)[None, :]
            return xyz

    client = types.ModuleType("ouster.client")
    client.SensorInfo = lambda s: object()
    client.Scans = FakeScans
    client.XYZLut = FakeLut
    client.ChanField = types.SimpleNamespace(RANGE="RANGE")
    pcap = types.ModuleType("ouster.pcap")
    pcap.Pcap = lambda path, info: object()
    ouster = types.ModuleType("ouster")
    ouster.client, ouster.pcap = client, pcap
    for name, module in (("ouster", ouster), ("ouster.client", client), ("ouster.pcap", pcap)):
        monkeypatch.setitem(sys.modules, name, module)


def test_ouster_loader_column_timestamps(tmp_path, monkeypatch):
    _ouster_stub(monkeypatch, 4, 8)
    pcap_file = tmp_path / "rec.pcap"
    pcap_file.write_bytes(b"\x00")
    (tmp_path / "rec.json").write_text("{}")
    got = tds.dataset_factory("ouster", pcap_file)
    ref = jds.dataset_factory("ouster", pcap_file)
    assert len(got) == len(ref) == 2 and got.sequence_id == ref.sequence_id == "rec"
    for i in range(2):
        frame = got[i]
        _equal(frame, ref[i])
        _equal(got.get_frames_timestamps(), ref.get_frames_timestamps())
        xyz, ts = frame
        assert xyz.shape == (4 * 8 - 2, 3)
        np.testing.assert_array_equal(ts, xyz[:, 1] / 8)  # a point's y is its column
    for ds in (got, ref):
        with pytest.raises(AssertionError, match="sequential"):
            ds[1]
    np.testing.assert_allclose(got.get_frames_timestamps()[0], 5.0, atol=1e-6)


def test_nuscenes_loader(tmp_path):
    tdir = tmp_path / "v1.0-mini"
    tdir.mkdir()
    (tmp_path / "sweeps").mkdir()
    scan = np.random.RandomState(3).randn(20, 5).astype(np.float32)
    files = ["sweeps/lidar_top_0.pcd.bin", "sweeps/lidar_top_1.pcd.bin"]
    for fn in files:
        (tmp_path / fn).write_bytes(scan.tobytes())

    def wxyz(r):
        x, y, z, w = r.as_quat()
        return [w, x, y, z]

    def dump(name, rows):
        (tdir / f"{name}.json").write_text(json.dumps(rows))

    R_ego = [_R.from_euler("ZYX", [0.5, -0.2, 0.1]), _R.from_euler("ZYX", [0.9, 0.3, -0.4])]
    dump("scene", [{"token": "sc0", "name": "scene-0001", "first_sample_token": "sa0"}])
    dump("sample", [{"token": "sa0"}])
    dump("sample_data", [
        {"token": "sd0", "sample_token": "sa0", "filename": files[0], "prev": "", "next": "sd1",
         "ego_pose_token": "ep0", "calibrated_sensor_token": "cs0"},
        {"token": "sd1", "sample_token": "sa0", "filename": files[1], "prev": "sd0", "next": "",
         "ego_pose_token": "ep1", "calibrated_sensor_token": "cs0"},
    ])
    dump("ego_pose", [{"token": f"ep{i}", "rotation": wxyz(R_ego[i]), "translation": t}
                      for i, t in enumerate([[5.0, 6.0, 7.0], [5.5, 6.5, 7.5]])])
    dump("calibrated_sensor", [{"token": "cs0", "rotation": wxyz(_R.from_euler("ZYX", [0.05, 0.02, -0.01])),
                                "translation": [0.1, 0.0, 0.3]}])
    got, ref = _both("nuscenes", tmp_path, sequence=1)
    assert got.lidar_tokens == ref.lidar_tokens == ["sd0", "sd1"]
    _same_frames(got, ref)
    for ds in (tds, jds):
        with pytest.raises(ValueError, match="scene-0002"):
            ds.dataset_factory("nuscenes", tmp_path, sequence=2)


def test_paris_luco_loader(tmp_path):
    (tmp_path / "frames").mkdir()
    pts = np.array([[1, 0, 0], [0, 2, 0]], np.float32)
    ts = np.array([1.0, 4.0], np.float64)
    (tmp_path / "frames" / "frame_0.ply").write_bytes(
        _PLY_HEADER.encode() + b"".join(pts[i].tobytes() + ts[i].tobytes() for i in range(2)))
    np.savetxt(tmp_path / "gt_traj_lidar.txt", np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]))
    got, ref = _both("paris_luco", tmp_path)
    _same_frames(got, ref)
    _equal(got.apply_calibration(got.gt_poses), ref.apply_calibration(ref.gt_poses))


def test_tum_loader(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    (tmp_path / "depth").mkdir()
    for i in range(2):
        depth = np.zeros((8, 8), np.uint16)
        depth[2, 3] = 5000 + 100 * i
        depth[4, 4] = 10000
        depth[6, 1] = 25000  # 5 m: beyond the 4 m truncation
        Image.fromarray(depth, mode="I;16").save(tmp_path / "depth" / f"{i}.png")
    (tmp_path / "depth.txt").write_text("1.00 depth/0.png\n1.04 depth/1.png\n")
    rows = []
    for t, e in ((0.98, [0.6, -0.25, 0.35]), (1.05, [0.1, 0.2, -0.3])):
        rows.append(f"{t} 1 2 3 " + " ".join(map(str, _R.from_euler("ZYX", e).as_quat())))
    (tmp_path / "groundtruth.txt").write_text("\n".join(rows) + "\n")
    got, ref = _both("tum", tmp_path)
    _same_frames(got, ref)
    assert got[0].shape == (2, 3)


@pytest.mark.parametrize("name,needs", [("mcap", "mcap"), ("rosbag", "rosbags"), ("ouster", "ouster-sdk")])
def test_container_loaders_gate_cleanly(tmp_path, name, needs):
    """Without its package each container reader raises the reference's
    ImportError, naming the package."""
    package = needs.split("-")[0]
    f = tmp_path / "data.bin"
    f.write_bytes(b"\x00")
    errors = []
    for ds in (tds, jds):
        with pytest.raises(ImportError, match=package) as e:
            ds.dataset_factory(name, f, topic="/points")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_factory_covers_all_reference_names():
    reference_names = {
        "generic", "kitti", "nclt", "mulran", "apollo", "boreas", "kitti_raw",
        "mcap", "ncd", "nuscenes", "ouster", "paris_luco", "rosbag", "tum",
    }
    assert set(tds._FACTORY) == set(jds._FACTORY) == reference_names
    for name in reference_names:
        assert tds._FACTORY[name].__name__ == jds._FACTORY[name].__name__
    with pytest.raises(ValueError, match="Unknown dataloader"):
        tds.dataset_factory("nope", ".")


def _nclt_tree(root, seq, scan_times, rows):
    scans = root / "velodyne_data" / seq / "velodyne_sync"
    scans.mkdir(parents=True)
    rng = np.random.RandomState(5)
    for ts in scan_times:
        rng.randint(15000, 25000, (6, 4)).astype(np.int16).tofile(scans / f"{ts}.bin")
    if rows is not None:
        (root / "ground_truth").mkdir()
        np.savetxt(root / "ground_truth" / f"groundtruth_{seq}.csv", np.asarray(rows), delimiter=",")


def test_nclt_kiss_loader_flips_to_z_up(tmp_path):
    scans = tmp_path / "velodyne_data" / "seq" / "velodyne_sync"
    scans.mkdir(parents=True)
    pts = np.array([[1.0, 2.0, -3.0], [-4.5, 0.25, 7.0]])
    data = np.zeros((2, 4), dtype=np.int16)
    data[:, :3] = np.round((pts + 100.0) / 0.005).astype(np.int16)
    data.tofile(scans / "1335704127712909.bin")
    got, ref = tds.NCLTDataset(tmp_path, sequence="seq"), jds.NCLTDataset(tmp_path, sequence="seq")
    assert got.gt_poses is None and ref.gt_poses is None
    _same_frames(got, ref)
    np.testing.assert_allclose(got[0], pts * [1, -1, -1], atol=0.005)


def test_generic_loader_natural_sort(tmp_path):
    for name in ("scan_10.bin", "scan_2.bin", "scan_1.bin"):
        np.random.RandomState(len(name)).randn(4, 4).astype(np.float32).tofile(tmp_path / name)
    got, ref = _both("generic", tmp_path)
    assert [f.name for f in got.scan_files] == [f.name for f in ref.scan_files] == [
        "scan_1.bin", "scan_2.bin", "scan_10.bin"]
    _same_frames(got, ref)


def test_nclt_gt_poses_recover_planted(tmp_path):
    rows = [[1000.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [1400.0, 2.0, -1.0, 0.5, 0.1, -0.2, 0.3],
            [3000.0, 5.0, 3.0, -0.25, -0.05, 0.15, 1.2], [5000.0, 9.0, 9.0, 9.0, 0.4, 0.4, 0.4]]
    _nclt_tree(tmp_path, "seq", (500, 1500, 3100), rows)
    got, ref = _both("nclt", tmp_path, "seq")
    assert len(got) == 2 and got.gt_poses.shape == (2, 4, 4)
    _equal(got.timestamps, ref.timestamps)
    _same_frames(got, ref)


def test_nclt_sequence_error_runs_on_gt(tmp_path):
    n = 12
    rows = [[1000 + 100 * k, 10.0 * k, 0.5 * k, 0.0, 0.0, 0.0, 0.02 * k] for k in range(n + 2)]
    _nclt_tree(tmp_path, "s", [1000 + 100 * k + 50 for k in range(1, n + 1)], rows)
    got, ref = _both("nclt", tmp_path, "s")
    assert len(got) == n
    est = [p @ _se3(_rot_z(0.01 * i), [0.05 * i, 0.0, 0.0]) for i, p in enumerate(got.gt_poses)]
    np.testing.assert_allclose(tmetrics.sequence_error(got.gt_poses, est),
                               jmetrics.sequence_error(ref.gt_poses, est), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tmetrics.absolute_trajectory_error(got.gt_poses, est),
                               jmetrics.absolute_trajectory_error(ref.gt_poses, est), rtol=1e-12, atol=0)
    assert max(tmetrics.sequence_error(got.gt_poses, list(got.gt_poses))) < 1e-9
