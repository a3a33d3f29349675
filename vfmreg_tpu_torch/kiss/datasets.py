"""Odometry dataset readers for the KISS pipeline (`kiss_icp/datasets/`).

Counterpart of `vfmreg_tpu/kiss/datasets.py`: `dataset_factory` with the
reference's 14 names. Each reader is an indexable of [N, 3] float64 frames
(or (frame, per-point timestamps in [0, 1])) with optional `gt_poses`,
`sequence_id`, `get_frames_timestamps` and `apply_calibration`, the surface
`kiss.pipeline.OdometryPipeline` reads:

* files on disk: `generic` (a folder of .bin, .npy, ASCII .ply, .xyz or
  .txt clouds), `kitti` (KITTI odometry: scan correction, ground truth in
  the LiDAR frame, timestamps), `nclt` (velodyne_sync scans, ground truth
  at the scan times), `mulran`, `apollo`, `boreas`, `kitti_raw`, `ncd`
  (Newer College), `nuscenes` (the JSON tables, no devkit), `paris_luco`
  and `tum` (depth PNGs, needs PIL);
* containers, each needing its package, imported when the reader is made
  and named in the ImportError when missing: `ouster` (ouster-sdk), `mcap`
  (mcap, mcap-ros2-support) and `rosbag` (rosbags); their PointCloud2
  messages are decoded by `kiss.point_cloud2`.

PCD and PLY files are read by `data.cloud_io`, in place of the reference
upstream's open3d, pyntcloud and plyfile.
"""

from __future__ import annotations

import glob
import os
import re
from pathlib import Path
from typing import List

import numpy as np

from vfmreg_tpu_torch.data.cloud_io import read_pcd_xyz, read_ply


def _natsorted(names):
    """Natural sort: runs of digits compare as integers (scan_2 < scan_10)."""
    def key(s):
        return tuple(int(p) if p.isdigit() else p for p in re.split(r"(\d+)", str(s)))

    return sorted(names, key=key)


class GenericDataset:
    """A folder of point-cloud files: .bin (KITTI float32 xyzi), .npy, ASCII
    .ply, .xyz / .txt (kiss-icp's `generic.py`), in natural order."""

    def __init__(self, data_dir: Path, *_, **__):
        self.data_dir = Path(data_dir)
        files: List[Path] = []
        for e in ("*.bin", "*.npy", "*.ply", "*.xyz", "*.txt"):
            files.extend(self.data_dir.glob(e))
        if not files:
            raise FileNotFoundError(f"No point cloud files in {data_dir}")
        self.scan_files = _natsorted(files)
        self.sequence_id = os.path.basename(str(data_dir))

    def __len__(self):
        return len(self.scan_files)

    @staticmethod
    def read_point_cloud(path: Path) -> np.ndarray:
        path = Path(path)
        if path.suffix == ".bin":
            return np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3].astype(np.float64)
        if path.suffix == ".npy":
            return np.load(path)[:, :3].astype(np.float64)
        if path.suffix == ".ply":
            return _read_ascii_ply(path)
        return np.loadtxt(path)[:, :3].astype(np.float64)

    def __getitem__(self, idx):
        return self.read_point_cloud(self.scan_files[idx])


def _read_ascii_ply(path: Path) -> np.ndarray:
    with open(path, "r") as f:
        n = 0
        props = []
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.loadtxt(f, max_rows=n)
    return data[:, [props.index(c) for c in ("x", "y", "z")]].astype(np.float64)


def correct_kitti_scan(points: np.ndarray) -> np.ndarray:
    """KITTI's vertical-angle correction (`Preprocessing.cpp:199-209`): each
    point rotated by 0.205 deg about (p x z) / |p x z|, in f32 as the
    reference computes it; float64 out."""
    p = np.asarray(points, dtype=np.float32)
    offset = np.float32(0.205 * np.pi / 180.0)
    axis = np.cross(p, np.array([0.0, 0.0, 1.0], dtype=np.float32))
    axis = axis / np.maximum(np.linalg.norm(axis, axis=-1, keepdims=True), np.float32(1e-12))
    cos_t, sin_t = np.cos(offset), np.sin(offset)
    out = p * cos_t + np.cross(axis, p) * sin_t + axis * np.sum(axis * p, axis=-1, keepdims=True) * (1 - cos_t)
    return out.astype(np.float64)


class KittiOdometryDataset:
    """KITTI odometry (`datasets/kitti.py`, the reference's
    `data/kitti_odometry.py` without the images): corrected scans, the
    camera-frame ground truth moved into the LiDAR frame (Tr^-1 P Tr), and
    the scan timestamps. Layout: <root>/sequences/<NN>/{velodyne/*.bin,
    calib.txt, times.txt}, <root>/poses/<NN>.txt."""

    def __init__(self, data_dir: Path, sequence: int = 0, *_, **__):
        root = Path(data_dir)
        self.sequence_id = f"{int(sequence):02d}"
        seq = root / "sequences" / self.sequence_id
        self.pcl_files = sorted((seq / "velodyne").glob("*.bin"))
        with open(seq / "calib.txt", encoding="UTF-8") as f:
            tr = np.array([float(x) for x in f.readlines()[4].strip("\n").split(" ")[1:]]).reshape(3, 4)
        Tr = np.insert(tr, 3, values=[0, 0, 0, 1], axis=0)
        Tr_inv = np.linalg.inv(Tr)
        with open(seq / "times.txt", encoding="UTF-8") as f:
            self.timestamps = [float(line.strip("\n")) for line in f.readlines()]
        poses = []
        with open(root / "poses" / f"{self.sequence_id}.txt", encoding="UTF-8") as f:
            for line in f.readlines():
                pose = np.eye(4)
                pose[:3, :] = np.array([float(x) for x in line.strip("\n").split(" ")]).reshape(3, 4)
                poses.append(Tr_inv @ pose @ Tr)
        self.gt_poses = np.stack(poses)
        self.data_dir = str(data_dir)

    def __len__(self):
        return len(self.pcl_files)

    def get_frames_timestamps(self):
        return np.asarray(self.timestamps)

    def __getitem__(self, idx):
        pcl = np.fromfile(self.pcl_files[idx], dtype=np.float32).reshape(-1, 4)[:, :3]
        return correct_kitti_scan(pcl)


class NCLTDataset:
    """NCLT velodyne_sync scans (`datasets/nclt.py`). With
    `ground_truth/groundtruth_<seq>.csv`, the scans are those strictly inside
    its time range and `gt_poses` the CSV's (x, y, z, roll, pitch, heading)
    at each scan time (nearest), conjugated by diag(1, -1, -1) into the
    decoded scans' z-up frame; without it, scans only. Accepts
    <root>/velodyne_data/<seq>/velodyne_sync or <seq>/velodyne_sync."""

    def __init__(self, data_dir: Path, sequence: str = "", *_, **__):
        self.data_dir = Path(data_dir)
        candidates = []
        if sequence:
            candidates.append((self.data_dir / "velodyne_data" / sequence / "velodyne_sync",
                               self.data_dir / "ground_truth" / f"groundtruth_{sequence}.csv", sequence))
        name = self.data_dir.name
        candidates.append((self.data_dir / "velodyne_sync",
                           self.data_dir.parent / "ground_truth" / f"groundtruth_{name}.csv", name))
        scans_dir = gt_file = None
        for sd, gf, sid in candidates:
            if sd.is_dir():
                scans_dir, gt_file, self.sequence_id = sd, gf, sid
                break
        if scans_dir is None:
            raise FileNotFoundError(f"No NCLT velodyne_sync directory under {data_dir}")
        self.scan_files = np.asarray(sorted(scans_dir.glob("*.bin")))
        if self.scan_files.size == 0:
            raise FileNotFoundError(f"No NCLT scans under {scans_dir}")
        self.gt_poses = None
        if gt_file.is_file():
            gt_data = np.loadtxt(gt_file, delimiter=",")
            ts = np.asarray([int(p.stem) for p in self.scan_files], dtype=np.int64)
            keep = (ts > gt_data[:, 0].min()) & (ts < gt_data[:, 0].max())
            self.timestamps = ts[keep]
            self.scan_files = self.scan_files[keep]
            self.gt_poses = self._interpolate_gt(gt_data, self.timestamps)

    @staticmethod
    def _interpolate_gt(gt_data: np.ndarray, timestamps: np.ndarray) -> np.ndarray:
        from scipy import interpolate
        from scipy.spatial.transform import Rotation

        gt = interpolate.interp1d(gt_data[:, 0], gt_data[:, 1:], kind="nearest", axis=0)(timestamps)
        T = np.tile(np.eye(4, dtype=np.float64), (gt.shape[0], 1, 1))
        # Columns after t: x, y, z, roll, pitch, heading -> intrinsic ZYX.
        T[:, :3, :3] = Rotation.from_euler("ZYX", gt[:, 3:][:, [2, 1, 0]]).as_matrix()
        T[:, :3, 3] = gt[:, :3]
        F = np.diag([1.0, -1.0, -1.0, 1.0])
        return np.einsum("ij,njk,kl->nil", F, T, F).astype(np.float64)

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        binary = np.fromfile(self.scan_files[idx], dtype=np.int16)
        x, y, z = (binary[c::4].astype(np.float32) * 0.005 - 100.0 for c in range(3))
        # z-up like the reference (`nclt.py:78-79`: [x, -y, -z]).
        return np.stack([x, -y, -z], axis=1).astype(np.float64)


class MulranDataset:
    """MulRan Ouster scans (`datasets/mulran.py` equivalent): KITTI-style bin
    with the fixed 64x1024 column-index timestamps, timestamp-matched
    global_pose.csv ground truth, and the base<->lidar calibration."""

    # calib_base2ouster.txt: t=[1.7042, -0.021, 1.8047],
    # rpy=[0.0001, 0.0003, 179.6654] deg (`mulran.py:89-96`).
    T_LIDAR_TO_BASE = np.array([
        [-9.9998295e-01, -5.8398386e-03, -5.2257060e-06, 1.7042000e00],
        [5.8398386e-03, -9.9998295e-01, 1.7758769e-06, -2.1000000e-02],
        [-5.2359878e-06, 1.7453292e-06, 1.0000000e00, 1.8047000e00],
        [0.0000000e00, 0.0000000e00, 0.0000000e00, 1.0000000e00],
    ])

    def __init__(self, data_dir: Path, *_, **__):
        self.data_dir = Path(data_dir)
        self.scan_files = sorted(str(p) for p in (self.data_dir / "Ouster").glob("*.bin"))
        self.sequence_id = os.path.basename(str(data_dir))
        if not self.scan_files:
            raise FileNotFoundError(f"No MulRan scans under {data_dir}/Ouster")
        self.scan_timestamps = [
            int(os.path.basename(t).split(".")[0]) for t in self.scan_files
        ]
        pose_file = self.data_dir / "global_pose.csv"
        self.gt_poses = self.load_gt_poses(pose_file) if pose_file.exists() else None

    def __len__(self):
        return len(self.scan_files)

    @staticmethod
    def get_timestamps():
        h, w = 64, 1024
        return np.floor(np.arange(h * w) / h) / w

    def __getitem__(self, idx):
        xyzi = np.fromfile(self.scan_files[idx], dtype=np.float32).reshape(-1, 4)
        frame = xyzi[:, :3].astype(np.float64)
        timestamps = self.get_timestamps()
        if frame.shape[0] != timestamps.shape[0]:
            # Broken point clouds fall back to no timestamps (`mulran.py:50-52`).
            return frame, np.ones(frame.shape[0])
        return frame, timestamps

    def load_gt_poses(self, poses_file):
        data = np.atleast_2d(np.loadtxt(poses_file, delimiter=","))
        timestamps, rows = data[:, 0], data[:, 1:]
        n = rows.shape[0]
        poses = np.concatenate(
            [rows, np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))], axis=1
        ).reshape(n, 4, 4)
        # One pose per scan: nearest CSV timestamp (`mulran.py:79`).
        poses = poses[[np.argmin(abs(timestamps - t)) for t in self.scan_timestamps]]
        poses = np.linalg.inv(poses[0]) @ poses
        T_lb = self.T_LIDAR_TO_BASE
        return T_lb @ poses @ np.linalg.inv(T_lb)


# --------------------------------------------------------------------------
# Quaternion helper shared by the pose readers below ((w, x, y, z) order).
def _quat_wxyz_to_matrix(w, x, y, z):
    n = max((w * w + x * x + y * y + z * z) ** 0.5, 1e-12)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


class ApolloDataset:
    """Apollo-SouthBay PCD scans + quaternion gt poses (`datasets/apollo.py`).

    open3d's pcd reader is replaced by the dependency-free `data.cloud_io`."""

    def __init__(self, data_dir: Path, *_, **__):
        self.scan_files = _natsorted(glob.glob(f"{data_dir}/pcds/*.pcd"))
        self.gt_poses = self.read_poses(f"{data_dir}/poses/gt_poses.txt")
        self.sequence_id = os.path.basename(str(data_dir))

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        return read_pcd_xyz(self.scan_files[idx])

    @staticmethod
    def read_poses(file):
        data = np.loadtxt(file)
        _, _, translations, qxyzw = np.split(data, [1, 2, 5], axis=1)
        poses = np.zeros((data.shape[0], 4, 4))
        for i, (x, y, z, w) in enumerate(qxyzw):
            poses[i, :3, :3] = _quat_wxyz_to_matrix(w, x, y, z)
        poses[:, :3, -1] = translations
        poses[:, -1, -1] = 1
        return np.linalg.inv(poses[0]) @ poses


class BoreasDataset:
    """Boreas lidar bin scans + Applanix csv poses (`datasets/boreas.py`),
    incl. the yaw-derived per-point timestamps and the ENU pose chain."""

    def __init__(self, data_dir: Path, *_, **__):
        self.root_dir = os.path.realpath(data_dir)
        self.scan_files = _natsorted(glob.glob(f"{data_dir}/lidar/*.bin"))
        self.gt_poses = self.load_poses(f"{data_dir}/applanix/lidar_poses.csv")
        self.sequence_id = os.path.basename(str(data_dir))
        assert len(self.scan_files) == self.gt_poses.shape[0]

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points = np.fromfile(self.scan_files[idx], dtype=np.float32).reshape(-1, 6)[:, :3]
        return points.astype(np.float64), self.get_timestamps(points)

    @staticmethod
    def get_timestamps(points):
        yaw = -np.arctan2(points[:, 1], points[:, 0])
        return 0.5 * (yaw / np.pi + 1.0)

    def load_poses(self, poses_file):
        data = np.atleast_2d(np.loadtxt(poses_file, delimiter=",", skiprows=1))
        poses = np.empty((data.shape[0], 4, 4), dtype=np.float32)
        first = None
        for i, row in enumerate(data):
            _, x, y, z, _, _, _, r, p, ya = row[:10]
            cur = self.get_transformation_matrix(x, y, z, ya, p, r)
            if first is None:
                first = cur
            poses[i] = np.linalg.inv(first) @ cur
        return poses

    @staticmethod
    def get_transformation_matrix(x, y, z, yaw, pitch, roll):
        # Applanix convention (`boreas.py:74-96`): the per-axis matrices are
        # written in transposed (passive) form and composed as
        # C_enu_sensor = R_roll @ R_pitch @ R_yaw == (Rz(ya) Ry(p) Rx(r))^T.
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cr, sr = np.cos(roll), np.sin(roll)
        R_yaw = np.array([[cy, sy, 0], [-sy, cy, 0], [0, 0, 1]])
        R_pitch = np.array([[cp, 0, -sp], [0, 1, 0], [sp, 0, cp]])
        R_roll = np.array([[1, 0, 0], [0, cr, sr], [0, -sr, cr]])
        T = np.identity(4)
        T[:3, :3] = R_roll @ R_pitch @ R_yaw
        T[:3, 3] = [x, y, z]
        return T


class KITTIRawDataset:
    """KITTI raw drives mapped to odometry sequences with OXTS/IMU ground
    truth in the Velodyne frame (`datasets/kitti_raw.py`, pykitti OXTS math)."""

    RAW_TO_ODOMETRY = {
        0: "2011_10_03/2011_10_03_drive_0027_sync/",
        1: "2011_10_03/2011_10_03_drive_0042_sync/",
        2: "2011_10_03/2011_10_03_drive_0034_sync/",
        4: "2011_09_30/2011_09_30_drive_0016_sync/",
        5: "2011_09_30/2011_09_30_drive_0018_sync/",
        6: "2011_09_30/2011_09_30_drive_0020_sync/",
        7: "2011_09_30/2011_09_30_drive_0027_sync/",
        8: "2011_09_30/2011_09_30_drive_0028_sync/",
        9: "2011_09_30/2011_09_30_drive_0033_sync/",
        10: "2011_09_30/2011_09_30_drive_0034_sync/",
    }
    BENCHMARK_INDICES = {
        "00": (0, 4540), "01": (0, 1100), "02": (0, 4660), "04": (0, 270),
        "05": (0, 2760), "06": (0, 1100), "07": (0, 1100), "08": (1100, 5170),
        "09": (0, 1590), "10": (0, 1200),
    }

    def __init__(self, data_dir: Path, sequence: int, *_, **__):
        self.sequence_id = str(int(sequence)).zfill(2)
        self.root_dir = os.path.realpath(Path(data_dir) / self.RAW_TO_ODOMETRY[int(sequence)])
        self.date_id = self.root_dir.split("/")[-2]
        lo, hi = self.BENCHMARK_INDICES[self.sequence_id]
        scan_files = sorted(glob.glob(os.path.join(self.root_dir, "velodyne_points/data/*.bin")))
        self.scan_files = scan_files[lo : hi + 1]
        self.calib_path = os.path.join(str(data_dir), self.date_id)
        self.T_velo_imu = self._load_t_velo_imu()
        oxts_files = sorted(glob.glob(os.path.join(self.root_dir, "oxts/data/*.txt")))
        self.oxts_files = oxts_files[lo : hi + 1]
        self.imu_poses = self.load_oxts_poses(self.oxts_files)
        self.gt_poses = self.T_velo_imu @ self.imu_poses @ np.linalg.inv(self.T_velo_imu)

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points = np.fromfile(self.scan_files[idx], dtype=np.float32).reshape(-1, 4)[:, :3]
        points = correct_kitti_scan(points)
        yaw = -np.arctan2(points[:, 1], points[:, 0])
        return points, 0.5 * (yaw / np.pi + 1.0)

    @staticmethod
    def _read_calib_file(filepath):
        data = {}
        with open(filepath) as f:
            for line in f:
                key, _, value = line.partition(":")
                try:
                    data[key] = np.array([float(x) for x in value.split()])
                except ValueError:
                    pass
        return data

    def _load_t_velo_imu(self):
        c = self._read_calib_file(os.path.join(self.calib_path, "calib_imu_to_velo.txt"))
        T = np.eye(4)
        T[:3, :3] = c["R"].reshape(3, 3)
        T[:3, 3] = c["T"]
        return T

    @staticmethod
    def _pose_from_oxts(vals, scale):
        lat, lon, alt, roll, pitch, yaw = vals[:6]
        er = 6378137.0
        t = np.array([
            scale * lon * np.pi * er / 180.0,
            scale * er * np.log(np.tan((90.0 + lat) * np.pi / 360.0)),
            alt,
        ])
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        T = np.eye(4)
        T[:3, :3] = Rz @ Ry @ Rx
        T[:3, 3] = t
        return T

    def load_oxts_poses(self, oxts_files):
        poses, scale = [], None
        for path in oxts_files:
            vals = np.loadtxt(path)
            if scale is None:
                scale = np.cos(vals[0] * np.pi / 180.0)
            poses.append(self._pose_from_oxts(vals, scale))
        poses = np.stack(poses)
        return np.linalg.inv(poses[0]) @ poses


class NewerCollegeDataset:
    """Newer College ouster PCDs + registered gt poses (`datasets/ncd.py`),
    pyntcloud replaced by `data.cloud_io.read_pcd_xyz`."""

    def __init__(self, data_dir: Path, *_, **__):
        self.data_source = os.path.join(str(data_dir), "")
        self.scan_folder = os.path.join(self.data_source, "raw_format/ouster_scan")
        self.pose_file = os.path.join(self.data_source, "ground_truth/registered_poses.csv")
        self.sequence_id = os.path.basename(str(data_dir))
        self.scan_files = self.get_pcd_filenames(self.scan_folder)
        self.gt_poses = self.load_gt_poses(self.pose_file)

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points = read_pcd_xyz(os.path.join(self.scan_folder, self.scan_files[idx]))
        timestamps = self.get_timestamps()
        if points.shape[0] != timestamps.shape[0]:
            return points, np.ones(points.shape[0])
        return points, timestamps

    @staticmethod
    def get_timestamps():
        h, w = 64, 1024
        return (np.floor(np.arange(h * w) / h) / w).reshape(-1)

    @staticmethod
    def get_pcd_filenames(scans_folder):
        # cloud_<secs>_<nsecs>.pcd: sort by integer time, not lexicographically
        # (`ncd.py:76-84` — non-zero-padded nsecs would otherwise misorder).
        regex = re.compile(r"^cloud_(\d*)_(\d*)")

        def ts(name):
            secs, nsecs = regex.search(name).groups()
            return int(secs) * 10**9 + int(nsecs)

        return sorted(os.listdir(scans_folder), key=ts)

    @staticmethod
    def load_gt_poses(path):
        rows = np.loadtxt(path, delimiter=",", skiprows=1)
        xyz = rows[:, 2:5]
        poses = np.zeros((rows.shape[0], 4, 4))
        for i, (qx, qy, qz, qw) in enumerate(rows[:, 5:9]):
            poses[i, :3, :3] = _quat_wxyz_to_matrix(qw, qx, qy, qz)
        poses[:, :3, 3] = xyz
        poses[:, 3, 3] = 1
        # Fixed camera->lidar extrinsic right-multiplied into every pose before
        # the first-pose normalization (`ncd.py:99-104`).
        T_CL = np.eye(4)
        T_CL[:3, :3] = _quat_wxyz_to_matrix(0.383, 0.0, 0.0, 0.924)
        T_CL[:3, 3] = [-0.084, -0.025, 0.050]
        poses = np.einsum("nij,jk->nik", poses, T_CL)
        return np.einsum("...ij,...jk->...ik", np.linalg.inv(poses[0]), poses)


class NuScenesDataset:
    """nuScenes LIDAR_TOP sweeps (`datasets/nuscenes.py`).

    The devkit is not required: the v1.0 tables are plain JSON, so the scene ->
    sample_data chain, ego poses, and lidar extrinsics are read directly."""

    def __init__(self, data_dir: Path, sequence: int, *_, version: str = "v1.0-mini", **__):
        import json

        self.data_dir = Path(data_dir)
        self.sequence_id = str(int(sequence)).zfill(4)
        self.scene_name = f"scene-{self.sequence_id}"
        tdir = self.data_dir / version

        def table(name):
            with open(tdir / f"{name}.json") as f:
                return {r["token"]: r for r in json.load(f)}

        scenes = table("scene")
        samples = table("sample")
        self.sample_data = table("sample_data")
        self.ego_pose = table("ego_pose")
        self.calibrated_sensor = table("calibrated_sensor")
        scene = next((s for s in scenes.values() if s["name"] == self.scene_name), None)
        if scene is None:
            raise ValueError(f"sequence {self.scene_name!r} not in {sorted(s['name'] for s in scenes.values())}")

        first_sample = samples[scene["first_sample_token"]]
        sd = next(
            r for r in self.sample_data.values()
            if r["sample_token"] == first_sample["token"]
            and "lidar" in r["filename"].lower() and r["prev"] == ""
        )
        self.lidar_tokens = [sd["token"]]
        while sd["next"]:
            sd = self.sample_data[sd["next"]]
            self.lidar_tokens.append(sd["token"])
        self.gt_poses = self._load_poses()

    def __len__(self):
        return len(self.lidar_tokens)

    def __getitem__(self, idx):
        filename = self.sample_data[self.lidar_tokens[idx]]["filename"]
        scan = np.fromfile(self.data_dir / filename, dtype=np.float32).reshape(-1, 5)
        return scan[:, :3].astype(np.float64)

    def _load_poses(self):
        poses = np.empty((len(self), 4, 4))
        for i, token in enumerate(self.lidar_tokens):
            sd = self.sample_data[token]
            cs = self.calibrated_sensor[sd["calibrated_sensor_token"]]
            ep = self.ego_pose[sd["ego_pose_token"]]

            def tmat(rec):
                T = np.eye(4)
                T[:3, :3] = _quat_wxyz_to_matrix(*rec["rotation"])
                T[:3, 3] = rec["translation"]
                return T

            poses[i] = tmat(ep) @ tmat(cs)
        return np.linalg.inv(poses[0]) @ poses


class OusterDataloader:
    """Ouster pcap streams (`datasets/ouster.py`); requires ouster-sdk, like
    the reference (which exits when the sdk is missing)."""

    def __init__(self, data_dir, meta=None, *_, **__):
        try:
            from ouster import client, pcap  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "Ouster pcap dataloader requires ouster-sdk: pip install ouster-sdk"
            ) from e
        import json

        self._client = client
        meta = meta or self._find_metadata_json(str(data_dir))
        with open(meta) as f:
            self._info = client.SensorInfo(f.read())
        self._xyzlut = client.XYZLut(self._info)
        self.sequence_id = os.path.basename(str(data_dir)).split(".")[0]
        self._n = sum(1 for _ in client.Scans(pcap.Pcap(str(data_dir), self._info)))
        # Per-frame absolute timestamps, filled during the sequential read
        # (`ouster.py:125-137`).
        self._timestamps = np.linspace(0, self._n, self._n, endpoint=False)
        self._iter = iter(client.Scans(pcap.Pcap(str(data_dir), self._info)))
        self._next_idx = 0

    @staticmethod
    def _find_metadata_json(pcap_file):
        dir_path, filename = os.path.split(pcap_file)
        candidates = sorted(glob.glob(f"{dir_path or os.getcwd()}/*.json"))
        if not candidates:
            return ""
        sizes = [len(os.path.commonprefix((filename, os.path.basename(p)))) for p in candidates]
        return candidates[max(range(len(sizes)), key=lambda i: sizes[i])]

    def __len__(self):
        return self._n

    def get_frames_timestamps(self):
        return self._timestamps

    def __getitem__(self, idx):
        # Sequential-read contract, per-COLUMN relative timestamps tiled across
        # rows, and zero-range return filtering (`ouster.py:131-146`): the
        # (h, w) range image is row-major, so point i sits in column i % w.
        assert self._next_idx == idx, (
            "Ouster pcap dataloader supports only sequential reads. "
            f"Expected idx: {self._next_idx}, but got {idx}"
        )
        scan = next(self._iter)
        self._next_idx += 1
        self._timestamps[self._next_idx - 1] = 1e-9 * scan.timestamp[0]
        timestamps = np.tile(np.linspace(0, 1.0, scan.w, endpoint=False), (scan.h, 1))
        sel = scan.field(self._client.ChanField.RANGE) != 0
        xyz = self._xyzlut(scan)[sel]
        return xyz.astype(np.float64), timestamps[sel]


class ParisLucoDataset:
    """ParisLuco PLY frames with per-point timestamps (`datasets/paris_luco.py`),
    plyfile replaced by `data.cloud_io.read_ply`."""

    def __init__(self, data_dir: Path, *_, **__):
        self.sequence_id = os.path.basename(str(data_dir))
        self.sequence_dir = os.path.realpath(data_dir)
        self.scan_files = sorted(glob.glob(os.path.join(self.sequence_dir, "frames/*.ply")))
        self.gt_poses = self.load_gt_poses(os.path.join(self.sequence_dir, "gt_traj_lidar.txt"))

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        cols = read_ply(self.scan_files[idx])
        points = np.column_stack([cols["x"], cols["y"], cols["z"]]).astype(np.float64)
        timestamps = np.asarray(cols["timestamp"], dtype=np.float64)
        return points, timestamps / np.max(timestamps)

    @staticmethod
    def load_gt_poses(file_path):
        poses = []
        for xyz in np.loadtxt(file_path):
            T = np.eye(4)
            T[:3, 3] = xyz
            poses.append(T)
        return poses

    def apply_calibration(self, poses):
        """xyz-only ground truth: identity rotations (`paris_luco.py:63-70`)."""
        out = []
        for pose in poses:
            T = pose.copy()
            T[:3, :3] = np.eye(3)
            out.append(T)
        return out


class TUMDataset:
    """TUM RGB-D depth frames -> point clouds (`datasets/tum.py`).

    open3d's create_from_tum_format is replaced by the direct conversion: 16-bit
    depth PNG / 5000 = meters, truncated at 4 m, back-projected through the
    TUM default pinhole (fx=fy=525, cx=319.5, cy=239.5)."""

    def __init__(self, data_dir: Path, *_, **__):
        self.data_dir = Path(data_dir)
        self.sequence_id = os.path.basename(str(data_dir))
        self.depth_frames = np.atleast_2d(np.loadtxt(fname=self.data_dir / "depth.txt", dtype=str))
        gt_list = np.atleast_2d(np.loadtxt(fname=self.data_dir / "groundtruth.txt", dtype=str))
        self.gt_poses = self.load_poses(gt_list)

    def __len__(self):
        return len(self.depth_frames)

    def get_frames_timestamps(self):
        return self.depth_frames[:, 0]

    def load_poses(self, gt_list):
        indices = np.unique(
            np.abs(
                np.subtract.outer(
                    gt_list[:, 0].astype(np.float64),
                    self.depth_frames[:, 0].astype(np.float64),
                )
            ).argmin(0)
        )
        xyz = gt_list[indices][:, 1:4].astype(np.float64)
        poses = np.eye(4).reshape(1, 4, 4).repeat(len(indices), axis=0)
        for i, (qx, qy, qz, qw) in enumerate(gt_list[indices][:, 4:8].astype(np.float64)):
            poses[i, :3, :3] = _quat_wxyz_to_matrix(qw, qx, qy, qz)
        poses[:, :3, 3] = xyz
        return poses

    def __getitem__(self, idx):
        from PIL import Image

        depth_path = self.data_dir / self.depth_frames[idx][-1]
        depth = np.asarray(Image.open(depth_path), dtype=np.float64) / 5000.0
        h, w = depth.shape
        fx = fy = 525.0
        cx, cy = 319.5, 239.5
        v, u = np.mgrid[0:h, 0:w]
        valid = (depth > 0) & (depth < 4.0)
        z = depth[valid]
        x = (u[valid] - cx) * z / fx
        y = (v[valid] - cy) * z / fy
        return np.column_stack([x, y, z])


class McapDataloader:
    """Standalone .mcap PointCloud2 stream (`datasets/mcap.py`); the message
    decoding runs through `kiss.point_cloud2` (no ROS needed), the container
    itself needs the `mcap` / `mcap-ros2-support` packages like the reference."""

    def __init__(self, data_dir: str, topic: str = None, *_, **__):
        try:
            from mcap.reader import make_reader
            from mcap_ros2.reader import read_ros2_messages
        except ImportError as e:
            raise ImportError(
                "mcap dataloader requires: pip install mcap-ros2-support"
            ) from e
        from vfmreg_tpu_torch.kiss.point_cloud2 import read_point_cloud

        assert os.path.isfile(data_dir), "mcap dataloader expects an existing MCAP file"
        self.sequence_id = os.path.basename(str(data_dir)).split(".")[0]
        self.bag = make_reader(open(data_dir, "rb"))
        self.summary = self.bag.get_summary()
        self.topic = self.check_topic(topic)
        self.n_scans = sum(
            count
            for cid, count in self.summary.statistics.channel_message_counts.items()
            if self.summary.channels[cid].topic == self.topic
        )
        self.msgs = read_ros2_messages(str(data_dir), topics=[self.topic])
        self.read_point_cloud = read_point_cloud

    def __len__(self):
        return self.n_scans

    def __getitem__(self, idx):
        return self.read_point_cloud(next(self.msgs).ros_msg)

    def check_topic(self, topic):
        schema_ids = [
            s.id for s in self.summary.schemas.values()
            if s.name == "sensor_msgs/msg/PointCloud2"
        ]
        candidates = [
            c.topic for c in self.summary.channels.values() if c.schema_id in schema_ids
        ]
        if topic and topic in candidates:
            return topic
        if len(candidates) == 1:
            return candidates[0]
        raise ValueError(
            f"Specify a PointCloud2 topic with --topic; available: {candidates}"
        )


class RosbagDataset:
    """ROS1/ROS2 bag PointCloud2 stream (`datasets/rosbag.py`); decoding via
    `kiss.point_cloud2`, the container needs the `rosbags` package."""

    def __init__(self, data_dir, topic: str = None, *_, **__):
        try:
            from rosbags.highlevel import AnyReader
        except ImportError as e:
            raise ImportError('rosbag dataloader requires: pip install rosbags') from e
        from vfmreg_tpu_torch.kiss.point_cloud2 import read_point_cloud

        self.read_point_cloud = read_point_cloud
        paths = [Path(data_dir)] if isinstance(data_dir, (str, Path)) else [Path(p) for p in data_dir]
        self.sequence_id = os.path.basename(str(paths[0])).split(".")[0]
        self.bag = AnyReader(paths)
        self.bag.open()
        self.topic = self.check_topic(topic)
        self.n_scans = self.bag.topics[self.topic].msgcount
        connections = [x for x in self.bag.connections if x.topic == self.topic]
        self.msgs = self.bag.messages(connections=connections)
        self.timestamps = []

    def __del__(self):
        if hasattr(self, "bag"):
            self.bag.close()

    def __len__(self):
        return self.n_scans

    def __getitem__(self, idx):
        connection, timestamp, rawdata = next(self.msgs)
        self.timestamps.append(timestamp * 1e-9)
        msg = self.bag.deserialize(rawdata, connection.msgtype)
        return self.read_point_cloud(msg)

    def check_topic(self, topic):
        candidates = [
            t for t, info in self.bag.topics.items()
            if "PointCloud2" in (info.msgtype or "")
        ]
        if topic and topic in candidates:
            return topic
        if len(candidates) == 1:
            return candidates[0]
        raise ValueError(
            f"Specify a PointCloud2 topic with --topic; available: {candidates}"
        )


_FACTORY = {
    "generic": GenericDataset,
    "kitti": KittiOdometryDataset,
    "nclt": NCLTDataset,
    "mulran": MulranDataset,
    "apollo": ApolloDataset,
    "boreas": BoreasDataset,
    "kitti_raw": KITTIRawDataset,
    "mcap": McapDataloader,
    "ncd": NewerCollegeDataset,
    "nuscenes": NuScenesDataset,
    "ouster": OusterDataloader,
    "paris_luco": ParisLucoDataset,
    "rosbag": RosbagDataset,
    "tum": TUMDataset,
}


def dataset_factory(dataloader: str, data_dir: Path, *args, **kwargs):
    if dataloader not in _FACTORY:
        raise ValueError(f"Unknown dataloader '{dataloader}'; available: {sorted(_FACTORY)}")
    return _FACTORY[dataloader](data_dir, *args, **kwargs)
