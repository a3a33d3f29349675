"""Odometry dataset readers for the KISS pipeline (`kiss_icp/datasets/`).

Counterpart of `vfmreg_tpu/kiss/datasets.py`: `dataset_factory` with the
reference's names, and the readers `generic` (a folder of .bin, .npy, ASCII
.ply, .xyz or .txt clouds), `kitti` (KITTI odometry: scan correction,
ground truth in the LiDAR frame, timestamps) and `nclt` (velodyne_sync scans
with the ground truth interpolated at the scan times). Each is an indexable
of [N, 3] float64 frames with optional `gt_poses`, `sequence_id`,
`get_frames_timestamps` and `apply_calibration`, the surface
`kiss.pipeline.OdometryPipeline` reads. The other readers of the reference
raise NotImplementedError naming ROADMAP A10b.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List

import numpy as np


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


def _not_ported(name: str):
    def reader(*_, **__):
        raise NotImplementedError(f"the '{name}' odometry reader waits for ROADMAP A10b")

    return reader


_FACTORY = {
    "generic": GenericDataset,
    "kitti": KittiOdometryDataset,
    "nclt": NCLTDataset,
    **{name: _not_ported(name) for name in ("mulran", "apollo", "boreas", "kitti_raw", "mcap", "ncd",
                                            "nuscenes", "ouster", "paris_luco", "rosbag", "tum")},
}


def dataset_factory(dataloader: str, data_dir: Path, *args, **kwargs):
    if dataloader not in _FACTORY:
        raise ValueError(f"Unknown dataloader '{dataloader}'; available: {sorted(_FACTORY)}")
    return _FACTORY[dataloader](data_dir, *args, **kwargs)
