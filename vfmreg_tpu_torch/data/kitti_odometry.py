"""KITTI odometry loader with images.

A copy of `vfmreg_tpu/data/kitti_odometry.py` (the reference's
`dataloader/kitti_odometry.py:10-125`). The scan correction is the port's
`kiss.datasets.correct_kitti_scan` (f32, as the reference computes it);
`PIL` is imported only where an image is read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from vfmreg_tpu_torch.kiss.datasets import correct_kitti_scan


class KittiOdometry:
    def __init__(self, sequence: int, root_dir: Path, image_subsample: int = 1) -> None:
        self.correct_kitti_scan = correct_kitti_scan
        self.same_cameras = [["camera"]]
        self.cameras = [x for sub in self.same_cameras for x in sub]

        self.root_dir = Path(root_dir)
        self.sequence = f"{sequence:02d}"
        self.image_subsample = image_subsample

        self.img_files = sorted(
            (self.root_dir / "sequences" / self.sequence / "image_2").glob("*.png")
        )
        self.pcl_files = sorted(
            (self.root_dir / "sequences" / self.sequence / "velodyne").glob("*.bin")
        )
        self.calib = self.read_calib()
        self.timestamps = self.read_times()
        self.gt_poses = self.read_poses()

    def __len__(self) -> int:
        return len(self.pcl_files)

    def read_images(self, frame_id: int) -> Dict[str, np.ndarray]:
        from PIL import Image as PILImage

        image = PILImage.open(self.img_files[frame_id])
        if self.image_subsample > 1:
            image = image.resize(
                (image.size[0] // self.image_subsample, image.size[1] // self.image_subsample),
                PILImage.BILINEAR,
            )
        return {"camera": np.array(image)}

    def read_pcl(self, frame_id: int) -> np.ndarray:
        pcl = np.fromfile(self.pcl_files[frame_id], dtype=np.float32).reshape(-1, 4)
        pcl = pcl[:, :3].astype(np.float64)
        return self.correct_kitti_scan(pcl)

    def read_calib(self) -> Dict[str, np.ndarray]:
        """P2 + Tr (velo->cam0) from calib.txt (`kitti_odometry.py:63-80`)."""
        calib_path = self.root_dir / "sequences" / self.sequence / "calib.txt"
        with open(calib_path, "r", encoding="UTF-8") as f:
            lines = f.readlines()
        P2 = np.array([float(x) for x in lines[2].strip("\n").split(" ")[1:]]).reshape(3, 4)
        Tr = np.array([float(x) for x in lines[4].strip("\n").split(" ")[1:]]).reshape(3, 4)
        Tr = np.insert(Tr, 3, values=[0, 0, 0, 1], axis=0)
        return {"P2": P2, "Tr_velo_to_cam": Tr}

    def read_poses(self) -> List[np.ndarray]:
        """Camera-frame GT poses converted to the LiDAR frame via Tr^-1 P Tr."""
        Tr = self.calib["Tr_velo_to_cam"]
        Tr_inv = np.linalg.inv(Tr)
        poses_path = self.root_dir / "poses" / f"{self.sequence}.txt"
        poses = []
        with open(poses_path, "r", encoding="UTF-8") as f:
            for line in f.readlines():
                pose = np.eye(4)
                pose[:3, :] = np.array(
                    [float(x) for x in line.strip("\n").split(" ")]
                ).reshape(3, 4)
                poses.append(Tr_inv @ pose @ Tr)
        return poses

    def read_times(self) -> List[float]:
        times_path = self.root_dir / "sequences" / self.sequence / "times.txt"
        with open(times_path, "r", encoding="UTF-8") as f:
            return [float(line.strip("\n")) for line in f.readlines()]

    def project_pcl_to_image(self, pcl, image, camera: str):
        """P2 @ Tr @ pcl projection (`kitti_odometry.py:110-125`)."""
        proj = self.calib["P2"] @ self.calib["Tr_velo_to_cam"] @ pcl
        pcl_indices = np.flatnonzero(proj[2, :] > 0)
        p = proj[:, pcl_indices]
        u, v = p[:2, :] / p[2, :] / self.image_subsample
        # `>=`: the reference's `>` (`kitti_odometry.py:117-118`) admits
        # u == width / v == height, which can only IndexError downstream.
        outlier = (u < 0) | (u >= image.shape[1]) | (v < 0) | (v >= image.shape[0])
        pcl_indices = pcl_indices[~outlier]
        return u[~outlier].astype(int), v[~outlier].astype(int), pcl_indices
