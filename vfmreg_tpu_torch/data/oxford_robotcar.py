"""Oxford RobotCar (radar-oxford-10k) loader.

A copy of `vfmreg_tpu/data/oxford_robotcar.py` (the reference's
`dataloader/oxford_robotcar.py:23-373`), with `PIL` imported only where an
image is read or written.

Four cameras (Bumblebee stereo/centre GBRG + three Grasshopper monos RGGB),
Bayer demosaic + LUT undistortion with an on-disk undistorted-PNG cache,
hood/no-LiDAR-coverage crops, INS pose interpolation to LiDAR timestamps,
2.5 m ego-removal + 50 m crop of the left Velodyne, timestamp sync-file cache.
"""

from __future__ import annotations

from copy import deepcopy
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from vfmreg_tpu_torch.data.robotcar_sdk import (
    CameraModel,
    build_se3_transform,
    demosaic_bilinear,
    interpolate_ins_poses,
)


class OxfordRobotcar:
    def __init__(
        self,
        sequence: str,
        root_dir: Path,
        image_subsample: int = 1,
        high_level_api: bool = False,
        models_dir: Optional[Path] = None,
        extrinsics_dir: Optional[Path] = None,
    ) -> None:
        self.root_dir = Path(root_dir)
        self.sequence = sequence
        self.image_subsample = image_subsample
        self.lidar_frequency = 10
        self.same_cameras = [["stereo/centre"], ["mono_left", "mono_right", "mono_rear"]]
        self.cameras = [x for sub in self.same_cameras for x in sub]

        # Camera models + extrinsics ship with the SDK; callers point these at
        # their checkout (the reference vendors them at
        # `dataloader/robotcar_sdk/{models,extrinsics}`).
        self.models_dir = Path(models_dir) if models_dir else self.root_dir / "models"
        self.extrinsics_dir = (
            Path(extrinsics_dir) if extrinsics_dir else self.root_dir / "extrinsics"
        )
        self.camera_model = {c: CameraModel(self.models_dir, c) for c in self.cameras}
        self.calib = self.read_calib()

        if not high_level_api:
            self.timestamps_abs = self.read_times()
            self.gt_poses = self.read_poses()
            self.timestamps = self.compute_relative_timestamps()

            seq_dir = self.root_dir / f"{self.sequence}-radar-oxford-10k"
            self.img_files = {
                c: [seq_dir / c / f"{ts}.png" for ts in self.timestamps_abs["image"][c]]
                for c in self.cameras
            }
            self.img_undistorted_files = {
                c: [
                    seq_dir / f"{c}_undistorted" / f"{ts}.png"
                    for ts in self.timestamps_abs["image"][c]
                ]
                for c in self.cameras
            }
            self.pcl_files = [
                seq_dir / "velodyne_left" / f"{ts}.bin" for ts in self.timestamps_abs["pcl"]
            ]
        else:
            self.timestamps_abs = None
            self.gt_poses = None
            self.timestamps = None

    def __len__(self) -> int:
        return len(self.pcl_files)

    def read_image_files(self, frame_id: int) -> Dict[str, Path]:
        return {c: self.img_files[c][frame_id] for c in self.cameras}

    def _read_one_image(self, camera: str, image_path: Path, frame_id: int, use_cache: bool):
        """Demosaic -> undistort -> crop; PNG cache (`oxford_robotcar.py:103-136`)."""
        from PIL import Image as PILImage

        if use_cache and self.img_undistorted_files[camera][frame_id].exists():
            image = PILImage.open(self.img_undistorted_files[camera][frame_id])
        else:
            raw = PILImage.open(image_path)
            pattern = "GBRG" if camera == "stereo/centre" else "RGGB"
            image = demosaic_bilinear(np.array(raw), pattern)
            image = self.camera_model[camera].undistort(image).astype(np.uint8)
            image = PILImage.fromarray(image)
            # Hood crop (stereo) / no-LiDAR-coverage crop (monos).
            crop_px = 150 if camera == "stereo/centre" else 200
            image = image.crop((0, 0, image.size[0], image.size[1] - crop_px))
            if use_cache:
                self.img_undistorted_files[camera][frame_id].parent.mkdir(
                    parents=True, exist_ok=True
                )
                image.save(self.img_undistorted_files[camera][frame_id])

        if self.image_subsample > 1:
            image = image.resize(
                (image.size[0] // self.image_subsample, image.size[1] // self.image_subsample),
                PILImage.BILINEAR,
            )
        return image

    def read_images(
        self, frame_id: int = -1, filenames: Optional[List[Path]] = None
    ) -> Dict[str, np.ndarray]:
        assert (frame_id != -1) != (filenames is not None)
        use_cache = frame_id != -1
        if use_cache:
            filenames = [self.img_files[c][frame_id] for c in self.cameras]

        images = {}
        for camera, filename in zip(self.cameras, filenames):
            if not use_cache:
                images[camera] = np.array(self._read_one_image(camera, filename, frame_id, False))
            else:
                try:
                    # np.array INSIDE the try: PIL decodes PNG pixels lazily,
                    # so with image_subsample == 1 a truncated cache body only
                    # surfaces at the array conversion, not at open().
                    images[camera] = np.array(
                        self._read_one_image(camera, filename, frame_id, True)
                    )
                except Exception:
                    # Corrupted cache entry: delete and retry once (`:144-153`).
                    self.img_undistorted_files[camera][frame_id].unlink()
                    images[camera] = np.array(
                        self._read_one_image(camera, filename, frame_id, True)
                    )
        return images

    def read_pcl(self, frame_id: int = -1, filename: Optional[Path] = None) -> np.ndarray:
        """float32 4xN binary, 2.5 m ego-removal, 50 m crop (`oxford_robotcar.py:159-183`)."""
        assert (frame_id != -1) != (filename is not None)
        pcl_path = filename if filename is not None else self.pcl_files[frame_id]
        pcl = np.fromfile(pcl_path, dtype=np.float32).reshape(4, -1).T
        depth = np.linalg.norm(pcl[:, :3], axis=1)
        pcl = pcl[depth > 2.5]
        depth = depth[depth > 2.5]
        pcl = pcl[depth < 50]
        return pcl[:, :3]

    def read_calib(self) -> Dict[str, np.ndarray]:
        """Extrinsics txt files -> lidar/camera/ins in ego (stereo) frame
        (`oxford_robotcar.py:185-217`)."""
        calib = {}
        with open(self.extrinsics_dir / "velodyne_left.txt") as f:
            calib["lidar_in_ego"] = np.asarray(
                build_se3_transform([float(x) for x in next(f).split(" ")])
            )
        for camera in self.cameras:
            name = "stereo" if camera == "stereo/centre" else camera
            with open(self.extrinsics_dir / f"{name}.txt") as f:
                calib[f"{camera}_in_ego"] = np.asarray(
                    build_se3_transform([float(x) for x in next(f).split(" ")])
                )
        with open(self.extrinsics_dir / "ins.txt") as f:
            calib["ins_in_ego"] = np.asarray(
                build_se3_transform([float(x) for x in next(f).split(" ")])
            )
        calib["lidar_in_ins"] = np.linalg.solve(calib["ins_in_ego"], calib["lidar_in_ego"])
        calib["ins_in_lidar"] = np.linalg.inv(calib["lidar_in_ins"])
        return calib

    def read_poses(self, absolute_poses: bool = False) -> List[np.ndarray]:
        """INS interpolation at pcl timestamps, moved into the LiDAR frame,
        NaN rows dropped with their timestamps (`oxford_robotcar.py:219-251`)."""
        ins_file = self.root_dir / f"{self.sequence}-radar-oxford-10k" / "gps" / "ins.csv"
        poses = np.asarray(
            interpolate_ins_poses(
                ins_file, deepcopy(self.timestamps_abs["pcl"]), self.timestamps_abs["pcl"][0]
            )
        )
        poses = np.asarray([pose @ self.calib["ins_in_lidar"] for pose in poses])

        if np.isnan(poses).any():
            nan_idx = sorted({int(x[0]) for x in np.argwhere(np.isnan(poses))}, reverse=True)
            for idx in nan_idx:
                poses = np.delete(poses, idx, axis=0)
                for k, v in self.timestamps_abs.items():
                    if k == "image":
                        for v2 in v.values():
                            del v2[idx]
                    else:
                        del v[idx]

        if not absolute_poses:
            origin = np.linalg.inv(poses[0])
            poses = [origin @ p for p in poses]
        return list(poses)

    def read_times(self) -> Dict:
        """LiDAR timestamps subsampled to lidar_frequency; per-camera nearest
        image sync with the `<cam>_<step>.timestamps` cache (`:253-295`)."""
        step = 20 // self.lidar_frequency
        seq_dir = self.root_dir / f"{self.sequence}-radar-oxford-10k"
        pcl_timestamps = (
            np.loadtxt(seq_dir / "velodyne_left.timestamps", delimiter=" ", usecols=[0], dtype=np.int64)[
                ::step
            ].tolist()
        )

        def read_image_times(camera: str) -> List[int]:
            cam_type = "stereo" if camera == "stereo/centre" else camera
            synced = seq_dir / f"{cam_type}_{step}.timestamps"
            if synced.exists():
                return np.loadtxt(synced, delimiter=" ", usecols=[0], dtype=np.int64).tolist()
            all_ts = np.loadtxt(
                seq_dir / f"{cam_type}.timestamps", delimiter=" ", usecols=[0], dtype=np.int64
            )
            idx = np.searchsorted(all_ts, pcl_timestamps)
            idx = np.clip(idx, 1, len(all_ts) - 1)
            left, right = all_ts[idx - 1], all_ts[idx]
            nearest = np.where(
                np.abs(np.asarray(pcl_timestamps) - left) <= np.abs(right - np.asarray(pcl_timestamps)),
                left,
                right,
            )
            np.savetxt(synced, nearest, fmt="%i", delimiter=" ")
            return nearest.tolist()

        return {"image": {c: read_image_times(c) for c in self.cameras}, "pcl": pcl_timestamps}

    def compute_relative_timestamps(self) -> List[float]:
        t0 = self.timestamps_abs["pcl"][0]
        return [(ts - t0) / 1e6 for ts in self.timestamps_abs["pcl"]]

    def project_pcl_to_image(self, pcl, image, camera: str):
        """LiDAR-frame homogeneous 4xN -> (u, v, indices) (`oxford_robotcar.py:330-363`)."""
        assert camera in self.cameras
        pcl_ = self.calib["lidar_in_ego"] @ pcl
        pcl_ = self.calib[f"{camera}_in_ego"] @ pcl_
        pcl_ = np.linalg.solve(self.camera_model[camera].G_camera_image, pcl_)

        # Strictly positive depth (the reference's `>= 0`, `oxford_robotcar.py:344`,
        # lets z == 0 produce NaN pixel coords that pass every filter and
        # crash/garbage-index the feature gather; z == 0 is measure-zero).
        in_front = np.flatnonzero(pcl_[2, :] > 0)
        p = pcl_[:, in_front]
        f = self.camera_model[camera].focal_length
        c = self.camera_model[camera].principal_point
        u = (f[0] * p[0, :] / p[2, :] + c[0]) / self.image_subsample
        v = (f[1] * p[1, :] / p[2, :] + c[1]) / self.image_subsample

        # `>=`: the reference's `>` (`oxford_robotcar.py:356-357`) admits
        # u == width / v == height, which can only IndexError downstream.
        outlier = (u < 0) | (u >= image.shape[1]) | (v < 0) | (v >= image.shape[0])
        pcl_indices = in_front[~outlier]
        return u[~outlier].astype(int), v[~outlier].astype(int), pcl_indices
