"""NCLT dataset loader.

A copy of `vfmreg_tpu/data/nclt.py` (the reference's `dataloader/nclt.py:20-366`)
with `cv2` imported only where the undistortion maps are built and images
read, so that the module imports without it; cv2's remap, resize, erode,
colour conversion and rotation are kept, so images equal the reference's.

Ladybug3 surround cameras (Cam1..Cam5; Cam0 faces the sky and is unused),
undistortion-map-based image loading with crop-mask bounds and 90-degree
rotations, int16 -> float 5 mm-scaled Velodyne decoding with a 50 m crop,
ground-truth pose CSV with nearest-timestamp interpolation, and pinhole
projection with crop-mask bounds + per-pixel RGB-validity filtering.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from scipy.interpolate import interp1d
from scipy.spatial.transform import Rotation as R

from vfmreg_tpu_torch.data.robotcar_sdk import build_se3_transform


class NCLT:
    def __init__(
        self,
        sequence: str,
        root_dir: Path,
        image_subsample: int = 1,
        high_level_api: bool = False,
    ) -> None:
        self.root_dir = Path(root_dir)
        self.sequence = sequence
        self.image_subsample = image_subsample

        # Cam0: sky-facing (unused). Cam1..Cam5: surround ring (`nclt.py:32-38`).
        self.same_cameras = [["Cam1"], ["Cam2"], ["Cam3"], ["Cam4"], ["Cam5"]]
        self.cameras = [x for sub in self.same_cameras for x in sub]

        self.calib = self.read_calib()
        self.undistortion_maps = self.read_undistortion_maps()
        self.undistortion_masks = self.read_undistortion_masks()
        self.camera_parameters = self.read_camera_parameters()

        self.timestamps_abs = self.read_times()
        self.timestamps = self.compute_relative_timestamps()

        self.img_files = {
            camera: [
                self.root_dir / "images" / self.sequence / "lb3" / camera / f"{ts}.tiff"
                for ts in self.timestamps_abs["image"]
            ]
            for camera in self.cameras
        }
        self.pcl_files = [
            self.root_dir / "velodyne_data" / self.sequence / "velodyne_sync" / f"{ts}.bin"
            for ts in self.timestamps_abs["pcl"]
        ]

    def __len__(self) -> int:
        return len(self.pcl_files)

    def read_image_files(self, frame_id: int) -> Dict[str, Path]:
        return {camera: self.img_files[camera][frame_id] for camera in self.cameras}

    def read_images(
        self,
        frame_id: int = -1,
        crop: bool = True,
        filenames: Optional[List[Path]] = None,
    ) -> Dict[str, np.ndarray]:
        """Undistort -> crop black borders -> rotate 90 deg CW (`nclt.py:68-112`)."""
        import cv2

        assert (frame_id != -1) != (filenames is not None), (
            "Provide exactly one of frame_id / filenames"
        )
        if frame_id != -1:
            filenames = [self.img_files[camera][frame_id] for camera in self.cameras]

        images = {}
        for camera, image_path in zip(self.cameras, filenames):
            image = cv2.imread(str(image_path))
            maps = self.undistortion_maps[camera]
            image = cv2.remap(image, maps["mapu"], maps["mapv"], cv2.INTER_LINEAR)
            image = cv2.resize(
                image, (maps["mask"].shape[1], maps["mask"].shape[0]),
                interpolation=cv2.INTER_CUBIC,
            )
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
            if crop:
                mask = self.undistortion_masks[camera]["mask"]
                coords = self.undistortion_masks[camera]["coords"]
                image = image[mask].reshape((coords[2], coords[3], 3))
            image = cv2.rotate(image, cv2.ROTATE_90_CLOCKWISE)
            if self.image_subsample > 1:
                image = cv2.resize(
                    image,
                    (image.shape[1] // self.image_subsample, image.shape[0] // self.image_subsample),
                    interpolation=cv2.INTER_AREA,
                )
            images[camera] = image
        return images

    def read_pcl(self, frame_id: int = -1, filename: Optional[Path] = None) -> np.ndarray:
        """int16 x4-interleaved, 5 mm scaling, -100 m offset, 50 m crop
        (`nclt.py:114-151`, dataset SDK `convert`)."""
        assert (frame_id != -1) != (filename is not None)
        pcl_path = filename if filename is not None else self.pcl_files[frame_id]

        binary = np.fromfile(pcl_path, dtype=np.int16)
        scaling, offset = 0.005, -100.0
        x = binary[0::4].astype(np.float32) * scaling + offset
        y = binary[1::4].astype(np.float32) * scaling + offset
        z = binary[2::4].astype(np.float32) * scaling + offset
        pcl = np.stack([x, y, z], axis=1)
        depth = np.linalg.norm(pcl, axis=1)
        return pcl[depth < 50]

    def read_calib(self) -> Dict[str, np.ndarray]:
        """Body<->LiDAR extrinsics from the dataset paper (`nclt.py:153-163`)."""
        calib = {}
        calib["lidar_in_ego"] = np.eye(4)
        calib["lidar_in_ego"][:3, :3] = R.from_euler(
            "xyz", [0.807, 0.166, -90.703], degrees=True
        ).as_matrix()
        calib["lidar_in_ego"][:3, 3] = [0.002, -0.004, -0.957]
        calib["ego_in_lidar"] = np.linalg.inv(calib["lidar_in_ego"])
        return calib

    def read_undistortion_maps(self) -> Dict[str, Dict[str, np.ndarray]]:
        """U2D_* map files; (mapu, mapv) are transposed-index, col 3 = u, col 2 = v
        (`nclt.py:165-189`, dataset SDK format)."""
        import cv2

        out = {}
        for camera in self.cameras:
            path = self.root_dir / "cam_params" / f"U2D_{camera}_1616X1232.txt"
            with open(path, "r") as f:
                header = f.readline().rstrip()
                chunks = re.sub(r"[^0-9,]", "", header).split(",")
                mapu = np.zeros((int(chunks[1]), int(chunks[0])), dtype=np.float32)
                mapv = np.zeros((int(chunks[1]), int(chunks[0])), dtype=np.float32)
                for line in f.readlines():
                    c = line.rstrip().split(" ")
                    mapu[int(c[0]), int(c[1])] = float(c[3])
                    mapv[int(c[0]), int(c[1])] = float(c[2])
            mask = np.ones(mapu.shape, dtype=np.uint8)
            mask = cv2.remap(mask, mapu, mapv, cv2.INTER_LINEAR)
            mask = cv2.erode(mask, np.ones((30, 30), np.uint8), iterations=1)
            out[camera] = {"mapu": mapu, "mapv": mapv, "mask": mask}
        return out

    def read_undistortion_masks(self) -> Dict[str, Dict]:
        """Fixed crop window [y0, x0, h, w] = [210, 450, 820, 700] (`nclt.py:191-202`)."""
        out = {camera: {"coords": [210, 450, 820, 700]} for camera in self.cameras}
        for camera in self.cameras:
            c = out[camera]["coords"]
            mask = np.zeros((1232, 1616), dtype=np.uint8)
            mask[c[0] : c[0] + c[2], c[1] : c[1] + c[3]] = 1
            out[camera]["mask"] = np.tile(mask[:, :, None], (1, 1, 3)).astype(bool)
        return out

    def read_camera_parameters(self) -> Dict[str, Dict[str, np.ndarray]]:
        """K_camN.csv intrinsics + x_lb3_cN.csv Ladybug extrinsics (`nclt.py:204-220`)."""
        out = {}
        for camera in self.cameras:
            cid = camera[-1]
            K = np.loadtxt(self.root_dir / "cam_params" / f"K_cam{cid}.csv", delimiter=",")
            x = np.loadtxt(self.root_dir / "cam_params" / f"x_lb3_c{cid}.csv", delimiter=",")
            x_lb3 = np.eye(4)
            x_lb3[:3, 3] = x[:3]
            x_lb3[:3, :3] = R.from_euler("xyz", x[3:], degrees=True).as_matrix()
            out[camera] = {"K": K, "x_lb3": x_lb3}
        return out

    def read_poses(
        self, absolute_poses: bool = False, interpolate_pcl: bool = True
    ) -> List[np.ndarray]:
        """GT CSV -> SE3 via xyzrpy, NaN rows dropped, nearest interpolation at
        point-cloud timestamps, origin-relative (`nclt.py:222-285`)."""
        poses_file = self.root_dir / "ground_truth" / f"groundtruth_{self.sequence}.csv"
        with open(poses_file) as f:
            reader = csv.reader(f)
            next(f)
            timestamps, abs_poses = [], []
            upper = max(self.timestamps_abs["pcl"])
            for row in reader:
                vals = [float(v) for v in row[1:7]]
                if np.any(np.isnan(vals)):
                    continue
                timestamps.append(int(row[0]))
                abs_poses.append(np.asarray(build_se3_transform(vals)))
                if timestamps[-1] >= upper:
                    break

        # Trim point clouds outside the pose window (`nclt.py:256-264`).
        pcl_ts = np.array(self.timestamps_abs["pcl"])
        keep = (pcl_ts <= max(timestamps)) & (pcl_ts >= min(timestamps))
        self.timestamps_abs["pcl"] = pcl_ts[keep].tolist()
        self.timestamps_abs["image"] = np.array(self.timestamps_abs["image"])[keep].tolist()

        if interpolate_pcl:
            interp = interp1d(timestamps, np.asarray(abs_poses), kind="nearest", axis=0)
            poses = np.asarray(interp(self.timestamps_abs["pcl"]))
        else:
            poses = np.asarray(abs_poses)

        if not absolute_poses:
            origin = np.linalg.inv(poses[0])
            poses = [origin @ p for p in poses]
        return list(poses)

    def read_times(self) -> Dict[str, List[int]]:
        """Intersection of Cam1 image and velodyne_sync timestamps (`nclt.py:287-300`)."""
        img_dir = self.root_dir / "images" / self.sequence / "lb3" / "Cam1"
        img_ts = sorted(int(f.stem) for f in img_dir.glob("*.tiff"))
        pcl_dir = self.root_dir / "velodyne_data" / self.sequence / "velodyne_sync"
        pcl_ts = sorted(int(f.stem) for f in pcl_dir.glob("*.bin"))
        common = sorted(set(img_ts) & set(pcl_ts))
        return {"image": common, "pcl": common}

    def compute_relative_timestamps(self) -> List[float]:
        t0 = self.timestamps_abs["pcl"][0] if self.timestamps_abs["pcl"] else 0
        return [(ts - t0) / 1e6 for ts in self.timestamps_abs["pcl"]]

    def project_pcl_to_image(self, pcl, image, camera: str):
        """Body-frame homogeneous 4xN points -> (u, v, indices) in the cropped,
        UNROTATED image frame (`nclt.py:311-366`)."""
        assert camera in self.cameras
        K = self.camera_parameters[camera]["K"]
        x_lb3_c = self.camera_parameters[camera]["x_lb3"]

        x_body_lb3 = np.eye(4)
        x_body_lb3[:3, 3] = [0.035, 0.002, -1.23]
        x_body_lb3[:3, :3] = R.from_euler(
            "xyz", [-179.93, -0.23, 0.50], degrees=True
        ).as_matrix()
        T_c_body = np.linalg.inv(x_lb3_c) @ np.linalg.inv(x_body_lb3)

        pcl_c = T_c_body @ pcl
        proj = K @ pcl_c[:3, :]
        z = proj[2]
        in_front = z > 0
        x_im = (proj[0] / z / self.image_subsample)[in_front].astype(int)
        y_im = (proj[1] / z / self.image_subsample)[in_front].astype(int)

        mask_coords = np.array(self.undistortion_masks[camera]["coords"]) // self.image_subsample
        x_out = (x_im < mask_coords[1]) | (x_im >= mask_coords[1] + mask_coords[3])
        y_out = (y_im < mask_coords[0]) | (y_im >= mask_coords[0] + mask_coords[2])
        in_image = ~(x_out | y_out)
        x_im, y_im = x_im[in_image] - mask_coords[1], y_im[in_image] - mask_coords[0]

        in_rgb = np.flatnonzero(np.any(image[y_im, x_im] != 0, axis=-1))
        x_im, y_im = x_im[in_rgb], y_im[in_rgb]

        pcl_indices = np.flatnonzero(in_front)[in_image][in_rgb]
        return x_im, y_im, pcl_indices
