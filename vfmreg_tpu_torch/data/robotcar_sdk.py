"""Oxford RobotCar SDK equivalents, numpy and scipy only.

A copy of `vfmreg_tpu/data/robotcar_sdk.py` (the reference vendors the SDK
at `dataloader/robotcar_sdk/python/`), matching the SDK behaviour the
pipeline uses:
  * `build_se3_transform` / `euler_to_so3` — ZYX-composed Euler transforms
    (`transform.py:23-66`);
  * `so3_to_quaternion` — standard Shepperd conversion (`transform.py:100+`);
  * `interpolate_poses` / `interpolate_ins_poses` — SLERP + lerp between INS
    poses, origin-relative (`interpolate_poses.py:107-210`): the first requested
    timestamp slot is the origin frame and its pose left-divides the rest;
  * `CameraModel` — pinhole intrinsics + bilinear undistortion LUT
    (`camera_model.py:23-154`);
  * `demosaic_bilinear` — bilinear Bayer demosaicing replacing the
    `colour_demosaicing` dependency (`oxford_robotcar.py:8`);
  * `load_image` — demosaic and optional undistortion (`PIL` is imported
    there only).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Sequence

import numpy as np
from scipy.ndimage import convolve, map_coordinates


def euler_to_so3(rpy: Sequence[float]) -> np.ndarray:
    """R = Rz(yaw) Ry(pitch) Rx(roll) (`transform.py:45-66`)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    R_x = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    R_y = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    R_z = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return R_z @ R_y @ R_x


def build_se3_transform(xyzrpy: Sequence[float]) -> np.ndarray:
    if len(xyzrpy) != 6:
        raise ValueError("Must supply 6 values to build transform")
    se3 = np.eye(4)
    se3[:3, :3] = euler_to_so3(xyzrpy[3:6])
    se3[:3, 3] = xyzrpy[0:3]
    return se3


def so3_to_euler(so3: np.ndarray) -> np.ndarray:
    """Inverse of euler_to_so3 (first valid pitch branch)."""
    roll = np.arctan2(so3[2, 1], so3[2, 2])
    yaw = np.arctan2(so3[1, 0], so3[0, 0])
    denom = np.sqrt(so3[0, 0] ** 2 + so3[1, 0] ** 2)
    for sign in (1.0, -1.0):
        pitch = np.arctan2(-so3[2, 0], sign * denom)
        if np.abs(euler_to_so3((roll, pitch, yaw)) - so3).sum() < 1e-4:
            return np.array([roll, pitch, yaw])
    raise ValueError("Could not find valid pitch angle")


def so3_to_quaternion(so3: np.ndarray) -> np.ndarray:
    """[w, x, y, z] via the trace-max branch method."""
    t = np.trace(so3)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [
                0.25 * s,
                (so3[2, 1] - so3[1, 2]) / s,
                (so3[0, 2] - so3[2, 0]) / s,
                (so3[1, 0] - so3[0, 1]) / s,
            ]
        )
    i = int(np.argmax(np.diag(so3)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(so3[i, i] - so3[j, j] - so3[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[0] = (so3[k, j] - so3[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (so3[j, i] + so3[i, j]) / s
    q[1 + k] = (so3[k, i] + so3[i, k]) / s
    return q


def _quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def interpolate_poses(
    pose_timestamps: Sequence[int],
    abs_poses: Sequence[np.ndarray],
    requested_timestamps: Sequence[int],
    origin_timestamp: int,
) -> List[np.ndarray]:
    """SLERP/lerp interpolation, poses reported relative to origin_timestamp
    (`interpolate_poses.py:107-210` semantics, including the shortest-arc sign
    flip and the linear fallback for nearly-parallel quaternions)."""
    pose_timestamps = np.asarray(pose_timestamps, dtype=np.int64)
    if len(pose_timestamps) != len(abs_poses):
        raise ValueError("Must supply same number of timestamps as poses")
    if np.any(np.diff(pose_timestamps) <= 0):
        raise ValueError("Pose timestamps must be in ascending order")

    requested = np.asarray([origin_timestamp] + list(requested_timestamps), dtype=np.int64)

    quats = np.stack([so3_to_quaternion(np.asarray(p)[:3, :3]) for p in abs_poses], axis=1)
    positions = np.stack([np.asarray(p)[:3, 3] for p in abs_poses], axis=1)

    upper = np.searchsorted(pose_timestamps, requested, side="right")
    upper = np.minimum(upper, len(pose_timestamps) - 1)
    lower = np.maximum(upper - 1, 0)
    denom = (pose_timestamps[upper] - pose_timestamps[lower]).astype(np.float64)
    denom[denom == 0] = 1.0
    frac = (requested - pose_timestamps[lower]) / denom

    q0 = quats[:, lower]
    q1 = quats[:, upper]
    d = np.sum(q0 * q1, axis=0)
    scale0 = np.empty_like(d)
    scale1 = np.empty_like(d)
    lin = np.abs(d) >= 1
    scale0[lin] = 1 - frac[lin]
    scale1[lin] = frac[lin]
    sl = ~lin
    theta = np.arccos(np.abs(d[sl]))
    scale0[sl] = np.sin((1 - frac[sl]) * theta) / np.sin(theta)
    scale1[sl] = np.sin(frac[sl] * theta) / np.sin(theta)
    scale1[d < 0] = -scale1[d < 0]
    q_interp = scale0 * q0 + scale1 * q1
    q_interp = q_interp / np.maximum(np.linalg.norm(q_interp, axis=0, keepdims=True), 1e-12)
    p_interp = (1 - frac) * positions[:, lower] + frac * positions[:, upper]

    poses = []
    for i in range(len(requested)):
        T = np.eye(4)
        T[:3, :3] = _quaternion_to_matrix(q_interp[:, i])
        T[:3, 3] = p_interp[:, i]
        poses.append(T)

    origin_inv = np.linalg.inv(poses[0])
    return [origin_inv @ T for T in poses[1:]]


def interpolate_ins_poses(
    ins_path: Path,
    pose_timestamps: Sequence[int],
    origin_timestamp: int,
    use_rtk: bool = False,
) -> List[np.ndarray]:
    """Reads the INS/RTK CSV and interpolates (`interpolate_poses.py:60-104`):
    the first row at or before the earliest request seeds the window; rows after
    the latest request are skipped."""
    import csv

    with open(ins_path) as f:
        reader = csv.reader(f)
        headers = next(f)
        ins_timestamps = [0]
        abs_poses = [np.eye(4)]
        upper_timestamp = max(max(pose_timestamps), origin_timestamp)
        for row in reader:
            timestamp = int(row[0])
            ins_timestamps.append(timestamp)
            if use_rtk:
                utm = row[5:8]
                rpy = row[11:14]
            else:
                utm = row[5:8]
                rpy = row[-3:]
            xyzrpy = [float(v) for v in utm] + [float(v) for v in rpy]
            abs_poses.append(build_se3_transform(xyzrpy))
            if timestamp >= upper_timestamp:
                break
    return interpolate_poses(ins_timestamps[1:], abs_poses[1:], list(pose_timestamps), origin_timestamp)


# ------------------------------------------------------------------- demosaic
_BILINEAR_G = np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]], dtype=np.float64) / 4.0
_BILINEAR_RB = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float64) / 4.0


def _cfa_masks(shape, pattern: str):
    """Boolean masks for each channel position of a 2x2 Bayer pattern."""
    pattern = pattern.upper()
    channels = {c: np.zeros(shape, dtype=bool) for c in "RGB"}
    for idx, c in enumerate(pattern):
        y, x = idx // 2, idx % 2
        channels[c][y::2, x::2] = True
    return channels["R"], channels["G"], channels["B"]


def demosaic_bilinear(raw: np.ndarray, pattern: str = "RGGB") -> np.ndarray:
    """Bilinear CFA demosaic, replacement for
    `colour_demosaicing.demosaicing_CFA_Bayer_bilinear`. Returns float RGB."""
    raw = np.asarray(raw, dtype=np.float64)
    if raw.ndim == 3:
        raw = raw[..., 0]
    R_m, G_m, B_m = _cfa_masks(raw.shape, pattern)
    R = convolve(raw * R_m, _BILINEAR_RB, mode="mirror")
    G = convolve(raw * G_m, _BILINEAR_G, mode="mirror")
    B = convolve(raw * B_m, _BILINEAR_RB, mode="mirror")
    return np.stack([R, G, B], axis=-1)


def load_image(image_path: Path, model: "CameraModel" = None, pattern: str = "GBRG") -> np.ndarray:
    """SDK `image.load_image` equivalent: demosaic + optional undistortion."""
    from PIL import Image as PILImage

    img = np.array(PILImage.open(image_path))
    img = demosaic_bilinear(img, pattern)
    if model is not None:
        img = model.undistort(img)
    return img


class CameraModel:
    """Pinhole intrinsics + bilinear undistortion LUT (`camera_model.py:23-154`)."""

    def __init__(self, models_dir: Path, images_dir: str):
        self.camera = None
        self.camera_sensor = None
        self.focal_length = None
        self.principal_point = None
        self.G_camera_image = None
        self.bilinear_lut = None
        self._load_intrinsics(models_dir, images_dir)
        self._load_lut(models_dir, images_dir)

    def _model_name(self, images_dir: str) -> str:
        m = re.search(r"(stereo|mono_(left|right|rear))", images_dir)
        if m is None:
            raise RuntimeError(f"Unknown camera model for: {images_dir}")
        self.camera = m.group(0)
        if self.camera == "stereo":
            sensor = re.search(r"(left|centre|right)", images_dir).group(0)
            self.camera_sensor = sensor
            return {"left": "stereo_wide_left", "right": "stereo_wide_right", "centre": "stereo_narrow_left"}[sensor]
        return self.camera

    def _load_intrinsics(self, models_dir, images_dir):
        name = self._model_name(images_dir)
        with open(os.path.join(models_dir, name + ".txt")) as f:
            vals = [float(x) for x in next(f).split()]
            self.focal_length = (vals[0], vals[1])
            self.principal_point = (vals[2], vals[3])
            self.G_camera_image = np.array([[float(x) for x in line.split()] for line in f])

    def _load_lut(self, models_dir, images_dir):
        name = self._model_name(images_dir)
        lut = np.fromfile(os.path.join(models_dir, name + "_distortion_lut.bin"), np.double)
        lut = lut.reshape([2, lut.size // 2])
        self.bilinear_lut = lut.transpose()

    def project(self, xyz: np.ndarray, image_size):
        """3xN (or 4xN) camera-frame points -> (uv[2,M], depth[M]) inside image."""
        if xyz.shape[0] == 3:
            xyz = np.vstack((xyz, np.ones((1, xyz.shape[1]))))
        xyzw = np.linalg.solve(self.G_camera_image, xyz)
        in_front = xyzw[2, :] >= 0
        xyzw = xyzw[:, in_front]
        u = self.focal_length[0] * xyzw[0] / xyzw[2] + self.principal_point[0]
        v = self.focal_length[1] * xyzw[1] / xyzw[2] + self.principal_point[1]
        in_img = (u >= 0.5) & (u <= image_size[1]) & (v >= 0.5) & (v <= image_size[0])
        return np.vstack((u[in_img], v[in_img])), xyzw[2, in_img]

    def undistort(self, image: np.ndarray) -> np.ndarray:
        if image.shape[0] * image.shape[1] != self.bilinear_lut.shape[0]:
            raise ValueError("Incorrect image size for camera model")
        if image.ndim == 1:
            raise ValueError("Undistortion function only works with multi-channel images")
        lut = self.bilinear_lut[:, 1::-1].T.reshape((2, image.shape[0], image.shape[1]))
        undistorted = np.stack(
            [map_coordinates(image[:, :, c], lut, order=1) for c in range(image.shape[2])],
            axis=-1,
        )
        return undistorted.astype(image.dtype)
