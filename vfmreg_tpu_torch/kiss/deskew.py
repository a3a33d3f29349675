"""Constant-velocity motion compensation (`core/Deskew.cpp:40-68`,
`kiss_icp/deskew.py`; counterpart of `vfmreg_tpu/kiss/deskew.py`): point i
moves by exp((t_i - 0.5) * log(T_start^-1 T_finish)); descriptor columns are
kept. The twists run in float64 through `geometry.se3` on the CPU (the
reference's run in f32 on its device)."""

from __future__ import annotations

import numpy as np
import torch

from vfmreg_tpu_torch.config import KISSConfig
from vfmreg_tpu_torch.geometry.se3 import exp_se3, log_se3

MID_POSE_TIMESTAMP = 0.5


def get_motion_compensator(config: KISSConfig):
    return MotionCompensator() if config.data.deskew else StubCompensator()


class StubCompensator:
    def deskew_scan(self, frame, poses, timestamps):
        return frame


class MotionCompensator:
    def deskew_scan(self, frame: np.ndarray, poses, timestamps) -> np.ndarray:
        if len(poses) <= 2:
            return frame
        start_pose = np.asarray(poses[-2], dtype=np.float64)
        finish_pose = np.asarray(poses[-1], dtype=np.float64)
        delta = log_se3(torch.from_numpy(np.linalg.inv(start_pose) @ finish_pose))
        ts = torch.from_numpy(np.asarray(timestamps, dtype=np.float64).reshape(-1, 1))
        motions = exp_se3((ts - MID_POSE_TIMESTAMP) * delta).numpy()
        out = np.einsum("nij,nj->ni", motions[:, :3, :3], frame[:, :3]) + motions[:, :3, 3]
        if frame.shape[1] > 3:
            return np.c_[out.astype(frame.dtype), frame[:, 3:]]
        return out.astype(frame.dtype)
