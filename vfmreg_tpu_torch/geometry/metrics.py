"""Registration error metrics (numpy, host side).

A copy of `vfmreg_tpu/geometry/metrics.py` (the port imports nothing of the
JAX package): `compute_errors` and `success_rate` score the recall gate of
`chip_smoke.py`; `seq_error` and `absolute_trajectory_error` score an
odometry trajectory (`Metrics.cpp:90-191`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def rotation_error_deg(pose: np.ndarray, gt_pose: np.ndarray) -> float:
    """Geodesic rotation error in degrees."""
    R = pose[:3, :3]
    R_gt = gt_pose[:3, :3]
    cos = min(max(((R.T @ R_gt).trace() - 1.0) / 2.0, -1.0), 1.0)
    return float(np.rad2deg(abs(np.arccos(cos))))


def translation_error(pose: np.ndarray, gt_pose: np.ndarray) -> float:
    """L2 translation error in meters."""
    return float(np.linalg.norm(pose[:3, 3] - gt_pose[:3, 3]))


def compute_errors(pose: np.ndarray, gt_pose: np.ndarray) -> Tuple[float, float]:
    """(RTE, RRE)."""
    return translation_error(pose, gt_pose), rotation_error_deg(pose, gt_pose)


def success_rate(
    trans_errors: Sequence[float],
    rot_errors: Sequence[float],
    translation_threshold: float,
    rotation_threshold: float,
) -> float:
    """Fraction with RTE < t_thr AND RRE < r_thr (nan when empty)."""
    t = np.asarray(trans_errors) < translation_threshold
    r = np.asarray(rot_errors) < rotation_threshold
    if t.size == 0:
        return float("nan")
    return float(np.mean(t & r))


_SEGMENT_LENGTHS = [100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0]


def _trajectory_distances(poses: Sequence[np.ndarray]) -> np.ndarray:
    dist = [0.0]
    for i in range(1, len(poses)):
        dist.append(dist[-1] + float(np.linalg.norm(poses[i][:3, 3] - poses[i - 1][:3, 3])))
    return np.asarray(dist)


def _last_frame_from_segment_length(dist: np.ndarray, first: int, length: float) -> int:
    for i in range(first, len(dist)):
        if dist[i] > dist[first] + length:
            return i
    return -1


def seq_error(poses_gt: Sequence[np.ndarray], poses_result: Sequence[np.ndarray]) -> Tuple[float, float]:
    """KITTI average relative error, (translation %, rotation deg/m), over
    segments of 100-800 m starting every 10 frames (`Metrics.cpp:90-155`);
    nan when the trajectory is shorter than 100 m. The reference divides the
    rotation by 3.14, not pi, and so does this copy."""
    step_size = 10
    dist = _trajectory_distances(poses_gt)
    t_errs: List[float] = []
    r_errs: List[float] = []
    for first in range(0, len(poses_gt), step_size):
        for length in _SEGMENT_LENGTHS:
            last = _last_frame_from_segment_length(dist, first, length)
            if last == -1:
                continue
            delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            delta_res = np.linalg.inv(poses_result[first]) @ poses_result[last]
            err = np.linalg.inv(delta_res) @ delta_gt
            d = 0.5 * (np.trace(err[:3, :3]) - 1.0)
            t_errs.append(float(np.linalg.norm(err[:3, 3])) / length)
            r_errs.append(np.arccos(max(min(d, 1.0), -1.0)) / length)
    if not t_errs:
        return float("nan"), float("nan")
    return 100.0 * float(np.mean(t_errs)), float(np.mean(r_errs)) / 3.14 * 180.0


def umeyama_alignment(source: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Rigid (no scale) Umeyama alignment of 3 x N point sets: the [4, 4]
    taking source onto target."""
    mu_s = source.mean(axis=1, keepdims=True)
    mu_t = target.mean(axis=1, keepdims=True)
    cov = (target - mu_t) @ (source - mu_s).T / source.shape[1]
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = (mu_t - R @ mu_s)[:, 0]
    return T


def absolute_trajectory_error(
    poses_gt: Sequence[np.ndarray], poses_result: Sequence[np.ndarray]
) -> Tuple[float, float]:
    """(ATE rotation [rad], ATE translation [m]): RMSE after aligning the
    positions (`Metrics.cpp:157-191`). As in the reference, a (nearly)
    straight trajectory leaves the rotation about its line to noise, and
    the rotation term with it."""
    if len(poses_gt) != len(poses_result):
        raise ValueError(f"{len(poses_gt)} ground-truth poses for {len(poses_result)} results")
    src = np.stack([p[:3, 3] for p in poses_result], axis=1)
    tgt = np.stack([p[:3, 3] for p in poses_gt], axis=1)
    T_align = umeyama_alignment(src, tgt)
    ate_rot = 0.0
    ate_trans = 0.0
    for gt, res in zip(poses_gt, poses_result):
        est = T_align @ res
        delta_R = gt[:3, :3] @ est[:3, :3].T
        delta_t = gt[:3, 3] - delta_R @ est[:3, 3]
        theta = np.arccos(max(min((np.trace(delta_R) - 1.0) / 2.0, 1.0), -1.0))
        ate_rot += theta * theta
        ate_trans += float(delta_t @ delta_t)
    n = len(poses_gt)
    return float(np.sqrt(ate_rot / n)), float(np.sqrt(ate_trans / n))
