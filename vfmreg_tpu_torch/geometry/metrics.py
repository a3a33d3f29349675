"""Registration error metrics (numpy, host side).

A copy of `compute_errors` and `success_rate` from
`vfmreg_tpu/geometry/metrics.py:19-52` (the port imports nothing of the JAX
package). They score the recall gate of `chip_smoke.py`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

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
