"""Point-cloud transform on the host (a copy of `vfmreg_tpu/utils/pcl.py:20`)."""

from __future__ import annotations

import numpy as np


def transform_pcl(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Transform the xyz columns of [N, 3 + D] points by a 4x4 pose; the
    descriptor columns ride along. Keeps the points' dtype."""
    pts = np.asarray(points)
    xyz = pts[:, :3] @ np.asarray(transform)[:3, :3].T + np.asarray(transform)[:3, 3]
    if pts.shape[1] > 3:
        return np.c_[xyz.astype(pts.dtype), pts[:, 3:]]
    return xyz.astype(pts.dtype)
