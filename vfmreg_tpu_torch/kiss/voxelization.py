"""Host voxel downsampling with the reference signature.

A copy of `vfmreg_tpu/kiss/voxelization.py`: `voxel_down_sample(points,
voxel_size)` takes [N, 3] or [N, 3 + D] numpy arrays and keeps the first
point of each voxel, in insertion order (`kiss_icp/voxelization.py:27-39`,
`Preprocessing.cpp:50-137`). Ragged host preprocessing; the batched
driver row uses `ops.voxel.voxel_down_sample_masked` on the device, which
selects the same rows in the same order.
"""

from __future__ import annotations

import numpy as np


def _voxel_keys(points: np.ndarray, voxel_size: float) -> np.ndarray:
    coords = np.trunc(points[:, :3] / voxel_size).astype(np.int64)
    # 64-bit packing of the three coords (exact: no collisions for |coord| < 2^20).
    return (
        (coords[:, 0] + (1 << 20)).astype(np.int64)
        | ((coords[:, 1] + (1 << 20)).astype(np.int64) << 21)
        | ((coords[:, 2] + (1 << 20)).astype(np.int64) << 42)
    )


def voxel_down_sample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """First-point-wins voxel downsample."""
    points = np.asarray(points)
    if points.ndim != 2 or points.shape[1] < 3:
        raise ValueError(f"Expected [N, >=3] points, got {points.shape}")
    if points.shape[0] == 0:
        return points
    keys = _voxel_keys(points, voxel_size)
    _, first_idx = np.unique(keys, return_index=True)
    return points[np.sort(first_idx)]
