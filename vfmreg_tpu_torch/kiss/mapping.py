"""Host-facing VoxelHashMap: the part the evaluation driver uses.

Counterpart of `vfmreg_tpu/kiss/mapping.py:39-434` (the reference's
`kiss_icp/mapping.py:30-131` API): points accumulate on the host in
insertion order, and the device grid (`ops.hash_grid.build_padded_grid`:
padded to `bucket_size`, the first `max_points_per_voxel` points of each
voxel kept) is built on the map's device at first use and cached until the
map changes. `point_cloud` reads the capped store back; the cosine
correspondence search runs kernel B1 through `ops.matching`.

The odometry side of the reference map (`update`, `remove_far_away_points`,
buffered merges, the native backend, the 27-voxel correspondence queries)
waits for the KISS odometry port (ROADMAP A10) and raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.config import KISSConfig
from vfmreg_tpu_torch.ops.hash_grid import HashGrid, build_padded_grid
from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences as _device_vfm_corr
from vfmreg_tpu_torch.ops.voxel import bucket_size
from vfmreg_tpu_torch.utils.device import resolve_device


def _a10(what: str) -> NotImplementedError:
    return NotImplementedError(f"VoxelHashMap.{what} waits for the KISS odometry port (ROADMAP A10)")


def get_voxel_hash_map(config: KISSConfig, device=None) -> "VoxelHashMap":
    """`kiss_icp/mapping.py:30-36`, on `device` (default: the card)."""
    return VoxelHashMap(
        voxel_size=config.mapping.voxel_size,
        max_distance=config.data.max_range,
        max_points_per_voxel=config.mapping.max_points_per_voxel,
        merge_interval=config.mapping.map_merge_interval,
        device=device,
    )


class VoxelHashMap:
    def __init__(
        self,
        voxel_size: float,
        max_distance: float,
        max_points_per_voxel: int = 20,
        merge_interval: int = 1,
        device=None,
    ):
        if int(merge_interval) != 1:
            raise _a10("merge_interval > 1")
        self.voxel_size = float(voxel_size)
        self.max_distance = float(max_distance)
        self.max_points_per_voxel = int(max_points_per_voxel)
        self.device = resolve_device(device)
        self._points = np.zeros((0, 3), dtype=np.float32)
        self._feats: Optional[np.ndarray] = None  # [N, D] when descriptor clouds were added
        self._grid: Optional[HashGrid] = None  # device cache

    # ------------------------------------------------------------- mutation API
    def clear(self):
        self._points = np.zeros((0, 3), dtype=np.float32)
        self._feats = None
        self._grid = None

    def empty(self) -> bool:
        return self._points.shape[0] == 0

    def _split(self, points: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        points = np.asarray(points)
        if points.ndim != 2 or points.shape[1] < 3:
            raise ValueError("Invalid shape")
        xyz = np.ascontiguousarray(points[:, :3], dtype=np.float32)
        feats = None
        if points.shape[1] > 3:
            feats = np.ascontiguousarray(points[:, 3:], dtype=np.float32)
        return xyz, feats

    def add_points(self, points: np.ndarray):
        """`VoxelHashMap::AddPoints` (`VoxelHashMap.cpp:733-770`): append in
        insertion order; the per-voxel cap applies when the grid is built."""
        xyz, feats = self._split(points)
        if xyz.shape[0] == 0:
            return
        if self._points.shape[0] == 0:
            self._points, self._feats = xyz, feats
        else:
            if (feats is None) != (self._feats is None):
                raise ValueError("Cannot mix descriptor and plain clouds in one map")
            self._points = np.concatenate([self._points, xyz])
            if feats is not None:
                self._feats = np.concatenate([self._feats, feats])
        self._grid = None

    def update(self, points: np.ndarray, pose: np.ndarray = np.eye(4)):
        raise _a10("update")

    def remove_far_away_points(self, origin: np.ndarray):
        raise _a10("remove_far_away_points")

    # --------------------------------------------------------------- device side
    def device_grid(self) -> HashGrid:
        """The cached grid: the stored points zero-padded to `bucket_size`
        rows on the map's device, capped per voxel."""
        if self._grid is None:
            feats = None if self._feats is None else torch.from_numpy(self._feats).to(self.device)
            self._grid = build_padded_grid(torch.from_numpy(self._points).to(self.device), feats,
                                           self.voxel_size, self.max_points_per_voxel)
        return self._grid

    # ---------------------------------------------------------------- query API
    def point_cloud(self) -> np.ndarray:
        """Capped stored points, [M, 3] in the grid's order (`Pointcloud`,
        `VoxelHashMap.cpp:628-660`)."""
        grid = self.device_grid()
        return grid.points[grid.valid].cpu().numpy()

    def point_cloud_n(self) -> np.ndarray:
        """Capped stored points with descriptors, [M, 3 + D] (`PointcloudN`)."""
        grid = self.device_grid()
        if grid.feats is None:
            raise ValueError("Map has no descriptors")
        return torch.cat([grid.points, grid.feats], dim=1)[grid.valid].cpu().numpy()

    def get_correspondences(self, points: np.ndarray, max_correspondance_distance: float,
                            xd: bool = False):
        raise _a10("get_correspondences")

    def get_vfm_correspondences(
        self, points: np.ndarray, min_cosine_similarity: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Cosine 1-NN descriptor matches (`GetVFMCorrespondences`,
        `VoxelHashMap.cpp:461-626`): (scan points [K, 3], map points [K, 3])
        of the accepted queries, in query order. points: [N, 3 + D]."""
        xyz, feats = self._split(points)
        if feats is None:
            raise ValueError("get_vfm_correspondences needs descriptor points")
        grid = self.device_grid()
        if grid.feats is None:
            raise ValueError("Map has no descriptors")
        n0 = xyz.shape[0]
        n = bucket_size(max(n0, 1))
        dev = self.device
        q = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        qf = torch.zeros((n, feats.shape[1]), dtype=torch.float32, device=dev)
        qmask = torch.zeros(n, dtype=torch.bool, device=dev)
        q[:n0] = torch.from_numpy(xyz).to(dev)
        qf[:n0] = torch.from_numpy(feats).to(dev)
        qmask[:n0] = True
        corr = _device_vfm_corr(grid.points, grid.feats, grid.valid, q, qf, qmask,
                                min_cosine_similarity=min_cosine_similarity)
        m = corr.mask
        return corr.source[m].cpu().numpy(), corr.target[m].cpu().numpy()
