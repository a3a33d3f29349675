"""Host-facing VoxelHashMap with the reference's Python API.

Counterpart of `vfmreg_tpu/kiss/mapping.py:39-434` (the reference's
`kiss_icp/mapping.py:30-131` API and the semantics of
`core/VoxelHashMap.cpp`): the first `max_points_per_voxel` points of each
voxel kept in insertion order, a whole voxel evicted once its first point
lies beyond `max_distance` of the sensor, [N, 3] and [N, 3 + D] clouds.

Two stores, as in the reference:

* host (the default on the CPU): points accumulate in numpy in insertion
  order, `update` appends and evicts there, and the device grid
  (`ops.hash_grid.build_padded_grid`) is built on the map's device at first
  use and cached until the map changes. The reference's native C++ backend
  gives the same rows; the port has none;
* device-resident (the default on the card): the map lives on the card as
  its grid, and each `update` sends only the new frame, transformed on the
  host in float64; `ops.hash_grid.extend_hash_grid` merges it, compacts,
  rebuilds and evicts there. The point count that sizes the next merge is
  copied back without waiting and read at the next merge, one frame late.
  With `merge_interval` K > 1, frames wait on the host and merge every K-th
  update (the grid the loop searches is then up to K - 1 frames old;
  exports and queries flush first).

Both stores export the same rows in the same order. The 27-voxel
correspondence search runs on the grid, plain or (`xd=True`) with the XD
path's cosine-weighted neighbours; the cosine search runs kernel B1 through
`ops.matching`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vfmreg_tpu_torch.config import KISSConfig
from vfmreg_tpu_torch.kiss.voxelization import _voxel_keys
from vfmreg_tpu_torch.ops.hash_grid import (
    HashGrid,
    build_hash_grid,
    build_padded_grid,
    extend_hash_grid,
    nearest_neighbors,
    nearest_neighbors_xd,
)
from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences as _device_vfm_corr
from vfmreg_tpu_torch.ops.voxel import bucket_size
from vfmreg_tpu_torch.utils.device import resolve_device


def get_voxel_hash_map(config: KISSConfig, device=None) -> "VoxelHashMap":
    """`kiss_icp/mapping.py:30-36`, on `device` (default: the card)."""
    return VoxelHashMap(
        voxel_size=config.mapping.voxel_size,
        max_distance=config.data.max_range,
        max_points_per_voxel=config.mapping.max_points_per_voxel,
        merge_interval=config.mapping.map_merge_interval,
        device=device,
    )


def _padded(rows: np.ndarray, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`rows` zero-padded to `n` rows on `device`, and the mask of the real ones."""
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float32, device=device)
    out[: rows.shape[0]] = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32)).to(device)
    return out, torch.arange(n, device=device) < rows.shape[0]


class VoxelHashMap:
    def __init__(
        self,
        voxel_size: float,
        max_distance: float,
        max_points_per_voxel: int = 20,
        merge_interval: int = 1,
        device=None,
        device_resident: Optional[bool] = None,
    ):
        self.voxel_size = float(voxel_size)
        self.max_distance = float(max_distance)
        self.max_points_per_voxel = int(max_points_per_voxel)
        self.device = resolve_device(device)
        self.merge_interval = max(int(merge_interval), 1)
        # Resident on the card unless the caller says otherwise, as the
        # reference is on its accelerator.
        self.device_resident = self.device.type == "cuda" if device_resident is None else bool(device_resident)
        self._count_host: Optional[torch.Tensor] = None  # pinned buffer of the lagged count
        self.clear()

    # ------------------------------------------------------------- mutation API
    def clear(self):
        self._pending = []  # (xyz, feats, origin, evict) waiting for the merge interval
        self._points = np.zeros((0, 3), dtype=np.float32)
        self._feats: Optional[np.ndarray] = None  # [N, D] when descriptor clouds were added
        self._grid: Optional[HashGrid] = None  # the device grid (the store itself when resident)
        self._dev_count = 0
        self._dev_count_pending = None  # (count tensor, event or None), read at the next merge

    def _count_later(self) -> None:
        """Start the copy of the grid's point count; `_resolve_count` reads it."""
        count = self._grid.valid.sum()
        if count.device.type != "cuda":
            self._dev_count_pending = (count, None)
            return
        if self._count_host is None:
            self._count_host = torch.empty((), dtype=torch.int64, pin_memory=True)
        self._count_host.copy_(count, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._dev_count_pending = (self._count_host, event)

    def _resolve_count(self) -> None:
        if self._dev_count_pending is not None:
            count, event = self._dev_count_pending
            if event is not None:
                event.synchronize()  # long done by the next frame
            self._dev_count = int(count)
            self._dev_count_pending = None

    def empty(self) -> bool:
        if self._pending:
            return False
        self._resolve_count()
        return self._dev_count == 0 and self._points.shape[0] == 0

    # The reference has one empty() per cloud variant (`mapping.py:50-57`); one store here.
    empty_n = empty
    empty_x = empty

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
        insertion order (no eviction); the per-voxel cap applies when the
        grid is built."""
        xyz, feats = self._split(points)
        if xyz.shape[0] == 0:
            return
        if self.device_resident:
            self._update_device(xyz, feats, np.zeros(3), evict=False)
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

    def _update_device(self, xyz, feats, origin, evict: bool = True):
        # Frames wait only once a grid exists: the first frames must be
        # searchable at once, or the first registrations see an empty map.
        if self.merge_interval > 1 and self._grid is not None:
            self._pending.append((xyz, feats, origin, evict))
            if len(self._pending) >= self.merge_interval:
                self._flush_pending()
            return
        self._merge_device(xyz, feats, origin, evict)

    def _flush_pending(self) -> None:
        """Merge the waiting frames at once; eviction from the last origin."""
        if not self._pending:
            return
        xyz = np.concatenate([p[0] for p in self._pending])
        feats = None if self._pending[0][1] is None else np.concatenate([p[1] for p in self._pending])
        origin = self._pending[-1][2]
        evict = any(p[3] for p in self._pending)
        self._pending = []
        self._merge_device(xyz, feats, origin, evict)

    def _merge_device(self, xyz: np.ndarray, feats: Optional[np.ndarray], origin, evict: bool = True):
        """Merge, compact and evict on the map's device in one
        `extend_hash_grid`; only the new rows come from the host."""
        dev = self.device
        n_new = xyz.shape[0]
        origin_t = torch.tensor(np.asarray(origin, dtype=np.float64), dtype=torch.float32, device=dev)
        if self._grid is None:
            if self._points.shape[0] == 0 and self._dev_count == 0:
                # The first frame: a plain padded build.
                pts, mask = _padded(xyz, bucket_size(max(n_new, 1)), dev)
                f = None if feats is None else _padded(feats, pts.shape[0], dev)[0]
                self._grid = build_hash_grid(pts, self.voxel_size, mask=mask, feats=f,
                                             max_points_per_voxel=self.max_points_per_voxel,
                                             evict_origin=origin_t if evict else None,
                                             max_distance=self.max_distance)
                self._count_later()
                return
            self.device_grid()  # host points to the device, once
            self._dev_count = int(self._points.shape[0])

        self._resolve_count()
        cap = bucket_size(max(self._dev_count + n_new, 1))
        # Pad the new rows so that old and new together can hold `cap` rows.
        pad_to = max(bucket_size(max(n_new, 1)), cap - self._grid.points.shape[0])
        pts, mask = _padded(xyz, pad_to, dev)
        f = None
        if self._grid.feats is not None:
            rows = np.zeros((0, self._grid.feats.shape[1]), np.float32) if feats is None else feats
            f = _padded(rows, pad_to, dev)[0]
        self._grid = extend_hash_grid(
            self._grid.points, self._grid.valid, self._grid.feats, pts, mask, f, self.voxel_size,
            origin_t, self.max_distance, cap=cap, max_points_per_voxel=self.max_points_per_voxel,
            evict=evict,
        )
        self._count_later()

    def update(self, points: np.ndarray, pose: np.ndarray = np.eye(4)):
        """Transform by `pose`, add, and evict the voxels far from the pose's
        origin (`VoxelHashMap.cpp:678-731`). The transform runs on the host
        in float64 in both stores, so both add the same f32 rows."""
        xyz, feats = self._split(points)
        pose = np.asarray(pose, dtype=np.float64)
        moved = (xyz.astype(np.float64) @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
        if self.device_resident:
            self._update_device(moved, feats, pose[:3, 3])
            return
        self.add_points(moved if feats is None else np.c_[moved, feats])
        self.remove_far_away_points(pose[:3, 3])

    def remove_far_away_points(self, origin: np.ndarray):
        """Evict the voxels whose FIRST point lies farther than max_distance
        from `origin` (`RemovePointsFarFromLocation`, `VoxelHashMap.cpp:772-796`).
        On the resident map it is a merge of no new rows with eviction (the
        reference's resident map drops its grid here instead). The host store
        also drops the points past each voxel's cap, as the reference's native
        store never keeps them: they are never exported or searched, and
        without them an odometry's store stays the size of its map."""
        if self._pending:
            self._flush_pending()
        if self.empty():
            return
        origin = np.asarray(origin, dtype=np.float64).reshape(3)
        if self.device_resident:
            self._merge_device(np.zeros((0, 3), np.float32), None, origin, evict=True)
            return
        # Each point's voxel by a stable sort: its rank there in insertion
        # order and the voxel's first point.
        keys = _voxel_keys(self._points, self.voxel_size)
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        row = np.arange(order.size)
        start = np.maximum.accumulate(np.where(np.r_[True, keys[1:] != keys[:-1]], row, 0))
        first_pts = self._points[order[start]]
        far = np.sum((first_pts - origin.astype(np.float32)) ** 2, axis=1) > self.max_distance**2
        keep = np.zeros(order.size, dtype=bool)
        keep[order] = ~far & (row - start < self.max_points_per_voxel)
        self._points = self._points[keep]
        if self._feats is not None:
            self._feats = self._feats[keep]
        self._grid = None

    # --------------------------------------------------------------- device side
    def device_grid(self) -> HashGrid:
        """The map's grid: the resident store itself, or the host store
        zero-padded to `bucket_size` rows on the map's device, capped per
        voxel and cached until the map changes."""
        if self._grid is None:
            feats = None if self._feats is None else torch.from_numpy(self._feats).to(self.device)
            self._grid = build_padded_grid(torch.from_numpy(self._points).to(self.device), feats,
                                           self.voxel_size, self.max_points_per_voxel)
        return self._grid

    # ---------------------------------------------------------------- query API
    def point_cloud(self) -> np.ndarray:
        """Capped stored points, [M, 3] in the grid's order (`Pointcloud`,
        `VoxelHashMap.cpp:628-660`)."""
        self._flush_pending()
        grid = self.device_grid()
        return grid.points[grid.valid].cpu().numpy()

    def point_cloud_n(self) -> np.ndarray:
        """Capped stored points with descriptors, [M, 3 + D] (`PointcloudN`)."""
        self._flush_pending()
        grid = self.device_grid()
        if grid.feats is None:
            raise ValueError("Map has no descriptors")
        return torch.cat([grid.points, grid.feats], dim=1)[grid.valid].cpu().numpy()

    def _queries(self, xyz: np.ndarray, feats: Optional[np.ndarray]):
        """Queries padded to `bucket_size` on the map's device: (xyz, feats, mask)."""
        n = bucket_size(max(xyz.shape[0], 1))
        q, qmask = _padded(xyz, n, self.device)
        qf = None if feats is None else _padded(feats, n, self.device)[0]
        return q, qf, qmask

    def get_correspondences(
        self, points: np.ndarray, max_correspondance_distance: float, xd: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        """27-voxel nearest map points within the distance
        (`GetCorrespondences`): (query rows [K, 3 + D], map points [K, 3]) of
        the accepted queries, in query order. Descriptor columns ride along
        but, as in the reference's Nd overload, do not weigh the search
        (`VoxelHashMap.cpp:246`); with `xd=True` and descriptors of the map's
        dim they do, as in the XD overload (`VoxelHashMap.cpp:320-455`:
        champion by d2 * clamp(0.5 * (1 - cos), 0.01, 1.0), acceptance
        Euclidean)."""
        self._flush_pending()
        pts = np.asarray(points)
        xyz, feats = self._split(pts)
        grid = self.device_grid()
        weighted = xd and feats is not None and grid.feats is not None and grid.feats.shape[1] == feats.shape[1]
        q, qf, qmask = self._queries(xyz, feats if weighted else None)
        if weighted:
            nbr, dist, found = nearest_neighbors_xd(grid, q, qf, qmask)
        else:
            nbr, dist, found = nearest_neighbors(grid, q, qmask)
        n0 = xyz.shape[0]
        accept = (found & (dist < max_correspondance_distance))[:n0].cpu().numpy()
        return pts[accept], nbr[:n0].cpu().numpy()[accept]

    def get_vfm_correspondences(
        self, points: np.ndarray, min_cosine_similarity: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Cosine 1-NN descriptor matches (`GetVFMCorrespondences`,
        `VoxelHashMap.cpp:461-626`): (scan points [K, 3], map points [K, 3])
        of the accepted queries, in query order. points: [N, 3 + D]."""
        self._flush_pending()
        xyz, feats = self._split(points)
        if feats is None:
            raise ValueError("get_vfm_correspondences needs descriptor points")
        grid = self.device_grid()
        if grid.feats is None:
            raise ValueError("Map has no descriptors")
        q, qf, qmask = self._queries(xyz, feats)
        corr = _device_vfm_corr(grid.points, grid.feats, grid.valid, q, qf, qmask,
                                min_cosine_similarity=min_cosine_similarity)
        m = corr.mask
        return corr.source[m].cpu().numpy(), corr.target[m].cpu().numpy()
