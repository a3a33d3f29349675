"""State carried across from the JAX package: the map index.

Scan-to-map registration has no learned weights; its state is the voxel hash
grid of the map. `grid_from_numpy` takes the arrays of a `vfmreg_tpu`
`HashGrid` (as numpy arrays, so this module needs no JAX) and returns the
port's `HashGrid` with the same layout, which lets the tests check matching
and ICP apart from the grid build.
"""

from __future__ import annotations

import numpy as np
import torch

from vfmreg_tpu_torch.ops.hash_grid import HashGrid
from vfmreg_tpu_torch.utils.device import resolve_device


def grid_from_numpy(
    table, points, bucket_slab, feats, valid, voxel_size, max_points_per_voxel: int, device=None
) -> HashGrid:
    """The port's `HashGrid` from the reference grid's arrays
    (`table` [H/2, 24] int32, `points` [M, 3], `bucket_slab` [R, 128],
    `feats` [M, D] or None, `valid` [M] bool), on `device` (default: the card)."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    table = put(table, np.int32)
    if table.ndim != 2 or table.shape[1] != 24:
        raise ValueError(f"table must be [H/2, 24], got {tuple(table.shape)}")
    return HashGrid(
        table=table,
        points=put(points, np.float32),
        bucket_slab=put(bucket_slab, np.float32),
        feats=None if feats is None else put(feats, np.float32),
        valid=put(valid, np.bool_),
        voxel_size=float(np.asarray(voxel_size)),
        max_points_per_voxel=int(max_points_per_voxel),
    )
