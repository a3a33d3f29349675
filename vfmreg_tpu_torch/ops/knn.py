"""Radius-limited k-NN on the voxel hash grid.

Counterpart of `vfmreg_tpu/ops/knn.py:31`: the hybrid search (at most `k`
neighbours within `radius`) that FPFH's normals and histograms and the DIP
and GeDi patches run. The candidates are the 27-voxel slab gather of
`ops/hash_grid.gather_candidate_slabs`, so the radius must not exceed the
grid's voxel size and a voxel contributes at most its first
`max_points_per_voxel` points, as in the reference.

The reference ranks the candidates with `lax.top_k`, which keeps the lower
candidate position when two distances tie (duplicate points). `torch.topk`
promises no order on ties, so the ranking key here is unique: the squared
distance's f32 bits (a nonnegative float orders as its bit pattern) in the
high word and the candidate position in the low word of one int64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vfmreg_tpu_torch.ops.hash_grid import HashGrid, gather_candidate_slabs


class RadiusKNN(NamedTuple):
    idx: torch.Tensor  # [N, k] int64 rows of grid.points (the grid's sorted order)
    dist: torch.Tensor  # [N, k] f32, inf where not a neighbour
    mask: torch.Tensor  # [N, k] bool: a neighbour within the radius


def stable_smallest(values: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest of each row of nonnegative f32 `values`
    [N, K] (+inf allowed), ascending, ties to the lower position: the order
    `lax.top_k(-values, k)` gives."""
    bits = values.contiguous().view(torch.int32).to(torch.int64)
    pos = torch.arange(values.shape[-1], dtype=torch.int64, device=values.device)
    key = (bits << 32) | pos
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).indices


def radius_knn(
    grid: HashGrid,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    k: int,
    radius,
    exclude_self: bool = False,
) -> RadiusKNN:
    """The k nearest grid points within `radius` of each query [N, 3].
    `exclude_self=True` drops exact-zero-distance hits (a query that is a
    grid point itself). Slots past a query's neighbours hold row 0."""
    n = queries.shape[0]
    radius2 = torch.tensor(radius, dtype=torch.float32, device=queries.device) ** 2
    cands = gather_candidate_slabs(grid, queries, query_mask)
    xs, ys, zs = cands.coords()
    dx = xs - queries[:, None, 0:1]
    dy = ys - queries[:, None, 1:2]
    dz = zs - queries[:, None, 2:3]
    d2_all = (dx * dx + dy * dy + dz * dz).reshape(n, -1)
    rows = cands.rowids().reshape(n, -1)
    # Dead lanes hold the coordinate sentinel as their row id; keep it in range.
    idx_all = torch.where(rows < grid.points.shape[0], rows, 0.0).to(torch.int64)

    within = d2_all <= radius2
    if exclude_self:
        within = within & (d2_all > 1e-12)
    d2_all = torch.where(within, d2_all, float("inf"))

    top_pos = stable_smallest(d2_all, k)
    top_d2 = torch.gather(d2_all, 1, top_pos)
    top_idx = torch.gather(idx_all, 1, top_pos)
    valid = torch.isfinite(top_d2) & query_mask[:, None]
    return RadiusKNN(
        idx=torch.where(valid, top_idx, 0),
        dist=torch.sqrt(torch.where(valid, top_d2, float("inf"))),
        mask=valid,
    )
