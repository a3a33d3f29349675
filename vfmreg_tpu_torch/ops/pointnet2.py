"""PointNet++ operators on batched fixed-shape tensors.

Counterpart of `vfmreg_tpu/ops/pointnet2.py:20-113` (GeDi's vendored
pointnet2_ops CUDA kernels): furthest-point sampling, gather, ball query,
grouping and three-NN interpolation, in plain PyTorch.

* `furthest_point_sampling` starts at index 0 and takes the first maximum
  of the running distance at each step (`torch.argmax` returns the first),
  so ties resolve as in the reference; `skip_near_origin` is the CUDA
  kernel's `mag <= 1e-3` guard.
* `ball_query` returns the first `nsample` in-ball points in index order
  and fills the short rows with the first hit; a centre with no hit gets
  index 0 throughout (the reference's argsort then gives position 0). The
  ranks come from a running count of the hits, not a sort, and the rows
  are processed in blocks of centres so that the [S, N] distances stay
  bounded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vfmreg_tpu_torch.ops.matching import _sq3

# Centres x points per block of `ball_query`'s distance matrix.
_BALL_BLOCK = 1 << 26


def furthest_point_sampling(
    xyz: torch.Tensor, npoint: int, mask: Optional[torch.Tensor] = None, skip_near_origin: bool = False
) -> torch.Tensor:
    """[B, N, 3] -> [B, npoint] int64 indices, starting from index 0."""
    b, n, _ = xyz.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    if skip_near_origin:
        mask = mask & (_sq3(xyz) > 1e-3)
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    min_d2 = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = idx[:, 0]
    for i in range(1, npoint):
        d2 = _sq3(xyz - xyz[rows, last][:, None, :])
        min_d2 = torch.where(mask, torch.minimum(min_d2, d2), -1e10)
        last = torch.argmax(min_d2, dim=1)
        idx[:, i] = last
    return idx


def gather_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, C, N], [B, S] -> [B, C, S]."""
    return torch.gather(features, 2, idx[:, None, :].expand(-1, features.shape[1], -1))


def ball_query(radius, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, N, 3], [B, S, 3] -> [B, S, nsample] int64 indices of the first
    `nsample` points within `radius` of each centre, in index order, short
    rows filled with the first."""
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    r2 = torch.tensor(radius, dtype=torch.float32, device=xyz.device) ** 2
    out = torch.empty((b, s, nsample), dtype=torch.int64, device=xyz.device)
    block = max(1, _BALL_BLOCK // max(b * n, 1))
    slot = torch.arange(nsample, device=xyz.device)
    for c0 in range(0, s, block):
        c = new_xyz[:, c0 : c0 + block]
        dx = c[:, :, None, 0] - xyz[:, None, :, 0]
        dy = c[:, :, None, 1] - xyz[:, None, :, 1]
        dz = c[:, :, None, 2] - xyz[:, None, :, 2]
        in_ball = ((dx * dx + dy * dy) + dz * dz < r2) & mask[:, None, :]  # [B, s', N]
        del dx, dy, dz
        rank = torch.cumsum(in_ball.to(torch.int32), dim=-1)
        count = rank[..., -1:]
        # The in-ball point of rank r <= nsample lands in slot r - 1; every
        # other point in a spare column.
        target = torch.where(in_ball & (rank <= nsample), rank - 1, nsample).to(torch.int64)
        del rank, in_ball
        cols = torch.full(target.shape[:-1] + (nsample + 1,), n, dtype=torch.int64, device=xyz.device)
        cols.scatter_reduce_(-1, target, torch.arange(n, device=xyz.device).expand_as(target), "amin")
        cols = cols[..., :nsample]
        head = torch.where(count > 0, cols[..., :1], 0)
        out[:, c0 : c0 + block] = torch.where(slot < count, cols, head)
    return out


def grouping_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, C, N], [B, S, k] -> [B, C, S, k]."""
    b, c, _ = features.shape
    _, s, k = idx.shape
    g = torch.gather(features, 2, idx.reshape(b, 1, s * k).expand(-1, c, -1))
    return g.reshape(b, c, s, k)


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, U, 3], [B, K, 3] -> (dist [B, U, 3], idx [B, U, 3]) of the three
    nearest known points, nearest first, ties to the lower index."""
    from vfmreg_tpu_torch.ops.knn import stable_smallest

    d2 = _sq3(unknown[:, :, None, :] - known[:, None, :, :])
    b, u, k = d2.shape
    idx = stable_smallest(d2.reshape(b * u, k), 3).reshape(b, u, 3)
    top = torch.gather(d2, 2, idx)
    return torch.sqrt(torch.clamp(top, min=0.0)), idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """[B, C, K], [B, U, 3], [B, U, 3] -> [B, C, U] weighted sums."""
    g = grouping_operation(features, idx)  # [B, C, U, 3]
    return (g * weight[:, None, :, :]).sum(dim=-1)
