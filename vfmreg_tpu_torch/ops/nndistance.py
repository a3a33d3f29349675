"""Bidirectional nearest-neighbour (Chamfer) distance between batched clouds.

Counterpart of `vfmreg_tpu/ops/nndistance.py` (DIP's torch-nndistance
extension): for xyz1 [B, N, 3] and xyz2 [B, M, 3], the squared distance of
every point to the other cloud and the index of its nearest point, first
index on ties; autograd flows through the minimum.
"""

from __future__ import annotations

from typing import Tuple

import torch


def nn_distance(
    xyz1: torch.Tensor, xyz2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dist1 [B, N], idx1 [B, N], dist2 [B, M], idx2 [B, M]): squared NN
    distances and int32 indices."""
    d2 = ((xyz1[:, :, None, :] - xyz2[:, None, :, :]) ** 2).sum(dim=-1)  # [B, N, M]
    dist1, idx1 = torch.min(d2, dim=2)
    dist2, idx2 = torch.min(d2, dim=1)
    return dist1, idx1.to(torch.int32), dist2, idx2.to(torch.int32)


def chamfer_loss(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    d1, _, d2, _ = nn_distance(xyz1, xyz2)
    return d1.mean() + d2.mean()
