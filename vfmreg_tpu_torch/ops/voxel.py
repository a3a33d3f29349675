"""Voxelization primitives on fixed-shape masked tensors.

Counterpart of `vfmreg_tpu/ops/voxel.py`. Point clouds are `(points[N,3],
mask[N])`; "filtering" compacts survivors to the front with a stable sort, and
first-point-wins downsampling is a stable sort by voxel hash plus run starts.

The hash is the reference's uint32 arithmetic, which wraps around. PyTorch
has no full uint32 arithmetic, so hashes live in int64 holding values in
[0, 2^32) and every multiply is reduced mod 2^32. Hashes must match the
reference bit for bit: the grid sorts by them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

INVALID_HASH = 0xFFFFFFFF  # sorts last, like the reference's uint32 sentinel
_MASK32 = 0xFFFFFFFF


def voxel_coords(points: torch.Tensor, voxel_size) -> torch.Tensor:
    """Integer voxel coordinates, truncated toward zero. (..., 3) f32 -> int32."""
    return torch.trunc(points / voxel_size).to(torch.int32)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) without int64 overflow: split a
    into 16-bit halves so that each partial product stays below 2^48."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def voxel_hash(coords: torch.Tensor) -> torch.Tensor:
    """32-bit spatial hash of int32 voxel coords (..., 3) -> int64 in [0, 2^32).

    Multiplicative chain plus the murmur3 fmix32 finalizer, as the reference.
    `& _MASK32` of the int64 coordinate is the reference's two's-complement
    `astype(uint32)` of a negative int32."""
    c = coords.to(torch.int64) & _MASK32
    h = _mul32(c[..., 0], 0x9E3779B1)
    h = _mul32((h + c[..., 1]) & _MASK32, 0x85EBCA77)
    h = _mul32((h + c[..., 2]) & _MASK32, 0xC2B2AE3D)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def int32_view(h: torch.Tensor) -> torch.Tensor:
    """The int32 bit pattern of a uint32 value held in int64 (the reference's
    `h.astype(int32)`), computed without relying on narrowing casts."""
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def compact_by_mask(mask: torch.Tensor, *arrays: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Stable-compact selected rows to the front. Returns (mask_sorted, *gathered)."""
    order = torch.sort((~mask).to(torch.int32), stable=True).indices
    return (mask[order],) + tuple(a[order] for a in arrays)


def voxel_down_sample_masked(
    points: torch.Tensor,
    voxel_size,
    mask: Optional[torch.Tensor] = None,
    feats: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """First-point-wins voxel downsample on padded tensors.

    Returns (points_out[N,3], feats_out[N,D] or None, mask_out[N]) with the
    representatives compacted to the front in input order."""
    n = points.shape[0]
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=points.device)

    coords = voxel_coords(points, voxel_size)
    h = torch.where(mask, voxel_hash(coords), INVALID_HASH)
    order = torch.sort(h, stable=True).indices
    h_s = h[order]
    coords_s = coords[order]

    # Run starts: hash change or coordinate change (a collision splits a run).
    same = (h_s[1:] == h_s[:-1]) & torch.all(coords_s[1:] == coords_s[:-1], dim=-1)
    prev_same = torch.cat([torch.zeros(1, dtype=torch.bool, device=h.device), same])
    selected = mask[order] & ~prev_same

    # Back to input order before compacting, so chained downsamples keep
    # first-in-insertion-order semantics at every stage.
    sel_orig = torch.empty_like(selected)
    sel_orig[order] = selected

    arrays = (points,) if feats is None else (points, feats)
    compacted = compact_by_mask(sel_orig, *arrays)
    feats_out = compacted[2] if feats is not None else None
    return compacted[1], feats_out, compacted[0]
