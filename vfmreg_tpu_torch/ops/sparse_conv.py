"""Gather-based sparse 3-D convolution: the MinkowskiEngine replacement.

Counterpart of `vfmreg_tpu/ops/sparse_conv.py`. For each kernel offset k
the in-coordinate `c_out + o_k` is looked up in a sorted index of the input
coordinates, its feature row gathered (zeros when absent), and
`feats_k @ W_k` accumulated: K gathers and K dense [N, C_in] x [C_in, C_out]
matmuls, in offset order, output-stationary (no scatter, so no float
atomics and the same sums on every run).

Coordinate convention (MinkowskiEngine's): a tensor at stride s has integer
coordinates that are multiples of s; stride-2 convolutions emit coordinates
floored to the next stride; transposed convolutions emit onto a cached
coordinate set (the U-Net skip level), connecting out y to in x when
x = y - o_k.

Kernel offset order (the weight-conversion contract): offsets enumerate
the cube [-r, r]^3 row-major with the last axis fastest,
index = (ox + r) e^2 + (oy + r) e + (oz + r), e the kernel edge, as
MinkowskiEngine's `RegionIterator` does for hyper-cube regions.

The index is an exact int64 key of the coordinates (`coord_key`, 21 bits an
axis; `descriptors.fcgf.sparse_quantize` finds its voxels by the same
key), sorted, and searched with
`torch.searchsorted`. The reference sorts a 32-bit hash and confirms the
coordinates over a 4-slot window; both give the same rows, except that the
reference reads a coordinate caught in a more than 4-way hash collision as
absent (ROADMAP, deliberate divergences). Coordinates must lie in
[-2^20, 2^20); a neighbour outside that range reads as absent.

`kernel_map` computes the rows of every offset once, so convolutions that
share an (input set, output set, offsets) triple share the lookups.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

COORD_BIAS = 1 << 20  # coordinates in [-2^20, 2^20) pack into 21 bits an axis
INVALID_KEY = torch.iinfo(torch.int64).max  # sorts after every packed key


def coord_key(coords: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer coordinates -> [...] int64 keys, x in the highest
    bits, so ascending keys are the lexicographic (x, y, z) order."""
    c = coords.to(torch.int64) + COORD_BIAS
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


def _in_range(coords: torch.Tensor) -> torch.Tensor:
    return ((coords >= -COORD_BIAS) & (coords < COORD_BIAS)).all(dim=-1)


class CoordLookup(NamedTuple):
    sorted_keys: torch.Tensor  # [N] int64 ascending, INVALID_KEY rows (masked) last
    row_of_sorted: torch.Tensor  # [N] int64: the input row of each sorted slot


def build_coord_lookup(coords: torch.Tensor, mask: torch.Tensor) -> CoordLookup:
    """The sorted index of coords [N, 3] (rows where `mask`). Of duplicate
    coordinates the lowest row is found (a stable sort)."""
    keys = torch.where(mask, coord_key(coords), INVALID_KEY)
    sorted_keys, order = torch.sort(keys, stable=True)
    return CoordLookup(sorted_keys=sorted_keys, row_of_sorted=order)


def lookup_rows(lookup: CoordLookup, coords: torch.Tensor, valid: torch.Tensor):
    """coords [M, 3] -> (row [M] int64, found [M] bool) in the indexed set;
    row 0 where not found, as the reference."""
    keys = coord_key(coords)
    pos = torch.searchsorted(lookup.sorted_keys, keys)
    pos = torch.clamp(pos, max=lookup.sorted_keys.shape[0] - 1)
    found = (lookup.sorted_keys[pos] == keys) & valid & _in_range(coords)
    row = torch.where(found, lookup.row_of_sorted[pos], 0)
    return row, found


def kernel_offsets(kernel_size: int, stride_units: int, order: str = "last_fastest") -> np.ndarray:
    """[K, 3] int32 offsets of a cubic kernel in lattice units."""
    r = (kernel_size - 1) // 2
    rng = range(-r, r + 1)
    if order == "last_fastest":
        offs = [(i, j, k) for i in rng for j in rng for k in rng]
    else:
        offs = [(k, j, i) for i in rng for j in rng for k in rng]
    return np.asarray(offs, dtype=np.int32) * stride_units


def _offset_rows(in_lookup, in_mask, out_coords, out_mask, off) -> torch.Tensor:
    """[N_out] int64 input row of `out + off`, or N_in (the zero row that
    `sparse_conv_apply_map` appends) where it is absent or masked."""
    row, found = lookup_rows(in_lookup, out_coords + off, out_mask)
    ok = found & in_mask[row]
    return torch.where(ok, row, in_mask.shape[0])


def kernel_map(in_lookup: CoordLookup, in_mask, out_coords, out_mask, offsets) -> torch.Tensor:
    """[K, N_out] int64 rows of every offset (`_offset_rows`)."""
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=out_coords.device)
    return torch.stack([_offset_rows(in_lookup, in_mask, out_coords, out_mask, o) for o in offs])


def sparse_conv_apply_map(in_feats: torch.Tensor, rows, out_mask: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """out[y] = sum_k feats[rows[k][y]] @ W_k, accumulated in offset order
    (the reference's scan), zero rows where `out_mask` is False. `rows` is a
    `kernel_map` or any sequence of its rows."""
    feats = torch.nn.functional.pad(in_feats.to(torch.float32), (0, 0, 0, 1))  # row N_in = 0
    acc = torch.zeros((out_mask.shape[0], weights.shape[-1]), dtype=torch.float32, device=feats.device)
    for r, W in zip(rows, weights):
        acc = acc + feats[r] @ W
    return torch.where(out_mask[:, None], acc, 0.0)


def sparse_conv_apply(
    in_feats: torch.Tensor,  # [N_in, C_in]
    in_coords: torch.Tensor,  # [N_in, 3]; the lookup holds them
    in_lookup: CoordLookup,
    in_mask: torch.Tensor,
    out_coords: torch.Tensor,  # [N_out, 3]
    out_mask: torch.Tensor,
    weights: torch.Tensor,  # [K, C_in, C_out]
    offsets,  # [K, 3]
) -> torch.Tensor:
    """out[y] = sum_k feats[x = y + o_k] @ W_k (zeros for absent x), the
    rows of one offset at a time: the form for a kernel whose map would be
    large (FCGF's 343-offset conv1)."""
    del in_coords  # identified through `in_lookup`, as the reference
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=out_coords.device)
    rows = (_offset_rows(in_lookup, in_mask, out_coords, out_mask, o) for o in offs)
    return sparse_conv_apply_map(in_feats, rows, out_mask, weights)


def downsample_coords(coords: torch.Tensor, mask: torch.Tensor, stride_units: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unique coordinates floored to multiples of 2 stride (a stride-2
    convolution's output), [N, 3] with the survivors at the front in
    lexicographic order, and their mask."""
    new_stride = 2 * stride_units
    floored = torch.div(coords, new_stride, rounding_mode="floor") * new_stride
    keys = torch.where(mask, coord_key(floored), INVALID_KEY)
    k_s, order = torch.sort(keys, stable=True)
    c_s, m_s = floored[order], mask[order]
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device), k_s[1:] != k_s[:-1]]) & m_s
    comp = torch.sort((~is_first).to(torch.int32), stable=True).indices
    return c_s[comp], is_first[comp]
