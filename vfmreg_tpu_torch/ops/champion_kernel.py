"""Kernel B3: single-pass champion-cache rebuild from transposed candidates.

Counterpart of `vfmreg_tpu/ops/champion_kernel.py:champions_from_planes`.
The geometric ICP loop (`registration/icp.py`) transposes each slab
gather once (`Candidates.planes`) and rebuilds the per-voxel champions from
it with one streaming pass per rebuild: per (voxel group, query) the in-voxel
nearest candidate, as three [32, N] planes (rows 27..31 the sentinel). The
result is bit-identical to `hash_grid.build_nn_cache`'s cx / cy / cz: the
same f32 squared distance, lowest row on ties, alive = finite minimum and
query mask, else INVALID_COORD. The geometric path never reads the cache's
row ids, so none are produced.

The CUDA kernel is `csrc/champions_from_planes.cu`;
`champions_from_planes_plain` is the same function in plain PyTorch, written
as the Pallas body is (minimum, first row equal to it, one-hot select). The
wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vfmreg_tpu_torch.ops import _build
from vfmreg_tpu_torch.ops.hash_grid import INVALID_COORD

NAME = "champions_from_planes"
_K = 32  # rows of the champion planes
_BIG = 2**30


def champions_from_planes_plain(
    cxt: torch.Tensor, cyt: torch.Tensor, czt: torch.Tensor,
    queries: torch.Tensor, query_mask: torch.Tensor, group: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cx, cy, cz) [32, N] in plain PyTorch."""
    kg, n = cxt.shape
    v = kg // group
    xs, ys, zs = (a.reshape(v, group, n) for a in (cxt, cyt, czt))
    dx = xs - queries[:, 0]
    dy = ys - queries[:, 1]
    dz = zs - queries[:, 2]
    d2 = dx * dx + dy * dy + dz * dz  # sentinels overflow to +inf
    best = torch.amin(d2, dim=1, keepdim=True)  # NaN propagates, as jnp.min
    iota = torch.arange(group, device=cxt.device)[None, :, None]
    ksel = torch.amin(torch.where(d2 == best, iota, _BIG), dim=1, keepdim=True)
    onehot = iota == ksel
    alive = torch.isfinite(best[:, 0]) & query_mask[None, :]
    pad = torch.full((_K - v, n), INVALID_COORD, dtype=torch.float32, device=cxt.device)

    def plane(a):
        champ = torch.sum(torch.where(onehot, a, 0.0), dim=1)
        return torch.cat([torch.where(alive, champ, INVALID_COORD), pad])

    return plane(xs), plane(ys), plane(zs)


def _check(cxt, cyt, czt, queries, query_mask, group):
    kg, n = cxt.shape
    if group <= 0 or kg % group or kg // group > _K:
        raise ValueError(f"{NAME}: {kg} rows do not make at most {_K} groups of {group}")
    for name, t, shape, dt in (
        ("cxt", cxt, (kg, n), torch.float32), ("cyt", cyt, (kg, n), torch.float32),
        ("czt", czt, (kg, n), torch.float32), ("queries", queries, (n, 3), torch.float32),
        ("query_mask", query_mask, (n,), torch.bool),
    ):
        if t.dtype != dt:
            raise TypeError(f"{NAME}: {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
        if t.device != cxt.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, cxt on {cxt.device}")
    if n == 0:
        raise ValueError(f"{NAME}: no queries")


def champions_from_planes(
    cxt: torch.Tensor, cyt: torch.Tensor, czt: torch.Tensor,
    queries: torch.Tensor, query_mask: torch.Tensor, group: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cx, cy, cz) champion planes [32, N] (see the module docstring).

    cxt, cyt, czt: [27 * group, N] candidate planes (`Candidates.planes`);
    queries: [N, 3] current source positions; query_mask: [N] bool."""
    _check(cxt, cyt, czt, queries, query_mask, group)
    if cxt.device.type == "cpu":
        return champions_from_planes_plain(cxt, cyt, czt, queries, query_mask, group)
    if cxt.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {cxt.device}")

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.launcher(NAME, "champions_from_planes_launch", [P] * 5 + [I] * 3 + [P] * 4)
    kg, n = cxt.shape
    out = torch.empty((3, _K, n), dtype=torch.float32, device=cxt.device)
    stream = torch.cuda.current_stream(cxt.device).cuda_stream
    err = fn(
        cxt.data_ptr(), cyt.data_ptr(), czt.data_ptr(), queries.data_ptr(),
        query_mask.data_ptr(), kg // group, group, n,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream,
    )
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
    return out[0], out[1], out[2]
