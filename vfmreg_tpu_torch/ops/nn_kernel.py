"""Kernel B4: nearest cached champion per query.

Counterpart of `vfmreg_tpu/ops/nn_kernel.py:nn_argmin`, the distance and
arg-min step of `hash_grid.nn_from_cache`. Per query n, over the K cached
champions of the transposed cache cx, cy, cz [K, N]: d2 = dx*dx + dy*dy +
dz*dz in f32 (the 2e19 sentinel of a dead champion squares to +inf), best =
min_k d2 (NaN propagates, as `jnp.min`), and the lowest k with d2 == best,
or 2^30 when no row equals it (a NaN query).

The CUDA kernel is `csrc/nn_argmin.cu`; `nn_argmin_plain` is the same
function in plain PyTorch, written as the Pallas body is. The kernel equals
it bit for bit. The wrapper runs the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vfmreg_tpu_torch.ops import _build

NAME = "nn_argmin"
NO_ROW = 2**30  # best_k of a query whose minimum is NaN


def nn_argmin_plain(
    cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, queries: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_d2 [N] f32, best_k [N] int32) in plain PyTorch."""
    dx = cx - queries[:, 0]
    dy = cy - queries[:, 1]
    dz = cz - queries[:, 2]
    d2 = dx * dx + dy * dy + dz * dz  # sentinels overflow to +inf
    best = torch.amin(d2, dim=0)  # NaN propagates, as jnp.min
    iota = torch.arange(cx.shape[0], dtype=torch.int32, device=cx.device)[:, None]
    ksel = torch.amin(torch.where(d2 == best, iota, NO_ROW), dim=0)
    return best, ksel.to(torch.int32)


def _check(cx, cy, cz, queries):
    k, n = cx.shape
    for name, t, shape in (("cx", cx, (k, n)), ("cy", cy, (k, n)), ("cz", cz, (k, n)),
                           ("queries", queries, (n, 3))):
        if t.dtype != torch.float32:
            raise TypeError(f"{NAME}: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
        if t.device != cx.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, cx on {cx.device}")
    if k == 0 or n == 0:
        raise ValueError(f"{NAME}: empty cache [{k}, {n}]")


def nn_argmin(
    cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, queries: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_d2 [N] f32, +inf for an empty neighbourhood; best_k [N] int32,
    the lowest champion index at the minimum, 2^30 for a NaN query).

    cx, cy, cz: [K, N] champion cache (sentinel 2e19 in dead lanes);
    queries: [N, 3] current positions."""
    _check(cx, cy, cz, queries)
    if cx.device.type == "cpu":
        return nn_argmin_plain(cx, cy, cz, queries)
    if cx.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {cx.device}")

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.launcher(NAME, "nn_argmin_launch", [P] * 4 + [I] * 2 + [P] * 3)
    k, n = cx.shape
    best_d2 = torch.empty(n, dtype=torch.float32, device=cx.device)
    best_k = torch.empty(n, dtype=torch.int32, device=cx.device)
    stream = torch.cuda.current_stream(cx.device).cuda_stream
    err = fn(cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), queries.data_ptr(), k, n,
             best_d2.data_ptr(), best_k.data_ptr(), stream)
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
    return best_d2, best_k
