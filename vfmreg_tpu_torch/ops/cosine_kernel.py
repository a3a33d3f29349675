"""Kernel B1: masked cosine arg-max without the [N, M] similarity matrix.

Counterpart of `vfmreg_tpu/ops/cosine_kernel.py:cosine_argmax`. The CUDA
kernel is `csrc/cosine_argmax.cu`; `cosine_argmax_plain` is the same function
in plain PyTorch, streamed over M in chunks (the reference's
`_chunked_argmax_ip`, under the kernel's masking contract). The wrapper runs
the plain version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.

Contract: masked rows score -1e30 (not -inf); ties go to the lowest index; a
query whose every row is masked gets (-1e30, 0); the index is clamped to M-1.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vfmreg_tpu_torch.ops import _build

NAME = "cosine_argmax"
_NEG = -1e30
# Tile sizes of the CUDA kernel: database rows per tile (BM) and queries per
# block (BQ) in the source.
_BM = 128
_BQ = 128


def cosine_argmax_plain(
    queries: torch.Tensor, database: torch.Tensor, db_mask: torch.Tensor, chunk: int = 4096
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_sim [N] f32, best_idx [N] int32) in plain PyTorch."""
    n, m = queries.shape[0], database.shape[0]
    best_sim = torch.full((n,), _NEG, dtype=torch.float32, device=queries.device)
    best_idx = torch.zeros(n, dtype=torch.int64, device=queries.device)
    for off in range(0, m, chunk):
        sim = queries @ database[off : off + chunk].T
        sim = torch.where(db_mask[None, off : off + chunk], sim, _NEG)
        s, j = torch.max(sim, dim=1)  # first maximum within the chunk
        better = s > best_sim  # strict across chunks: lowest index wins
        best_sim = torch.where(better, s, best_sim)
        best_idx = torch.where(better, j + off, best_idx)
    return best_sim, torch.clamp(best_idx, max=m - 1).to(torch.int32)


def _check(queries, database, db_mask):
    for name, t, dt in (("queries", queries, torch.float32), ("database", database, torch.float32),
                        ("db_mask", db_mask, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"{NAME}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
        if t.device != queries.device:
            raise ValueError(f"{NAME}: {name} is on {t.device}, queries on {queries.device}")
    if queries.ndim != 2 or database.ndim != 2 or queries.shape[1] != database.shape[1]:
        raise ValueError(f"{NAME}: shapes {tuple(queries.shape)} and {tuple(database.shape)}")
    if db_mask.shape != (database.shape[0],):
        raise ValueError(f"{NAME}: db_mask shape {tuple(db_mask.shape)}")
    if queries.shape[0] == 0 or database.shape[0] == 0:
        raise ValueError(f"{NAME}: empty input")


def _tiles_per_split(n: int, m_tiles: int, device: torch.device) -> int:
    """Split M so that about eight blocks per SM are launched (the result
    does not depend on the split)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-n // _BQ)
    splits = max(1, min(m_tiles, -(-8 * sms // q_tiles)))
    return -(-m_tiles // splits)


def cosine_argmax(
    queries: torch.Tensor, database: torch.Tensor, db_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_sim [N] f32, best_idx [N] int32) of the masked inner-product
    arg-max of pre-normalized queries [N, D] against database [M, D]."""
    _check(queries, database, db_mask)
    if queries.device.type == "cpu":
        return cosine_argmax_plain(queries, database, db_mask)
    if queries.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {queries.device}")

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.launcher(NAME, "cosine_argmax_launch", [P] * 7 + [I] * 4 + [P])
    n, d = queries.shape
    m = database.shape[0]
    m_tiles = -(-m // _BM)
    tps = _tiles_per_split(n, m_tiles, queries.device)
    splits = -(-m_tiles // tps)
    part_sim = torch.empty((splits, n), dtype=torch.float32, device=queries.device)
    part_idx = torch.empty((splits, n), dtype=torch.int32, device=queries.device)
    out_sim = torch.empty(n, dtype=torch.float32, device=queries.device)
    out_idx = torch.empty(n, dtype=torch.int32, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = fn(
        queries.data_ptr(), database.data_ptr(), db_mask.data_ptr(),
        part_sim.data_ptr(), part_idx.data_ptr(), out_sim.data_ptr(), out_idx.data_ptr(),
        n, m, d, tps, stream,
    )
    _build.LAUNCHES[NAME] += 1
    _build.check(err, NAME)
    return out_sim, out_idx
