"""Kernel B1: masked cosine arg-max without the [N, M] similarity matrix.

Counterpart of `vfmreg_tpu/ops/cosine_kernel.py:cosine_argmax`. The CUDA
kernel is `csrc/cosine_argmax.cu` (its products in 3xTF32 on the tensor
cores); `cosine_argmax_plain` is the same function in plain PyTorch,
streamed over M in chunks (the reference's `_chunked_argmax_ip`, under the
kernel's masking contract). The wrapper runs
the plain version for CPU tensors only; for CUDA tensors it launches the
kernel or raises.

Contract: masked rows score -1e30 (not -inf); ties go to the lowest index; a
query whose every row is masked gets (-1e30, 0); the index is clamped to M-1.
A query row that `q_mask` marks false gets (-1e30, 0) too, the fill and not a
similarity: the kernel computes only the live rows, and a live row's result
is the one it gets with every row live, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from vfmreg_tpu_torch.ops import _build

NAME = "cosine_argmax"
_NEG = -1e30
# Tile sizes of the CUDA kernel: database rows per tile (BM) and queries per
# block (BQ) in the source.
_BM = 128
_BQ = 128


def cosine_argmax_plain(
    queries: torch.Tensor, database: torch.Tensor, db_mask: torch.Tensor,
    q_mask: Optional[torch.Tensor] = None, chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_sim [N] f32, best_idx [N] int32) in plain PyTorch; rows that
    `q_mask` marks false get the fill (-1e30, 0)."""
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
    if q_mask is not None:
        best_sim = torch.where(q_mask, best_sim, _NEG)
        best_idx = torch.where(q_mask, best_idx, 0)
    return best_sim, torch.clamp(best_idx, max=m - 1).to(torch.int32)


def _check(queries, database, db_mask, q_mask):
    args = [("queries", queries, torch.float32), ("database", database, torch.float32),
            ("db_mask", db_mask, torch.bool)]
    if q_mask is not None:
        args.append(("q_mask", q_mask, torch.bool))
    for name, t, dt in args:
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
    if q_mask is not None and q_mask.shape != (queries.shape[0],):
        raise ValueError(f"{NAME}: q_mask shape {tuple(q_mask.shape)}")
    if queries.shape[0] == 0 or database.shape[0] == 0:
        raise ValueError(f"{NAME}: empty input")
    if queries.numel() >= 2**31:
        raise ValueError(f"{NAME}: {tuple(queries.shape)} queries: the kernel offsets them in 32 bits")


def _split_plan(live_tiles: int, m_tiles: int, target: int, capacity: Optional[int] = None) -> Tuple[int, int]:
    """(tiles per split, splits) of M for `live_tiles` tiles of live queries:
    about `target` blocks, at most `capacity`. The kernel's `split_plan`,
    which decides on the card from the live count, is the same function; the
    host calls it with every row live, for the grid it launches (the result
    does not depend on the split)."""
    s = min(m_tiles, -(-target // live_tiles))
    if capacity is not None:
        s = min(s, capacity // live_tiles)
    tps = -(-m_tiles // max(1, s))
    return tps, -(-m_tiles // tps)


def _target_blocks(device: torch.device) -> int:
    """About eight blocks per SM: four waves of the kernel's two resident
    blocks per SM, so the last wave's tail is short."""
    return 8 * torch.cuda.get_device_properties(device).multi_processor_count


# Query rows handed to the kernel (counted on the host), and, per device, the
# live rows it computed (an int64 on the card that the compaction step adds
# to): read by `row_stats`, never on the timed path.
_rows_passed = 0
_live_rows: Dict[torch.device, torch.Tensor] = {}


def row_stats() -> Dict[str, int]:
    """{"rows_passed", "live_rows"} of the kernel's calls since
    `reset_row_stats`. Reads the card (a synchronisation): for tools and
    tests."""
    return {"rows_passed": _rows_passed, "live_rows": sum(int(t.item()) for t in _live_rows.values())}


def reset_row_stats() -> None:
    global _rows_passed
    _rows_passed = 0
    for t in _live_rows.values():
        t.zero_()


def cosine_argmax(
    queries: torch.Tensor, database: torch.Tensor, db_mask: torch.Tensor, q_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_sim [N] f32, best_idx [N] int32) of the masked inner-product
    arg-max of pre-normalized queries [N, D] against database [M, D].
    `q_mask` [N] (None: every row) marks the live queries: the kernel
    computes only those, and the others get (-1e30, 0). Nothing is read
    back to the host, so the call can be captured in a CUDA graph (after a
    first call on the device)."""
    global _rows_passed
    _check(queries, database, db_mask, q_mask)
    if queries.device.type == "cpu":
        return cosine_argmax_plain(queries, database, db_mask, q_mask)
    if queries.device.type != "cuda":
        raise ValueError(f"{NAME}: unsupported device {queries.device}")

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.launcher(NAME, "cosine_argmax_launch", [P] * 10 + [I] * 5 + [P])
    dev = queries.device
    n, d = queries.shape
    m = database.shape[0]
    q_tiles = -(-n // _BQ)
    target = _target_blocks(dev)
    capacity = q_tiles * _split_plan(q_tiles, -(-m // _BM), target)[1]
    live_rows = _live_rows.get(dev)
    if live_rows is None:
        live_rows = _live_rows[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    rows = torch.empty(n + 1, dtype=torch.int32, device=dev)  # the live list, then its count
    part_sim = torch.empty(capacity * _BQ, dtype=torch.float32, device=dev)
    part_idx = torch.empty(capacity * _BQ, dtype=torch.int32, device=dev)
    out_sim = torch.empty(n, dtype=torch.float32, device=dev)
    out_idx = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        queries.data_ptr(), database.data_ptr(), db_mask.data_ptr(),
        None if q_mask is None else q_mask.data_ptr(), rows.data_ptr(),
        part_sim.data_ptr(), part_idx.data_ptr(), out_sim.data_ptr(), out_idx.data_ptr(), live_rows.data_ptr(),
        n, m, d, target, capacity, stream,
    )
    _build.LAUNCHES[NAME] += 1
    _rows_passed += n
    _build.check(err, NAME)
    return out_sim, out_idx
