"""The yardstick's peaks and the operation and byte counts of the kernels
whose rooflines the benchmark reports.

Peaks of one NVIDIA H100 SXM5 80 GB from NVIDIA's data sheet (dense rates,
no sparsity), which assume the card's full 700 W power limit: each run
prints the card's `power.limit` beside them (`power_limit`).
"""

from __future__ import annotations

import subprocess
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12  # tensor cores, dense
F32_FLOPS = 67e12  # CUDA cores


def cosine_argmax_work(live_queries: int, valid_rows: int, dim: int, rows: int) -> tuple:
    """(flops, bytes) of one masked cosine arg-max (kernel B1): 2 q m D
    multiply-adds' flops over the live queries and the valid map rows; the
    live queries' and valid rows' descriptors read once (f32), the row mask
    read once (1 byte a row) and one (similarity, index) pair written per
    live query (8 bytes)."""
    flops = 2.0 * live_queries * valid_rows * dim
    nbytes = 4.0 * (live_queries * dim + valid_rows * dim) + rows + 8.0 * live_queries
    return flops, nbytes


def cosine_argmax_seconds(live_queries: int, valid_rows: int, dim: int, rows: int) -> float:
    """The least time of that work on the card: B1 runs its f32 products as
    three TF32 products on the tensor cores (3xTF32), so the operations
    bound is 3 x flops at the TF32 peak; the larger of it and the bytes at
    the HBM bandwidth."""
    flops, nbytes = cosine_argmax_work(live_queries, valid_rows, dim, rows)
    return max(3.0 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def matching_work(map_points, map_feats, map_mask, scan_points, scan_feats, scan_mask, *args, **kwargs) -> tuple:
    """`cosine_argmax_seconds`' arguments for one call of the program's
    `get_vfm_correspondences_batched`, counted from its arguments: (live
    queries, valid map rows, descriptor width, map rows)."""
    return (int(scan_mask.sum()), int(map_mask.sum()), int(map_feats.shape[1]), int(map_feats.shape[0]))


def power_limit() -> Optional[str]:
    """The card's name and power limit as `nvidia-smi` reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None
