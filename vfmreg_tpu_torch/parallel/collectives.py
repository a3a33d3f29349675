"""The collective calls of the multi-device paths, recorded.

The reference's mesh programs reduce with `jax.lax.all_gather(tiled=True)`,
`pmin` and `psum` inside `shard_map`. Here each rank of a `torch.distributed`
group calls these with its own tensors: NCCL on the card, gloo on the CPU.
Every call made inside a `recording()` block is logged with its operation,
its bytes and its time (CUDA events around it on the card, the host clock
on the CPU), so a driver can count the collectives of a path and time them
(`collective_ms`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
import torch.distributed as dist

# The open `recording` blocks' logs.
_LOGS: List[List[dict]] = []


@contextlib.contextmanager
def recording():
    """A list that collects one record per collective call made inside the
    block: {"op", "bytes", "start", "end"} (CUDA events on the card, host
    seconds on the CPU)."""
    log: List[dict] = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS[:] = [other for other in _LOGS if other is not log]


def collective_ms(log: List[dict]) -> Dict[str, float]:
    """{"calls", "ms"}: the number of recorded calls and their summed time.
    On the card read it after a synchronize."""
    ms = 0.0
    for r in log:
        if isinstance(r["start"], float):
            ms += 1e3 * (r["end"] - r["start"])
        else:
            ms += r["start"].elapsed_time(r["end"])
    return {"calls": len(log), "ms": ms}


def _run(op: str, t: torch.Tensor, call):
    if not _LOGS:
        call()
        return
    cuda = t.device.type == "cuda"
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        start = time.perf_counter()
    call()
    if cuda:
        end.record()
    else:
        end = time.perf_counter()
    rec = {"op": op, "bytes": t.numel() * t.element_size(), "start": start, "end": end}
    for log in _LOGS:
        log.append(rec)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` in the group's rank order
    (`jax.lax.all_gather(..., tiled=True)`). Bool tensors travel as uint8."""
    world = dist.get_world_size(group)
    src = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    out = [torch.empty_like(src) for _ in range(world)]
    _run("all_gather", src, lambda: dist.all_gather(out, src, group=group))
    cat = torch.cat(out, dim=dim)
    return cat.to(torch.bool) if t.dtype == torch.bool else cat


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """`t` reduced over the group with `op` (`dist.ReduceOp.MIN` for `pmin`,
    `SUM` for `psum`, `MAX`), in place; returns `t`."""
    _run(f"all_reduce_{getattr(op, 'name', op)}".lower(), t, lambda: dist.all_reduce(t, op=op, group=group))
    return t
