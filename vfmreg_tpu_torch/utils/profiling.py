"""Structured timing and profiler integration.

Counterpart of `vfmreg_tpu/utils/profiling.py`: a wall-clock `Timer` of
named spans, `summarize_durations`, and `trace` / `annotate` on
`torch.profiler` (the reference wraps `jax.profiler`). A span's time on the
host clock holds the device's work only where the span ends in a
synchronize; `trace` records the card's kernels besides.

`span` marks the program's layer boundaries (the scan-to-map entry, the
method row's stages, the grid, the queries, the matching, VFM-ICP and the
ICP lane loop). Under a recording profiler each is a `vfmreg.<name>` range
on the profiler's clock, beside the card's kernels; with a `Timer` it is a
stage clock that ends in a synchronize; otherwise it costs one check.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class Timer:
    """Accumulating named spans: `with timer.span("icp"): ...`; `timer.report()`."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            total, n = self.totals[name], self.counts[name]
            lines.append(f"{name:<32} {total:8.3f}s  x{n:<5} avg {1e3 * total / n:8.2f}ms")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


GLOBAL_TIMER = Timer()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """A `torch.profiler` trace of the block (the host's operations, and the
    card's kernels where CUDA is available), written as a Chrome trace
    `trace_<pid>.json` into `log_dir`; with `log_dir` None, nothing."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


SPAN_PREFIX = "vfmreg."
_NOTHING = contextlib.nullcontext()


def span(name: str, timer: Optional[Timer] = None, device=None):
    """A span of the program named `name`, as a context manager:

    * while a profiler records, a host range `vfmreg.<name>` on its clock,
      nested in the range of the span that encloses it. It is recorded as a
      function's range, not as a user annotation (`record_function`): the
      profiler gives a kernel's device-side range to the innermost user
      annotation around its launch, and a span must not take the kernels
      from an annotation that a caller put around the program;
    * with `timer`, the block's host seconds added to `timer` under `name`
      after a synchronize of `device` where it is a CUDA device;
    * with neither, nothing beyond the one check."""
    recording = torch.autograd._profiler_enabled()
    if timer is None and not recording:
        return _NOTHING
    return _span(name, timer, device, recording)


@contextlib.contextmanager
def _span(name: str, timer: Optional[Timer], device, recording: bool) -> Iterator[None]:
    mark = torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name) if recording else _NOTHING
    clock = timer.span(name) if timer is not None else _NOTHING
    with mark, clock:
        yield
        if timer is not None and device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in traces (`torch.profiler.record_function`)."""
    with torch.profiler.record_function(name):
        yield


def summarize_durations(durations_s) -> Dict[str, float]:
    d = np.asarray(list(durations_s))
    if d.size == 0:
        return {}
    return {
        "mean_ms": float(d.mean() * 1e3),
        "p50_ms": float(np.percentile(d, 50) * 1e3),
        "p95_ms": float(np.percentile(d, 95) * 1e3),
        "max_ms": float(d.max() * 1e3),
        "fps": float(1.0 / d.mean()),
    }
