"""The program's own spans in the traced window, beside the card's operations.

The program marks its layer boundaries (`vfmreg_tpu_torch.utils.profiling
.span`): each is a host range `vfmreg.<name>` on the profiler's clock, in
the thread that ran the window (`ctx["host"]`), as are the card's
operations (`ctx["ops"]`) and the CUDA runtime's launch calls. An idle
interval is a stretch of the window (`bench.window`) in which no device
operation runs. A layer's idle time is the length of the idle intervals
that its spans' host extent overlaps, whatever the span runs inside it: the
card waited while that layer's host code ran. Where the trace holds no
device operation (the CPU) or no such span (a program without it), the
readers give None.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.harness import union_intervals as union

PREFIX = "vfmreg."
WINDOW = "bench.window"
# The kernel-launch calls of the CUDA runtime and driver that the profiler records on the H100's host for
# PyTorch's kernels and the ctypes-loaded ones.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")

Interval = Tuple[float, float]


def overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def window(ctx: Dict) -> Optional[Interval]:
    """The traced window's host extent (us)."""
    for name, a, b in ctx.get("host", []):
        if name == WINDOW:
            return (a, b)
    return None


def idle(ctx: Dict) -> List[Interval]:
    """The window's idle intervals: where no device operation runs."""
    w = window(ctx)
    if w is None or not ctx.get("ops"):
        return []
    busy = union((max(a, w[0]), min(b, w[1])) for _, a, b, _ in ctx["ops"] if b > w[0] and a < w[1])
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]


def extents(ctx: Dict, names: Iterable[str]) -> List[Interval]:
    """The union of the host extents of the spans `vfmreg.<name>` for each of `names`."""
    wanted = {PREFIX + n for n in names}
    return union((a, b) for name, a, b in ctx.get("host", []) if name in wanted)


def idle_ms(ctx: Dict, names: Iterable[str]) -> Optional[float]:
    """Idle time of the card that the spans `names` overlap, ms per profiled call."""
    spans = extents(ctx, names)
    if not spans or window(ctx) is None or not ctx.get("ops") or not ctx.get("trace_calls"):
        return None
    return overlap(idle(ctx), spans) * 1e-3 / ctx["trace_calls"]


def launches(ctx: Dict, names: Iterable[str]) -> Optional[int]:
    """Kernel-launch calls of the host that start inside the spans `names`."""
    spans = extents(ctx, names)
    if not spans:
        return None
    starts = sorted(a for name, a, _ in ctx["host"] if name in LAUNCH_CALLS)
    return sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s) for s, e in spans)
