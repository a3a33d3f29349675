"""The method row's snap filter and RANSAC per call, ms: its stage clock's
`snap` plus `ransac` (with the host's f64 orthogonalization), each ending
in a synchronize."""

import statistics


def read(ctx):
    a, b = ctx["stage_ms"].get("snap"), ctx["stage_ms"].get("ransac")
    return statistics.fmean(a) + statistics.fmean(b) if a and b else None
