"""The map grid's build per call, ms: the stage's host-clock time ending in
a synchronize (scan-to-map: the `build_hash_grid` span; the method row: its
`grid_build` stage)."""

import statistics


def read(ctx):
    ms = ctx["stage_ms"].get("grid_build")
    return statistics.fmean(ms) if ms else None
