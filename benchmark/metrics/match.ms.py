"""Descriptor matching per call, ms: the stage's host-clock time ending in a
synchronize (scan-to-map: the `get_vfm_correspondences_batched` span; the
method row: its `match` stage, with its retry and re-match and their reads)."""

import statistics


def read(ctx):
    ms = ctx["stage_ms"].get("match")
    return statistics.fmean(ms) if ms else None
