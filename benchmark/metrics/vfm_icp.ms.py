"""VFM-ICP per call, ms: the host-clock time of the
`register_frames_vfm_lanes` span, ending in a synchronize."""

import statistics


def read(ctx):
    ms = ctx["stage_ms"].get("vfm_icp")
    return statistics.fmean(ms) if ms else None
