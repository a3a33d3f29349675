"""The method row's geometric ICP rows per call, ms: its stage clock's
`gt_refine_icp` plus `vanilla_icp`, each ending in a synchronize."""

import statistics


def read(ctx):
    a, b = ctx["stage_ms"].get("gt_refine_icp"), ctx["stage_ms"].get("vanilla_icp")
    return statistics.fmean(a) + statistics.fmean(b) if a and b else None
