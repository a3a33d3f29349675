"""The method row's geometric ICP rows' idle card time per call, ms: the
traced window's idle intervals overlapped by the program's stage spans
`vfmreg.row.gt_refine_icp` and `vfmreg.row.vanilla_icp`."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("row.gt_refine_icp", "row.vanilla_icp"))
