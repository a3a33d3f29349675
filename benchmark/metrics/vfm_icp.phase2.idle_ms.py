"""VFM-ICP phase 2's idle card time per call, ms: the traced window's idle
intervals overlapped by the program's span `vfmreg.vfm_icp.phase2` (the
geometric ICP lane loop and the poses composed after it)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("vfm_icp.phase2",))
