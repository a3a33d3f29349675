"""VFM-ICP phase 1's idle card time per call, ms: the traced window's idle
intervals overlapped by the program's span `vfmreg.vfm_icp.phase1` (the
lanes' set-up and the VFM loop to its last read of the lanes' state)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("vfm_icp.phase1",))
