"""VFM-ICP phase 1's kernel launches per scan: the host's kernel-launch
calls (`cudaLaunchKernel` and its variants, as the profiler records them)
inside the program's span `vfmreg.vfm_icp.phase1`, over the scans of the
profiled calls."""

from benchmark import program_spans


def read(ctx):
    n = program_spans.launches(ctx, ("vfm_icp.phase1",))
    if n is None or not ctx.get("trace_attempted"):
        return None
    return n / ctx["trace_attempted"]
