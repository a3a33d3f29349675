"""The voxel layer's idle card time per call, ms: the traced window's idle
intervals overlapped by the program's span of the 5 m queries
(`vfmreg.queries`, scan-to-map) or the method row's preprocessing stage
(`vfmreg.row.preprocess`: 0.1 / 0.5 / 1 m voxelizations and the 5 m
queries)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("queries", "row.preprocess"))
