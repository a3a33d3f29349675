"""The method row's snap and RANSAC idle card time per call, ms: the traced
window's idle intervals overlapped by the program's stage spans
`vfmreg.row.snap` and `vfmreg.row.ransac` (with the host's f64
orthogonalization)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("row.snap", "row.ransac"))
