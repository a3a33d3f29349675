"""The descriptor assembly's idle card time per call, ms: the traced
window's idle intervals overlapped by the program's span
`vfmreg.descriptors.assemble` (each image's projection, patch sampling and
copy to the host, and each scan's first-camera scatter on the host)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("descriptors.assemble",))
