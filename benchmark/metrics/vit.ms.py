"""The ViT per call, ms: the program's span `vfmreg.vit` (each image's
forward in `ImageFeatureGenerator._forward`) on the generator's stage clock,
each span ending in a synchronize, summed over the call's images; the mean
over the timed calls that follow the profiled ones."""

import statistics


def read(ctx):
    ms = ctx["stage_ms"].get("vit")
    return statistics.fmean(ms) if ms else None
