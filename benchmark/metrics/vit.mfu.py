"""The ViT's model flops utilization, %: the model flops of the profiled
calls' forwards (`vit_work.vit_flops` at the configuration's widths, for as
many images and tokens an image as the program's counter gives) over the
profiled calls' wall time (under the profiler) x the card's f32 peak,
67 TFLOP/s (the model runs in f32 with TF32 off; B5's share runs on the
tensor cores, counted as the same flops). None without the card's trace."""

from benchmark import roofline, vit_work


def read(ctx):
    seen = vit_work.profiled_forwards(ctx)
    if seen is None or not ctx.get("ops") or not ctx.get("trace_window_s"):
        return None
    images, tokens = seen
    flops = images * vit_work.vit_flops(ctx["config"], tokens)
    return 100.0 * flops / (ctx["trace_window_s"] * roofline.F32_FLOPS)
