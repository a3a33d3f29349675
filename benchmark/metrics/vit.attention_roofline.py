"""B5's share of its roofline in the ViT, %: the least time of the
attention of every profiled image's every block (`vit_work.attention_seconds`
at one image, the counter's tokens, the configuration's heads and width)
over the time of B5's kernel records (`flash_kernel`) in the profiled calls."""

from benchmark import vit_work

KERNEL = "flash_kernel"


def read(ctx):
    seen = vit_work.profiled_forwards(ctx)
    device_us = sum(b - a for name, a, b, kernel in ctx["ops"] if kernel and KERNEL in name)
    if seen is None or device_us <= 0:
        return None
    images, tokens = seen
    cfg = ctx["config"]
    heads, d = cfg["num_attention_heads"], cfg["hidden_size"]
    least_s = images * cfg["num_hidden_layers"] * vit_work.attention_seconds(1, round(tokens), heads, d // heads)
    return 100.0 * least_s / (device_us * 1e-6)
