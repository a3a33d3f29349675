"""The matching's share of its roofline, %: the least time of the matching
work over the card's time in the operations that ran inside the matching
spans of the traced window (each span's extent on the device, as the
profiler marks it). The least time, per matching call, is the larger of the
bytes at the HBM bandwidth and 3 x 2 x live queries x valid map rows x D
flops at the TF32 peak (`roofline.cosine_argmax_seconds`: kernel B1's f32
products run as three TF32 products), counted from the call's arguments,
whatever implements it."""

from benchmark import roofline


def read(ctx):
    spans = ctx["device_spans"].get("match", [])
    notes = ctx["notes"].get("match", [])[:len(spans)]
    if not spans or len(notes) < len(spans):
        return None
    device_us = sum(b - a for _, a, b, _ in ctx["ops"] if any(s <= a < e for s, e in spans))
    if device_us <= 0:
        return None
    least_s = sum(roofline.cosine_argmax_seconds(*n) for n in notes)
    return 100.0 * least_s / (device_us * 1e-6)
