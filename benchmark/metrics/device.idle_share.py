"""Share of the traced window in which no operation ran on the card:
1 - (union of the device operations' intervals) / (window), from the
profiler's trace."""


def read(ctx):
    if ctx["trace_window_s"] <= 0 or not ctx["ops"]:
        return None
    return 1.0 - ctx["busy_s"] / ctx["trace_window_s"]
