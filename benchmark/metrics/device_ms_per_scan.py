"""The card's busy time per scan, ms: the union of the device operations'
intervals over the calls that follow the window under the profiler (the
`--trace 0` run's `trace_calls`, every batch in turn), over the scans those
calls registered. Kernel time as the window's calls spend it, without the
host's share of a call."""


def read(ctx):
    if not ctx.get("post_busy_s") or not ctx.get("post_scans"):
        return None
    return 1e3 * ctx["post_busy_s"] / ctx["post_scans"]
