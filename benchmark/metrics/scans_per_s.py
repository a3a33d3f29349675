"""Scans completed in the window over its wall time (every call ends in a
synchronize; the window closes when the call that passes --seconds ends)."""


def read(ctx):
    return ctx["attempted"] / ctx["window_s"]
