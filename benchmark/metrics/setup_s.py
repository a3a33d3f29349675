"""Process start to the first timed call, s: imports, the scene on the card,
the kernels' build in a checkout's first run, one warm-up call a batch."""


def read(ctx):
    return ctx["setup_s"]
