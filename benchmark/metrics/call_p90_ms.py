"""The 90th percentile of the latency of every call in the window, ms."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.array(ctx["latencies_s"]) * 1e3, 90))
