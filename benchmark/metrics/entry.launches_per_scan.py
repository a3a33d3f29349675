"""CUDA kernel launches in the traced window per scan registered there
(memory copies and sets left out), from the profiler's trace."""


def read(ctx):
    kernels = sum(1 for op in ctx["ops"] if op[3])
    if not kernels or not ctx["trace_attempted"]:
        return None
    return kernels / ctx["trace_attempted"]
