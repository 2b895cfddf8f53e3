"""Kernel launches a step in the traced stretch, as the profiler records
them."""


def read(ctx):
    t = ctx.trace
    return len(t["kernels"]) / t["steps"] if t["kernels"] else None
