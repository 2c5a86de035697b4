"""Device launches (kernels, copies, sets) per batched step of the traced
chunk.  A count: it repeats exactly."""

from benchmark import trace


def read(ctx):
    n = len(trace.device_work(ctx["events"], ctx["span"]))
    return n / ctx["steps"] if n and ctx["steps"] else None
