"""Share (%) of the traced chunk's wall in which no kernel, copy or set
runs on the card (the union of the device intervals)."""

from benchmark import trace


def read(ctx):
    lo, hi = ctx["span"]
    if hi <= lo:
        return None
    busy = trace.busy_ns(ctx["events"], ctx["span"])
    if not busy:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
