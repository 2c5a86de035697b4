"""K2's share of its roofline (%): the least time of its calls at the
traced shapes (``benchmark/roofline/k2.py``) over their device time."""

from benchmark import trace
from benchmark.roofline import k2

KERNEL = "topi_moments_kernel"


def read(ctx):
    ev = [e for e in trace.device_work(ctx["events"], ctx["span"]) if KERNEL in e.name]
    shapes = ctx["shapes"].get("k2") or []
    if not ev or not shapes:
        return None
    least = sum(k2.least(**s) for s in shapes) / len(shapes)
    mean = sum(e.end - e.start for e in ev) / len(ev) / 1e9
    return 100.0 * least / mean
