"""K4's share of its roofline (%): the least time of its batched solves at
the traced shape (``benchmark/roofline/k4.py``) over their device time."""

from benchmark import trace
from benchmark.roofline import k4

KERNEL = "chol_solve_kernel"


def read(ctx):
    ev = [e for e in trace.device_work(ctx["events"], ctx["span"]) if KERNEL in e.name]
    shape = ctx["shapes"].get("k4")
    if not ev or not shape:
        return None
    mean = sum(e.end - e.start for e in ev) / len(ev) / 1e9
    return 100.0 * k4.least(**shape) / mean
