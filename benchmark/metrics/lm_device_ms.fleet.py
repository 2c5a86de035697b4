"""Device time (ms) per batched step of the work launched inside the port's
``randt.lm_solve`` ranges (a kernel counts by its launch)."""

import numpy as np

from benchmark import trace


def read(ctx):
    r = trace.ranges(ctx["events"], "randt.lm_solve")
    if not len(r):
        return None
    launched = [(e, t) for e, t in trace.launch_times(ctx["events"]) if t is not None]
    if not launched:
        return None
    t = np.array([t for _, t in launched], dtype=np.int64)
    dur = np.array([e.end - e.start for e, _ in launched], dtype=np.float64)
    ins = trace.inside(t, r)
    if not ins.any():
        return None
    return float(dur[ins].sum()) / 1e6 / ctx["steps"]
