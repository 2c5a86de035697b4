"""Host wall inside the port's ``randt.lm_solve`` ranges per batched step
(ms): the dispatch of the LM loop."""

from benchmark import trace


def read(ctx):
    lo, hi = ctx["span"]
    r = trace.ranges(ctx["events"], "randt.lm_solve")
    r = r[(r[:, 0] >= lo) & (r[:, 1] <= hi)] if len(r) else r
    if not len(r):
        return None
    return float((r[:, 1] - r[:, 0]).sum()) / 1e6 / ctx["steps"]
