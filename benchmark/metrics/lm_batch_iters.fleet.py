"""LM iterations a batch-level exit would have to dispatch per solve and
still keep every answer: over the GNC rounds, the most iterations any member
that keeps the round worked in it; the mean over the traced chunk's solves
(the port's LM counters, ``benchmark/program.py``)."""

import numpy as np

from benchmark import program


def read(ctx):
    solves = program.lm_rounds(ctx)
    if not solves:
        return None
    need = [sum(int(live[r][kept[r]].max()) if kept[r].any() else 0
                for r in range(live.shape[0])) for live, kept in solves]
    return float(np.mean(need))
