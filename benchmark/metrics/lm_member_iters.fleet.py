"""LM iterations that worked on a member per solve (of 2 GNC rounds x 25),
in the rounds whose result the member kept: the mean over the traced
chunk's member-solves (the port's LM counters, ``benchmark/program.py``)."""

import numpy as np

from benchmark import program


def read(ctx):
    solves = program.lm_rounds(ctx)
    if not solves:
        return None
    per_member = np.concatenate([(live * kept).sum(axis=0) for live, kept in solves])
    return float(per_member.mean())
