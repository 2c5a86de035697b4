"""Per chunk the last rank's end of ``randt.batch_chunk`` less the first
rank's, in ms per step, over the window's untraced chunks: the wait that the
exchange passes on to the ranks that finish first (``benchmark/ranks.py``)."""

from benchmark import ranks


def read(ctx):
    return ranks.skew_ms(ctx)
