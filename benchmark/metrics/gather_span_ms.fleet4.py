"""Per chunk the longest of the ranks' ``randt.gather_outputs`` (the
all-gather of the chunk's outputs and each rank's wait for the others in
it), in ms per step, over the window's untraced chunks
(``benchmark/ranks.py``)."""

from benchmark import ranks


def read(ctx):
    return ranks.gather_ms(ctx)
