"""Host wall (ms) per batched step inside the port's ``randt.filter_scan``
spans (the filter with K1), over the window's untraced chunks."""

from benchmark import program


def read(ctx):
    return program.span_ms(ctx, ["randt.filter_scan"])
