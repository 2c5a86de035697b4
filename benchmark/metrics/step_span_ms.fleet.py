"""Host wall (ms) per batched step inside the port's ``randt.frontend_step``
spans, over the window's untraced chunks (``benchmark/program.py``)."""

from benchmark import program


def read(ctx):
    return program.span_ms(ctx, ["randt.frontend_step"])
