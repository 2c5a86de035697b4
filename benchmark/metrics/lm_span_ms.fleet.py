"""Host wall (ms) per batched step inside the port's ``randt.lm_solve``
spans, over the window's untraced chunks: the LM loop's dispatch with no
profiler running (``lm_host_ms.fleet`` is its profiled twin)."""

from benchmark import program


def read(ctx):
    return program.span_ms(ctx, ["randt.lm_solve"])
