"""Host wall (ms) per batched step inside the union of the port's
``randt.association`` and ``randt.submap_merge`` spans, over the window's
untraced chunks."""

from benchmark import program


def read(ctx):
    return program.span_ms(ctx, ["randt.association", "randt.submap_merge"])
