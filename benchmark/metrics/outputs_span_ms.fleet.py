"""Host wall (ms) per batched step inside the port's ``randt.outputs_to_host``
spans (a chunk's outputs copied to the host and the host's wait for the
device, spread over the chunk's steps), over the window's untraced chunks."""

from benchmark import program


def read(ctx):
    return program.span_ms(ctx, ["randt.outputs_to_host"])
