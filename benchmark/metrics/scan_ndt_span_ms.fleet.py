"""Host wall (ms) per batched step inside the port's ``randt.scan_ndt``
spans (the scan NDT with K2), over the window's untraced chunks."""

from benchmark import program


def read(ctx):
    return program.span_ms(ctx, ["randt.scan_ndt"])
