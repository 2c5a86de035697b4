"""The slowest rank's host wall per batched step inside
``randt.frontend_step`` over the window's untraced chunks
(``benchmark/ranks.py``): ``step_span_ms.fleet``'s counterpart where several
ranks share one host."""

from benchmark import ranks


def read(ctx):
    return ranks.slowest_step_ms(ctx)
