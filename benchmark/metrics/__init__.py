"""One reader per per-layer metric, ``<metric>.py`` with ``read(ctx)``.

``ctx`` is what a traced run gives (``benchmark/traffic/fleet.py``,
``trace_context``): ``events`` (``benchmark/trace.Ev`` tuples of the traced
chunk), ``steps`` (batched frames in it), ``span`` (the traced chunk's host
range) and ``shapes`` (the kernels' call shapes).  A reader that finds
nothing to read returns None, and the metric is left out of the result."""
