"""The plain reference that decides a fleet run's ``correct``.

A frozen copy of ``randt_slam_torch``'s plain path under the per-frame
step: ``config``, ``runtime``, ``geometry``, ``preprocess``, ``ndt/cells``,
``ndt/grid``, ``registration/`` and ``pipeline/frontend``, with the module
docstrings of the port.  It imports nothing of the port.  What differs
from the port's modules:

* ``ops/``: the plain versions of K1-K4 only; every entry runs its plain
  version on any device (the module docstrings that speak of kernels
  describe the port's);
* ``pipeline/frontend.frontend_step`` makes no ScanContext descriptor and
  no online extras, and writes the running submap into a store of any
  number of rows (the check hands it one);
* no ``record_function`` spans, so a trace never counts the reference.

On the CPU it is bit for bit the port's plain path
(``benchmark/tests/test_bench_reference.py``).
"""
