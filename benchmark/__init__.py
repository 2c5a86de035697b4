"""The benchmark of ``randt_slam_torch`` on an NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  The cells,
configurations and metrics are data (``BENCHMARK.json``, ``workloads/``,
``configs/``, ``metrics/``); ``traffic/`` holds the generators, ``inputs/``
the frozen renderers, ``reference/`` the plain reference the check holds
the program against, ``roofline/`` the kernels' work arithmetic.  Nothing
here imports ``jax`` or the JAX package, and ``reference/`` imports nothing
of ``randt_slam_torch``."""
