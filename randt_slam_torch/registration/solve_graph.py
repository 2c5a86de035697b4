"""CUDA graphs of the odometry window's GNC-LM solve.

The solve of ``matcher.estimate_window`` is ``gnc_steps`` x
``lm_max_iterations`` LM iterations of a fixed trip count with no host read
(``solver.py``): ~460 small launches an iteration as tensor ops (six with
both kernel switches on, ``ops/lm_step``), each of which costs the host
more to dispatch than the card to run.  :class:`SolveGraphs` captures such
a solve once per key and replays it per frame:

* the first time a key is seen, the solve runs eagerly (its result is
  used), which also makes every cached constant and library handle it needs,
  since nothing may be first created from host memory inside a capture;
  then it is captured on static input buffers;
* afterwards each call copies its tensors into those buffers, replays the
  graph inside a ``randt.lm_solve`` span, and returns copies of the graph's
  outputs, which the next replay overwrites.

A run owns its cache: the odometry entry points (``pipeline/slam.run_odometry``,
``parallel/batch.make_batched_scan``, ``pipeline/online.OnlineSlam``) each
hold one for their lifetime and pass it down to ``estimate_window``, so
dropping the run frees its graphs, their memory pool and their input
buffers.  The key (:func:`key`) is everything the captured work depends on
that the caller can observe; the static input buffers are shared by the
keys of one input layout, and all graphs of a cache by one private memory
pool: no two of them run at once.  The kernel wrappers' launch counters and
the LM counters' samples follow the replays (``utils/profiling.captured``).
The registry's host counters ``lm_graph.capture`` and ``lm_graph.replay``
count captures and replays; ``lm_graph.eager`` counts the window solves on
the card that ran eagerly: each key's first, and every solve made without
a cache (``estimate_window(..., graphs=None)``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import profiling


def key(part: tuple, args) -> tuple:
    """The key of a graph: the caller's ``part`` (what the captured work
    depends on besides its inputs' layout) and the device, dtype, shape and
    strides of every tensor of ``args``."""
    return part + (tuple((a.device, a.dtype, tuple(a.shape), a.stride()) for a in args),)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    static: tuple           # the input buffers the graph reads
    out: tuple              # the graph's outputs (a NamedTuple of tensors)
    held: profiling.Held    # what the capture counted and sampled


class SolveGraphs:
    """CUDA graphs of ``fn(*args) -> NamedTuple of tensors``, one per key."""

    def __init__(self):
        self.graphs = {}    # key -> _Graph
        self.static = {}    # input layout -> input buffers
        self.pool = None    # the memory pool of the graphs

    def __call__(self, part: tuple, fn: Callable, args: tuple):
        k = key(part, args)
        g = self.graphs.get(k)
        if g is None:
            out = fn(*args)
            profiling.count("lm_graph.eager")
            self.graphs[k] = self._capture(k[-1], fn, args)
            profiling.count("lm_graph.capture")
            return out
        with profiling.span("randt.lm_solve"):
            for s, a in zip(g.static, args):
                s.copy_(a)
            g.graph.replay()
            out = type(g.out)(*(o.clone() for o in g.out))
            profiling.replayed(g.held)
        profiling.count("lm_graph.replay")
        return out

    def _capture(self, lay, fn, args) -> _Graph:
        dev = args[0].device
        static = self.static.get(lay)
        if static is None:
            # the arguments' own strides, so the graph runs the kernels the
            # eager solve ran
            static = self.static[lay] = tuple(
                torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=dev)
                for a in args)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), profiling.captured() as held:
            with torch.cuda.graph(graph, pool=self.pool):
                out = fn(*static)
        return _Graph(graph, static, out, held)
