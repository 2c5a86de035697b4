"""Multi-sequence batching: B sequences of one length through the odometry
front end, on one device or sharded over a group of ranks.

Port of ``randt_slam_tpu/parallel/batch.py``: the JAX package runs
``lax.scan(vmap(frontend_step))`` over a (B, T, ...) frame batch, BASELINE
configs 4-5 ("all 8 Oxford eval sequences batched in parallel"), and with a
mesh shards the batch axis over ``data`` (``shard_map``).  Here
:func:`frontend_step` itself takes the batch axis: every tensor of the carry
and the frame has a leading (B,), and each device operation of a frame, the
kernels K1, K2, K3a/K3b and K4 included, covers all B sequences at once.
So a batched frame makes the launches of one sequence, and B sequences
share the host's dispatch.  SLAM is sequential in time: per-sequence
latency is fixed, and fleet throughput scales with the batch.

With a group (``parallel/mesh.py``, one process per card), rank r of W runs
members ``[r B/W, (r+1) B/W)`` on its own card with no communication during
the scan, and the outputs are gathered at its end, so every rank returns
the whole batch's, as the JAX package's ``out_specs=P("data")``.  A rank is
given its own share of the frames (its frames live on its own card) or the
whole batch's, of which it takes its share.

No ScanContext descriptor is made (``with_descriptor=False``): a fleet
throughput batch runs no loop pass per step, as in the JAX package.

Each call of a scan function is a span ``randt.batch_chunk`` with the
call's index as ``chunk`` (``utils/profiling``); the spans inside it carry
the frame's index in the chunk as ``t``; ``randt.outputs_to_host`` holds the
outputs' copy to the host and the host's wait for the device.  With a group
every span of a call carries the rank's index in the group as ``rank``, and
the exchange of the outputs is a span of its own after ``randt.batch_chunk``
ends, ``randt.gather_outputs`` (ids ``chunk`` and ``rank``), so that a rank's
own work and its wait for the others stay apart; while counting, the
counter ``gather.bytes`` adds the bytes each exchange gathers on the rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..config import SlamConfig
from ..pipeline import frontend as F
from ..pipeline import slam
from ..registration import solve_graph
from ..utils import profiling
from . import mesh

__all__ = ["init_batched_carry", "make_batched_scan"]


def init_batched_carry(cfg: SlamConfig, batch: int, initial_pose=None,
                       dtype=torch.float32, device=None,
                       group=None) -> F.FrontendCarry:
    """:func:`frontend.init_batched_carry` of ``batch`` sequences; with a
    group, of this rank's share of them (``batch / W`` members), so every
    rank makes the same call."""
    lo, hi = mesh.shard_range(batch, group)
    return F.init_batched_carry(cfg, hi - lo, initial_pose, dtype, device)


def _leaves(tree):
    """The array leaves of a FrameOutput, depth first (None skipped)."""
    for x in tree:
        if isinstance(x, tuple):
            yield from _leaves(x)
        elif x is not None:
            yield x


def _rebuild(tree, it):
    items = [_rebuild(x, it) if isinstance(x, tuple) else None if x is None
             else next(it) for x in tree]
    return tuple(items) if type(tree) is tuple else type(tree)(*items)


def _gather_outputs(outs: F.FrameOutput, group, device) -> F.FrameOutput:
    """Every rank's (b, T, ...) outputs concatenated over the members, in
    rank order: one all-gather of their bytes (through ``device``)."""
    leaves = [np.ascontiguousarray(x) for x in _leaves(outs)]
    buf = np.concatenate([x.reshape(-1).view(np.uint8) for x in leaves])
    got = mesh.all_gather_cat(torch.from_numpy(buf).to(device), group).cpu().numpy()
    if profiling.counting():
        profiling.count("gather.bytes", got.nbytes)
    per_rank = got.reshape(-1, buf.size)
    cat, off = [], 0
    for x in leaves:
        part = per_rank[:, off:off + x.nbytes]
        cat.append(np.concatenate([p.view(x.dtype).reshape(x.shape) for p in part]))
        off += x.nbytes
    return _rebuild(outs, iter(cat))


def _own_members(n_frames: int, n_carries: int, group) -> tuple[int, int]:
    """``[lo, hi)`` of the frames' members that this rank steps: all of them
    where the frames hold as many members as its carries (the rank's own
    share), its share of the batch where they hold the group's whole batch
    (W times that); any other count raises."""
    if n_frames == n_carries:
        return 0, n_frames
    w = 1 if group is None else dist.get_world_size(group)
    if n_frames != w * n_carries:
        raise ValueError(f"frames of {n_frames} members for carries of {n_carries} "
                         f"on a rank of {w}: give the rank's share or the whole batch")
    return mesh.shard_range(n_frames, group)


def make_batched_scan(cfg: SlamConfig, sensor_to_base, device=None, group=None):
    """Returns ``scan_fn(carries, frames, on_frame=None) -> (carries, outs)``
    over a (B, T, ...) frame batch on ``device`` (CUDA unless
    ``device="cpu"``): ``carries`` from :func:`init_batched_carry`,
    ``frames`` a ``Frame`` of (b, T, ...) tensors, ``outs`` a
    ``FrameOutput`` of numpy (B, T, ...) arrays, all B members on every
    rank.  Without a group b = B.  With a group of W ranks, b is the rank's
    share B / W (its own frames, as many members as its carries) or the
    whole batch B, of which the rank takes its share; any other b raises.
    The rank's frames are moved to the device once per call (nothing moves
    where they are there already).  The carries passed in are updated in
    place (the submap store) and must not be used again; they stay this
    rank's.  ``on_frame(t, carries)`` is called as in
    ``pipeline/slam.run_odometry``: before frame ``t`` is stepped.
    ``scan_fn`` keeps the CUDA graphs of its window solves
    (``registration/solve_graph``) while it lives."""
    dev = runtime.resolve_device(device)
    s2b = torch.as_tensor(np.asarray(sensor_to_base, np.float32)).to(dev)
    graphs = solve_graph.SolveGraphs()
    calls = 0

    def scan_fn(carries: F.FrontendCarry, frames: F.Frame, on_frame=None):
        nonlocal calls
        lo, hi = _own_members(frames.stamp.shape[0], carries.cur_pose.shape[0], group)
        chunk, calls = calls, calls + 1
        with mesh.rank_ids(group):
            with profiling.span("randt.batch_chunk", chunk=chunk):
                frames = F.Frame(*(x[lo:hi].to(dev) for x in frames))
                outs = []
                for t in range(frames.stamp.shape[1]):
                    if on_frame is not None:
                        on_frame(t, carries)
                    fr = F.Frame(*(x[:, t] for x in frames))
                    with profiling.ids(t=t):
                        carries, out = F.frontend_step(cfg, carries, fr, s2b,
                                                       with_descriptor=False,
                                                       graphs=graphs)
                    outs.append(out)
                with profiling.span("randt.outputs_to_host"):
                    outs = slam.stack_outputs(outs, batch=hi - lo)
            if group is not None:
                with profiling.span("randt.gather_outputs", chunk=chunk):
                    outs = _gather_outputs(outs, group, dev)
        return carries, outs

    return scan_fn
