"""Process groups for multi-device runs: one process per card.

Port of ``randt_slam_tpu/parallel/mesh.py``.  The JAX package drives a mesh
of devices from each process, and its sharded paths split arrays over the
mesh's ``data`` axis with ``shard_map``, combining them with ``psum`` and
``all_gather(tiled=True)``.  Here each process drives one device: a rank
of a ``torch.distributed`` group takes its share of the work (its slice of
the sequences, edges or submaps) on its own card, and the sharded paths
combine the shares with :func:`all_reduce_sum` and :func:`all_gather_cat`
where the JAX package's collectives stand.  NCCL joins the cards; gloo joins
CPU processes.

The launcher gives each process the same three variables as the JAX
package's (``RANDT_COORDINATOR`` = ``host:port`` of rank 0,
``RANDT_NUM_PROCESSES``, ``RANDT_PROCESS_ID``), or the caller passes them.
W ranks on one host::

    RANDT_COORDINATOR=localhost:29512 RANDT_NUM_PROCESSES=W \\
        RANDT_PROCESS_ID=r python -m randt_slam_torch.run ...   # r = 0..W-1
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from .. import runtime
from ..utils import profiling


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device=None) -> bool:
    """Join this process to the default group; a no-op returning False for
    one process, so every entry point can call it first.

    The arguments left out are read from ``RANDT_COORDINATOR``,
    ``RANDT_NUM_PROCESSES`` and ``RANDT_PROCESS_ID``.  ``device`` is the
    rank's device as the entry points take it (CUDA unless ``"cpu"``); on
    CUDA the rank binds card ``rank % device_count`` as its current device,
    so ``runtime.resolve_device(None)`` lands on it.  ``backend`` defaults
    to ``"nccl"`` on CUDA and ``"gloo"`` on the CPU.  Returns True iff a
    process group of more than one rank was joined.
    """
    coord = coordinator_address or os.environ.get("RANDT_COORDINATOR")
    n = num_processes if num_processes is not None else int(
        os.environ.get("RANDT_NUM_PROCESSES", "1"))
    rank = process_id if process_id is not None else int(
        os.environ.get("RANDT_PROCESS_ID", "0"))
    if n <= 1 or coord is None:
        return False
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            runtime.resolve_device(None)  # raises: no card, CPU not asked for
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if "://" not in coord:
        coord = "tcp://" + coord
    dist.init_process_group(backend, init_method=coord, world_size=n, rank=rank)
    return True


def data_group(n_ranks: int | None = None):
    """The counterpart of ``data_mesh``: a group of the first ``n_ranks``
    ranks, or of the world.  ``None`` in a single process (no group: the
    sharded paths then run unsharded).  Creating a sub-group is collective:
    every rank of the world calls it, and ranks outside it must not use
    what it returns."""
    if not dist.is_initialized():
        if n_ranks not in (None, 1):
            raise ValueError(f"{n_ranks} ranks asked for, but no process group")
        return None
    world = dist.get_world_size()
    if n_ranks is None or n_ranks == world:
        return dist.group.WORLD
    if not 1 <= n_ranks <= world:
        raise ValueError(f"{n_ranks} ranks asked for in a world of {world}")
    return dist.new_group(list(range(n_ranks)))


def rank_ids(group):
    """Give this process's rank in ``group`` as the id ``rank`` to every span
    opened inside the block (``utils/profiling.ids``); without a group, no
    id."""
    if group is None:
        return contextlib.nullcontext()
    return profiling.ids(rank=dist.get_rank(group))


def shard_range(n: int, group) -> tuple[int, int]:
    """``[lo, hi)`` of this rank's contiguous share of ``n`` items, as
    ``P("data")`` splits a leading axis; ``(0, n)`` without a group.  ``n``
    must divide by the group's size, as ``shard_map`` requires."""
    if group is None:
        return 0, n
    w, r = dist.get_world_size(group), dist.get_rank(group)
    if n % w:
        raise ValueError(f"{n} items do not split over {w} ranks")
    return r * (n // w), (r + 1) * (n // w)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through the host: gloo moves CPU tensors only, so
    on a gloo group a CUDA tensor is copied to the host and the result back
    (the caller chose gloo, for ranks that share a card).  NCCL moves CUDA
    tensors only; a CPU tensor there, or another backend, raises."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return t.is_cuda
    if backend == "nccl" and t.is_cuda:
        return False
    raise ValueError(f"a {t.device.type} tensor on a {backend} group")


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (``psum``), a new tensor on
    ``t``'s device, the same bits on every rank."""
    staged = _staged(t, group)
    x = t.detach().to("cpu") if staged else t.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device) if staged else x


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in rank order
    (``all_gather(tiled=True)``); every rank's ``t`` has the same shape."""
    staged = _staged(t, group)
    x = t.detach().to("cpu") if staged else t.detach()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    return out.to(t.device) if staged else out
