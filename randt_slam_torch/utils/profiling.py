"""The port's one registry of spans and counters (the structured successor of
the reference's ``TicToc`` stopwatches and ``total_time_`` counters,
cf. ``tictoc.h`` and ``local_fuser.h:164-165``).

**Spans.** :class:`span` (``@span("randt.scan_ndt")`` or ``with span(name,
**ids)``) marks a layer of the program.  On entry and exit it always reads
``time.time_ns()``, the Unix-epoch clock that ``torch.profiler``'s host
events carry, and at exit writes ``(name, start, end, ids, attrs)`` into a
ring of :data:`RING_SIZE` preallocated slots, so memory does not grow over a
long replay and the newest records are kept (:func:`records`).  While a
``torch.profiler`` records, the span also opens a ``record_function`` range
of the same name, with its ids as the range's ``args``.  Otherwise it enters
no range, makes no tensor and does no device work: two clock reads and one
slot write.  A span's ids are those of the spans around it updated by its
own; :func:`ids` adds ids to the spans opened inside it without a record of
its own.

**Counters.**

* Host counts (:func:`count`, :func:`counter`): always on, plain integer
  adds.  The kernel wrappers count their launches as ``kernel.<name>``
  (``ops/build.LAUNCHES`` is a view of them).  A CUDA graph's capture
  launches nothing: inside :func:`captured` the counts go to the capture,
  and :func:`replayed` adds them at each replay, so the counters count
  real launches.
* Device samples (:func:`record`, :func:`samples`): tensors a layer keeps,
  such as the LM solve's per-member iteration counts, taken only while
  :func:`counting` (inside :func:`tracing`, or while a ``torch.profiler``
  records), held in a bounded queue with the time they were taken and the
  ids open then, and read on the host only by whoever reads them.
* Allocator deltas: while counting, the spans named in
  :data:`ALLOC_SPANS` keep the caching allocator's device mallocs, frees and
  retries over their extent as their ``attrs``.

**Ranks.** Each process has its own ring; the sharded paths give their
spans the process's rank as an id (``parallel/mesh.rank_ids``), and
:func:`gather_records` brings every rank's records to one rank after a run.

:class:`Profiler` aggregates the spans recorded after its creation by name
(the CLI's ``profile``); the ring folds its records into every live
``Profiler`` before it overwrites them.  One thread: spans nest.
"""

from __future__ import annotations

import collections
import collections.abc
import contextlib
import functools
import json
import time
import weakref
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

RING_SIZE = 1 << 16          # span records kept
SAMPLE_SIZE = 4096           # device samples kept
ALLOC_SPANS = frozenset({"randt.frontend_step", "randt.outputs_to_host"})
ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")
KERNELS = ("row_windows", "segment_topk_moments", "segment_moments",
           "ndt_linearize", "ndt_robust_cost", "chol_solve", "lm_assemble",
           "lm_trial", "lm_accept")


class Record(NamedTuple):
    name: str
    start: int      # ns, time.time_ns()
    end: int
    ids: dict
    attrs: dict | None


class Sample(NamedTuple):
    name: str
    time: int       # ns, time.time_ns()
    ids: dict
    values: dict


class Registry:
    """The ring of span records, the host counters and the device samples."""

    def __init__(self, size: int = RING_SIZE, samples: int = SAMPLE_SIZE):
        self.size = size
        self.ring = [None] * size
        self.n = 0                       # records written so far
        self.counters = {f"kernel.{k}": 0 for k in KERNELS}
        self.samples = collections.deque(maxlen=samples)
        self.tracing = 0                 # depth of open tracing() blocks
        self.stack = [{}]                # the ids of the open spans, innermost last
        self.folds = weakref.WeakSet()   # Profilers that see every record

    def write(self, rec: tuple) -> None:
        i = self.n % self.size
        if i == 0 and self.n and self.folds:
            for p in list(self.folds):
                p._fold()
        self.ring[i] = rec
        self.n += 1

    def records(self, since: int = 0) -> list:
        """The records written at or after the ``since``-th still in the
        ring, oldest first."""
        lo = max(since, self.n - self.size)
        return [Record(*self.ring[k % self.size]) for k in range(lo, self.n)]


REGISTRY = Registry()


def counting() -> bool:
    """Whether counters that cost device or host calls run now."""
    return bool(REGISTRY.tracing) or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def tracing():
    """Turn the counters on for the block, with or without a profiler."""
    REGISTRY.tracing += 1
    try:
        yield
    finally:
        REGISTRY.tracing -= 1


@contextlib.contextmanager
def ids(**kw):
    """Give ``kw`` as ids to every span opened inside the block."""
    stack = REGISTRY.stack
    stack.append({**stack[-1], **kw})
    try:
        yield
    finally:
        stack.pop()


def _alloc_counts():
    if not torch.cuda.is_initialized():
        return None
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ALLOC_KEYS}


class span:
    """A named layer of the program: a decorator or a context manager (see
    the module docstring)."""

    __slots__ = ("name", "own", "reg", "ids", "t0", "rf", "mem")

    def __init__(self, name: str, **ids):
        self.name = name
        self.own = ids

    def __call__(self, fn):
        name, own = self.name, self.own

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, **own):
                return fn(*args, **kwargs)
        return spanned

    def __enter__(self):
        reg = self.reg = REGISTRY
        ids = reg.stack[-1]
        if self.own:
            ids = {**ids, **self.own}
        reg.stack.append(ids)
        self.ids = ids
        self.rf = self.mem = None
        profiling = _autograd_profiler._is_profiler_enabled
        if (profiling or reg.tracing) and self.name in ALLOC_SPANS:
            self.mem = _alloc_counts()
        if profiling:
            self.rf = torch.profiler.record_function(
                self.name, json.dumps(ids) if ids else None)
        self.t0 = time.time_ns()
        if profiling:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.time_ns()
        attrs = None
        if self.mem is not None:
            now = _alloc_counts()
            attrs = {k: now[k] - self.mem[k] for k in ALLOC_KEYS}
        reg = self.reg
        reg.stack.pop()
        reg.write((self.name, self.t0, t1, self.ids, attrs))
        return False


def records(since: int = 0) -> list:
    """The span records in the ring (:class:`Record`), oldest first."""
    return REGISTRY.records(since)


def gather_records(group=None, since: int = 0, dst: int = 0) -> list | None:
    """After a run of ranks: every rank's ring records written at or after
    its ``since``-th (:func:`records`), brought to rank ``dst`` of ``group``
    (the default group when None) in rank order, each with its rank in the
    group as the id ``rank``.  The ranks of one host share the clock
    (``time.time_ns()``), so the records line up as they are.  Collective:
    every rank of the group calls it, outside the timed steps.  Returns the
    records on ``dst`` and None on the other ranks; without a process group,
    this process's records as rank 0's."""
    import torch.distributed as dist

    mine = [tuple(r) for r in records(since)]
    if not dist.is_initialized():
        parts = [mine]
    else:
        me = dist.get_rank(group)
        parts = [None] * dist.get_world_size(group) if me == dst else None
        root = dst if group is None else dist.get_global_rank(group, dst)
        dist.gather_object(mine, parts, dst=root, group=group)
        if me != dst:
            return None
    return [Record(name, start, end, {**ids, "rank": rank}, attrs)
            for rank, part in enumerate(parts) for name, start, end, ids, attrs in part]


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    c = REGISTRY.counters
    c[name] = c.get(name, 0) + n


def counter(name: str) -> int:
    return REGISTRY.counters.get(name, 0)


def record(name: str, **values) -> None:
    """Keep ``values`` (tensors, left where they are) as a sample of
    ``name``, with the time and the open spans' ids.  Callers make the
    tensors only while :func:`counting`."""
    REGISTRY.samples.append(Sample(name, time.time_ns(), REGISTRY.stack[-1], values))


def samples(name: str | None = None) -> list:
    """The kept device samples (of ``name``), oldest first."""
    return [s for s in REGISTRY.samples if name is None or s.name == name]


class Held(NamedTuple):
    """What a CUDA graph's capture counted and sampled (:func:`captured`)."""
    counts: dict
    samples: list


@contextlib.contextmanager
def captured():
    """The block is a CUDA graph's capture: its host counts and device
    samples go to the yielded :class:`Held` instead of the registry, and
    the counters are on, so that the graph computes its samples at every
    replay whether or not the replay counts."""
    reg = REGISTRY
    held = Held({}, [])
    saved = reg.counters, reg.samples
    reg.counters, reg.samples = held.counts, held.samples
    reg.tracing += 1
    try:
        yield held
    finally:
        reg.counters, reg.samples = saved
        reg.tracing -= 1


def _copied(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (list, tuple)):
        return type(v)(_copied(x) for x in v)
    return v


def replayed(held: Held) -> None:
    """Count a replay of a capture: add its counts, and while counting keep
    copies of its samples (the graph's own tensors, which the next replay
    overwrites), with this time and the open spans' ids."""
    for k, n in held.counts.items():
        count(k, n)
    if counting():
        for s in held.samples:
            record(s.name, **{k: _copied(v) for k, v in s.values.items()})


class CounterView(collections.abc.MutableMapping):
    """The host counters ``<prefix><key>`` as a mapping keyed by ``key``."""

    def __init__(self, prefix: str, keys):
        self.prefix = prefix
        self.keys_ = tuple(keys)

    def __getitem__(self, k):
        if k not in self.keys_:
            raise KeyError(k)
        return counter(self.prefix + k)

    def __setitem__(self, k, v):
        if k not in self.keys_:
            raise KeyError(k)
        REGISTRY.counters[self.prefix + k] = v

    def __delitem__(self, k):
        raise TypeError("counters are not deleted")

    def __iter__(self):
        return iter(self.keys_)

    def __len__(self):
        return len(self.keys_)

    def __repr__(self):
        return repr(dict(self))


# ---------------------------------------------------------------------------
# aggregates
# ---------------------------------------------------------------------------


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Profiler:
    """Every span recorded after its creation, aggregated by name;
    :meth:`stage` opens a span that ends when the device has finished."""

    def __init__(self, sync: bool = True):
        self.stages: dict[str, StageStats] = collections.defaultdict(StageStats)
        self.sync = sync
        self.reg = REGISTRY
        self.seen = self.reg.n
        self.reg.folds.add(self)

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        """A span ``name`` around the block; with ``sync`` on and a CUDA
        tensor as ``sync_value``, it ends when the device has finished."""
        with span(name):
            try:
                yield
            finally:
                if (self.sync and isinstance(sync_value, torch.Tensor)
                        and sync_value.is_cuda):
                    torch.cuda.synchronize(sync_value.device)

    def _fold(self):
        for r in self.reg.records(self.seen):
            self.stages[r.name].add((r.end - r.start) / 1e9)
        self.seen = self.reg.n

    def report(self) -> dict:
        self._fold()
        return {
            k: {
                "count": v.count,
                "total_s": round(v.total_s, 6),
                "mean_s": round(v.mean_s, 6),
                "min_s": round(v.min_s, 6),
                "max_s": round(v.max_s, 6),
            }
            for k, v in sorted(self.stages.items())
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)
