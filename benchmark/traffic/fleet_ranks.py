"""Fleet replay over ranks: the fleet traffic of ``fleet.py`` on W ranks,
one process per card, stepped together through the port's sharded batched
scan (``make_batched_scan(..., group=data_group())``) with each rank's own
frames, closed loop.

The traffic of a cell (``benchmark/workloads/<cell>.json``, ``params``):

* ``ranks``: W.  Rank 0 is the calling process (``run.py``'s), on card 0;
  it starts ranks 1 .. W-1 as child processes on cards 1 .. W-1, which join
  through ``mesh.init_distributed`` from the ``RANDT_*`` variables, on a
  free localhost port.  With fewer cards than ranks (a test on one card or
  on the CPU) the ranks share the cards and join through gloo, the port's
  exchange staged through the host;
* ``batch``, ``drives``, ``check_members``: per rank, as ``fleet.py``
  reads them.  Each rank renders its own ``drives`` drives from ``--seed``
  and its rank, holds their frames on its own card, and steps its
  ``batch`` members with its own share of the frames; the port gathers
  every chunk's outputs, so every rank holds all W x ``batch`` members';
* ``chunk``, ``warmup_frames``, ``check_frames``: as ``fleet.py``.

The window closes on rank 0: before each chunk rank 0 tells the other ranks
whether the chunk starts, so that all ranks run the same chunks.  Closed
loop: a chunk starts when every rank holds the last chunk's outputs.
``fleet_fps`` is every member-frame of all W ranks completed in the window
over rank 0's window wall.  Only rank 0 is traced (``--trace 1``).

After the window every rank's span ring goes to rank 0
(``utils/profiling.gather_records``; the readers find it as
``ctx["rings"]``).  Each rank checks its own sampled (frame, member) pairs
against the reference as ``fleet.py`` does, reading its members at their
global indices of the gathered outputs; rank 0 takes the largest of each
number over the ranks, and ``exact_mismatches`` also counts every chunk
whose gathered outputs on a rank differ from rank 0's.

No hangs: every wait of a rank on another has a deadline.  Rank 0 watches
its children: one that dies or exits non-zero, or a run that makes no
progress for :data:`STALL_S`, kills every child and ends rank 0 with an
error, within :data:`GRACE_S` even where rank 0 waits inside a
collective.  A child whose parent is gone, or that makes no progress, ends
itself.  The control messages go over a gloo group with a timeout.

Run as a module, this file is a child rank (``python -m
benchmark.traffic.fleet_ranks SPEC``).
"""

from __future__ import annotations

import ctypes
import datetime
import hashlib
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from . import fleet

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STALL_S = 600.0     # the longest a run may go without progress
GRACE_S = 15.0      # after a failure, how long rank 0 waits for its main thread
LEAVE_S = 60.0      # the longest the process group's teardown may take
CTL_TIMEOUT_S = 600.0
POLL_S = 0.25
RANK_TAG = 4      # separates the ranks' seeds from the drives' (inputs.drives)
GRAPH_COUNTERS = ("lm_graph.replay", "lm_graph.capture", "lm_graph.eager")


def make(cell: dict, seed: int, device: str = "cuda", program: str = "port",
         workers: int | None = None):
    """The run of a multi-rank fleet cell (the generator's entry for
    ``run.py``): rank 0, which starts the others."""
    return Ranks(cell, seed, device, program, workers)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s drives and check in a run seeded
    ``seed``."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), RANK_TAG, int(rank)])
    return int(ss.generate_state(1, np.uint64)[0])


class RankFailed(RuntimeError):
    """A rank died, exited non-zero, or the run made no progress."""


# ---------------------------------------------------------------------------
# one rank's share
# ---------------------------------------------------------------------------


class RankFleet(fleet.Fleet):
    """One rank's share of the fleet: ``fleet.Fleet``'s inputs, reference
    and check, with the program stepped in the group on the rank's own
    frames and the window paced by rank 0."""

    def __init__(self, cell, seed, device, program, workers, rank, world, beat):
        super().__init__(cell, rank_seed(seed, rank), device, program, workers)
        self.rank, self.world, self.beat = rank, world, beat

    def setup(self, group, ctl, join_s):
        """Build the program, load the rank's drives onto its card, warm up
        (every warm-up chunk runs the exchange, so the ranks leave it
        together).  ``setup_phases`` keeps each part's seconds, from the
        join (``join_s``) on: the first exchange (the exchange's own set-up,
        apart from the steps) and each warm-up chunk; ``warm_split`` keeps
        each warm-up chunk's own work and exchange (s), from the ring."""
        import torch

        from randt_slam_torch.utils import profiling

        from .. import cellspec
        t = time.perf_counter()
        phases = self.setup_phases = {"join": join_s}

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            phases[name] = now - t
            t = now

        self.dev = torch.device(self.device)
        self.group, self.ctl = group, ctl
        _first_exchange(group, self.dev)
        lap("first_exchange")
        self.prog_cfg = cellspec.program_config(self.conf)
        self.ref_cfg = cellspec.reference_config(self.conf)
        self.s2b = np.zeros(3, np.float32)
        if self.dev.type == "cuda":
            from randt_slam_torch.ops import build
            build.build()
            torch.zeros(1, device=self.dev)
        lap("program_and_kernels")
        if self._render is not None:
            self._laps = self._render.get()
            self._render = None
        lap("render_wait")
        self._inputs()
        lap("upload")
        self.scan_fn, init = _program(self.program, self)
        self.carries = init()
        self.init_carry = self.carries
        self.chunk = 0
        n_warm = max(1, -(-int(self.params["warmup_frames"]) // self.T))
        since = profiling.REGISTRY.n
        for i in range(n_warm):
            self._step_chunk()
            self.beat()
            if i == n_warm - 1:
                self._sync()
            lap(f"warmup_{i + 1}")
        self.warm_split = _own_and_exchange(profiling.records(since))

    def run_window(self, go, trace: bool):
        """Chunks while ``go(n)`` says the n-th starts; with ``trace``, the
        window's second chunk runs under ``torch.profiler``.  Returns the
        window's wall (s)."""
        import torch

        from randt_slam_torch.utils import profiling

        keep_at = random.Random(f"{self.seed}:keep").randrange(fleet.KEEP_FIRST)
        self.kept, self.outs, self.chunk_walls, self.graph_counts = {}, {}, [], []
        self._sync()
        mem0 = fleet._alloc_counts(self.dev)
        self.since = profiling.REGISTRY.n
        t0 = time.perf_counter()
        n, last = 0, None
        while go(n):
            tc = time.perf_counter()
            c = self.chunk
            g0 = [profiling.counter(k) for k in GRAPH_COUNTERS]
            snaps = []
            on_frame = (lambda t, carries: snaps.append(carries))
            if trace and n == 1:
                from torch.profiler import ProfilerActivity, profile
                bytes0 = profiling.counter("gather.bytes")
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                with prof:
                    with torch.profiler.record_function("bench.traced"):
                        outs = self._step_chunk(on_frame)
                        self._sync()
                self.traced, self.traced_chunk = (prof, c), c
                self.gather_bytes = profiling.counter("gather.bytes") - bytes0
            else:
                outs = self._step_chunk(on_frame)
            snaps.append(self.carries)
            self.chunk_walls.append(time.perf_counter() - tc)
            self.graph_counts.append([profiling.counter(k) - v
                                      for k, v in zip(GRAPH_COUNTERS, g0)])
            self.outs[c] = outs
            last = (c, snaps)
            if n == keep_at:
                self.kept[c] = snaps
            n += 1
            self.beat()
        self._sync()
        wall = time.perf_counter() - t0
        self.alloc_counts = {k: v - mem0.get(k, 0)
                             for k, v in fleet._alloc_counts(self.dev).items()}
        if last is not None and last[0] not in self.kept:
            self.kept[last[0]] = last[1]
        self.n_chunks = n
        return wall

    def settle_outputs(self) -> dict:
        """After the window: each chunk's digest of the gathered outputs,
        and the kept chunks' outputs cut to this rank's members, at their
        global indices, for the check (the rest dropped)."""
        lo = self.rank * self.B
        digests = {c: _digest(o) for c, o in self.outs.items()}
        self.outs = {c: _members(self.outs[c], lo, lo + self.B) for c in self.kept}
        return digests


def _first_exchange(group, dev):
    """One all-gather over the data group before the warm-up, so that the
    exchange's set-up (NCCL's communicators) is timed apart from the steps."""
    import torch

    from randt_slam_torch.parallel import mesh

    mesh.all_gather_cat(torch.zeros(1, device=dev), group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _own_and_exchange(recs) -> list:
    """Per chunk of the ring records ``recs``: (its ``randt.batch_chunk``,
    its ``randt.gather_outputs``) in seconds; empty where the program wrote
    neither."""
    names = ("randt.batch_chunk", "randt.gather_outputs")
    per = {}
    for r in recs:
        if r.name in names:
            s = per.setdefault(r.ids["chunk"], [0.0, 0.0])
            s[names.index(r.name)] += (r.end - r.start) / 1e9
    return [tuple(per[c]) for c in sorted(per)]


def _program(kind: str, run: RankFleet):
    """``(scan_fn, init)`` of the program under test on one rank."""
    B, W, dev = run.B, run.world, run.dev
    if kind == "port":
        from randt_slam_torch.parallel import batch
        scan = batch.make_batched_scan(run.prog_cfg, run.s2b, device=dev, group=run.group)
        return scan, lambda: batch.init_batched_carry(run.prog_cfg, W * B, device=dev,
                                                      group=run.group)
    if kind == "control":
        scan, init = fleet._control(run.ref_cfg, run.s2b, dev, B)
        return _exchanged(scan, run.ctl), init
    if kind.startswith("fault:"):
        name = kind[len("fault:"):]
        scan, init = _program("port", run)
        if name == "shares_swapped":
            return _shares_swapped(scan, B), init
        if name == "rank_stalled":
            return (_stalled(scan) if run.rank == W - 1 else scan), init
        if name == "rank_killed":
            return scan, init
        return fleet._faulty(name, scan), init
    raise ValueError(f"unknown program {kind!r}")


def _exchanged(scan, ctl):
    """The control's scan with its outputs gathered over the ranks as the
    port's are (in rank order, every rank all of them)."""
    import torch.distributed as dist

    def run(carries, frames, on_frame=None):
        carries, outs = scan(carries, frames, on_frame)
        parts = [None] * dist.get_world_size(ctl)
        dist.all_gather_object(parts, outs, group=ctl)
        return carries, _concat(parts)

    return run


def _shares_swapped(scan, B):
    """Fault: rank 1's share of every gathered output replaced by rank 0's."""
    def run(carries, frames, on_frame=None):
        carries, outs = scan(carries, frames, on_frame)
        return carries, _map(outs, lambda x: np.concatenate([x[:B], x[:B], x[2 * B:]]))
    return run


def _stalled(scan):
    """Fault: the rank steps a copy of its carries through the chunk (so it
    still takes part in every exchange) and keeps its carries unchanged."""
    def run(carries, frames, on_frame=None):
        for t in range(frames.stamp.shape[1]):
            if on_frame is not None:
                on_frame(t, carries)
        _, outs = scan(fleet._clone(carries), frames)
        return carries, outs
    return run


def _map(outs, fn):
    if outs is None:
        return None
    if isinstance(outs, tuple):
        return type(outs)(*(_map(x, fn) for x in outs))
    return fn(np.asarray(outs))


def _members(outs, lo, hi):
    """Members ``[lo, hi)`` of numpy (B, T, ...) outputs."""
    return _map(outs, lambda x: x[lo:hi])


def _concat(parts):
    """Outputs of the ranks joined along the members, in rank order."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_concat([p[i] for p in parts]) for i in range(len(first))))
    return np.concatenate([np.asarray(p) for p in parts])


def _digest(outs) -> str:
    h = hashlib.sha256()
    _map(outs, lambda x: h.update(np.ascontiguousarray(x).tobytes()))
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the group, the control messages and the watch on the ranks
# ---------------------------------------------------------------------------


def _join(device: str, rank: int, world: int, coordinator: str):
    """Join the world; returns (the data group, the control group)."""
    import torch
    import torch.distributed as dist

    from randt_slam_torch.parallel import mesh

    on_cuda = torch.device(device).type == "cuda"
    backend = "nccl" if on_cuda and torch.cuda.device_count() >= world else "gloo"
    mesh.init_distributed(coordinator, world, rank, backend=backend,
                          device=None if on_cuda else "cpu")
    ctl = dist.new_group(backend="gloo",
                         timeout=datetime.timedelta(seconds=CTL_TIMEOUT_S))
    return mesh.data_group(), ctl


def _flag(ctl, value: int | None = None) -> int:
    """Rank 0's ``value`` on every rank."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([0 if value is None else int(value)], dtype=torch.int64)
    dist.broadcast(t, src=0, group=ctl)
    return int(t.item())


def _gather(ctl, obj):
    """Every rank's ``obj`` on rank 0 in rank order (None elsewhere)."""
    import torch.distributed as dist

    me = dist.get_rank(ctl)
    parts = [None] * dist.get_world_size(ctl) if me == 0 else None
    dist.gather_object(obj, parts, dst=0, group=ctl)
    return parts


def _leave():
    """End this process's group.  Every rank calls it at the end of a run,
    together: NCCL's teardown of a rank waits for the other ranks' while
    they live.  A teardown that does not return within :data:`LEAVE_S` ends
    the process."""
    import torch.distributed as dist

    def stuck():
        print(f"fleet_ranks: the process group's teardown took over {LEAVE_S:.0f} s",
              file=sys.stderr, flush=True)
        os._exit(78)

    timer = threading.Timer(LEAVE_S, stuck)
    timer.daemon = True
    timer.start()
    try:
        dist.destroy_process_group()
    finally:
        timer.cancel()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(device: str, rank: int) -> str:
    import torch

    if device.split(":")[0] != "cuda":
        return device
    return f"cuda:{rank % max(1, torch.cuda.device_count())}"


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError as e:
        return f"(no log: {e})"


class _Watch(threading.Thread):
    """Rank 0's watch on its children and on the run's progress."""

    def __init__(self, procs, logs):
        super().__init__(name="fleet-ranks-watch", daemon=True)
        self.procs, self.logs = procs, logs
        self.main = threading.main_thread().ident
        self.lock = threading.Lock()
        self.last = time.monotonic()
        self.closing = False
        self.failed = None
        self.finished = threading.Event()

    def beat(self):
        self.last = time.monotonic()

    def run(self):
        while not self.finished.wait(POLL_S):
            why = None
            for r, p in self.procs.items():
                rc = p.poll()
                if rc is not None and rc != 0:
                    why = f"rank {r} exited with code {rc}"
                    break
            if why is None and time.monotonic() - self.last > STALL_S:
                why = f"no progress for {STALL_S:.0f} s"
            if why is not None:
                with self.lock:
                    if self.closing:
                        return
                    self.failed = why
                self._fail(why)
                return

    def _fail(self, why):
        print(f"fleet_ranks: {why}; stopping every rank", file=sys.stderr, flush=True)
        for r, p in self.procs.items():
            if p.poll() is None:
                p.kill()
        for r in self.procs:
            print(f"--- rank {r}'s log (tail) ---\n{_tail(self.logs[r])}",
                  file=sys.stderr, flush=True)
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(self.main),
                                                   ctypes.py_object(RankFailed))
        if not self.finished.wait(GRACE_S):
            print("fleet_ranks: rank 0 did not return; exiting", file=sys.stderr, flush=True)
            os._exit(75)


# ---------------------------------------------------------------------------
# rank 0: the run that run.py drives
# ---------------------------------------------------------------------------


class Ranks:
    """Rank 0 of a multi-rank fleet run: its own share (:class:`RankFleet`)
    and the child processes of the other ranks."""

    def __init__(self, cell, seed, device="cuda", program="port", workers=None):
        self.cell, self.seed, self.program = cell, int(seed), program
        self.world = int(cell["workload"]["params"]["ranks"])
        self.device = _rank_device(device, 0)
        self.workers = workers
        self.procs, self.logs = {}, {}
        self.watch = None
        self.tmp = None
        self.joined = self.done = False
        self.attempted = 0
        self.rings = None
        self.fleet = RankFleet(cell, seed, self.device, program, workers, 0,
                               self.world, self._beat)

    def _beat(self):
        if self.watch is not None:
            self.watch.beat()

    def start(self):
        """Start the other ranks, and this rank's render."""
        self.tmp = tempfile.mkdtemp(prefix="fleet_ranks_")
        self.coordinator = f"127.0.0.1:{_free_port()}"
        for r in range(1, self.world):
            spec = dict(cell=self.cell, seed=self.seed, device=self.device.split(":")[0],
                        program=self.program, workers=self.workers, rank=r,
                        world=self.world, coordinator=self.coordinator)
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
            self.logs[r] = os.path.join(self.tmp, f"rank{r}.log")
            with open(self.logs[r], "wb") as log:
                self.procs[r] = subprocess.Popen(
                    [sys.executable, "-m", "benchmark.traffic.fleet_ranks", json.dumps(spec)],
                    cwd=ROOT, env=env, stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT)
        self.watch = _Watch(self.procs, self.logs)
        self.watch.start()
        self.fleet.start()

    def setup(self):
        t0 = time.perf_counter()
        self.group, self.ctl = _join(self.device, 0, self.world, self.coordinator)
        self.joined = True
        self._beat()
        self.fleet.setup(self.group, self.ctl, time.perf_counter() - t0)
        _flag(self.ctl, 1)          # every rank is warm
        self.setup_phases = self.fleet.setup_phases

    def window(self, seconds: float, trace: bool) -> dict:
        from randt_slam_torch.utils import profiling

        t0 = [None]

        def go(n):
            if n == 0:
                t0[0] = time.perf_counter()
            return bool(_flag(self.ctl, n == 0 or time.perf_counter() - t0[0] < seconds))

        wall = self.fleet.run_window(go, trace)
        per = self.fleet.B * self.fleet.T * self.fleet.n_chunks
        self.attempted = self.world * per
        self.chunk_walls = self.fleet.chunk_walls
        self.alloc_counts = self.fleet.alloc_counts
        self.rings = profiling.gather_records(self.ctl, since=self.fleet.since)
        self.fleet.digests = self.fleet.settle_outputs()
        self._beat()
        return {"fleet_fps": self.attempted / wall}

    def trace_context(self) -> dict | None:
        ctx = self.fleet.trace_context()
        if ctx is None:
            return None
        ctx.update(rings=self.rings, traced_chunk=self.fleet.traced_chunk, ranks=self.world)
        return ctx

    def free_program(self):
        self.fleet.free_program()

    def check(self, limits: dict) -> list:
        """Every rank's check (:meth:`fleet.Fleet.check` on its own members),
        the largest of each number on rank 0."""
        mine = _rank_result(self.fleet, limits)
        parts = _gather(self.ctl, mine)
        self.done = True
        _leave()                    # with the other ranks, which leave after sending
        self.joined = False
        self._beat()
        ref = parts[0]["digests"]
        compared, where = {}, {}
        for r, p in enumerate(parts):
            differ = sum(p["digests"].get(c) != d for c, d in ref.items())
            differ += len(set(p["digests"]) ^ set(ref))
            for k, v, lim in p["compared"]:
                v = v + differ if k == "exact_mismatches" else v
                compared[k] = (max(compared[k][0], v) if k in compared else v, lim)
            where.update({f"rank {r} {k}": v for k, v in p["where"].items()})
        self.checked = dict(where=where,
                            not_compared={k: max(p["not_compared"][k] for p in parts)
                                          for k in parts[0]["not_compared"]})
        self._report(parts)
        return [(k, v, lim) for k, (v, lim) in compared.items()]

    def _report(self, parts):
        for r, p in enumerate(parts):
            print(f"rank {r} setup (s): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in p["setup"].items())
                  + "; warm-up chunks' own work / exchange (s) "
                  + " ".join(f"{a:.3f}/{b:.3f}" for a, b in p["warm_split"]),
                  file=sys.stderr)
            g = np.array(p["graph_counts"]).T.tolist() if p["graph_counts"] else [[], [], []]
            print(f"rank {r}: {p['chunks']} chunks; per chunk "
                  + ", ".join(f"{k} {v}" for k, v in zip(GRAPH_COUNTERS, g))
                  + f"; chunk walls (s) {' '.join(f'{w:.3f}' for w in p['walls'])}",
                  file=sys.stderr)
        if getattr(self.fleet, "gather_bytes", None) is not None:
            print(f"gather.bytes in the traced chunk on rank 0: {self.fleet.gather_bytes}",
                  file=sys.stderr)

    def close(self):
        """Stop the render, wait for the other ranks (each must exit 0; after
        a failure they are stopped), and end the group if the run did not."""
        self.fleet.close()
        watch = self.watch
        if watch is not None:
            with watch.lock:
                watch.closing = True
        try:
            failed = [] if watch is None or watch.failed is None else [watch.failed]
            deadline = time.monotonic() + (60.0 if self.done else 10.0)
            for r, p in self.procs.items():
                try:
                    rc = p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    rc = p.wait()
                if rc != 0 and not failed:
                    failed.append(f"rank {r} exited with code {rc}")
                    print(f"--- rank {r}'s log (tail) ---\n{_tail(self.logs[r])}",
                          file=sys.stderr, flush=True)
            if self.joined:
                self.joined = False
                _leave()
            if failed:
                raise RankFailed("; ".join(failed))
        finally:
            for p in self.procs.values():
                if p.poll() is None:
                    p.kill()
            if watch is not None:
                watch.finished.set()
            if self.tmp is not None:
                shutil.rmtree(self.tmp, ignore_errors=True)
                self.tmp = None


def _rank_result(run: RankFleet, limits: dict) -> dict:
    """What a rank sends rank 0 after its check."""
    compared = run.check(limits)
    return dict(compared=compared, digests=run.digests,
                where={k: str(v) for k, v in run.checked["where"].items()},
                not_compared=run.checked["not_compared"], chunks=run.n_chunks,
                graph_counts=run.graph_counts, walls=run.chunk_walls,
                setup=run.setup_phases, warm_split=run.warm_split)


# ---------------------------------------------------------------------------
# the other ranks: child processes
# ---------------------------------------------------------------------------


def _child_watch(stop: threading.Event, last: list):
    """End this child when its parent is gone or it makes no progress."""
    parent = os.getppid()
    while not stop.wait(POLL_S):
        if os.getppid() != parent:
            os._exit(76)
        if time.monotonic() - last[0] > STALL_S:
            print(f"fleet_ranks: no progress for {STALL_S:.0f} s", file=sys.stderr, flush=True)
            os._exit(77)


def child(spec: dict) -> int:
    """Rank ``spec["rank"]`` of a run: the same steps as rank 0's, paced by
    rank 0's messages."""
    rank, world = int(spec["rank"]), int(spec["world"])
    last = [time.monotonic()]
    stop = threading.Event()
    threading.Thread(target=_child_watch, args=(stop, last), daemon=True).start()

    def beat():
        last[0] = time.monotonic()

    device = _rank_device(spec["device"], rank)
    run = RankFleet(spec["cell"], spec["seed"], device, spec["program"], spec["workers"],
                    rank, world, beat)
    try:
        import torch
        from randt_slam_torch.utils import profiling

        if torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        run.start()
        t0 = time.perf_counter()
        group, ctl = _join(device, rank, world, spec["coordinator"])
        beat()
        run.setup(group, ctl, time.perf_counter() - t0)
        _flag(ctl)
        killed = spec["program"] == "fault:rank_killed" and rank == 1

        def go(n):
            if killed and n == 1:
                os.kill(os.getpid(), signal.SIGKILL)
            return bool(_flag(ctl))

        run.run_window(go, trace=False)
        profiling.gather_records(ctl, since=run.since)
        beat()
        run.digests = run.settle_outputs()
        run.free_program()
        _gather(ctl, _rank_result(run, spec["cell"]["workload"]["limits"]))
        _leave()
        return 0
    finally:
        run.close()
        stop.set()


if __name__ == "__main__":
    sys.exit(child(json.loads(sys.argv[1])))
