"""Fleet replay: B recorded drives stepped together through the port's
batched odometry, closed loop, chunk after chunk.

The traffic of a cell (``benchmark/workloads/<cell>.json``, ``params``):

* ``batch``: B members stepped together by
  ``randt_slam_torch.parallel.batch.make_batched_scan``;
* ``drives``: the number of distinct drives rendered from ``--seed``
  (member b replays drive ``b % drives``), each a closed lap of the
  configuration's drive (``benchmark/configs/<config>.json``, ``drive``);
* members of one drive start at ``batch / drives`` offsets spread evenly
  round its lap, and every member wraps round its lap, so no member runs
  out of frames however fast the step gets;
* ``chunk``: frames handed to the scan function per call, the carries
  passed on; the frames live on the card and each chunk is gathered from
  them by index;
* ``warmup_frames``: frames stepped before the window (rounded up to whole
  chunks), which reach the steady state and run every shape and branch the
  window runs, a submap switch included;
* ``check_frames``, ``check_members``: how many (frame, member) pairs of
  the window the plain reference checks, drawn from the seed
  (``benchmark/check.py``).

Closed loop: the next chunk starts when the last one's outputs are on the
host.  ``fleet_fps`` is every member-frame completed in the window over the
window's wall time; the window ends at the synchronised end of the last
chunk started before ``--seconds`` ran out.
"""

from __future__ import annotations

import math
import os
import random
import time

import numpy as np

from ..inputs import drives as D

KEEP_FIRST = 2    # the check keeps one of the window's first chunks, drawn from the seed


def make(cell: dict, seed: int, device: str = "cuda", program: str = "port",
         workers: int | None = None):
    """The run of a fleet cell (the generator's entry for ``run.py``)."""
    return Fleet(cell, seed, device, program, workers)


class Fleet:
    """One run of a fleet cell: inputs, the program, the window, the check.

    ``program`` is ``"port"`` (what the benchmark measures), ``"control"``
    (the plain reference in the port's place, one precision below the
    configuration's; see :func:`_control`) or ``"fault:<name>"`` (the port
    with a fault planted; see :func:`_faulty`), the last two for the tests
    and the readings of the limits."""

    def __init__(self, cell: dict, seed: int, device: str = "cuda",
                 program: str = "port", workers: int | None = None):
        self.params = cell["workload"]["params"]
        self.conf = cell["config"]
        self.seed = int(seed)
        self.device = device
        self.program = program
        self.B = int(self.params["batch"])
        self.T = int(self.params["chunk"])
        self.drives = int(self.params["drives"])
        if self.B % self.drives:
            raise ValueError(f"batch {self.B} is not a multiple of drives {self.drives}")
        self.workers = workers or min(self.drives, os.cpu_count() or 1)
        self._render = None
        self._laps = None
        self.traced = None
        self.attempted = 0

    # ------------------------------------------------------------------ inputs

    def start(self):
        """Start rendering the drives (threads of this process), so that
        they render while the program and the card start."""
        drive = self.conf["drive"]
        self._render = D.LapRender(drive["kind"], drive, self.seed,
                                   self.drives, self.workers)

    def use_laps(self, laps: list):
        """Take laps rendered before (``inputs.drives.LapRender``) for this
        run's seed, instead of rendering them."""
        self._laps = laps

    def close(self):
        """Stop the render if it still runs, and wait for it."""
        if self._render is not None:
            self._render.close()
            self._render = None

    def _inputs(self):
        import torch

        laps, self._laps = self._laps, None   # the host's copy goes once uploaded
        dev = self.dev
        drive = self.conf["drive"]
        self.lap = int(drive["lap_frames"])
        self.dt = float(drive["dt"])
        self.use_imu = bool(self.prog_cfg.use_imu)
        self.imu_bias = float(drive.get("imu_bias", 0.0))
        self.scans = torch.from_numpy(np.stack([x["scans"] for x in laps])).to(dev)
        self.yaw = torch.from_numpy(np.stack([x["gt"][:, 2] for x in laps])).to(dev)
        self.imu_noise = torch.from_numpy(np.stack([x["imu_noise"] for x in laps])).to(dev)
        az, ranges = laps[0]["az"], laps[0]["ranges"]
        B, T = self.B, self.T
        self.az = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(az, (B, T, az.size)))).to(dev)
        self.ranges = torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(ranges, (B, T, ranges.size)))).to(dev)
        self.mask = torch.ones((B, T, az.size), dtype=torch.bool, device=dev)
        per = B // self.drives
        b = np.arange(B)
        offsets = np.round((b // self.drives) * self.lap / per).astype(np.int64) % self.lap
        self.drive_of = torch.from_numpy(b % self.drives).to(dev)
        self.offset = torch.from_numpy(offsets).to(dev)

    def frames(self, c: int):
        """The Frame of chunk ``c`` (global frames c*T .. c*T + T - 1 of
        every member), gathered on the card."""
        from randt_slam_torch.pipeline.frontend import Frame
        return Frame(*self._fields(c * self.T, self.T))

    def _fields(self, start: int, n: int, members=None):
        """(intensity, azimuths, ranges, azimuth_mask, stamp, imu_yaw, index)
        of global frames start .. start + n - 1 of ``members`` (all by
        default), each (b, n, ...)."""
        import torch

        steps = torch.arange(start, start + n, device=self.dev)
        drive_of, offset = self.drive_of, self.offset
        if members is not None:
            drive_of, offset = drive_of[members], offset[members]
        b = drive_of.shape[0]
        fidx = (offset[:, None] + steps[None, :]) % self.lap
        dsel = drive_of[:, None].expand_as(fidx)
        intensity = self.scans[dsel, fidx]
        stamp64 = steps.to(torch.float64) * self.dt
        stamp = stamp64.to(torch.float32)[None, :].expand(b, -1).contiguous()
        if self.use_imu:
            imu = (self.yaw[dsel, fidx].double() + self.imu_noise[dsel, fidx].double()
                   + self.imu_bias * stamp64[None, :])
            imu = torch.atan2(torch.sin(imu), torch.cos(imu)).to(torch.float32)
        else:
            imu = torch.zeros((b, n), dtype=torch.float32, device=self.dev)
        index = steps.to(torch.int32)[None, :].expand(b, -1).contiguous()
        if members is None and n == self.T:
            az, ranges, mask = self.az, self.ranges, self.mask
        else:
            az = self.az[:1, :1].expand(b, n, -1).contiguous()
            ranges = self.ranges[:1, :1].expand(b, n, -1).contiguous()
            mask = self.mask[:1, :1].expand(b, n, -1).contiguous()
        return (intensity, az, ranges, mask, stamp, imu, index)

    # ----------------------------------------------------------------- program

    def setup(self):
        """Build the program, load the drives onto the card, warm up.
        ``setup_phases`` keeps each part's seconds."""
        import torch

        from .. import cellspec
        t = time.perf_counter()
        phases = self.setup_phases = {}

        def lap(name):
            nonlocal t
            now = time.perf_counter()
            phases[name] = now - t
            t = now

        self.dev = torch.device(self.device)
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
        self.scan_fn, init = _program(self.program, self.prog_cfg, self.ref_cfg,
                                      self.s2b, self.dev, self.B)
        self.carries = init()
        self.init_carry = self.carries
        self.chunk = 0
        n_warm = max(1, math.ceil(int(self.params["warmup_frames"]) / self.T))
        for _ in range(n_warm):
            self._step_chunk()
        self._sync()
        lap("warmup")

    def _sync(self):
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _step_chunk(self, on_frame=None):
        frames = self.frames(self.chunk)
        self.carries, outs = self.scan_fn(self.carries, frames, on_frame=on_frame)
        self.chunk += 1
        return outs

    def window(self, seconds: float, trace: bool) -> dict:
        """The timed window: chunks until ``seconds`` have passed; with
        ``trace``, the window's second chunk runs under ``torch.profiler``.
        Returns the end-to-end metrics this traffic measures."""
        import torch

        # the chunks whose carries the check may read: one of the first
        # KEEP_FIRST, drawn from the seed, and the last; every seed holds
        # the same number of chunks for the same stretch of the window
        keep_at = random.Random(f"{self.seed}:keep").randrange(KEEP_FIRST)
        self.kept = {}         # chunk -> carries at each frame boundary
        self.outs = {}         # chunk -> numpy outputs
        self._sync()
        mem0 = _alloc_counts(self.dev)
        t0 = time.perf_counter()
        n = 0
        self.chunk_walls = []
        while n == 0 or time.perf_counter() - t0 < seconds:
            tc = time.perf_counter()
            c = self.chunk
            keep = n == keep_at
            snaps = []
            on_frame = (lambda t, carries: snaps.append(carries))
            if trace and n == 1:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                with prof:
                    with torch.profiler.record_function("bench.traced"):
                        outs = self._step_chunk(on_frame)
                        self._sync()
                self.traced = (prof, c)
            else:
                outs = self._step_chunk(on_frame)
            snaps.append(self.carries)
            self.chunk_walls.append(time.perf_counter() - tc)
            self.outs[c] = outs
            last = (c, snaps)
            if keep:
                self.kept[c] = snaps
            n += 1
        self._sync()
        wall = time.perf_counter() - t0
        self.alloc_counts = {k: v - mem0.get(k, 0) for k, v in _alloc_counts(self.dev).items()}
        if last[0] not in self.kept:
            self.kept[last[0]] = last[1]
        self.attempted = self.B * self.T * n
        return {"fleet_fps": self.B * self.T * n / wall}

    # ----------------------------------------------------------- per-layer data

    def trace_context(self) -> dict | None:
        """What the per-layer readers read: the traced chunk's events, its
        steps and span, and the shapes of the kernels' calls in it."""
        if self.traced is None:
            return None
        from .. import trace
        from ..reference.pipeline import frontend as RF

        prof, c = self.traced
        events = trace.collect(prof)
        self.traced = None
        del prof
        span = trace.span(events, "bench.traced")
        # K2's work depends on the data: the points of the kept cells, worked
        # out by the reference from the traced chunk's frames
        k2 = []
        cap = self.ref_cfg.capacity
        for t in range(self.T):
            fr = self._ref_frame(c, t)
            scan, filt = RF.build_scan_cells(self.ref_cfg, fr, self.s2b_ref())
            kept = float(scan.stats.n.sum())
            k2.append(dict(B=self.B, P=int(filt.points.shape[-2]), CH=13,
                           k=int(cap.max_scan_cells), kept_rows=kept))
        W = self.ref_cfg.matcher.smoothing_steps
        return dict(events=events, steps=self.T, span=span,
                    shapes=dict(k2=k2, k4=dict(B=self.B, P=9 * (W + 1))),
                    breakdown=trace.breakdown(events, span))

    def s2b_ref(self):
        import torch
        return torch.as_tensor(self.s2b).to(self.dev)

    def _ref_frame(self, c, t, members=None):
        """Frame t of chunk c of ``members`` as the reference's Frame of
        (b, ...) tensors."""
        from ..reference.pipeline import frontend as RF
        return RF.Frame(*(x[:, 0] for x in self._fields(c * self.T + t, 1, members)))

    # -------------------------------------------------------------------- check

    def free_program(self):
        """Drop what only the window needed (the chunk's frames, the
        program's latest carry beyond those kept for the check)."""
        import torch
        self.carries = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> list:
        """Hold a sample of the window's steps, drawn from the seed, and the
        program's initial carry against the plain reference.  Returns
        [(name, value, limit)] for every number the cell's limits name."""
        import torch

        from .. import check as K
        from ..reference.pipeline import frontend as RF

        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            g = K.Gaps()
            rng = np.random.default_rng([abs(self.seed), int(self.seed < 0), 7])
            cands = [(c, t) for c in sorted(self.kept) for t in range(self.T)]
            n = min(int(self.params["check_frames"]), len(cands))
            pick = sorted(rng.choice(len(cands), size=n, replace=False).tolist())
            nm = min(int(self.params["check_members"]), self.B)
            m_init = torch.from_numpy(_check_members(rng, self.B, nm)).to(self.dev)
            ref_init = RF.init_carry(self.ref_cfg, device=self.dev)
            K.compare_init(g, K.take(self.init_carry, m_init), ref_init)
            del ref_init
            self.init_carry = None
            s2b = self.s2b_ref()
            for i in pick:
                c, t = cands[i]
                snaps = self.kept[c]
                m = torch.from_numpy(_check_members(rng, self.B, nm)).to(self.dev)
                fr = self._ref_frame(c, t, m)
                pre_m = K.take(snaps[t], m)
                ref_in = K.reference_input(self.ref_cfg, snaps[t], m)
                label = f"chunk {c} frame {t}"
                K.compare_caches(g, pre_m, ref_in, label)
                ref_post, ref_out = RF.frontend_step(self.ref_cfg, ref_in, fr, s2b)
                mi = m.cpu().numpy()
                out_m = _take_out(self.outs[c], mi, t)
                K.compare_step(g, out_m, K.take(snaps[t + 1], m), ref_out, ref_post, label)
            q = np.percentile(g.per_pair, [50, 90, 99, 100]).tolist() if g.per_pair else []
            self.checked = dict(frames=n, members=nm, where=dict(g.where), pair_gap_q=q,
                                not_compared={k: g.v[k] for k in K.NUMBERS
                                              if k not in limits})
            return [(k, g.v[k], limits[k]) for k in K.NUMBERS if k in limits]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _alloc_counts(dev) -> dict:
    """The caching allocator's counters of device mallocs, frees and
    retries (a retry frees every cached block and synchronises)."""
    import torch
    if dev.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(dev)
    return {k: st.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc",
                                       "num_device_free", "num_sync_all_streams")}


def _check_members(rng, B, n):
    return np.sort(rng.choice(B, size=n, replace=False)).astype(np.int64)


def _take_out(outs, mi, t):
    """Frame t of members ``mi`` of a chunk's numpy (B, T, ...) outputs."""
    def take(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(take(v) for v in x))
        x = np.asarray(x)
        return x[mi, t]
    return take(outs)


# ---------------------------------------------------------------------------
# the program under test, the control and the planted faults
# ---------------------------------------------------------------------------


def _program(kind, prog_cfg, ref_cfg, s2b, dev, B):
    """``(scan_fn, init)`` of the program under test."""
    if kind == "port":
        from randt_slam_torch.parallel import batch
        scan = batch.make_batched_scan(prog_cfg, s2b, device=dev)
        return scan, lambda: batch.init_batched_carry(prog_cfg, B, device=dev)
    if kind == "control":
        return _control(ref_cfg, s2b, dev, B)
    if kind.startswith("fault:"):
        scan, init = _program("port", prog_cfg, ref_cfg, s2b, dev, B)
        return _faulty(kind[len("fault:"):], scan), init
    raise ValueError(f"unknown program {kind!r}")


def _control(ref_cfg, s2b, dev, B):
    """The plain reference in the port's place, one precision below the
    configuration's float32 with TF32 off: bfloat16 storage, the frames'
    intensities and every float32 tensor of the reference's state but its
    stamps (poses, velocities, the gyro bias, scan cells, maps) rounded to
    bfloat16 between steps, the arithmetic of each step in float32.  TF32,
    the nearest precision below, changes no bit of the Oxford path (PERF.md
    section 4), so it cannot be a control there."""
    import torch

    from randt_slam_torch.pipeline import slam
    from ..reference.pipeline import frontend as RF
    s2b_t = torch.as_tensor(s2b).to(dev)

    def scan(carries, frames, on_frame=None):
        outs = []
        for t in range(frames.stamp.shape[1]):
            carries = _bf16_state(carries)
            if on_frame is not None:
                on_frame(t, carries)
            fr = RF.Frame(*(x[:, t] for x in frames))
            fr = fr._replace(intensity=_bf16(fr.intensity))
            carries, out = RF.frontend_step(ref_cfg, carries, fr, s2b_t)
            outs.append(out)
        return carries, slam.stack_outputs(outs, batch=frames.stamp.shape[0])

    return scan, lambda: RF.init_batched_carry(ref_cfg, B, device=dev)


def _bf16(x):
    import torch
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _bf16_state(c):
    """A reference carry with its float32 tensors but the stamps rounded to
    bfloat16 (the store, written in place and never read, is left)."""
    keep = {"stamps", "kq_stamp", "store_cells", "store_origin", "store_root"}

    def rnd(x):
        if isinstance(x, tuple):
            return type(x)(*(rnd(v) for v in x))
        return _bf16(x)
    return c._replace(**{f: rnd(getattr(c, f)) for f in c._fields if f not in keep})


def _faulty(name, scan):
    """The port's scan with one fault planted:

    * ``state_unchanged``: every step returns the state it was given;
    * ``half_batch``: the second half of the members is left out, and its
      outputs and state are the first half's;
    * ``answer_altered``: member 0's odometry pose is moved by 0.25 m in
      every frame where it is produced."""
    import torch

    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam

    def one_frame(carries, frames, t):
        fr = F.Frame(*(x[:, t:t + 1] for x in frames))
        return scan(carries, fr)

    def run(carries, frames, on_frame=None):
        outs = []
        for t in range(frames.stamp.shape[1]):
            if on_frame is not None:
                on_frame(t, carries)
            if name == "state_unchanged":
                _, out = one_frame(_clone(carries), frames, t)
            elif name == "half_batch":
                h = frames.stamp.shape[0] // 2
                first = _half(carries, h)
                new, out = one_frame(first, F.Frame(*(x[:h] for x in frames)), t)
                carries = _dup(new, carries)
                out = _dup_np(out)
            elif name == "answer_altered":
                carries, out = one_frame(carries, frames, t)
                pose = out.odom_pose.copy()
                pose[0, :, 0] += 0.25
                out = out._replace(odom_pose=pose)
            else:
                raise ValueError(f"unknown fault {name!r}")
            outs.append(out)
        return carries, _cat_outs(outs)

    return run


def _clone(x):
    import torch
    if isinstance(x, tuple):
        return type(x)(*(_clone(v) for v in x))
    return x.clone() if isinstance(x, torch.Tensor) else x


def _half(x, h):
    import torch
    if isinstance(x, tuple):
        return type(x)(*(_half(v, h) for v in x))
    return x[:h].clone() if isinstance(x, torch.Tensor) else x


def _dup(new, like):
    """The first half's tensors repeated to the whole batch (in place for
    the store, as the port updates it)."""
    import torch
    if isinstance(new, tuple):
        return type(new)(*(_dup(a, b) for a, b in zip(new, like)))
    if isinstance(new, torch.Tensor):
        return torch.cat([new, new], dim=0)
    return new


def _dup_np(out):
    if out is None:
        return None
    if isinstance(out, tuple):
        return type(out)(*(_dup_np(v) for v in out))
    x = np.asarray(out)
    return np.concatenate([x, x], axis=0) if x.ndim else x


def _cat_outs(outs):
    """Per-frame (B, 1, ...) numpy outputs joined along the frames."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_cat_outs([o[i] for o in outs]) for i in range(len(first))))
    arrs = [np.asarray(o) for o in outs]
    if arrs[0].ndim < 2:
        return arrs[0]
    return np.concatenate(arrs, axis=1)
