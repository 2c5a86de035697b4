"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. the CUDA kernels of the main path (``randt_slam_torch/csrc``) build with
   nvcc, all sources at once;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of one Oxford-geometry frame (400 azimuths x 1157 range bins), on seeded
   random inputs and on a rendered frame; its time (CUDA events), the plain
   version's, a one-call PyTorch yardstick and the least time the card could
   take for the same work;
4. the main path: ``run_odometry`` with ``oxford_config()`` over 160 rendered
   frames of that geometry; every kernel must launch once per frame, all
   poses finite, odometry ATE against the rendered ground truth within the
   band below; steady frames/s and ms/frame, timed inside the run, and the
   host's CPU model, clock and load beside them;
5. the first 20 frames twice on the card (bitwise-identical poses) and once
   on the CPU (identical node/edge tables, poses within 1e-2 m and 1e-3 rad
   on every frame);
6. a short ``torch.profiler`` window: device busy share, the kernels that
   take the device time, and host and device time per layer of the port.

The second-to-last line of the output is the kernels' JSON record, the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_AZ = 400
BIN_W = 0.0864          # m: Oxford bins after the 2x downsampling of io/oxford
MAX_RANGE = 100.0
N_FRAMES = 160
N_SHORT = 20
ATE_BAND_M = 0.25       # odometry ATE over the 160 frames (~160 m driven)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM, non-tensor float32, published


def render_frames(n_frames, seed=0):
    """Oxford-geometry frames: a smooth drive through a scatterer world,
    rendered as polar intensity images (as the JAX package's bench.py does
    without the recorded ground truth)."""
    from randt_slam_torch.io import synthetic as S

    rng = np.random.default_rng(seed)
    gt = S.make_trajectory(rng, n_frames, dt=0.25, speed=4.0)
    landmarks = S.make_world(rng, trajectory=gt, n_walls=120, corridor=50.0,
                             n_clutter=240)
    az = (np.arange(N_AZ) / N_AZ * 2 * np.pi - np.pi).astype(np.float32)
    n_bins = int(MAX_RANGE / BIN_W)
    ranges = ((np.arange(n_bins) + 0.5) * BIN_W).astype(np.float32)
    scans = np.stack([
        S.render_scan_fast(
            p, landmarks[(np.abs(landmarks[:, 0] - p[0]) < MAX_RANGE + 5)
                         & (np.abs(landmarks[:, 1] - p[1]) < MAX_RANGE + 5)],
            az, ranges, rng)
        for p in gt
    ]).astype(np.float32)
    stamps = (np.arange(n_frames) * 0.25).astype(np.float32)
    return scans, az, ranges, stamps, gt


def device_ms(fn, reps=50):
    """Median device time of ``fn`` in ms: each call is queued behind a
    sleep kernel so the host's launch overhead does not enter the events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def frame_inputs(cfg, scan_np, az, ranges, dev):
    """K1 and K2 inputs of one frame, formed as the main path forms them."""
    import torch
    import torch.nn.functional as Fn

    from randt_slam_torch import preprocess as pp
    from randt_slam_torch.ndt import cells as C

    img = torch.from_numpy(scan_np).to(dev)
    r = torch.from_numpy(ranges).to(dev)
    pc = cfg.preprocessor
    rw = 32
    gated = torch.where(((r > pc.min_range) & (r < pc.max_range))[None, :], img,
                        float("-inf"))
    peak = torch.argmax(gated, dim=1)
    sentinel = torch.full((rw,), -1e9, device=dev)
    k1 = (Fn.pad(img, (rw, rw)).contiguous(), torch.cat([sentinel, r, sentinel]),
          peak, 2 * rw + 1)
    scan = pp.PolarScan(img, torch.from_numpy(az).to(dev), r,
                        torch.ones(img.shape[0], dtype=torch.bool, device=dev))
    filt = pp.filter_scan(scan, pc, torch.zeros(3, device=dev))
    ids, num = pp.cluster_ids(filt.points, filt.mask, pc)
    values = C._moment_channels(filt.points, filt.mask).contiguous()
    return k1, (values, ids, num, cfg.capacity.max_scan_cells)


def check_k1(k1_sets, dev):
    import torch

    from randt_slam_torch.ops import window_slice as K1

    err = 0.0
    for img, rng_row, starts, win in k1_sets:
        a = K1.row_windows_cuda(img, rng_row, starts, win)
        b = K1.row_windows_plain(img, rng_row, starts, win)
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError("K1 row_windows: kernel differs from the plain version")
        err = max(err, float((a[0] - b[0]).abs().max()), float((a[1] - b[1]).abs().max()))
    img, rng_row, starts, win = k1_sets[-1]
    A, R = img.shape
    jw = (starts[:, None] + torch.arange(win, device=dev)[None, :]).clamp(0, R - 1)
    t = dict(
        ms=device_ms(lambda: K1.row_windows_cuda(img, rng_row, starts, win)),
        plain_ms=device_ms(lambda: K1.row_windows_plain(img, rng_row, starts, win)),
        library_ms=device_ms(lambda: torch.gather(img, 1, jw)),
    )
    # the least the function must move: the image windows, the range row and
    # the row starts read once, two (A, win) float32 outputs written
    nbytes = A * win * 4 + R * 4 + A * 4 + 2 * A * win * 4
    b, by = bound_ms(nbytes, 0)
    print(f"K1 row_windows: bitwise equal to plain on {len(k1_sets)} inputs; "
          f"kernel {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
          f"torch.gather (image half only) {t['library_ms'] * 1e3:.2f} us, "
          f"bound {b * 1e3:.3f} us ({by}, {nbytes} B)", flush=True)
    return dict(max_abs_err=err, bound_ms=b, bound_by=by, **t)


def check_k2(k2_sets, dev):
    import torch

    from randt_slam_torch.ops import segment_moments as K2

    err = 0.0
    for values, ids, num, k in k2_sets:
        out, topi = K2.segment_topk_moments(values, ids, num, k)
        again, topi_again = K2.segment_topk_moments(values, ids, num, k)
        plain = K2.topi_moments_plain(values, ids, topi, num)
        scale = K2.topi_moments_plain(values.abs(), ids, topi, num)
        _, topi_cpu = K2.segment_topk_moments(values.cpu(), ids.cpu(), num, k)
        torch.cuda.synchronize()
        if not (torch.equal(out, again) and torch.equal(topi, topi_again)):
            raise AssertionError("K2: two launches are not bitwise identical")
        if not torch.equal(topi.cpu(), topi_cpu):
            raise AssertionError("K2: top-k segments differ from the CPU path's")
        rel_ok = (out - plain).abs() <= 1e-5 * scale
        if not bool(rel_ok.all()):
            raise AssertionError("K2: moments differ from plain beyond 1e-5 of their scale")
        err = max(err, float((out - plain).abs().max()))
    values, ids, num, k = k2_sets[-1]
    P, CH = values.shape
    _, topi = K2.segment_topk_moments(values, ids, num, k)
    ok = (ids >= 0) & (ids < num)
    ids32, topi32 = torch.where(ok, ids, -1).to(torch.int32), topi.to(torch.int32)
    rank = torch.full((num + 1,), k, dtype=torch.long, device=dev)
    rank[topi] = torch.arange(k, device=dev)
    rank_of_point = rank[torch.where(ok, ids, num).long()]
    t = dict(
        ms=device_ms(lambda: K2.topi_moments_cuda(values, ids32, topi32)),
        plain_ms=device_ms(lambda: K2.topi_moments_plain(values, ids, topi, num)),
        library_ms=device_ms(lambda: torch.zeros(k + 1, CH, device=dev).index_add_(
            0, rank_of_point, values)),
    )
    # the least the function must move: every id, the value rows of the
    # points in the kept segments, the k segment ids, the (k, CH) output;
    # one add per kept row and channel
    kept_rows = int(torch.isin(ids, topi).sum())
    nbytes = P * 4 + kept_rows * CH * 4 + k * 4 + k * CH * 4
    b, by = bound_ms(nbytes, kept_rows * CH)
    print(f"K2 segment_topk_moments: topi equal to the CPU path's, moments within "
          f"1e-5 of their scale, two launches bitwise equal, on {len(k2_sets)} "
          f"inputs; kernel {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
          f"index_add_ into a rank map (approximate yardstick) "
          f"{t['library_ms'] * 1e3:.2f} us, bound {b * 1e3:.3f} us ({by}, "
          f"{nbytes} B, {kept_rows} rows in the kept segments)", flush=True)
    return dict(max_abs_err=err, bound_ms=b, bound_by=by, **t)


def profile_frames(cfg, frames, n, dev):
    """Device busy share and top kernels over ``n`` frames."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from randt_slam_torch.pipeline import slam

    sub = type(frames)(*(x[:n] for x in frames))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slam.run_odometry(cfg, sub, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies, fills); the host-side operator
    # rows carry the same device time again
    rows = []
    total = 0.0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or e.key.startswith("randt."):
            continue  # host rows, and the device spans of the layer ranges
        rows.append((e.self_device_time_total, e.count, e.key))
        total += e.self_device_time_total
    rows.sort(reverse=True)
    busy = total / 1e6 / wall if wall > 0 else float("nan")
    print(f"profile over {n} frames: wall {wall * 1e3:.1f} ms, device busy "
          f"{total / 1e3:.1f} ms ({100 * busy:.1f}% of wall), "
          f"{sum(r[1] for r in rows)} device launches", flush=True)
    for dt, cnt, key in rows[:12]:
        print(f"  {dt / 1e3:9.3f} ms  {cnt:7d} x  {key[:90]}", flush=True)
    # the port's layers (``randt.*`` profiler ranges): host time inside each,
    # and the device time of the kernels it launched
    for e in prof.key_averages():
        if e.key.startswith("randt.") and not str(e.device_type).endswith("CUDA"):
            print(f"  layer {e.key:22s} {e.count:4d} calls: host "
                  f"{e.cpu_time_total / 1e3 / n:8.2f} ms/frame, device "
                  f"{e.device_time_total / 1e3 / n:7.2f} ms/frame", flush=True)


def host_cpu() -> str:
    """The host's CPU model, usable cores, mean current clock and load."""
    import os

    import platform

    model, mhz = f"CPU model not reported ({platform.machine()})", []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key.strip() == "model name":
                    model = val.strip()
                elif key.strip() == "cpu MHz":
                    mhz.append(float(val))
    except OSError:
        pass
    clock = f"{statistics.mean(mhz):.0f} MHz mean of {len(mhz)}" if mhz else "clock unknown"
    load = ", ".join(f"{x:.2f}" for x in os.getloadavg())
    return (f"{model}; {len(os.sched_getaffinity(0))} usable of {os.cpu_count()} "
            f"cores; {clock}; load average {load}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import randt_slam_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the randt_slam_torch package is not beside this script",
              file=sys.stderr)
        return 1
    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.io import formats
    from randt_slam_torch.ops import build
    from randt_slam_torch.pipeline import slam

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi, flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for "
          f"{sorted(built) or 'nothing (cached)'}", flush=True)
    for n, (sec, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {n}: {sec:.2f} s; {'; '.join(regs)}", flush=True)

    # ---- 3. kernels against their plain versions ---------------------------
    cfg = oxford_config()
    t0 = time.perf_counter()
    scans, az, ranges, stamps, gt = render_frames(N_FRAMES)
    print(f"rendered {N_FRAMES} frames of {scans.shape[1]}x{scans.shape[2]} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(1)
    A, R, win = N_AZ, scans.shape[2] + 64, 65
    k1_sets = [(
        torch.from_numpy(rng.random((A, R), dtype=np.float32) * 255).to(dev),
        torch.from_numpy(rng.random(R, dtype=np.float32) * 100).to(dev),
        torch.from_numpy(rng.integers(-8, R - win + 8, A)).to(dev), win)]
    P, num = A * win, cfg.preprocessor.cluster_row_size ** 2
    vals = rng.normal(0, 30, (P, 13)).astype(np.float32)
    vals[:, 0] = (rng.random(P) < 0.3).astype(np.float32)
    k2_sets = [(torch.from_numpy(vals).to(dev),
                torch.from_numpy(rng.integers(-1, num + 1, P)).to(dev), num,
                cfg.capacity.max_scan_cells)]
    k1_frame, k2_frame = frame_inputs(cfg, scans[N_FRAMES // 2], az, ranges, dev)
    k1_sets.append(k1_frame)
    k2_sets.append(k2_frame)
    k1 = check_k1(k1_sets, dev)
    k2 = check_k2(k2_sets, dev)

    # ---- 4./5. the main path ------------------------------------------------
    frames = slam.frames_from_arrays(scans, az, ranges, stamps, device=dev)
    short = type(frames)(*(x[:N_SHORT] for x in frames))
    t0 = time.perf_counter()
    r_a = slam.run_odometry(cfg, short, device=dev)
    print(f"first {N_SHORT}-frame run (cold): {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    r_b = slam.run_odometry(cfg, short, device=dev)
    wall_short = time.perf_counter() - t0
    for k in ("odom_poses", "node_pose", "edge_trans"):
        if not np.array_equal(getattr(r_a, k), getattr(r_b, k)):
            raise AssertionError(f"two CUDA runs differ in {k}")
    print(f"two CUDA runs of {N_SHORT} frames: bitwise-identical poses "
          f"({wall_short:.2f} s warm)", flush=True)

    print(f"host before the main path: {host_cpu()}", flush=True)
    marks, cpu_marks = [], []

    def mark(t, carry):
        # the steady window opens with the device drained at frame N_SHORT;
        # every frame's host issue time is kept without a sync
        if t == N_SHORT:
            torch.cuda.synchronize()
            cpu_marks.extend((time.process_time(), time.thread_time()))
        marks.append(time.perf_counter())

    build.reset_launches()
    t0 = time.perf_counter()
    res = slam.run_odometry(cfg, frames, device=dev, on_frame=mark)
    t_end = time.perf_counter()
    proc_s, thread_s = time.process_time() - cpu_marks[0], time.thread_time() - cpu_marks[1]
    wall = t_end - t0
    launches = dict(build.LAUNCHES)
    for kname, cnt in launches.items():
        if cnt != N_FRAMES:
            raise AssertionError(f"{kname} launched {cnt} times over {N_FRAMES} frames")
    if not np.all(np.isfinite(res.odom_poses)) or res.odom_poses.shape != (N_FRAMES, 3):
        raise AssertionError("odometry poses are not finite / of the expected shape")
    ate = formats.ate(res.odom_poses, gt)
    t_rpe, r_rpe = formats.rpe(res.odom_poses, gt)
    # frames N_SHORT..N-1, from the drained device at frame N_SHORT to the
    # end of run_odometry (its flush and the one copy of the outputs)
    steady_ms = (t_end - marks[N_SHORT]) / (N_FRAMES - N_SHORT) * 1e3
    issue = np.diff(marks[N_SHORT:]) * 1e3
    print(f"main path: {N_FRAMES} frames in {wall:.2f} s; steady (frames "
          f"{N_SHORT}..{N_FRAMES - 1}, timed inside the run) {steady_ms:.1f} "
          f"ms/frame = {1e3 / steady_ms:.3f} frames/s; host issue time per frame "
          f"median {np.median(issue):.1f} ms, min {issue.min():.1f}, max "
          f"{issue.max():.1f}; warm {N_SHORT}-frame run "
          f"{wall_short / N_SHORT * 1e3:.1f} ms/frame; launches {launches}; "
          f"{len(res.node_id)} nodes, {res.n_submaps} submaps, "
          f"{int(res.rejected_frames.sum())} rejected frames", flush=True)
    # CPU time over the steady window: near the wall when the host thread
    # ran all along (a slower run then spent more CPU per frame), well below
    # it when the thread waited (the device, or other work on the host)
    window_s = t_end - marks[N_SHORT]
    print(f"host after the main path: {host_cpu()}; CPU time over the steady "
          f"window: main thread {thread_s / window_s * 100:.1f} % of the wall, "
          f"whole process {proc_s / window_s * 100:.1f} %", flush=True)
    print(f"odometry vs rendered ground truth: ATE {ate:.4f} m (band < "
          f"{ATE_BAND_M} m), RPE {t_rpe:.4f} m / {r_rpe:.4f} deg", flush=True)
    if not ate < ATE_BAND_M:
        raise AssertionError(f"odometry ATE {ate:.3f} m outside the band")

    t0 = time.perf_counter()
    frames_cpu = slam.frames_from_arrays(scans[:N_SHORT], az, ranges,
                                         stamps[:N_SHORT], device="cpu")
    r_cpu = slam.run_odometry(cfg, frames_cpu, device="cpu")
    for k in ("node_id", "node_frame", "node_submap", "node_is_root",
              "edge_begin", "edge_end"):
        if not np.array_equal(getattr(r_cpu, k), getattr(r_a, k)):
            raise AssertionError(f"CUDA and CPU {k} tables differ")
    d = np.abs(r_cpu.odom_poses - r_a.odom_poses)
    pos = d[:, :2].max(axis=1)
    if not (d[:, 2].max() <= 1e-3 and pos.max() <= 1e-2):
        raise AssertionError(f"CUDA and CPU poses differ: {pos.max():.4f} m, "
                             f"{d[:, 2].max():.2e} rad")
    print(f"CPU run of {N_SHORT} frames ({time.perf_counter() - t0:.1f} s): tables "
          f"identical; poses within {pos.max():.2e} m / {d[:, 2].max():.2e} rad "
          f"of the CUDA run", flush=True)

    # ---- 6. profile --------------------------------------------------------
    profile_frames(cfg, frames, 3, dev)

    kernels = [
        dict(name="row_windows", route="cuda",
             source="randt_slam_torch/csrc/window_slice.cu",
             replaces="randt_slam_tpu/ops/window_slice.py:49",
             launches=launches["row_windows"], **k1),
        dict(name="segment_topk_moments", route="cuda",
             source="randt_slam_torch/csrc/segment_moments.cu",
             replaces="randt_slam_tpu/ops/segment_moments.py:154",
             launches=launches["segment_topk_moments"], **k2),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
