"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--save-slam-graph PATH]
    python3 chip_smoke.py --multi-device PATH    # phases 1, 2 and 12 alone

Five paths of the port run at the Oxford configuration, and two modules
between them (and, last, the IMU-aided path at the indoor configuration): offline odometry with the kernel switches off
(``oxford_config()``: the scan kernels K1 and K2, the LM loop in autograd
and ``solve_ex``) and on
(``use_pallas_linearize`` and ``use_pallas_chol``: also the fused
linearize/cost kernels K3a/K3b and the Cholesky kernel K4 in the LM loop),
and full offline SLAM (``run_slam``: odometry with the switches on,
ScanContext loop closure with the CS gate, the pose graph), then the
occupancy grid of that SLAM run and the Schur-complement pose graph at a
full sequence's size, then online SLAM (``OnlineSlam``: the same front
end with loop search, the pose graph re-anchoring the active submap and
raytracing on their cadences, checkpoint and resume), and last batched
odometry (``parallel/batch``: B drives per card in one front end, each
kernel taking the whole batch in one launch), and multi-device runs of
batched odometry and of both pose-graph routes (``parallel/mesh``: one
process per rank).  The full segment
sum K5 has no pipeline caller; its entry point is ``ndt/cells.from_points``.

Phases (any failed check raises and the script exits non-zero):

1. the card: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. every CUDA kernel of the port (``randt_slam_torch/csrc``) builds with
   nvcc, all sources at once;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of one Oxford-geometry frame (400 azimuths x 1157 range bins), on seeded
   random inputs and on a rendered frame (K3a/K3b/K4 and the LM
   iteration's own kernels lm_assemble, lm_trial and lm_accept: the inputs
   of every LM iteration of that frame's solve, captured on the
   switches-on path, the last three within ``LM_REL`` of plain, the trial
   bitwise, the acceptance's flags exact where decided; K5: the frame's
   filtered points and cluster ids, and its entry point ``from_points``
   driven once with the counts at 0); its time (CUDA events), the plain
   version's, a one-call PyTorch yardstick where one exists and the least
   time the card could take for the same work; beside them the launch
   floor (an empty launch timed the same way), K4's time for all the
   frame's systems in one launch, whether K4 beats ``cholesky_ex`` +
   ``cholesky_solve``, K2's whole call (counts, stable sort and kernel),
   K5's whole call on the frame and on a dense seeded set, the device
   launches of one K1 and one K5 call (the profiler: exactly the kernel),
   and K1's, K2's, K3a's, K3b's, K4's and K5's times in their earlier
   designs (PERF.md); then K1 to K4 again at phase 13's indoor shapes: K1
   and K2 on frame 10 of phase 13's drive (400 x 400 bins of 3 cm, 256
   kept cells), K3a/K3b/K4 and the LM iteration's kernels on the captured
   inputs of that frame's IMU-on window solve at ``indoor_config()`` (the
   first 11 frames on the switches-on path, the bias column free at the
   reference's weight);
4. per odometry path, ``run_odometry`` over rendered frames of that
   geometry (40 with the switches on, 30 off): exact launch counts (K1 and K2 once per frame; per
   ``estimate_window`` call K3a and K4 gnc_steps x lm_max_iterations times
   and K3b
   2 + gnc_steps x (1 + lm_max_iterations) times on the switches-on path,
   none of them on the other), all poses finite, odometry ATE against the
   rendered ground truth within the band below; steady frames/s and
   ms/frame (frames 20 to the end, timed inside the run), and the host's
   CPU model, clock and load beside them;
5. per odometry path, the first 20 frames twice on the card, the second
   time from host memory in chunks of 8 (``frames_from_arrays(...,
   host=True)``, ``run_odometry(..., chunk=8)``: chunks of 8, 8 and 4, some
   nodes leaving the keyframe queue in the chunk after their source
   frame's), bitwise-identical poses, node and edge tables and node
   descriptors; and the first 12 once on the CPU, where the kernels' plain
   versions run (identical node/edge tables, poses within 1e-2 m and 1e-3
   rad on every frame);
6. per odometry path, a ``torch.profiler`` window over its first two frames
   (one solved): device busy share, launches per LM iteration, the kernels that take the device time, and
   host and device time per layer of the port; the switches-on window must
   hold no LU (``getrf``/``getrs``) kernel and no autograd pass over the NDT
   residuals (``randt.ndt_autograd``), the switches-off window some; each
   window's solved frame is the first of its run's graph key, so it runs
   eagerly and is captured inside the window (a replayed CUDA graph runs
   no Python), and a window that captured nothing fails;
7. full SLAM: ``run_slam`` over a looping drive of that geometry (240
   frames, 1.5 laps of 160 m), the frames in host memory and uploaded 64 at
   a time (``run_slam(..., chunk=64)``, as the JAX package's bench.py runs
   its end-to-end window): each chunk's seconds, the odometry's peak device
   memory and the frames' size; ScanContext candidates, accepted loop edges
   (at least one) and odometry-gate rejections; finite poses; the dense
   pose-graph route with the two-stage DCS schedule; odometry and post-PGO
   node ATE against the rendered ground truth (post-PGO no worse than 1.05 x
   odometry); wall seconds per phase and loop stage, beside the host's CPU;
   exact launch counts of the run (K1 and K2 once per frame and once per
   candidate frame rebuilt in the loop phase, of which the loop phase
   launches exactly the latter; K3a/K3b/K4 per window solve as in phase 4;
   no K5); the loop phase's peak device memory.  Then the loop and
   pose-graph phases again from the same odometry result, twice more on the
   card (bitwise equal; the second under ``torch.profiler``) and once on the
   CPU (identical candidate and edge tables; optimized poses within 1e-3 m /
   1e-4 rad; the CS gate on the card run's cells and refined poses within
   1e-4 relative; free-running, the refined edges within one ulp-decided LM
   step and the CS divergences within the band below);
8. the occupancy grid of that run: ``render_ogm`` at the Oxford OGM
   configuration (13 submaps of 3990 x 3990 int32 counts), the node frames
   gathered from host memory 32 at a time, twice on the card and once on
   the CPU: exact launches (K1 once per chunk of 32 keyframe nodes, nothing
   else), the counting grids bitwise equal across the three runs
   and the occupancy within 1e-5; wall seconds, peak device memory and the
   counts' range; a third card run under the profiler (device busy share,
   launches, top kernels);
9. the Schur-complement pose graph at a full Oxford sequence's size: the
   JAX package's ``bench.py`` graph of 4077 nodes through ``optimize_auto``
   on the card (the Schur route, no kernel of the port launched, bitwise
   repeatable), held to the ground truth, to the dense route on the card
   and to the Schur route on the CPU within ``SCHUR_BAND``; the steady
   call's wall ms, iterations and ms per iteration, the
   ``max_iterations=10`` figure ``bench.py`` reports, and a profile of that
   call (device busy share, launches per iteration, top kernels);
10. online SLAM: ``OnlineSlam`` over the first 190 frames of phase 7's
   drive (switches on, default cadences: loop search every 5 frames, pose
   graph every 20; the online OGM on), then ``finalize`` and
   ``render_ogm``: exact launches (K1 and K2 once per frame; K3a/K3b/K4
   per window solve as in phase 4; none in the loop cadences or in any
   refinement; no K5); at least one accepted loop edge and one mid-run
   pose-graph tick with loop edges that moves the active submap's origin;
   finite poses; post-PGO node ATE no worse than 1.05 x the node ATE as
   odometry emitted the nodes; the odometry trace bitwise equal to phase
   7's on every frame before the first re-anchoring; steady ms/frame
   beside phase 7's odometry, stage medians, candidates refined; the
   counting grids on the card (those of submaps that can still receive
   nodes) and in host memory (the finished ones), with their bytes, and no
   grid uploaded again; peak device memory.  A checkpoint after frame 178
   (its size, save and load seconds): a fresh engine resumes it on the
   card to the end, bitwise equal to the uninterrupted run (odometry,
   trajectory, edges, counting grids, whether on the card or the host; K1
   and K2 once more per restored-frame node), and one cadence
   from it on the CPU and on the card gives the same candidates and edges,
   refined edges and CS within the bands below and optimized poses within
   1e-3 m / 1e-4 rad;
11. batched odometry: ``parallel/batch.make_batched_scan`` over B distinct
   drives of that geometry per card (drive 0 is phase 4's), B in
   ``BATCH_SIZES`` with the switches on over 30 frames and B = 4 with the
   switches off over 12: per B the steady ms per batched frame and fleet
   frames/s (B x frames / wall, timed inside the run), the device busy share
   and launches per LM iteration of a profiled 2-frame window, the peak
   device memory; exact launches, those of one sequence (K1 and K2 once per
   batched frame, K3a/K3b/K4 per window solve as in phase 4); every member
   against a single-sequence run of its first 8 frames (identical tables,
   poses within ``BATCH_BANDS``, the first frame with other bits printed)
   and its ATE against its rendered ground truth within the band below;
   then K1, K2, K3a, K3b and K4 on one frame's batched inputs of the
   largest batch against their batched plain versions (the tolerances of
   phase 3), B = 1 bitwise equal to the unbatched launch, the LM
   iteration's kernels on every iteration of that frame's batched solve
   (member 0 bitwise its window's launch alone), and their times and
   bounds at that batch;
12. multi-device: the script re-runs itself as the ranks of a world
   (``--md-rank``; the kernels were built once, in phase 2), one rank per
   card under NCCL and, on one card, a 2-rank gloo world whose ranks share
   it (collectives staged through the host); a rank that fails fails the
   run.  Per world: (a) ``make_batched_scan`` with the group over phase
   11's 8 drives x 30 frames (switches on): fleet frames/s (B x frames
   20-29 over the slowest rank's wall) beside phase 11's B = 8 run in this
   call, each rank's launches exactly one sequence's, every member's tables
   identical to phase 11's B = 8 run and its poses within ``BATCH_BANDS``,
   every rank the same gathered outputs, and in the 2-rank world rank 0's
   drives 0-3 bitwise phase 11's B = 4 run; (b) ``optimize_auto`` with the
   group on ``bench.py``'s 4077-node graph at ``max_iterations=10`` (the
   sharded Schur route): phase 9's iteration count, finite poses equal on
   every rank, their gap to phase 9's (or "bitwise"), ms per iteration beside
   phase 9's and beside the unsharded solve in the rank's own process, the
   bytes all-gathered per iteration; (c) ``optimize_distributed`` on phase
   7's pose graph: within ``MD_DENSE_BAND`` of ``pose_graph.optimize`` and
   ``MD_ONE_RANK_BAND`` of rank 0 alone, ms per iteration, the bytes
   all-reduced; (d) per rank the seconds from the spawn to its start, its
   imports, ``init_distributed`` and its first collective.
   ``--save-slam-graph`` writes phase 7's pose graph, which
   ``--multi-device`` reads to run phase 12 alone (with its references
   made anew) on a machine of several cards.
13. indoor with the IMU: ``indoor_config()`` (``use_imu``; 256 scan cells,
   1024 submap cells, a 50 x 50 grid of 1 m cells, a 90 x 40 m OGM at 0.1 m,
   ScanContext's ``num_exclude_recent`` of 50) on a drive rendered at the
   sensor geometry of ``scripts/indoor_sim.py`` (400 azimuths x 400 bins of
   3 cm, 0.8 m/s; 136 frames, laps of 112 frames round a 22.4 m rounded
   square) with a drifting gyro (its kernels at these shapes are checked in
   phase 3): (b) ``run_slam`` from host memory in chunks of 48: exact
   launches as in phase 7, finite poses, odometry ATE within the band, the
   newest bias state within 0.5-1.6 x the rendered drift, at least one
   accepted loop edge, each within ``LOOP_TRUTH_M`` of the rendered ground
   truth, post-PGO node ATE no worse than 1.05 x odometry's, the steady
   odometry ms/frame, and ``render_ogm``'s counting grids bitwise the
   CPU's; (c) that run's first 11 frames against the same frames with the
   gyro readings zeroed (poses more than 1e-6 apart), and its first 10
   against one CPU run of them (identical tables, poses within 1e-2 m /
   1e-3 rad); (d) ``OnlineSlam`` over the first 10 frames with a
   checkpoint after frame 7, resumed bitwise through the loop-search tick
   at 10 (the IMU carry included).
   ``--multi-device`` skips it.

The second-to-last line of the output is the kernels' JSON record, the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_AZ = 400
BIN_W = 0.0864          # m: Oxford bins after the 2x downsampling of io/oxford
MAX_RANGE = 100.0
# odometry main runs per switch setting (the switches-off path, the earlier
# and slower one, is cut deeper to keep the script inside its time on a slow
# host: 40 frames until online SLAM joined; the switches-on one went from 80
# to 60 frames when the long-sequence path joined phases 5, 7, 8 and 10,
# and to 40 when phase 13 joined; full SLAM drives the switches-on path over
# 240 frames)
N_FRAMES = {"on": 40, "off": 30}
N_SHORT = 20
N_CPU = 12              # phase 5's CPU run (20 frames until phase 13 joined)
SHORT_CHUNK = 8         # phase 5's host-resident run: chunks of 8, 8 and 4
LOOP_CHUNK = 64         # phase 7's host-resident run
OGM_CHUNK = 32          # phase 8: node frames per batched filter (K1) call
# the odometry drive as rendered since PR 1 (its trajectory depends on its
# length): the runs take its first frames, the kernel checks its middle frame
N_RENDER = 160
N_LOOP = 240            # full-SLAM drive: 1.5 laps of a 160 m loop
LOOP_LAPS = 1.5
# online SLAM (phase 10): the first frames of that drive (revisits start near
# frame 160; 200 until phase 13 joined), and the frame count after which a
# checkpoint is taken (not a cadence multiple, so loop queries are pending)
N_ONLINE = 190
ONLINE_SAVE_AT = 178
# phase 10's peak device memory while every counting grid (11) and phase 7's
# frames stayed on the card (PERF.md, NVIDIA H100 80GB HBM3 at 700 W)
ONLINE_PEAK_RESIDENT_GIB = 2.394
ATE_BAND_M = 0.25       # odometry ATE over the main runs (40-80 m driven)
# free-running loop closure on the CPU against the card's, from one odometry
# result: refined edges (m, rad) and CS divergences (relative); twice the
# largest reading on an H100 over two drives (this script's: 1.72e-3 m,
# 1.85e-5 rad, 5.54e-4; tests/test_torch_kernels_cuda.py's loop sequence:
# 6.26e-3 m, 7.93e-5 rad, 8.36e-4), inside the CPU tests' one-step band
LOOP_EDGE_BAND = (1.3e-2, 1.6e-4)
LOOP_CS_BAND = 1.7e-3
# the Schur-complement pose graph at a full Oxford sequence's size
# (bench.py's graph); its solve is held to the ground truth, to the dense
# solve and to its own CPU run within a (m, rad) band of twice the larger
# reading of CPU runs of the same two solves (scripts/torch_schur_band.py on
# 6 and 8 threads: Schur against the ground truth 4.01e-3 m / 4.00e-5 rad
# and 7.54e-3 m / 7.50e-5 rad, against the dense solve 4.02e-3 m / 4.01e-5
# rad and 7.53e-3 m / 7.49e-5 rad; the Schur route stops at the
# 100-iteration cap a few mm from the optimum, where the dense one
# converges to 1.2e-5-1.5e-5 m of it, as in the JAX package: PERF.md)
SCHUR_NODES = 4077
SCHUR_BAND = (1.51e-2, 1.5e-4)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM, non-tensor float32, published
CAPTURE_FRAME = 10          # the frame whose LM-solve inputs K3a/K3b/K4 check
SWITCHES_ON = {"matcher.use_pallas_linearize": True,
               "matcher.use_pallas_chol": True}
# the LM iteration's own kernels (ops/lm_step): wrappers and kernel names
LM_WRAPPERS = ("assemble_cuda", "trial_cuda", "accept_cuda")
LM_KERNELS = ("lm_assemble", "lm_trial", "lm_accept")
LM_REL = 1e-5   # their sums against plain, relative to each sum's scale
# float operations per pair, counted from csrc/ndt_linearize.cu with sqrt,
# division and powf as one each: the pair math (residual, S^-1 d, dS/dtheta)
# ~130, the Jacobian, weight and the ten sums ~70 more for K3a; the residual
# and the two reductions ~10 more for K3b
K3A_FLOPS_PER_PAIR = 200
K3B_FLOPS_PER_PAIR = 140
K3_REL = 1e-4   # K3a/K3b sums against plain, relative to their scale
# the earlier designs of K3a and K3b (one block per slot), K4 (one block
# per system) and K2 (one block per kept segment) at these shapes (PERF.md,
# NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's times
K3A_ONE_BLOCK_US = 15.20
K3B_ONE_BLOCK_US = 14.30
K4_ONE_BLOCK_US = 79.58
K2_BLOCK_PER_SEGMENT_US = 27.49
# batched odometry (phase 11): B sequences per card, each a distinct drive
# (drive 0 is phase 4's), switches on over N_BATCH frames (steady from
# N_SHORT), and one switches-off run of BATCH_OFF_B sequences over
# N_BATCH_OFF frames (steady from BATCH_OFF_STEADY); every member is held
# against a single-sequence run of its first N_BATCH_CHECK frames within
# tests/test_torch_batch.py's free-running bands (ATE gap, headings,
# positions); B = 2 and three of the checked frames were cut when phase 12
# joined (the batch curve is benchmark/sweep_batch.py's)
BATCH_SIZES = (1, 4, 8)
N_BATCH = 30
BATCH_OFF_B = 4
N_BATCH_OFF = 12        # 16 until phase 13 joined
BATCH_OFF_STEADY = 8
N_BATCH_CHECK = 5
BATCH_BANDS = (1e-2, 5e-3, 1e-1)
# indoor with the IMU (phase 13): indoor_config() on frames rendered at the
# sensor geometry of scripts/indoor_sim.py (400 azimuths, 12 m in 3 cm bins,
# 0.25 s frames at 0.8 m/s through a wall-dense world).  A node's loop
# candidates lie num_exclude_recent = 50 nodes back, ~107 frames at the
# 0.47 nodes a frame of insertion_step 2 and 20-pose submaps, so a lap is
# INDOOR_LAP frames (22.4 m) and the drive runs 24 frames into the second:
# the shortest, in steps of 8 from the first with loop edges (120), on
# which the JAX package passes every check of (b) on more than half of
# seeds 0-7 (2, 4 and 5 of 8 at 120, 128 and 136 frames; PERF.md section
# 4).  That script's rounded rectangle (straights 6a and 2a) has corners
# of a = 1.0 m at this lap, 0.2 rad a frame between straights: there both
# packages lose the heading on some
# seeds (the JAX package on seed 0 at laps of 96 and 112 frames: 1.10 and
# 3.13 rad; the port 1.22 and 3.12 rad; scripts/torch_indoor_loops.py
# --half 3 1).  The route here keeps its shape with straights of a
# (ROUTE_HALF = (hx / a, hy / a)): corners of a = 2.2 m, 0.09 rad a frame.
# The gyro is that of tests/test_imu.py, whose bias check this phase
# repeats (a drift of 0.02 rad/s under 0.001 rad of noise): at
# indoor_sim.py's 0.002 rad/s under 0.004 rad the bias is not observable
# over such a run.  The full-SLAM run takes tests/test_imu.py's
# weight_imu_bias of 50 (the reference's 750000.1 holds the bias near its
# start for the length of such a run); the kernel checks of phase 3 take
# indoor_config()'s own weights
IN_AZ = 400
IN_MAX_RANGE = 12.0
IN_BIN_W = 0.03
IN_DT = 0.25
IN_SPEED = 0.8
IMU_BIAS = 0.02
IMU_NOISE = 0.001
BIAS_WEIGHT = {"matcher.weight_imu_bias": 50.0}
ROUTE_HALF = (0.5, 0.5)
INDOOR_LAP = 112
N_INDOOR = 136
IN_CHUNK = 48           # the host-resident SLAM run's chunks
N_IMU_CHECK = 11        # (c): the IMU against the IMU zeroed over these frames
N_IMU_CPU = 10          # (c): the card against the CPU over these frames
IMU_CPU_BAND = (1e-2, 1e-3)
N_IN_ONLINE = 10        # (d): OnlineSlam over these frames (a loop-search tick
IN_ONLINE_SAVE_AT = 7   # at 10); its checkpoint after 7 (no tick)
# the newest bias state against the rendered drift (tests/test_imu.py)
BIAS_RANGE = (0.5, 1.6)
# an accepted loop edge's translation against the rendered ground truth:
# within half of indoor_config()'s 1 m NDT cell
LOOP_TRUTH_M = 0.5
# the drive's seed: the lowest on whose drive the JAX package's run
# (scripts/torch_indoor_loops.py --jax) passes every check of (b) (seed 0:
# an edge 1.46 m off the truth and the pose graph at 1.065 x the odometry's
# node ATE, in both packages)
IN_SEED = 1
# multi-device (phase 12): the sharded dense pose graph against
# pose_graph.optimize (tests/test_multichip.py's band) and against one rank
# (m); a world's time limit (s)
MD_DENSE_BAND = 5e-3
MD_ONE_RANK_BAND = 1e-5
MD_TIMEOUT = 600
# and K1's (a block per row behind an int32 cast of the starts) and K5's
# (a plain stable sort, binary search and casts before a kernel over the
# runs), their whole calls
K1_BLOCK_PER_ROW_US = 7.84
K5_SORT_AND_RUNS_US = 117.44


def render_frames(n_frames, seed=0, laps=None):
    """Oxford-geometry frames: a smooth drive through a scatterer world,
    rendered as polar intensity images (as the JAX package's bench.py does
    without the recorded ground truth); with ``laps``, a circular drive of
    that many laps, revisiting its first lap."""
    from randt_slam_torch.io import synthetic as S

    rng = np.random.default_rng(seed)
    if laps is None:
        gt = S.make_trajectory(rng, n_frames, dt=0.25, speed=4.0)
    else:
        gt = S.make_trajectory(rng, n_frames, dt=0.25, speed=4.0, loop=True,
                               laps=laps)
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


def indoor_route(n_frames, lap_frames, half=(3.0, 1.0)):
    """The rounded-rectangle route of ``scripts/indoor_sim.py`` (straights
    of 2 hx and 2 hy joined by quarter circles of radius a; ``half`` =
    (hx / a, hy / a), that script's (3, 1)), one lap per ``lap_frames``
    frames at IN_SPEED x IN_DT per frame, driven for ``n_frames`` frames
    from the middle of its bottom straight, heading +x, and expressed
    relative to that first pose (numpy (n_frames, 3))."""
    step = IN_SPEED * IN_DT
    lap_len = lap_frames * step
    a = lap_len / (4 * (half[0] + half[1]) + 2 * np.pi)
    hx, hy = half[0] * a, half[1] * a
    seg = np.array([2 * hx, np.pi * a / 2, 2 * hy, np.pi * a / 2] * 2)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    out = np.zeros((n_frames, 3))
    for i in range(n_frames):
        s = (hx + i * step) % lap_len   # arc length from the bottom-left end
        k = min(int(np.searchsorted(cum, s, side="right")) - 1, 7)
        t = s - cum[k]
        th = t / a
        out[i] = [
            (-hx + t, -hy - a, 0.0),
            (hx + a * np.sin(th), -hy - a * np.cos(th), th),
            (hx + a, -hy + t, np.pi / 2),
            (hx + a * np.cos(th), hy + a * np.sin(th), np.pi / 2 + th),
            (hx - t, hy + a, np.pi),
            (-hx - a * np.sin(th), hy + a * np.cos(th), np.pi + th),
            (-hx - a, hy - t, -np.pi / 2),
            (-hx - a * np.cos(th), -hy - a * np.sin(th), -np.pi / 2 + th),
        ][k]
    out[:, 1] += hy + a   # the first pose at the origin
    out[:, 2] = np.arctan2(np.sin(out[:, 2]), np.cos(out[:, 2]))
    return out.astype(np.float32)


def render_indoor(n_frames=N_INDOOR, lap_frames=INDOOR_LAP, seed=0, half=ROUTE_HALF):
    """Indoor frames at the geometry of ``scripts/indoor_sim.py``: its
    wall-dense world around :func:`indoor_route`, rendered as polar images
    of IN_AZ x 400 bins, and a gyro yaw reading that drifts at IMU_BIAS
    rad/s under IMU_NOISE rad of Gaussian noise.  Returns (scans, az,
    ranges, stamps, imu_yaw, gt)."""
    from randt_slam_torch.io import synthetic as S

    rng = np.random.default_rng(seed)
    gt = indoor_route(n_frames, lap_frames, half)
    landmarks = S.make_world(rng, trajectory=gt, n_walls=int(40 + n_frames / 10),
                             corridor=9.0, n_clutter=n_frames // 5, min_refl=40.0,
                             max_refl=120.0, wall_point_spacing=0.15)
    az = (np.arange(IN_AZ) / IN_AZ * 2 * np.pi - np.pi).astype(np.float32)
    n_bins = int(round(IN_MAX_RANGE / IN_BIN_W))
    ranges = ((np.arange(n_bins) + 0.5) * IN_BIN_W).astype(np.float32)
    scans = np.stack([S.render_scan_fast(p, landmarks, az, ranges, rng, speckle=2.0)
                      for p in gt]).astype(np.float32)
    stamps = (np.arange(n_frames) * IN_DT).astype(np.float32)
    imu_yaw = (gt[:, 2] + IMU_BIAS * stamps
               + rng.normal(0, IMU_NOISE, n_frames)).astype(np.float32)
    return scans, az, ranges, stamps, imu_yaw, gt


def bench_graph(n_nodes):
    """The JAX package's ``bench.py`` pose graph (:91-135), numpy: a noisy
    two-lap circle of ``n_nodes`` nodes, odometry edges and loop edges every
    100 nodes of the second lap back to the matching first-lap submap root,
    all measuring exact ground-truth relative poses (so the optimum is the
    ground truth); submaps of 8 nodes with a root each, ``node_submap``
    capped at n // 8 - 1, so the last submap holds two roots.  Returns
    (poses, id_begin, id_end, trans, sqrt_information, node_submap,
    node_is_root, gt)."""
    rng = np.random.default_rng(1)
    t = np.linspace(0, 4 * np.pi, n_nodes)
    gt = np.stack([60 * np.cos(t), 60 * np.sin(t), t + np.pi / 2], 1)
    noisy = gt + np.concatenate(
        [np.zeros((1, 3)), np.cumsum(rng.normal(0, 0.03, (n_nodes - 1, 3)), 0)])
    eb = np.arange(n_nodes - 1)
    ee = eb + 1
    c, s = np.cos(gt[:-1, 2]), np.sin(gt[:-1, 2])
    d = gt[1:] - gt[:-1]
    trans = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1], d[:, 2]], 1)
    per, lap = 8, n_nodes // 2
    lq = np.arange(lap, n_nodes - 1, 100)           # query nodes
    lr = ((lq - lap) // per) * per                  # matched submap roots
    cl, sl = np.cos(gt[lr, 2]), np.sin(gt[lr, 2])
    dl = gt[lq] - gt[lr]
    ltrans = np.stack([cl * dl[:, 0] + sl * dl[:, 1],
                       -sl * dl[:, 0] + cl * dl[:, 1], dl[:, 2]], 1)
    eb, ee = np.concatenate([eb, lr]), np.concatenate([ee, lq])
    trans = np.concatenate([trans, ltrans])
    sqrt_i = np.tile(np.diag([10.0, 10.0, 50.0]), (len(eb), 1, 1))
    node_submap = np.minimum(np.arange(n_nodes) // per, n_nodes // per - 1)
    node_is_root = np.zeros(n_nodes, bool)
    node_is_root[::per] = True
    f32 = np.float32
    return (noisy.astype(f32), eb, ee, trans.astype(f32), sqrt_i.astype(f32),
            node_submap, node_is_root, gt)


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
    # K5's entry point as build_scan_cells calls the scan NDT build
    cell = cfg.ndt_map.cell
    k5 = (filt.points, filt.mask, ids, num,
          filt.polar if cell.use_pndt else None,
          np.asarray(cell.beam_cov) if cell.use_pndt else None)
    return k1, (values, ids, num, cfg.capacity.max_scan_cells), k5


def device_kernels(fn, tries=3):
    """The device kernels one call of ``fn`` launches, as (name, count)
    pairs from a ``torch.profiler`` trace.  A trace with no device event at
    all is taken again, up to ``tries`` traces: the profiler now and then
    delivers none for a window this short (once in phase 13's K1 check,
    after it had read phase 3's).  A call that launches nothing reads
    empty every time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows, _, _ = trace_rows(prof.profiler.kineto_results.events())
        if rows:
            break
    return [(name, n) for _, n, name in rows]


def only_kernel(label, fn, kernel):
    """Fail unless one call of ``fn`` launches exactly one device kernel,
    ``kernel``; returns the count printed beside the times."""
    seen = device_kernels(fn)
    if len(seen) != 1 or seen[0][1] != 1 or kernel not in seen[0][0]:
        raise AssertionError(f"{label}: one call launched {seen}, expected one {kernel}")
    return 1


def check_k1(k1_sets, dev, earlier_us=K1_BLOCK_PER_ROW_US):
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
    per_call = only_kernel("K1 row_windows",
                           lambda: K1.row_windows(img, rng_row, starts, win),
                           "row_windows_kernel")
    jw = (starts[:, None] + torch.arange(win, device=dev)[None, :]).clamp(0, R - 1)
    t = dict(
        ms=device_ms(lambda: K1.row_windows_cuda(img, rng_row, starts, win)),
        plain_ms=device_ms(lambda: K1.row_windows_plain(img, rng_row, starts, win)),
        library_ms=device_ms(lambda: torch.gather(img, 1, jw)),
    )
    # the least the function must move: the image windows, the range row and
    # the row starts (int64) read once, two (A, win) float32 outputs written
    nbytes = A * win * 4 + R * 4 + A * starts.element_size() + 2 * A * win * 4
    b, by = bound_ms(nbytes, 0)
    earlier = ("" if earlier_us is None else f" (a block per row with an int32 cast "
                                              f"{earlier_us:.2f} us)")
    print(f"K1 row_windows ({A} x {R} "
          f"padded image, windows of {win}): bitwise equal to plain on {len(k1_sets)} "
          f"inputs; {per_call} device launch per call (the kernel, int64 starts read as "
          f"they come); kernel {t['ms'] * 1e3:.2f} us{earlier}, plain {t['plain_ms'] * 1e3:.2f} "
          f"us, torch.gather (image half only) {t['library_ms'] * 1e3:.2f} us, bound "
          f"{b * 1e3:.3f} us ({by}, {nbytes} B)", flush=True)
    return dict(max_abs_err=err, bound_ms=b, bound_by=by, **t)


def check_k2(k2_sets, dev, earlier_us=K2_BLOCK_PER_SEGMENT_US):
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
        whole_call_ms=device_ms(lambda: K2.segment_topk_moments(values, ids, num, k)),
    )
    # the least the function must move: every id, the value rows of the
    # points in the kept segments, the k segment ids, the (k, CH) output;
    # one add per kept row and channel
    kept_rows = int(torch.isin(ids, topi).sum())
    nbytes = P * 4 + kept_rows * CH * 4 + k * 4 + k * CH * 4
    b, by = bound_ms(nbytes, kept_rows * CH)
    earlier = ("" if earlier_us is None else f" (one block per kept segment "
                                              f"{earlier_us:.2f} us)")
    print(f"K2 segment_topk_moments (P={P}, "
          f"k={k}): topi equal to the CPU path's, moments within "
          f"1e-5 of their scale, two launches bitwise equal, on {len(k2_sets)} "
          f"inputs; kernel {t['ms'] * 1e3:.2f} us{earlier}, the whole call with its plain counts "
          f"and stable sort {t['whole_call_ms'] * 1e3:.2f} us, plain "
          f"{t['plain_ms'] * 1e3:.2f} us, index_add_ into a rank map (approximate "
          f"yardstick) {t['library_ms'] * 1e3:.2f} us, bound {b * 1e3:.3f} us ({by}, "
          f"{nbytes} B, {kept_rows} rows in the kept segments)", flush=True)
    return dict(max_abs_err=err, bound_ms=b, bound_by=by, **t)


def check_k5(k5_sets, entry, cfg, dev, per_call):
    """K5 against its plain version on seeded sets and a rendered frame's
    scan NDT inputs: every element within 1e-5 of the sum of the absolute
    values of its terms, two launches bitwise equal, a segment without
    points exactly 0.  Then its entry point ``cells.from_points`` on that
    frame, once with the counts at 0: the rows at K2's top-k segments agree
    with ``from_points_compact`` within the same rule.  Times the whole
    ``segment_moments`` call (one launch of the kernel, nothing else) on the
    frame and on the dense seeded set; ``per_call`` is its device launches
    per call (:func:`only_kernel`).  Returns the record and the entry run's
    launch count."""
    import torch

    from randt_slam_torch.ndt import cells as C
    from randt_slam_torch.ops import build
    from randt_slam_torch.ops import segment_moments as K5

    err = 0.0
    for values, ids, num in k5_sets:
        out = K5.segment_moments(values, ids, num)
        again = K5.segment_moments(values, ids, num)
        plain = K5.segment_moments_plain(values, ids, num)
        scale = K5.segment_moments_plain(values.abs(), ids, num)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError("K5: two launches are not bitwise identical")
        if not bool(((out - plain).abs() <= 1e-5 * scale).all()):
            raise AssertionError("K5: sums differ from plain beyond 1e-5 of their scale")
        if not bool((out[scale.sum(1) == 0] == 0).all()):
            raise AssertionError("K5: a segment without points is not exactly 0")
        err = max(err, float((out - plain).abs().max()))

    # the entry point, driven once with the counts at 0
    points, mask, ids, num, polar, beam_cov = entry
    build.reset_launches()
    full = C.from_points(points, mask, ids, num, polar=polar, beam_cov=beam_cov)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    if launches["segment_moments"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"from_points launched {launches}, expected one K5")
    k = cfg.capacity.max_scan_cells
    compact, topi = C.from_points_compact(points, mask, ids, num, k, polar=polar,
                                          beam_cov=beam_cov)
    chans = C._moment_channels(points, mask, polar, beam_cov)
    scale = C._unpack(K5.segment_moments_plain(chans.abs(), ids, num))
    for a, b, sc in zip(full, compact, scale):
        if not bool(((a[topi] - b).abs() <= 1e-5 * sc[topi]).all()):
            raise AssertionError("K5: from_points rows at K2's top-k differ from "
                                 "from_points_compact beyond 1e-5 of their scale")

    def timed(values, ids, num):
        """The whole call's time, the plain version's and index_add_'s, and
        the bound: every id read once (at its own width), the value rows of
        the kept points only (a dropped id's row adds to no sum), the
        (S, CH) sums written once; one add per kept value."""
        P, CH = values.shape
        ok = (ids >= 0) & (ids < num)
        safe = torch.where(ok, ids, num).long()
        t = dict(
            ms=device_ms(lambda: K5.segment_moments(values, ids, num)),
            plain_ms=device_ms(lambda: K5.segment_moments_plain(values, ids, num)),
            library_ms=device_ms(lambda: torch.zeros(num + 1, CH, device=dev).index_add_(
                0, safe, values)),
        )
        kept = int(ok.sum())
        nbytes = P * ids.element_size() + kept * CH * 4 + num * CH * 4
        b, by = bound_ms(nbytes, kept * CH)
        return t, dict(bound_ms=b, bound_by=by, nbytes=nbytes, kept=kept, P=P, S=num)

    t, bd = timed(*k5_sets[-1])
    td, bdd = timed(*k5_sets[-2])  # the dense seeded set at the frame's P and S
    for label, tt, b in (("the rendered frame", t, bd), ("the dense seeded set", td, bdd)):
        print(f"K5 segment_moments on {label} (P={b['P']}, S={b['S']}, {b['kept']} kept "
              f"points, ids {'int64' if label.endswith('frame') else 'int32'}): the "
              f"whole call {tt['ms'] * 1e3:.2f} us ({per_call} device launch, the "
              f"kernel; the plain sort, search and casts with the run kernel "
              f"{K5_SORT_AND_RUNS_US:.2f} us), plain {tt['plain_ms'] * 1e3:.2f} us, "
              f"index_add_ (atomic, not reproducible) {tt['library_ms'] * 1e3:.2f} us, "
              f"bound {b['bound_ms'] * 1e3:.4f} us ({b['bound_by']}, {b['nbytes']} B), "
              f"{'faster' if tt['ms'] < tt['library_ms'] else 'NOT faster'} than "
              f"index_add_", flush=True)
    print(f"K5 segment_moments: within 1e-5 of the scale of plain, two launches "
          f"bitwise equal, empty segments exactly 0, on {len(k5_sets)} inputs; "
          f"from_points launched K5 once and agrees with from_points_compact at "
          f"K2's top-{k}", flush=True)
    return dict(max_abs_err=err, bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                dense_ms=td["ms"], dense_library_ms=td["library_ms"],
                dense_bound_ms=bdd["bound_ms"], **t), launches["segment_moments"]


@contextlib.contextmanager
def spying_solves(frame):
    """Keep the K3a inputs of every LM iteration of frame ``frame`` (its
    pair packs, slot poses, mu and NDT scale), the damped systems K4
    solves there and the inputs of the LM iteration's own kernels, on the
    switches-on path run inside the block; yields (now, lin, chol, steps):
    the caller's ``on_frame`` sets ``now[0]`` to the frame about to be
    stepped.  The solve of frame ``frame`` runs eagerly: a replayed CUDA
    graph of it would call no kernel wrapper.  On the card an iteration's
    K3a reads the slot poses' [tx, ty, cos, sin] (``window.window_loop``):
    its inputs are kept when ``lm_assemble`` takes its blocks, with the
    poses of the parameters it assembles at.  ``steps`` holds, per call of
    ``lm_assemble``, ``lm_trial`` and ``lm_accept``, (wrapper name, the
    solve's ``window.WindowAux``, the other arguments, cloned before the
    call)."""
    import torch

    from randt_slam_torch.ops import lm_step
    from randt_slam_torch.ops import ndt_linearize as NL
    from randt_slam_torch.ops import small_chol
    from randt_slam_torch.registration import solve_graph, window

    now, lin, chol, steps, pending, auxes = [-1], [], [], [], [], []
    orig_lin, orig_chol = NL.linearize_cuda, small_chol.chol_solve_cuda
    orig_aux = window.window_aux
    orig_step = {n: getattr(lm_step, n) for n in LM_WRAPPERS}
    graphs = solve_graph.SolveGraphs.__call__

    def spy_lin(pose4, mu, ndt_scale, packed, *a, **k):
        out = orig_lin(pose4, mu, ndt_scale, packed, *a, **k)
        if now[0] == frame:
            pending[:] = [(mu.clone(), ndt_scale.clone(), tuple(x.clone() for x in packed))]
        return out

    def spy_aux(*a, **k):
        auxes[:] = [orig_aux(*a, **k)]
        return auxes[0]

    def _fresh(a):
        return tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)

    def spy_step(name):
        def wrapped(win, *a):
            if now[0] == frame:
                if name == "assemble_cuda" and pending:
                    lin.append((window.slot_poses(a[2]).clone(), *pending.pop()))
                steps.append((name, auxes[0], _fresh(a)))
            return orig_step[name](win, *a)
        return wrapped

    def spy_chol(A, b):
        if now[0] == frame:
            chol.append((A.clone(), b.clone()))
        return orig_chol(A, b)

    def solve(self, part, fn, args):
        return fn(*args) if now[0] == frame else graphs(self, part, fn, args)

    NL.linearize_cuda, small_chol.chol_solve_cuda = spy_lin, spy_chol
    window.window_aux = spy_aux
    for n in LM_WRAPPERS:
        setattr(lm_step, n, spy_step(n))
    solve_graph.SolveGraphs.__call__ = solve
    try:
        yield now, lin, chol, steps
    finally:
        NL.linearize_cuda, small_chol.chol_solve_cuda = orig_lin, orig_chol
        window.window_aux = orig_aux
        for n, fn in orig_step.items():
            setattr(lm_step, n, fn)
        solve_graph.SolveGraphs.__call__ = graphs
    if not lin or len(chol) != len(lin):
        raise AssertionError(f"captured {len(lin)} linearizations and {len(chol)} "
                             f"solves in frame {frame}")
    if [n for n, _, _ in steps] != list(LM_WRAPPERS) * len(lin):
        raise AssertionError(f"frame {frame}: {len(steps)} calls of the LM iteration's "
                             f"kernels, expected {len(LM_WRAPPERS)} after each of its "
                             f"{len(lin)} linearizations")


def capture_solve_inputs(cfg, frames, dev, frame):
    """Run ``frames`` on the switches-on path, keeping what
    :func:`spying_solves` keeps of ``frame``.  Returns the result and the
    captured inputs (lin, chol, steps)."""
    from randt_slam_torch.pipeline import slam

    with spying_solves(frame) as (now, lin, chol, steps):
        res = slam.run_odometry(cfg, frames, device=dev,
                                on_frame=lambda t, c: now.__setitem__(0, t))
    return res, lin, chol, steps


def check_k3(k3_sets, cfg, dev, earlier_us=(K3A_ONE_BLOCK_US, K3B_ONE_BLOCK_US)):
    """K3a/K3b against their plain versions: every sum within K3_REL of its
    scale (the sum of the absolute values of its per-pair terms), the max
    within 1e-5 of itself, two launches bitwise equal, a NaN pair passed on
    to its slot's sums, cost and max as the plain version does."""
    import torch

    from randt_slam_torch.ops import ndt_linearize as NL
    from randt_slam_torch.registration import matcher

    sc, al = cfg.matcher.loss_function_scale, cfg.matcher.loss_function_convexity
    err_a = err_b = worst_a = worst_b = 0.0
    for pose4, mu, ns, packed in k3_sets:
        H, g, rho = NL.linearize_cuda(pose4, mu, ns, packed, sc, al)
        H2, g2, rho2 = NL.linearize_cuda(pose4, mu, ns, packed, sc, al)
        Hp, gp, rhop = NL.linearize_plain(pose4, mu, ns, packed, sc, al)
        Hs, gs, rhos = NL.sums_to_blocks(
            NL.linearize_terms(pose4, mu, ns, packed, sc, al).abs().sum(-1))
        c, m = NL.robust_cost_cuda(pose4, mu, packed, sc, al)
        c2, m2 = NL.robust_cost_cuda(pose4, mu, packed, sc, al)
        cp, mp = NL.robust_cost_plain(pose4, mu, packed, sc, al)
        cs = NL.robust_cost_terms(pose4, mu, packed, sc, al)[0].abs().sum(-1)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in ((H, H2), (g, g2), (rho, rho2))):
            raise AssertionError("K3a: two launches are not bitwise identical")
        if not (torch.equal(c, c2) and torch.equal(m, m2)):
            raise AssertionError("K3b: two launches are not bitwise identical")
        for a, b, s in ((H, Hp, Hs), (g, gp, gs), (rho, rhop, rhos)):
            worst_a = max(worst_a, float(((a - b).abs() / s.clamp(min=1e-30)).max()))
            err_a = max(err_a, float((a - b).abs().max()))
        worst_b = max(worst_b, float(((c - cp).abs() / cs.clamp(min=1e-30)).max()))
        err_b = max(err_b, float((c - cp).abs().max()))
        if not bool(((m - mp).abs() <= 1e-5 * mp).all()):
            raise AssertionError("K3b: r2max differs from plain beyond 1e-5 of itself")
        err_b = max(err_b, float((m - mp).abs().max()))
    if not (worst_a <= K3_REL and worst_b <= K3_REL):
        raise AssertionError(f"K3a/K3b differ from plain by {worst_a:.2e}/{worst_b:.2e} "
                             f"of their scale (limit {K3_REL})")
    # a non-finite valid pair in slot 1: the cost sum and the max pass the
    # NaN on in that slot, as the plain version does
    pose4, mu, ns, packed = k3_sets[0]
    nan_packed = tuple(x.clone() for x in packed)
    first = int(torch.nonzero(packed[4][1, 0] > 0)[0])
    nan_packed[2][1, 0, first] = float("nan")
    c, m = NL.robust_cost_cuda(pose4, mu, nan_packed, sc, al)
    cp, mp = NL.robust_cost_plain(pose4, mu, nan_packed, sc, al)
    if not (bool(m[1].isnan()) and torch.equal(c.isnan(), cp.isnan())
            and torch.equal(m.isnan(), mp.isnan())):
        raise AssertionError(f"K3b: a NaN pair gives {c.tolist()}, {m.tolist()}; "
                             f"plain {cp.tolist()}, {mp.tolist()}")
    # and K3a's H, g and rho of that slot
    out = NL.linearize_cuda(pose4, mu, ns, nan_packed, sc, al)
    plain = NL.linearize_plain(pose4, mu, ns, nan_packed, sc, al)
    if not all(bool(a[1].isnan().all()) and torch.equal(a.isnan(), p.isnan())
               for a, p in zip(out, plain)):
        raise AssertionError(f"K3a: a NaN pair gives {[a.tolist() for a in out]}; "
                             f"plain {[p.tolist() for p in plain]}")

    pose4, mu, ns, packed = k3_sets[-1]
    W, N = packed[0].shape[0], packed[0].shape[-1]
    # the switches-off path's linearization of the same pairs: autograd
    # Jacobian plus the two einsums, with the pairs unpacked to (W,1,N,1,...)
    mm, mc, am, ac, v = packed
    ij = NL.SYM6 + ((1, 0), (2, 0), (2, 1))
    src = list(range(6)) + [1, 2, 4]

    def full(c6):
        out = torch.empty(W, N, 3, 3, device=dev)
        for (i, j), k in zip(ij, src):
            out[..., i, j] = c6[:, k]
        return out.reshape(W, 1, N, 1, 3, 3)

    un = (mm.transpose(1, 2).reshape(W, 1, N, 1, 3), full(mc),
          am.transpose(1, 2).reshape(W, 1, N, 1, 3), full(ac),
          (v[:, 0] > 0).reshape(W, 1, N, 1))
    poses = torch.stack([pose4[:, 0], pose4[:, 1],
                         torch.atan2(pose4[:, 3], pose4[:, 2])], 1)
    autograd_ms = device_ms(lambda: matcher.ndt_blocks_autograd(
        poses, un[0], un[1], un[2], un[3], un[4], ns, sc, al, mu), reps=20)
    ta = dict(ms=device_ms(lambda: NL.linearize_cuda(pose4, mu, ns, packed, sc, al)),
              plain_ms=device_ms(lambda: NL.linearize_plain(pose4, mu, ns, packed, sc, al)),
              library_ms=None)
    tb = dict(ms=device_ms(lambda: NL.robust_cost_cuda(pose4, mu, packed, sc, al)),
              plain_ms=device_ms(lambda: NL.robust_cost_plain(pose4, mu, packed, sc, al)),
              library_ms=None)
    # the least either must move: the valid weight of every pair, the other
    # 18 floats of the valid pairs only (an invalid pair has weight 0 and
    # finite values, so it adds nothing), the pose and the scalars read
    # once, the outputs written once; the pair math only for valid pairs
    n_valid = int((v > 0).sum())
    nbytes_in = W * N * 4 + n_valid * 18 * 4 + W * 4 * 4
    nbytes_a = nbytes_in + 2 * 4 + W * 13 * 4
    nbytes_b = nbytes_in + 4 + W * 2 * 4
    ba, bya = bound_ms(nbytes_a, n_valid * K3A_FLOPS_PER_PAIR)
    bb, byb = bound_ms(nbytes_b, n_valid * K3B_FLOPS_PER_PAIR)
    earlier_a, earlier_b = ("", "") if earlier_us is None else (
        f" (one block per slot {us:.2f} us)" for us in earlier_us)
    print(f"K3a ndt_linearize: within {worst_a:.2e} of each sum's scale of plain "
          f"(limit {K3_REL}), two launches bitwise equal, a NaN pair passed on as "
          f"plain passes it, on {len(k3_sets)} inputs (W={W}, N={N}); kernel "
          f"{ta['ms'] * 1e3:.2f} us{earlier_a}, plain "
          f"{ta['plain_ms'] * 1e3:.2f} us, no one-call library yardstick (for "
          f"information, the switches-off linearization of the same pairs, "
          f"autograd Jacobian and einsums: {autograd_ms * 1e3:.2f} us), bound "
          f"{ba * 1e3:.4f} us ({bya}, {nbytes_a} B, {n_valid} of {W * N} pairs "
          f"valid in frame {CAPTURE_FRAME}'s last linearization)", flush=True)
    print(f"K3b ndt_robust_cost: within {worst_b:.2e} of the sum's scale of plain, "
          f"r2max within 1e-5, two launches bitwise equal, a NaN pair passed on "
          f"as plain passes it; kernel "
          f"{tb['ms'] * 1e3:.2f} us{earlier_b}, plain "
          f"{tb['plain_ms'] * 1e3:.2f} us, no "
          f"one-call library yardstick, bound {bb * 1e3:.4f} us ({byb}, "
          f"{nbytes_b} B)", flush=True)
    return (dict(max_abs_err=err_a, bound_ms=ba, bound_by=bya, **ta),
            dict(max_abs_err=err_b, bound_ms=bb, bound_by=byb, **tb))


def check_k4(systems, dev, earlier_us=K4_ONE_BLOCK_US):
    """K4 against its plain version and a float64 solve, on the damped,
    Jacobi-scaled systems of one frame's LM solve: both within the
    float32 Cholesky forward-error bound 4 P eps kappa |x|, and the
    residual |A x - b| within 4 P eps |A| |x|."""
    import torch

    from randt_slam_torch.ops import small_chol as K4

    A = torch.stack([a for a, _ in systems]).contiguous()
    b = torch.stack([x for _, x in systems]).contiguous()
    P = A.shape[-1]
    x = K4.chol_solve_cuda(A, b)
    x2 = K4.chol_solve_cuda(A, b)
    one = torch.stack([K4.chol_solve_cuda(A[i].contiguous(), b[i].contiguous())
                       for i in range(A.shape[0])])
    xp = K4.chol_solve_plain(A, b)
    x64 = torch.linalg.solve(A.double(), b.double())
    kappa = torch.linalg.cond(A.double())
    torch.cuda.synchronize()
    if not (torch.equal(x, x2) and torch.equal(x, one)):
        raise AssertionError("K4: launches are not bitwise identical (batch, repeat, one by one)")
    bound = 4 * P * float(np.finfo(np.float32).eps) * kappa * x64.abs().amax(-1)
    e64 = (x.double() - x64).abs().amax(-1)
    ep = (x - xp).double().abs().amax(-1)
    if not bool(((e64 <= bound) & (ep <= bound)).all()):
        raise AssertionError(f"K4: off the bound (float64 {float((e64 / bound).max()):.2f}, "
                             f"plain {float((ep / bound).max()):.2f} of it)")
    # the residual of a backward-stable solve, independent of kappa
    res = (A.double() @ x.double()[..., None])[..., 0] - b.double()
    res_bound = (4 * P * float(np.finfo(np.float32).eps) * A.abs().amax((-2, -1))
                 * x.abs().amax(-1)).double()
    res_share = float((res.abs().amax(-1) / res_bound).max())
    if not res_share <= 1.0:
        raise AssertionError(f"K4: residual |Ax - b| at {res_share:.2f} of 4 P eps |A| |x|")
    n_ident = int((A[0].diagonal() == 1.0).sum())
    A1, b1 = A[-1].contiguous(), b[-1].contiguous()
    t = dict(ms=device_ms(lambda: K4.chol_solve_cuda(A1, b1)),
             plain_ms=device_ms(lambda: K4.chol_solve_plain(A1, b1)),
             library_ms=device_ms(lambda: torch.linalg.solve_ex(A1, b1)))
    chol_lib = device_ms(lambda: torch.cholesky_solve(
        b1[:, None], torch.linalg.cholesky_ex(A1)[0]))
    batch_ms = device_ms(lambda: K4.chol_solve_cuda(A, b))
    # the least it must move: the lower triangle of A (an SPD solve reads one
    # triangle), b read once, x written once
    nbytes = (P * (P + 1) // 2 + 2 * P) * 4
    flops = 2 * P ** 3 // 3 + 2 * P * P
    bd, by = bound_ms(nbytes, flops)
    print(f"K4 chol_solve: {A.shape[0]} "
          f"systems of frame {CAPTURE_FRAME} (P={P}, "
          f"kappa {float(kappa.min()):.3g}..{float(kappa.max()):.3g}, {n_ident} "
          f"diagonal entries exactly 1 in the first); within "
          f"{float((e64 / bound).max()):.3f} of the bound of a float64 solve and "
          f"{float((ep / bound).max()):.3f} of plain; residual within "
          f"{res_share:.3f} of 4 P eps |A| |x|; batch, repeat and one by one "
          f"bitwise equal; kernel {t['ms'] * 1e3:.2f} us"
          f"{'' if earlier_us is None else f' (one block per system {earlier_us:.2f} us)'}, "
          f"all {A.shape[0]} systems in one launch "
          f"{batch_ms * 1e3:.2f} us, plain "
          f"{t['plain_ms'] * 1e3:.2f} us, torch.linalg.solve_ex {t['library_ms'] * 1e3:.2f} "
          f"us, cholesky_ex + cholesky_solve {chol_lib * 1e3:.2f} us, bound "
          f"{bd * 1e3:.4f} us ({by}, {nbytes} B, {flops} flops)", flush=True)
    print(f"K4 chol_solve {'beats' if t['ms'] < chol_lib else 'does not beat'} "
          f"cholesky_ex + cholesky_solve in this run ({t['ms'] * 1e3:.2f} against "
          f"{chol_lib * 1e3:.2f} us)", flush=True)
    return dict(max_abs_err=float((x - xp).abs().max()), bound_ms=bd, bound_by=by, **t)


def check_lm_assemble(aux, Hj, gj, p, lam):
    """lm_assemble against its plain version: dscale within LM_REL of
    itself (the diagonal is a sum of positive terms); A within LM_REL of
    1 + |A| (after the Jacobi scaling an entry off the diagonal is at most
    1 by Cauchy-Schwarz, 1 + lam on it); rhs within LM_REL of its scale,
    |rhs| + |r_aux| + |g_ndt| dscale (Cauchy-Schwarz again: |J_a . r| <=
    |J_a| |r|); two launches bitwise.  Returns (the plain (A, rhs,
    dscale), the largest |kernel - plain|)."""
    import torch

    from randt_slam_torch.ops import lm_step as L
    from randt_slam_torch.registration import window as Wn

    out = L.assemble_cuda(aux.kern, Hj, gj, p, lam)
    again = L.assemble_cuda(aux.kern, Hj, gj, p, lam)
    plain = Wn.assemble_plain(aux, Hj, gj, p, lam)
    (A, rhs, ds), (Ap, rhsp, dsp) = out, plain
    g_ndt = torch.zeros_like(p).index_put(aux.g_at, gj.abs() * aux.af_blk,
                                          accumulate=True)
    r_aux = torch.sqrt(Wn.aux_cost(aux, p))[..., None]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError("lm_assemble: two launches are not bitwise identical")
    for what, a, b, scale in (("dscale", ds, dsp, dsp), ("A", A, Ap, 1 + Ap.abs()),
                              ("rhs", rhs, rhsp, rhsp.abs() + r_aux + g_ndt * dsp)):
        if not bool(((a - b).abs() <= LM_REL * scale).all()):
            raise AssertionError(f"lm_assemble: {what} differs from plain by "
                                 f"{float((a - b).abs().max()):.3e}, beyond {LM_REL} "
                                 f"of its scale")
    return plain, max(float((a - b).abs().max()) for a, b in zip(out, plain))


def check_lm_trial(aux, p, x, ds):
    """lm_trial against its plain version: the trial bitwise (both round op
    by op), its slot poses within 1e-6, the norms within LM_REL of
    themselves.  Returns (the plain (trial, slot poses, |delta|, |p *
    active|), the largest |kernel - plain|)."""
    import torch

    from randt_slam_torch.ops import lm_step as L
    from randt_slam_torch.registration import window as Wn

    k = L.trial_cuda(aux.kern, p, x, ds)
    pl = Wn.trial_plain(aux, p, x, ds)
    torch.cuda.synchronize()
    if not torch.equal(k[0], pl[0]):
        raise AssertionError("lm_trial: the trial is not bitwise plain's")
    if not bool(((k[1] - pl[1]).abs() <= 1e-6).all()):
        raise AssertionError(f"lm_trial: slot poses off plain by "
                             f"{float((k[1] - pl[1]).abs().max()):.3e}")
    for a, b in zip(k[2:], pl[2:]):
        if not bool(((a - b).abs() <= LM_REL * b).all()):
            raise AssertionError(f"lm_trial: a norm off plain by "
                                 f"{float((a - b).abs().max()):.3e}")
    return pl, max(float((a - b).abs().max()) for a, b in zip(k, pl))


def check_lm_accept(aux, rho, trial, dnorm, pnorm, ndt_scale, tol, ftol, p, c, lam,
                    done, live):
    """lm_accept against its plain version on clones of the state.  Where
    the cost test, the function tolerance and the step tolerance are
    decided by more than LM_REL of their sides (the kernel's trial cost is
    another sum of the same terms), the flags are exact: done, lam and p
    bitwise, c the trial cost within LM_REL of itself where it was taken
    and bitwise else; live is exact everywhere and the slot poses within
    1e-6.  Returns (the share of members decided, the largest |kernel -
    plain| of c and the slot poses where decided)."""
    import torch

    from randt_slam_torch.ops import lm_step as L
    from randt_slam_torch.registration import window as Wn

    st = [t.clone() for t in (p, c, lam, done)] + [None if live is None else live.clone()]
    kp, kc, klam, kdone, kpose = L.accept_cuda(aux.kern, rho, trial, dnorm, pnorm,
                                               ndt_scale, tol, ftol, *st)
    live_p = None if live is None else live.clone()
    pp, pc, plam, pdone, ppose = Wn.accept_plain(aux, rho, trial, dnorm, pnorm, ndt_scale,
                                                 tol, ftol, p, c, lam, done, live_p)
    c_new = 0.5 * (ndt_scale * rho.sum(-1) + Wn.aux_cost(aux, trial))
    bar = tol * (pnorm + tol)
    # (a step of exactly 0, where nothing is active, is decided too)
    d = (((c - c_new).abs() > LM_REL * c.abs())
         & (((c - c_new) - ftol * c).abs() > LM_REL * c.abs())
         & (((dnorm - bar).abs() > LM_REL * bar) | (dnorm == 0)))
    torch.cuda.synchronize()
    if not (kp is st[0] and kc is st[1] and klam is st[2] and kdone is st[3]):
        raise AssertionError("lm_accept: the state was not updated in place")
    if live is not None and not torch.equal(st[4], live_p):
        raise AssertionError("lm_accept: the live counter differs from plain")
    if not (torch.equal(kdone[d], pdone[d]) and torch.equal(klam[d], plam[d])
            and torch.equal(kp[d], pp[d])):
        raise AssertionError("lm_accept: done, lam or p differ from plain where decided")
    took = d & ~done & (c_new < c)
    if not (torch.equal(kc[d & ~took], pc[d & ~took])
            and bool(((kc[took] - pc[took]).abs() <= LM_REL * pc[took]).all())):
        raise AssertionError("lm_accept: the cost differs from plain where decided")
    if not bool(((kpose[d] - ppose[d]).abs() <= 1e-6).all()):
        raise AssertionError("lm_accept: slot poses off plain where decided")
    err = max([float((kc[d] - pc[d]).abs().max()), float((kpose[d] - ppose[d]).abs().max())]
              if bool(d.any()) else [0.0])
    return float(d.float().mean()), err


def lm_step_bytes(name, B, W):
    """The least ``name`` must move for B windows of W transitions: each
    input read once (float32; done 1 B and live 4 B a member), the
    constants once, each output written once."""
    P = (W + 1) * 9
    if name == "lm_assemble":  # Hj, gj, p, dts, imu, lam; sqrt_info, valid, active; A, rhs, dscale
        return 4 * (B * (12 * W + P + 2 * W + 1) + 64 + 10 * W + P + B * (P * P + 2 * P))
    if name == "lm_trial":  # p, x, dscale; active, angle; trial, slot poses, two norms
        return 4 * (3 * B * P + 2 * P + B * (P + 4 * W + 2))
    # rho, trial, dnorm, pnorm, ndt_scale, dts, imu, p, c, lam; sqrt_info,
    # valid; p, c, lam, slot poses; done and live read and written
    return 4 * (B * (3 * W + 2 * P + 5) + 64 + 10 * W + B * (P + 2 + 4 * W)) + 10 * B


def check_lm_step(steps, label):
    """The LM iteration's own kernels on every call that one window solve
    made of them (:func:`spying_solves`' ``steps``), each against its plain
    version (:func:`check_lm_assemble`, :func:`check_lm_trial`,
    :func:`check_lm_accept`: at least one acceptance decided); with a batch,
    member 0 of each launch bitwise the launch of its window alone.  On the
    last iteration's inputs, each kernel's time (CUDA events), its plain
    version's and the least time its bytes take.  Returns {kernel: record}."""
    import torch

    from randt_slam_torch.ops import lm_step as L
    from randt_slam_torch.registration import window as Wn

    checks = dict(zip(LM_WRAPPERS, (check_lm_assemble, check_lm_trial, check_lm_accept)))
    plains = dict(zip(LM_WRAPPERS, (Wn.assemble_plain, Wn.trial_plain, Wn.accept_plain)))
    err, decided, last = dict.fromkeys(LM_WRAPPERS, 0.0), [], {}
    for name, aux, a in steps:
        share, e = checks[name](aux, *a)
        if name == "accept_cuda":
            decided.append(share)
        err[name], last[name] = max(err[name], e), (aux, a)
    if not max(decided) > 0:
        raise AssertionError(f"{label}: no acceptance of the {len(decided)} LM iterations "
                             f"decided by more than {LM_REL}")

    def fresh(a):
        return tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)

    out = {}
    for (wrapper, (aux, a)), kname in zip(last.items(), LM_KERNELS):
        kernel, win = getattr(L, wrapper), aux.kern
        lead, W = aux.lead, aux.W
        B = lead[0] if lead else 1
        member = ""
        if lead:
            whole = kernel(win, *fresh(a))
            alone = kernel(win._replace(dts=win.dts[0].contiguous(),
                                        imu_meas=win.imu_meas[0].contiguous()),
                           *(x[0].clone() if isinstance(x, torch.Tensor) else x for x in a))
            torch.cuda.synchronize()
            if not all(torch.equal(x[0], y) for x, y in zip(whole, alone)):
                raise AssertionError(f"{kname}: member 0 of the batch of {B} differs "
                                     f"from its window's launch alone")
            member = ", member 0 bitwise its launch alone"
        args = fresh(a)
        t = dict(ms=device_ms(lambda: kernel(win, *args)),
                 plain_ms=device_ms(lambda: plains[wrapper](aux, *a[:-1], None)
                                    if wrapper == "accept_cuda" else plains[wrapper](aux, *a)),
                 library_ms=None)
        nbytes = lm_step_bytes(kname, B, W)
        bd, by = bound_ms(nbytes, 0)
        out[kname] = dict(max_abs_err=err[wrapper], bound_ms=bd, bound_by=by, **t)
        print(f"{kname} ({label}, B={B}, W={W}): within LM_REL {LM_REL} of plain on "
              f"{len(decided)} LM iterations (largest |kernel - plain| "
              f"{err[wrapper]:.3e}){member}; kernel {t['ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, no one-call library yardstick, bound "
              f"{bd * 1e3:.4f} us ({by}, {nbytes} B)", flush=True)
    print(f"lm_accept ({label}): flags exact where decided, on "
          f"{100 * float(np.mean(decided)):.1f}% of the members over the iterations "
          f"(at least one iteration asked)", flush=True)
    return out


def trace_rows(events):
    """Sum a profiler trace's raw events (``kineto_results.events()``):
    device rows sorted by device time as (us, count, name), device busy us,
    and the ``randt.*`` layer ranges as name -> (calls, host us, device us).
    A layer's device time is that of the kernels whose launching operator
    started inside one of its ranges (on any host thread); a kernel launched
    outside any operator (the port's own, through ctypes) counts by the start
    of its launch call.  This pass takes a second where the profiler's
    ``key_averages`` takes minutes over the ~10^5 launches of a window."""
    kernels, ranges, op_start, api_start, launched = {}, {}, {}, {}, []
    for e in events:
        name, start, dur = e.name(), e.start_ns(), e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if name.startswith("randt."):
                continue  # the device span of a layer range
            row = kernels.setdefault(name, [0, 0])
            row[0] += dur
            row[1] += 1
            launched.append((e.linked_correlation_id(), e.correlation_id(), dur))
        else:
            if name.startswith("randt."):
                ranges.setdefault(name, []).append((start, start + dur))
            # operators and ranges, which kernels link to; the CUDA API
            # calls (cudaLaunchKernel, ...) number their own correlation,
            # which their kernels share
            if name.startswith("cu"):
                api_start[e.correlation_id()] = start
            elif e.correlation_id() > 0:
                op_start[e.correlation_id()] = start
    rows = sorted(((ns / 1e3, n, name) for name, (ns, n) in kernels.items()),
                  reverse=True)
    total = sum(r[0] for r in rows)
    linked = [(op_start[c] if c in op_start else api_start[a], d)
              for c, a, d in launched if c in op_start or a in api_start]
    k_at = np.array([t for t, _ in linked], dtype=np.int64)
    k_dur = np.array([d for _, d in linked], dtype=np.float64)
    layers = {}
    for name, spans in ranges.items():
        spans = np.array(sorted(spans), dtype=np.int64)
        i = np.searchsorted(spans[:, 0], k_at, side="right") - 1
        inside = (i >= 0) & (k_at <= spans[np.maximum(i, 0), 1])
        layers[name] = (len(spans), float((spans[:, 1] - spans[:, 0]).sum()) / 1e3,
                        float(k_dur[inside].sum()) / 1e3)
    return rows, total, layers


def profile_window(fn):
    """Run ``fn()`` under ``torch.profiler``: returns (its result, wall s,
    and :func:`trace_rows` of the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, total, layers = trace_rows(prof.profiler.kineto_results.events())
    print(f"profiler: {time.perf_counter() - t_all - wall:.1f} s of wall beyond the "
          f"{wall:.1f} s window (trace collection and aggregation)", flush=True)
    return out, wall, rows, total, layers


def print_profile(rows, layers, per, unit):
    for dt, cnt, key in rows[:12]:
        print(f"  {dt / 1e3:9.3f} ms  {cnt:7d} x  {key[:90]}", flush=True)
    # the port's layers (``randt.*`` profiler ranges): host time inside each,
    # and the device time of the kernels it launched
    for key, (calls, host_us, dev_us) in sorted(layers.items()):
        print(f"  layer {key:24s} {calls:5d} calls: host "
              f"{host_us / 1e3 / per:9.2f} ms/{unit}, device "
              f"{dev_us / 1e3 / per:8.2f} ms/{unit}", flush=True)


def profile_frames(label, cfg, frames, n, dev):
    """Device busy share, launches per LM iteration, top kernels and the
    port's layers over the first ``n`` frames (frame 0 is not solved).
    Returns the device kernel names and the layer ranges seen."""
    from randt_slam_torch.pipeline import slam

    sub = type(frames)(*(x[:n] for x in frames))
    _, wall, rows, total, layers = profile_window(
        lambda: slam.run_odometry(cfg, sub, device=dev))
    busy = total / 1e6 / wall if wall > 0 else float("nan")
    launches = sum(r[1] for r in rows)
    lm_iters = (n - 1) * cfg.matcher.gnc_steps * cfg.matcher.lm_max_iterations
    print(f"profile, switches {label}, over {n} frames: wall {wall * 1e3:.1f} ms, "
          f"device busy {total / 1e3:.1f} ms ({100 * busy:.1f}% of wall), {launches} "
          f"device launches = {launches / lm_iters:.1f} per LM iteration of the "
          f"{n - 1} solved frames", flush=True)
    print_profile(rows, layers, n, "frame")
    return [r[2] for r in rows], set(layers)


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


@contextlib.contextmanager
def counting_solves():
    """Count the ``matcher.estimate_window`` calls (one per solved frame)
    made inside the block, in the one-element list it yields."""
    from randt_slam_torch.registration import matcher

    solves, estimate_window = [0], matcher.estimate_window

    def counted(*a, **k):
        solves[0] += 1
        return estimate_window(*a, **k)

    matcher.estimate_window = counted
    try:
        yield solves
    finally:
        matcher.estimate_window = estimate_window


def expected_launches(cfg, scans, solves):
    """The exact launch counts of ``scans`` scan builds (frames and loop
    candidates) and ``solves`` window solves: K1 and K2 once per scan; per
    solve, on the switches-on path, K3a and K4 gnc_steps x
    lm_max_iterations times and K3b 2 + gnc_steps x (1 + lm_max_iterations)
    times, and with both switches on lm_assemble, lm_trial and lm_accept as
    often as K3a; no K5."""
    m = cfg.matcher
    lin = bool(m.use_pallas_linearize and m.use_intensity_as_dimension)
    iters = m.gnc_steps * m.lm_max_iterations
    step = solves * iters if lin and m.use_pallas_chol else 0
    return {"row_windows": scans, "segment_topk_moments": scans,
            "segment_moments": 0,
            "ndt_linearize": solves * iters if lin else 0,
            "ndt_robust_cost": solves * (2 + m.gnc_steps * (1 + m.lm_max_iterations))
            if lin else 0,
            "chol_solve": solves * iters if m.use_pallas_chol else 0,
            "lm_assemble": step, "lm_trial": step, "lm_accept": step}


def run_path(label, cfg, frames, short, first, gt, dev, scans, az, ranges, stamps):
    """Phases 4-6 for one switch setting, the main run over its first
    ``N_FRAMES[label]`` frames; returns the main run's launch counts."""
    import torch

    from randt_slam_torch.io import formats
    from randt_slam_torch.ops import build
    from randt_slam_torch.pipeline import slam
    from randt_slam_torch.utils import profiling

    # ---- 5. (first part) two CUDA runs of the first frames: the second from
    # host memory in chunks of SHORT_CHUNK (a node leaves the keyframe queue
    # insertion_delay frames after its source frame, so some straddle a
    # chunk boundary) ----------------------------------------------------------
    t0 = time.perf_counter()
    r_a = first if first is not None else slam.run_odometry(cfg, short, device=dev)
    cold = time.perf_counter() - t0
    host = slam.frames_from_arrays(scans[:N_SHORT], az, ranges, stamps[:N_SHORT],
                                   host=True)
    t0 = time.perf_counter()
    r_b = slam.run_odometry(cfg, host, device=dev, chunk=SHORT_CHUNK)
    wall_short = time.perf_counter() - t0
    for k in ("odom_poses", "node_pose", "edge_trans", "node_desc", "node_id",
              "node_frame", "node_submap", "node_is_root", "edge_begin", "edge_end",
              "edge_sqrt_information"):
        if not np.array_equal(getattr(r_a, k), getattr(r_b, k)):
            raise AssertionError(f"switches {label}: the chunked host-resident run "
                                 f"differs from the resident one in {k}")
    exits = np.asarray(r_b.node_frame) + cfg.local_fuser.insertion_delay
    straddle = int(np.sum(r_b.node_frame // SHORT_CHUNK < exits // SHORT_CHUNK))
    if not straddle or len(r_b.chunk_seconds) != -(-N_SHORT // SHORT_CHUNK):
        raise AssertionError(f"switches {label}: no node across a chunk boundary, or "
                             f"{len(r_b.chunk_seconds)} chunks")
    print(f"switches {label}: two CUDA runs of {N_SHORT} frames, the second "
          f"host-resident in chunks of {SHORT_CHUNK} ({straddle} nodes leave the "
          f"queue in the chunk after their source frame's): bitwise-identical poses, "
          f"tables and node descriptors "
          f"({'captured above' if first is not None else f'{cold:.2f} s cold'}, "
          f"{wall_short:.2f} s warm; chunk seconds "
          f"{[round(x, 3) for x in r_b.chunk_seconds]})", flush=True)

    # ---- 4. the main path ----------------------------------------------------
    n_frames = N_FRAMES[label]
    frames = type(frames)(*(x[:n_frames] for x in frames))
    gt = gt[:n_frames]
    print(f"host before the main path: {host_cpu()}", flush=True)
    marks, cpu_marks = [], []

    def mark(t, carry):
        # the steady window opens with the device drained at frame N_SHORT;
        # every frame's host issue time is kept without a sync
        if t == N_SHORT:
            torch.cuda.synchronize()
            cpu_marks.extend((time.process_time(), time.thread_time()))
        marks.append(time.perf_counter())

    with counting_solves() as solves:
        build.reset_launches()
        t0 = time.perf_counter()
        res = slam.run_odometry(cfg, frames, device=dev, on_frame=mark)
        t_end = time.perf_counter()
        launches = dict(build.LAUNCHES)
    proc_s, thread_s = time.process_time() - cpu_marks[0], time.thread_time() - cpu_marks[1]
    wall = t_end - t0
    m = cfg.matcher
    lin = bool(m.use_pallas_linearize and m.use_intensity_as_dimension)
    want = expected_launches(cfg, n_frames, solves[0])
    if launches != want:
        raise AssertionError(f"switches {label}: launches {launches} over {n_frames} "
                             f"frames and {solves[0]} window solves, expected {want}")
    per_solve = {k: v / solves[0] for k, v in launches.items() if k in
                 ("ndt_linearize", "ndt_robust_cost", "chol_solve")}
    if not np.all(np.isfinite(res.odom_poses)) or res.odom_poses.shape != (n_frames, 3):
        raise AssertionError("odometry poses are not finite / of the expected shape")
    ate = formats.ate(res.odom_poses, gt)
    t_rpe, r_rpe = formats.rpe(res.odom_poses, gt)
    # frames N_SHORT..N-1, from the drained device at frame N_SHORT to the
    # end of run_odometry (its flush and the one copy of the outputs)
    steady_ms = (t_end - marks[N_SHORT]) / (n_frames - N_SHORT) * 1e3
    issue = np.diff(marks[N_SHORT:]) * 1e3
    print(f"main path, switches {label}: {n_frames} frames in {wall:.2f} s; steady "
          f"(frames {N_SHORT}..{n_frames - 1}, timed inside the run) {steady_ms:.1f} "
          f"ms/frame = {1e3 / steady_ms:.3f} frames/s; host issue time per frame "
          f"median {np.median(issue):.1f} ms, min {issue.min():.1f}, max "
          f"{issue.max():.1f}; warm {N_SHORT}-frame run "
          f"{wall_short / N_SHORT * 1e3:.1f} ms/frame; launches {launches} "
          f"({solves[0]} window solves; per solve {per_solve}); "
          f"{len(res.node_id)} nodes, {res.n_submaps} submaps, "
          f"{int(res.rejected_frames.sum())} rejected frames", flush=True)
    # CPU time over the steady window: near the wall when the host thread
    # ran all along (a slower run then spent more CPU per frame), well below
    # it when the thread waited (the device, or other work on the host)
    window_s = t_end - marks[N_SHORT]
    print(f"host after the main path: {host_cpu()}; CPU time over the steady "
          f"window: main thread {thread_s / window_s * 100:.1f} % of the wall, "
          f"whole process {proc_s / window_s * 100:.1f} %", flush=True)
    print(f"switches {label}: odometry vs rendered ground truth: ATE {ate:.4f} m "
          f"(band < {ATE_BAND_M} m), RPE {t_rpe:.4f} m / {r_rpe:.4f} deg", flush=True)
    if not ate < ATE_BAND_M:
        raise AssertionError(f"switches {label}: odometry ATE {ate:.3f} m outside the band")

    # ---- 5. (second part) the CPU, where the plain versions run, over the
    # first N_CPU frames: the nodes and edges they emit are the first of the
    # card run's (odometry is causal) ----------------------------------------------
    t0 = time.perf_counter()
    frames_cpu = slam.frames_from_arrays(scans[:N_CPU], az, ranges,
                                         stamps[:N_CPU], device="cpu")
    r_cpu = slam.run_odometry(cfg, frames_cpu, device="cpu")
    for k in ("node_id", "node_frame", "node_submap", "node_is_root",
              "edge_begin", "edge_end"):
        mine = getattr(r_cpu, k)
        if not np.array_equal(mine, getattr(r_a, k)[:len(mine)]):
            raise AssertionError(f"switches {label}: CUDA and CPU {k} tables differ")
    d = np.abs(r_cpu.odom_poses - r_a.odom_poses[:N_CPU])
    pos = d[:, :2].max(axis=1)
    if not (d[:, 2].max() <= 1e-3 and pos.max() <= 1e-2):
        raise AssertionError(f"switches {label}: CUDA and CPU poses differ: "
                             f"{pos.max():.4f} m, {d[:, 2].max():.2e} rad")
    print(f"switches {label}: CPU run of {N_CPU} frames ({time.perf_counter() - t0:.1f} "
          f"s): tables identical ({len(r_cpu.node_id)} nodes); poses within {pos.max():.2e} m / "
          f"{d[:, 2].max():.2e} rad of the CUDA run", flush=True)

    # ---- 6. profile ------------------------------------------------------------
    captures = profiling.counter("lm_graph.capture")
    names, layers = profile_frames(label, cfg, frames, 2, dev)
    captures = profiling.counter("lm_graph.capture") - captures
    lu = sorted({k for k in names if "getrf" in k.lower() or "getrs" in k.lower()})
    print(f"switches {label}: LU kernels in the window: {lu or 'none'}; NDT autograd "
          f"range {'present' if 'randt.ndt_autograd' in layers else 'absent'}; "
          f"{captures} window solve captured", flush=True)
    # the window's solve is what its run's later frames replay
    if captures != 1:
        raise AssertionError(f"switches {label}: the profiled window captured "
                             f"{captures} window solves, not 1")
    if lin and "randt.ndt_autograd" in layers:
        raise AssertionError("switches on: the NDT residuals went through autograd")
    if m.use_pallas_chol and lu:
        raise AssertionError(f"switches on: LU kernels ran: {lu}")
    if not lin and "randt.ndt_autograd" not in layers:
        raise AssertionError("switches off: no autograd linearization seen")
    return launches


def loop_and_pgo(cfg, odo, frames, device):
    """The loop-closure and pose-graph phases of ``run_slam`` from one
    odometry result, on ``device``: (loops, optimized node poses)."""
    from randt_slam_torch.graph import schur
    from randt_slam_torch.loops import detector
    from randt_slam_torch.pipeline import slam

    loops = detector.detect_loops(cfg, odo, frames, device=device)
    opt, info = schur.optimize_auto(slam.build_pose_graph(odo, loops, device),
                                    cfg.global_fuser, node_submap=odo.node_submap,
                                    node_is_root=odo.node_is_root)
    return loops, opt.cpu().numpy()


def gate_from_identical_inputs(cfg, odo, frames, loops, dev):
    """The CS gate on the CPU from the card run's inputs: its accepted edges'
    refined poses and candidate scan cells (rebuilt on the card, as in the
    run, and moved over).  Returns the largest relative CS difference, and
    in how many candidate frames the cells rebuilt on the CPU differ from the
    card's (a point that crosses a cluster boundary by an ulp moves two
    cells' statistics and can change their rank among the kept cells)."""
    import torch

    from randt_slam_torch.loops import detector

    cpu = torch.device("cpu")
    stage = loops.query_stage[loops.query_stage >= 2]
    cs_card = loops.cs_divergences[stage == 3]
    frames_of = np.asarray(odo.node_frame)[loops.edge_end]
    moving = [x.cpu() for x in detector._candidate_features(cfg, frames, frames_of,
                                                            None, dev)]
    moving_cpu = detector._candidate_features(cfg, frames, frames_of, None, cpu)
    moved = ((moving_cpu[0] - moving[0]).abs().amax(-1) > 1e-3) & moving[2]
    frames_differ = int(moved.any(-1).sum())
    fields = detector._store_fields(cfg, odo, cpu)
    sub = np.asarray(odo.node_submap)[loops.edge_begin]
    f_self = detector._self_terms(*fields, sub)
    s = torch.from_numpy(sub.astype(np.int64))
    cs = detector._cs_gate(torch.from_numpy(loops.edge_trans.astype(np.float32)),
                           fields[0][s], fields[1][s], fields[2][s], *moving,
                           torch.tensor([f_self[int(x)] for x in sub]))
    cs_rel = float(np.max(np.abs(cs.numpy() / cs_card - 1)))
    return dict(cs_rel=cs_rel, frames_differ=frames_differ,
                n_frames=len(frames_of))


def slam_phase(cfg, dev):
    """Phase 7: full SLAM over a looping drive; returns the run's launch
    counts, its result, its frames and their ground truth."""
    import torch

    from randt_slam_torch.io import formats
    from randt_slam_torch.loops import detector
    from randt_slam_torch.ops import build
    from randt_slam_torch.pipeline import slam

    t0 = time.perf_counter()
    scans, az, ranges, stamps, gt = render_frames(N_LOOP, seed=2, laps=LOOP_LAPS)
    print(f"full SLAM: rendered a looping drive of {N_LOOP} frames ({LOOP_LAPS} "
          f"laps of {N_LOOP / LOOP_LAPS:.0f} m) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # in host memory, as the JAX package's bench.py runs its end-to-end
    # window: run_slam uploads them LOOP_CHUNK at a time
    frames = slam.frames_from_arrays(scans, az, ranges, stamps, host=True)
    frame_bytes = sum(x.nbytes for x in frames)

    # the loop phase, watched from inside run_slam: its kernel launches and
    # its peak device memory, and the odometry's before it
    watch = {}
    detect = detector.detect_loops

    def watched(*a, **k):
        torch.cuda.synchronize(dev)
        watch["odometry_peak"] = torch.cuda.max_memory_allocated(dev)
        before = dict(build.LAUNCHES)
        torch.cuda.reset_peak_memory_stats(dev)
        watch["resident"] = torch.cuda.memory_allocated(dev)
        out = detect(*a, **k)
        torch.cuda.synchronize(dev)
        watch["peak"] = torch.cuda.max_memory_allocated(dev)
        watch["launches"] = {n: build.LAUNCHES[n] - before[n] for n in before}
        return out

    print(f"host before full SLAM: {host_cpu()}", flush=True)
    detector.detect_loops = watched
    try:
        with counting_solves() as solves:
            build.reset_launches()
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            watch["before"] = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            res = slam.run_slam(cfg, frames, device=dev, chunk=LOOP_CHUNK)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
    finally:
        detector.detect_loops = detect
    odo, loops = res.odometry, res.loops
    print(f"host after full SLAM: {host_cpu()}", flush=True)

    n_cand = loops.n_sc_candidates
    if watch["launches"] != expected_launches(cfg, n_cand, 0):
        raise AssertionError(f"loop phase launched {watch['launches']}, expected one "
                             f"K1 and one K2 per candidate frame ({n_cand}) and "
                             f"nothing else")
    want = expected_launches(cfg, N_LOOP + n_cand, solves[0])
    if launches != want:
        raise AssertionError(f"full SLAM launched {launches} over {N_LOOP} frames, "
                             f"{n_cand} candidate frames and {solves[0]} window "
                             f"solves, expected {want}")
    if loops.n_accepted < 1:
        raise AssertionError(f"no loop edge accepted ({n_cand} candidates, stages "
                             f"{np.bincount(loops.query_stage, minlength=4).tolist()})")
    if not (np.all(np.isfinite(res.node_pose_optimized))
            and np.all(np.isfinite(odo.odom_poses))):
        raise AssertionError("full SLAM: poses are not finite")
    t = res.timings
    if t["pgo_solver"] != "dense" or not t["pgo_two_stage"]:
        raise AssertionError(f"pose graph took {t['pgo_solver']}, two-stage "
                             f"{t['pgo_two_stage']}")
    node_gt = gt[odo.node_frame]
    ate_odo = formats.ate(odo.node_pose, node_gt)
    ate_pgo = formats.ate(res.node_pose_optimized, node_gt)
    ate_frames = formats.ate(odo.odom_poses, gt)
    stages = np.bincount(loops.query_stage, minlength=4)
    print(f"full SLAM: {N_LOOP} frames in {wall:.2f} s; {len(odo.node_id)} nodes, "
          f"{odo.n_submaps} submaps; queries {len(loops.query_node)} (no candidate "
          f"{stages[0]}, own submap {stages[1]}, gated out {stages[2]}, accepted "
          f"{stages[3]}); ScanContext candidates {n_cand}, accepted loop edges "
          f"{loops.n_accepted}, odometry-gate rejections {loops.n_odom_gate_rejected}; "
          f"CS divergences {np.round(loops.cs_divergences, 3).tolist()}", flush=True)
    print(f"full SLAM: node ATE odometry {ate_odo:.4f} m, after the pose graph "
          f"{ate_pgo:.4f} m (limit 1.05 x); per-frame odometry ATE {ate_frames:.4f} m; "
          f"pose graph: {t['pgo_solver']}, two-stage, {res.pgo_iterations} "
          f"iterations in the second stage, cost {res.pgo_cost:.4g}", flush=True)
    if not ate_pgo <= 1.05 * ate_odo:
        raise AssertionError(f"post-PGO ATE {ate_pgo:.4f} m above 1.05 x odometry "
                             f"{ate_odo:.4f} m")
    lt = loops.timings
    print(f"full SLAM wall seconds: odometry {t['odometry_s']}, loop closure "
          f"{t['loop_closure_s']} (descriptors {lt['features_s']}, retrieval "
          f"{lt['retrieval_s']}, candidate features {lt['cand_features_s']}, refine + "
          f"gate {lt['refine_gate_s']}), pose graph {t['pgo_s']}; loop phase: K1/K2 "
          f"launched once per candidate frame ({n_cand}), peak device memory "
          f"{watch['peak'] / 2**30:.3f} GiB ({watch['resident'] / 2**30:.3f} GiB "
          f"resident before it); run launches {launches}", flush=True)
    cs = odo.chunk_seconds
    if len(cs) != -(-N_LOOP // LOOP_CHUNK):
        raise AssertionError(f"full SLAM: {len(cs)} odometry chunks")
    print(f"full SLAM, host-resident frames in chunks of {LOOP_CHUNK}: chunk seconds "
          f"{[round(x, 3) for x in cs]} ({1e3 * cs[1:].sum() / (N_LOOP - LOOP_CHUNK):.1f} "
          f"ms/frame after the first chunk); odometry peak device memory "
          f"{watch['odometry_peak'] / 2**30:.3f} GiB ({watch['before'] / 2**30:.3f} "
          f"GiB resident before it); the {N_LOOP} frames take {frame_bytes / 2**20:.1f} "
          f"MiB of host memory ({frame_bytes / N_LOOP / 2**20:.2f} MiB a frame), which "
          f"they would take on the card if resident", flush=True)

    # ---- the loop and pose-graph phases again: twice on the card (the second
    # under the profiler), once on the CPU, from the same odometry result
    t0 = time.perf_counter()
    again = [loop_and_pgo(cfg, odo, frames, dev)]
    card_s = time.perf_counter() - t0
    profiled, pw, rows, total, layers = profile_window(
        lambda: loop_and_pgo(cfg, odo, frames, dev))
    again.append(profiled)
    for lp, opt in again:
        same = (np.array_equal(lp.edge_trans, loops.edge_trans)
                and np.array_equal(lp.cs_divergences, loops.cs_divergences)
                and np.array_equal(lp.query_match, loops.query_match)
                and np.array_equal(opt, res.node_pose_optimized))
        if not same:
            raise AssertionError("full SLAM: loop + pose-graph runs on the card differ")
    t0 = time.perf_counter()
    lc, opt_c = loop_and_pgo(cfg, odo, frames, "cpu")
    cpu_s = time.perf_counter() - t0
    for k in ("query_node", "query_match", "query_stage", "edge_begin", "edge_end"):
        if not np.array_equal(getattr(lc, k), getattr(loops, k)):
            raise AssertionError(f"full SLAM: CPU and CUDA loop tables differ in {k}")
    if (lc.n_sc_candidates, lc.n_accepted, lc.n_odom_gate_rejected) != (
            n_cand, loops.n_accepted, loops.n_odom_gate_rejected):
        raise AssertionError("full SLAM: CPU and CUDA loop counts differ")
    cs_rel = float(np.max(np.abs(lc.cs_divergences / loops.cs_divergences - 1)))
    de = np.abs(lc.edge_trans - loops.edge_trans)
    dp = np.abs(opt_c - res.node_pose_optimized)
    t0 = time.perf_counter()
    gate = gate_from_identical_inputs(cfg, odo, frames, loops, dev)
    gate_s = time.perf_counter() - t0
    print(f"full SLAM, loop + pose graph from one odometry result: two more card "
          f"runs bitwise equal ({card_s:.1f} s, and the profiled one); CPU run "
          f"({cpu_s:.1f} s; the CPU gate from identical inputs {gate_s:.1f} s more): "
          f"tables identical, CS within "
          f"{cs_rel:.2e} relative, edges within {de[:, :2].max():.2e} m / "
          f"{de[:, 2].max():.2e} rad, optimized poses within {dp[:, :2].max():.2e} m "
          f"/ {dp[:, 2].max():.2e} rad; the candidate scan cells rebuilt on the two "
          f"devices differ in {gate['frames_differ']} of {gate['n_frames']} frames "
          f"(a mean moved by more than 1e-3 m); the CPU gate on the card run's cells "
          f"and refined poses within {gate['cs_rel']:.2e} of the card run's CS",
          flush=True)
    if not (gate["cs_rel"] <= 1e-4 and dp[:, :2].max() <= 1e-3
            and dp[:, 2].max() <= 1e-4):
        raise AssertionError("full SLAM: the CS gate from identical inputs differs "
                             "beyond 1e-4 relative, or the optimized poses beyond "
                             "1e-3 m / 1e-4 rad, between CPU and CUDA")
    # free-running from the same odometry, the two devices rebuild some
    # candidate cells differently (points an ulp apart across a cluster
    # boundary), and refinement from them lands within one ulp-decided LM
    # step, as the CPU tests' one-step band allows
    if not (cs_rel <= LOOP_CS_BAND and de[:, :2].max() <= LOOP_EDGE_BAND[0]
            and de[:, 2].max() <= LOOP_EDGE_BAND[1]):
        raise AssertionError(f"full SLAM: CPU and CUDA loop edges differ beyond "
                             f"{LOOP_CS_BAND} (CS, relative) / {LOOP_EDGE_BAND[0]} m "
                             f"/ {LOOP_EDGE_BAND[1]} rad")

    # ---- the profile of the second card run ----------------------------------
    n_launch = sum(r[1] for r in rows)
    print(f"profile, loop closure + pose graph: wall {pw * 1e3:.1f} ms, device busy "
          f"{total / 1e3:.1f} ms ({100 * total / 1e6 / pw:.1f}% of wall), {n_launch} "
          f"device launches for {n_cand} candidates", flush=True)
    print_profile(rows, layers, 1, "run")
    missing = {"randt.loop_retrieval", "randt.loop_refine", "randt.cs_gate",
               "randt.pgo"} - set(layers)
    if missing:
        raise AssertionError(f"profile: ranges {sorted(missing)} not seen")
    return launches, res, frames, gt


def se2_gap(a, b):
    """Largest position (m) and heading (rad, modulo 2 pi) gap of two pose
    arrays."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    return float(np.abs(d[:, :2]).max()), float(np.abs(d[:, 2]).max())


@contextlib.contextmanager
def counting_schur_iterations():
    """Sum the Gauss-Newton iterations of the ``schur.optimize_schur`` calls
    made inside the block (both stages of the two-stage schedule)."""
    from randt_slam_torch.graph import schur

    its, optimize_schur = [0], schur.optimize_schur

    def counted(*a, **k):
        poses, info = optimize_schur(*a, **k)
        its[0] += info["iterations"]
        return poses, info

    schur.optimize_schur = counted
    try:
        yield its
    finally:
        schur.optimize_schur = optimize_schur


def schur_phase(dev, smi):
    """Phase 9: bench.py's graph of SCHUR_NODES nodes through
    ``schur.optimize_auto`` on the card (the Schur route, the two-stage DCS
    schedule of the shipped configuration), against the ground truth, the
    dense route on the card and the Schur route on the CPU; wall times of
    the steady (second) call, iterations and ms per iteration, and
    ``bench.py``'s ``pose_graph_solve_ms`` figure (max_iterations=10)."""
    import torch

    from randt_slam_torch.config import GlobalFuserConfig
    from randt_slam_torch.graph import pose_graph as PG
    from randt_slam_torch.graph import schur
    from randt_slam_torch.ops import build

    poses, eb, ee, trans, sqrt_i, node_submap, node_is_root, gt = bench_graph(SCHUR_NODES)

    def graph(device):
        def put(x):
            return torch.from_numpy(x).to(device)
        return PG.PoseGraph(put(poses), put(eb), put(ee), put(trans), put(sqrt_i),
                            torch.ones(len(eb), dtype=torch.bool, device=device))

    def solve(g, cfg, submaps=True):
        kw = dict(node_submap=node_submap, node_is_root=node_is_root) if submaps else {}
        with counting_schur_iterations() as its:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, info = schur.optimize_auto(g, cfg, **kw)
            p = p.cpu().numpy()
            wall = time.perf_counter() - t0
        return p, info, wall, its[0]

    g = graph(dev)
    cfg = GlobalFuserConfig()
    build.reset_launches()
    card, info, cold, _ = solve(g, cfg)
    launches = dict(build.LAUNCHES)
    again, _, steady, its = solve(g, cfg)
    if info["solver"] != "schur" or not info.get("two_stage"):
        raise AssertionError(f"{SCHUR_NODES} nodes took {info}")
    if any(launches.values()):
        raise AssertionError(f"the Schur route launched {launches}")
    if not (np.array_equal(card, again) and np.all(np.isfinite(card))):
        raise AssertionError("two Schur solves on the card differ or are not finite")
    b10, _, _, _ = solve(g, GlobalFuserConfig(max_iterations=10))
    _, _, wall10, its10 = solve(g, GlobalFuserConfig(max_iterations=10))
    # where an iteration's time goes: the max_iterations=10 solve profiled
    (_, _, _, its_p), pw, rows, total, layers = profile_window(
        lambda: solve(g, GlobalFuserConfig(max_iterations=10)))
    print(f"profile, Schur route, max_iterations=10 ({its_p} iterations): wall "
          f"{pw * 1e3:.1f} ms, device busy {total / 1e3:.1f} ms ({100 * total / 1e6 / pw:.1f}% "
          f"of wall), {sum(r[1] for r in rows) / its_p:.1f} device launches per "
          f"iteration", flush=True)
    print_profile(rows, layers, its_p, "iteration")
    dense, dinfo, dense_s, _ = solve(g, cfg, submaps=False)
    if dinfo["solver"] != "dense":
        raise AssertionError(f"the dense comparison took {dinfo}")
    cpu, cinfo, cpu_s, _ = solve(graph("cpu"), cfg)
    gaps = {"ground truth": se2_gap(card, gt), "the dense solve": se2_gap(card, dense),
            "the CPU's Schur solve": se2_gap(card, cpu)}
    print(f"Schur pose graph, bench.py's graph of {SCHUR_NODES} nodes ({len(eb)} edges, "
          f"{int(node_is_root.sum())} roots), on {smi}: optimize_auto took the Schur "
          f"route with the two-stage DCS schedule, launched none of the port's kernels, "
          f"repeats bitwise; steady (second) call {steady * 1e3:.1f} ms wall for {its} "
          f"iterations over both stages ({info['iterations']} in the second) = "
          f"{steady * 1e3 / its:.2f} ms per iteration (cold {cold * 1e3:.1f} ms); "
          f"max_iterations=10 (bench.py's pose_graph_solve_ms_4077_nodes): "
          f"{wall10 * 1e3:.1f} ms for {its10} iterations, "
          f"{se2_gap(b10, gt)[0]:.3g} m from the ground truth; the dense route on the "
          f"card {dense_s:.2f} s ({dinfo['iterations']} iterations in the second "
          f"stage); the Schur route on the CPU {cpu_s:.2f} s", flush=True)
    for what, (m, rad) in gaps.items():
        print(f"  Schur on the card against {what}: {m:.3e} m / {rad:.3e} rad "
              f"(band {SCHUR_BAND[0]:.3e} m / {SCHUR_BAND[1]:.3e} rad)", flush=True)
        if not (m <= SCHUR_BAND[0] and rad <= SCHUR_BAND[1]):
            raise AssertionError(f"Schur solve off {what} beyond the band")
    return dict(steady_ms=steady * 1e3, iterations=its, ms_per_iteration=steady * 1e3 / its,
                max10_ms=wall10 * 1e3, max10_poses=b10, max10_iterations=its10)


def ogm_phase(cfg, res, frames, dev):
    """Phase 8: ``render_ogm`` on the full-SLAM run's result at the Oxford
    OGM configuration, the node frames gathered from host memory OGM_CHUNK
    at a time, twice on the card (exact launches: K1 once per chunk and
    nothing else; bitwise-equal grids) and once on the CPU (counting grids
    bitwise equal, occupancy within 1e-5).  Returns the card run's K1
    launches."""
    import torch

    from randt_slam_torch.ops import build
    from randt_slam_torch.pipeline import slam

    n_nodes = len(res.odometry.node_id)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    build.reset_launches()
    t0 = time.perf_counter()
    occ, grids = slam.render_ogm(cfg, res, frames, device=dev, chunk=OGM_CHUNK)
    cold = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    n_chunks = -(-n_nodes // OGM_CHUNK)
    want = {n: (n_chunks if n == "row_windows" else 0) for n in launches}
    if launches != want:
        raise AssertionError(f"render_ogm launched {launches}, expected K1 once per "
                             f"chunk of {OGM_CHUNK} of the {n_nodes} nodes and "
                             f"nothing else")
    t0 = time.perf_counter()
    occ2, grids2 = slam.render_ogm(cfg, res, frames, device=dev, chunk=OGM_CHUNK)
    steady = time.perf_counter() - t0
    _, pw, rows, total, layers = profile_window(
        lambda: slam.render_ogm(cfg, res, frames, device=dev, chunk=OGM_CHUNK))
    print(f"profile, render_ogm (a third card run): wall {pw * 1e3:.1f} ms, device "
          f"busy {total / 1e3:.1f} ms ({100 * total / 1e6 / pw:.1f}% of wall), "
          f"{sum(r[1] for r in rows)} device launches", flush=True)
    print_profile(rows, layers, 1, "run")
    if not (np.array_equal(grids, grids2) and np.array_equal(occ, occ2)):
        raise AssertionError("render_ogm: two card runs differ")
    t0 = time.perf_counter()
    occ_c, grids_c = slam.render_ogm(cfg, res, frames, device="cpu", chunk=OGM_CHUNK)
    cpu_s = time.perf_counter() - t0
    d_occ = float(np.abs(occ - occ_c).max())
    o = cfg.ogm
    print(f"OGM: render_ogm on the full-SLAM result ({n_nodes} nodes, "
          f"{res.odometry.n_submaps} submaps of {o.submap_size_y}x{o.submap_size_x} "
          f"int32 cells, node frames from host memory in chunks of {OGM_CHUNK}, global {o.size_y}x{o.size_x} at {o.resolution} m): card "
          f"{cold:.3f} s cold, {steady:.3f} s steady; peak device memory "
          f"{peak / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB resident before); "
          f"launches {launches}; counts {int(grids.min())}..{int(grids.max())}, "
          f"{int((grids != 0).sum())} cells touched, {int((occ >= 0).sum())} global "
          f"cells known; two card runs bitwise equal; CPU run {cpu_s:.2f} s: counting "
          f"grids {'bitwise equal' if np.array_equal(grids, grids_c) else 'DIFFER'}, "
          f"occupancy within {d_occ:.2e}", flush=True)
    if grids.shape != (res.odometry.n_submaps, o.submap_size_y, o.submap_size_x):
        raise AssertionError(f"counting grids of shape {grids.shape}")
    if not (grids.min() < 0 and grids.max() >= 2 and np.isfinite(occ).all()):
        raise AssertionError("render_ogm: no free-space or hit counts, or a non-finite cell")
    if not (np.array_equal(grids, grids_c) and d_occ <= 1e-5):
        raise AssertionError("render_ogm: the card's grids differ from the CPU's")
    return launches["row_windows"]


def se2_gap_free(a, b):
    """se2_gap of two pose arrays that may be empty."""
    return se2_gap(a, b) if len(a) else (0.0, 0.0)


def online_phase(cfg, res, frames, gt, dev, smi):
    """Phase 10: ``OnlineSlam`` over the first N_ONLINE frames of phase 7's
    drive (switches on, default cadences, online OGM), then ``finalize`` and
    ``render_ogm``; a checkpoint after ONLINE_SAVE_AT frames resumed on the
    card and, for one cadence, on the CPU.  Returns the main run's launch
    counts."""
    import dataclasses
    import os
    import tempfile

    import torch

    from randt_slam_torch.io import formats
    from randt_slam_torch.ops import build
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline.online import OnlineSlam
    from randt_slam_torch.utils import profiling

    cfg = dataclasses.replace(cfg, visualize_ogm=True)
    n = N_ONLINE

    # phase 7's frames are in host memory: pinned, each frame is uploaded
    # on the compute stream without a wait
    pinned = F.Frame(*(x[:n].pin_memory() for x in frames))

    def frame(t):
        return F.Frame(*(x[t].to(dev, non_blocking=True) for x in pinned))

    eng = OnlineSlam(cfg, device=dev)
    # watched on the instance: the pose-graph ticks (loop edges, whether the
    # active submap's origin moved), the launches of the loop cadences and of
    # each refinement, and every node pose as odometry emitted it
    ticks, cadence_launches, refine_launches, emitted = [], [], [], []
    tick, detect, refine, record_out = (eng.optimize_pose_graph, eng.detect_loops,
                                        eng._refine_and_gate, eng._record_outputs)

    def watched_tick(final=False):
        before, loops = eng.carry.submap_origin.clone(), eng.n_loop_edges
        t0 = time.perf_counter()
        tick(final)
        ticks.append(dict(frame=eng._frame_count, loops=loops, final=final,
                          moved=not torch.equal(before, eng.carry.submap_origin),
                          s=time.perf_counter() - t0))

    def launches_of(fn, into):
        def run(*a, **kw):
            before = dict(build.LAUNCHES)
            out = fn(*a, **kw)
            into.append(sum(build.LAUNCHES[k] - before[k] for k in before))
            return out
        return run

    def watched_record(out, h):
        record_out(out, h)
        emitted.extend(np.array(p) for p in eng.node_pose[len(emitted):])

    eng.optimize_pose_graph = watched_tick
    eng.detect_loops = launches_of(detect, cadence_launches)
    eng._refine_and_gate = launches_of(refine, refine_launches)
    eng._record_outputs = watched_record
    ck = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "online.npz")
    print(f"host before online SLAM: {host_cpu()}", flush=True)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    with counting_solves() as solves:
        build.reset_launches()
        t0 = time.perf_counter()
        marks, walls, captured, n_rec = [], [], [], profiling.REGISTRY.n
        for t in range(n):
            if t == ONLINE_SAVE_AT:
                t_save = time.perf_counter()
                eng.save_checkpoint(ck)
                save_s = time.perf_counter() - t_save
                pending = list(eng._pending_loop_queries)
                saved_nodes = len(eng.node_pose)
            c0 = profiling.counter("lm_graph.capture")
            marks.append(time.perf_counter())
            eng.process_frame(frame(t))
            walls.append(time.perf_counter() - marks[-1])
            if profiling.counter("lm_graph.capture") > c0:
                captured.append(t)
        t_end = time.perf_counter()
        eng.finalize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    place = eng.grid_placement()
    if place["reuploads"] or not place["host"]:
        raise AssertionError(f"online SLAM: counting grids {place}: a grid went back to "
                             f"the card, or none of a finished submap left it")
    want = expected_launches(cfg, n, solves[0])
    if launches != want:
        raise AssertionError(f"online SLAM launched {launches} over {n} frames and "
                             f"{solves[0]} window solves, expected {want}")
    if any(cadence_launches) or any(refine_launches):
        raise AssertionError(f"online loop cadences launched {cadence_launches} "
                             f"(refinements {refine_launches}), expected none")
    steady_ms = ((t_end - marks[N_SHORT]) - save_s) / (n - N_SHORT) * 1e3
    odo_ms = res.timings["odometry_s"] / N_LOOP * 1e3
    odom = np.stack(eng.odom_trace)
    traj = eng.trajectory()
    if not (np.all(np.isfinite(odom)) and np.all(np.isfinite(traj))):
        raise AssertionError("online SLAM: poses are not finite")
    if eng.n_loop_edges < 1:
        raise AssertionError("online SLAM: no loop edge accepted")
    mid = [k for k in ticks if not k["final"] and k["loops"] > 0]
    anchor = [k for k in mid if k["moved"]]
    if not anchor:
        raise AssertionError(f"online SLAM: no mid-run tick with loop edges moved the "
                             f"active submap's origin ({ticks})")
    # before the first re-anchoring the online odometry is phase 7's, bitwise
    first = anchor[0]["frame"]
    prefix = res.odometry.odom_poses[:first]
    if not np.array_equal(odom[:first], prefix):
        bad = int(np.argmax(np.any(odom[:first] != prefix, axis=1)))
        raise AssertionError(f"online odometry differs from phase 7's at frame {bad} "
                             f"(first re-anchoring after frame {first})")
    node_gt = gt[np.asarray(eng.node_frame)]
    ate_odo = formats.ate(np.stack(emitted), node_gt)
    ate_pgo = formats.ate(traj, node_gt)
    if not ate_pgo <= 1.05 * ate_odo:
        raise AssertionError(f"online post-PGO node ATE {ate_pgo:.4f} m above 1.05 x "
                             f"odometry {ate_odo:.4f} m")
    med = {k: float(np.median(v)) * 1e3 if v else float("nan")
           for k, v in eng.stage_walls.items()}
    accepted = sum(1 for x in eng.loop_trace if x[-1])
    print(f"online SLAM on {smi}: {n} frames + finalize in {wall:.2f} s; steady "
          f"(frames {N_SHORT}..{n - 1}, the checkpoint save taken out) {steady_ms:.1f} "
          f"ms/frame, beside phase 7's odometry {odo_ms:.1f} ms/frame in this call; "
          f"stage medians step {med['step']:.1f}, record {med['record']:.1f}, loops "
          f"{med['loops']:.1f}, pgo {med['pgo']:.1f} ms ({len(eng.stage_walls['loops'])} "
          f"loop cadences, {len(eng.stage_walls['pgo'])} pose-graph cadences); loop "
          f"candidates refined {len(eng.loop_trace)}, accepted {accepted} "
          f"(loop edges {eng.n_loop_edges}); {len(traj)} nodes; counting grids: "
          f"{place['device']} on the card ({place['device_bytes'] / 2**20:.1f} MiB), "
          f"{place['host']} in host memory ({place['host_bytes'] / 2**20:.1f} MiB), "
          f"{place['reuploads']} re-uploads; launches {launches} ({solves[0]} window "
          f"solves; loop cadences and refinements none); peak device memory "
          f"{peak / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB resident before), "
          f"beside {ONLINE_PEAK_RESIDENT_GIB} GiB with every grid and the frames on "
          f"the card", flush=True)
    print(f"host after online SLAM: {host_cpu()}", flush=True)
    # the frames whose window solve ran eagerly and was captured (the first of
    # each graph key) against the others: the front-end step's span
    # (``randt.online_step``, ring) and the frame's whole process_frame wall
    step_ms = [(r.end - r.start) / 1e6 for r in profiling.records(n_rec)
               if r.name == "randt.online_step"]
    frame_ms = np.asarray(walls) * 1e3
    others = [t for t in range(n) if t not in captured]
    if len(step_ms) != n or not captured:
        raise AssertionError(f"online SLAM: {len(step_ms)} randt.online_step records "
                             f"over {n} frames, captures at frames {captured}")
    print(f"online SLAM: frames {captured} captured a window solve: randt.online_step "
          f"{[round(step_ms[t], 1) for t in captured]} ms, process_frame "
          f"{[round(float(frame_ms[t]), 1) for t in captured]} ms; the other {len(others)} "
          f"frames: randt.online_step median {np.median([step_ms[t] for t in others]):.1f} "
          f"(max {max(step_ms[t] for t in others):.1f}) ms, process_frame median "
          f"{np.median(frame_ms[others]):.1f} (max {frame_ms[others].max():.1f}) ms",
          flush=True)
    print(f"online SLAM: pose-graph ticks {[(k['frame'], k['loops'], k['moved'], round(k['s'], 3)) for k in ticks]} "
          f"(frame count, loop edges, origin moved, s); first re-anchoring after "
          f"frame {first}: odometry bitwise phase 7's on frames 0..{first - 1}; node "
          f"ATE odometry {ate_odo:.4f} m, after finalize {ate_pgo:.4f} m (limit 1.05 x); "
          f"per-frame odometry ATE {formats.ate(odom, gt[:n]):.4f} m", flush=True)
    t0 = time.perf_counter()
    occ = eng.render_ogm()
    render_s = time.perf_counter() - t0
    grids = list(eng.count_grids().values())
    if not (np.isfinite(occ).all() and min(g.min() for g in grids) < 0
            and max(g.max() for g in grids) >= 2 and (occ >= 0).any()):
        raise AssertionError("online render_ogm: no free-space or hit counts, or a "
                             "non-finite cell")

    # ---- resume on the card from the checkpoint -------------------------------
    size_mb = os.path.getsize(ck) / 2**20
    again = OnlineSlam(cfg, device=dev)
    t0 = time.perf_counter()
    again.load_checkpoint(ck)
    load_s = time.perf_counter() - t0
    with counting_solves() as solves2:
        build.reset_launches()
        for t in range(ONLINE_SAVE_AT, n):
            again.process_frame(frame(t))
        again.finalize()
        launches2 = dict(build.LAUNCHES)
    restored = sum(1 for i, f in enumerate(again.node_frame)
                   if i >= saved_nodes and f < ONLINE_SAVE_AT)
    want2 = expected_launches(cfg, n - ONLINE_SAVE_AT + restored, solves2[0])
    if launches2 != want2:
        raise AssertionError(f"resumed run launched {launches2}, expected {want2} "
                             f"({restored} restored-frame nodes)")
    same = (np.array_equal(np.stack(again.odom_trace), odom)
            and np.array_equal(again.trajectory(), traj)
            and [e[:2] for e in again.edges] == [e[:2] for e in eng.edges]
            and all(np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
                    for a, b in zip(again.edges, eng.edges))
            and again.count_grids().keys() == eng.count_grids().keys()
            and all(np.array_equal(again.count_grids()[k], g)
                    for k, g in eng.count_grids().items())
            and again.grid_placement()["reuploads"] == 0)
    if not same:
        raise AssertionError("the resumed run differs from the uninterrupted one")
    print(f"online checkpoint after frame {ONLINE_SAVE_AT} ({saved_nodes} nodes, "
          f"pending queries {pending}): {size_mb:.1f} MiB, saved in {save_s:.2f} s, "
          f"loaded in {load_s:.2f} s; the resumed run (frames {ONLINE_SAVE_AT}..{n - 1} "
          f"+ finalize) bitwise equal to the uninterrupted one (odometry, "
          f"trajectory, edges, counting grids); its launches {launches2}, K1/K2 "
          f"{restored} more than its frames: the restored-frame nodes; render_ogm "
          f"{render_s:.3f} s", flush=True)

    # ---- one cadence from the checkpoint on the CPU and on the card -----------
    card, cpu = OnlineSlam(cfg, device=dev), OnlineSlam(cfg, device="cpu")
    walls = {}
    for name, e in (("card", card), ("cpu", cpu)):
        e.load_checkpoint(ck)
        t0 = time.perf_counter()
        e.detect_loops()
        e.optimize_pose_graph()
        walls[name] = time.perf_counter() - t0
    if ([x[:3] for x in cpu.loop_trace] != [x[:3] for x in card.loop_trace]
            or [e[:2] for e in cpu.edges] != [e[:2] for e in card.edges]):
        raise AssertionError("one cadence from the checkpoint: CPU and card candidates "
                             "or edges differ")
    de = se2_gap_free(np.asarray([x[3] for x in cpu.loop_trace]).reshape(-1, 3),
                      np.asarray([x[3] for x in card.loop_trace]).reshape(-1, 3))
    cs_rel = max([abs(a[4] / b[4] - 1) for a, b in zip(cpu.loop_trace, card.loop_trace)],
                 default=0.0)
    dp = se2_gap(cpu.trajectory(), card.trajectory())
    print(f"online, one cadence from the checkpoint: {len(card.loop_trace)} candidates "
          f"refined, {sum(1 for x in card.loop_trace if x[-1])} accepted; card "
          f"{walls['card']:.2f} s, CPU {walls['cpu']:.2f} s; CPU against card: edges "
          f"within {de[0]:.2e} m / {de[1]:.2e} rad, CS within {cs_rel:.2e} relative, "
          f"optimized poses within {dp[0]:.2e} m / {dp[1]:.2e} rad", flush=True)
    if not (de[0] <= LOOP_EDGE_BAND[0] and de[1] <= LOOP_EDGE_BAND[1]
            and cs_rel <= LOOP_CS_BAND and dp[0] <= 1e-3 and dp[1] <= 1e-4):
        raise AssertionError("one cadence from the checkpoint: CPU and card differ "
                             "beyond the bands")
    os.remove(ck)
    return launches


def member_outputs(outs, b, n):
    """Member ``b``'s first ``n`` frames of a batched (B, T, ...) output."""
    def take(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(take(v) for v in x))
        return x[b, :n]
    return take(outs)


def batch_run(cfg, frames_b, steady_from, dev, on_frame=None, group=None):
    """One ``make_batched_scan`` run of ``frames_b`` (B, T, ...), sharded
    over ``group`` if one is given: returns the outputs (all B members),
    this process's launch counts and window solves, the steady ms per
    batched frame (frames ``steady_from`` to the end, timed inside the run,
    the device drained at its start, the gather of a sharded run included),
    the fleet frames/s (B x frames / that wall) and the peak device
    memory."""
    import torch

    from randt_slam_torch.ops import build
    from randt_slam_torch.parallel import batch

    B, n = frames_b.stamp.shape[:2]
    marks = []

    def mark(t, carries):
        if on_frame is not None:
            on_frame(t, carries)
        if t == steady_from:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    scan = batch.make_batched_scan(cfg, np.zeros(3), device=dev, group=group)
    carries = batch.init_batched_carry(cfg, B, device=dev, group=group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with counting_solves() as solves:
        build.reset_launches()
        _, outs = scan(carries, frames_b, on_frame=mark)  # ends in the host copy
        t_end = time.perf_counter()
        launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    steady = t_end - marks[steady_from]
    return (outs, launches, solves[0], steady / (n - steady_from) * 1e3,
            B * (n - steady_from) / steady, peak)


def batch_kernel_inputs(cfg, scans_b, az, ranges, dev):
    """K1 and K2 inputs of one batched frame (B, A, R), formed as the
    batched main path forms them."""
    import torch
    import torch.nn.functional as Fn

    from randt_slam_torch import preprocess as pp
    from randt_slam_torch.ndt import cells as C

    img = torch.from_numpy(scans_b).to(dev)
    B = img.shape[0]
    r = torch.from_numpy(ranges).to(dev).expand(B, -1)
    pc = cfg.preprocessor
    rw = 32
    gated = torch.where(((r > pc.min_range) & (r < pc.max_range))[:, None, :], img,
                        float("-inf"))
    peak = torch.argmax(gated, dim=-1)
    sentinel = torch.full((B, rw), -1e9, device=dev)
    k1 = (Fn.pad(img, (rw, rw)).contiguous(),
          torch.cat([sentinel, r, sentinel], dim=-1).contiguous(), peak, 2 * rw + 1)
    scan = pp.PolarScan(img, torch.from_numpy(az).to(dev).expand(B, -1), r,
                        torch.ones(img.shape[:2], dtype=torch.bool, device=dev))
    filt = pp.filter_scan(scan, pc, torch.zeros(3, device=dev))
    ids, num = pp.cluster_ids(filt.points, filt.mask, pc)
    values = C._moment_channels(filt.points, filt.mask).contiguous()
    return k1, (values, ids, num, cfg.capacity.max_scan_cells)


def check_batched_kernels(k1b, k2b, lin, chol, steps, cfg, dev):
    """Phase 11 (b): K1, K2, K3a, K3b and K4 on real batched inputs (one
    frame of the B = 8 run) against their batched plain versions, to the
    single checks' tolerances; B = 1 batched bitwise equal to the unbatched
    launch; then the LM iteration's own kernels on every iteration of that
    frame's batched solve (:func:`check_lm_step`); each kernel's time at
    this B and its bound for the batched bytes.  Returns {kernel: (ms,
    bound_ms, bound_by)}."""
    import torch

    from randt_slam_torch.ops import ndt_linearize as NL
    from randt_slam_torch.ops import segment_moments as K2
    from randt_slam_torch.ops import small_chol as K4
    from randt_slam_torch.ops import window_slice as K1

    out = {}
    # K1: exact
    img, rr, peak, win = k1b
    B, A, R = img.shape
    a = K1.row_windows_cuda(img, rr, peak, win)
    p = K1.row_windows_plain(img, rr, peak, win)
    one = K1.row_windows_cuda(img[:1], rr[:1], peak[:1], win)
    ub = K1.row_windows_cuda(img[0], rr[0], peak[0], win)
    torch.cuda.synchronize()
    if not (torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])):
        raise AssertionError("batched K1: kernel differs from the plain version")
    if not (torch.equal(one[0][0], ub[0]) and torch.equal(one[1][0], ub[1])):
        raise AssertionError("K1: B = 1 batched differs from the unbatched launch")
    nbytes = B * (A * win * 4 + R * 4 + A * 8 + 2 * A * win * 4)
    out["row_windows"] = (device_ms(lambda: K1.row_windows_cuda(img, rr, peak, win)),
                          *bound_ms(nbytes, 0))
    # K2: top-k equal to the CPU path's, moments within 1e-5 of their scale
    values, ids, num, k = k2b
    o, topi = K2.segment_topk_moments(values, ids, num, k)
    plain = K2.topi_moments_plain(values, ids, topi, num)
    scale = K2.topi_moments_plain(values.abs(), ids, topi, num)
    _, topi_cpu = K2.segment_topk_moments(values.cpu(), ids.cpu(), num, k)
    ok = (ids >= 0) & (ids < num)
    ids32, topi32 = torch.where(ok, ids, -1).to(torch.int32), topi.to(torch.int32)
    one = K2.topi_moments_cuda(values[:1], ids32[:1], topi32[:1])
    ub = K2.topi_moments_cuda(values[0], ids32[0], topi32[0])
    torch.cuda.synchronize()
    if not torch.equal(topi.cpu(), topi_cpu):
        raise AssertionError("batched K2: top-k segments differ from the CPU path's")
    if not bool(((o - plain).abs() <= 1e-5 * scale).all()):
        raise AssertionError("batched K2: moments differ from plain beyond 1e-5 of their scale")
    if not torch.equal(one[0], ub):
        raise AssertionError("K2: B = 1 batched differs from the unbatched launch")
    P, CH = values.shape[-2:]
    kept = int(sum(int(torch.isin(ids[b], topi[b]).sum()) for b in range(B)))
    nbytes = B * (P * 4 + k * 4 + k * CH * 4) + kept * CH * 4
    out["segment_topk_moments"] = (
        device_ms(lambda: K2.topi_moments_cuda(values, ids32, topi32)),
        *bound_ms(nbytes, kept * CH))
    # K3a/K3b: within K3_REL of each sum's scale, r2max within 1e-5
    sc, al = cfg.matcher.loss_function_scale, cfg.matcher.loss_function_convexity
    poses, mu, ns, packed = lin[-1]
    pose4 = NL.pose_inputs(poses)
    H, g, rho = NL.linearize_cuda(pose4, mu, ns, packed, sc, al)
    Hp, gp, rhop = NL.linearize_plain(pose4, mu, ns, packed, sc, al)
    Hs, gs, rhos = NL.sums_to_blocks(
        NL.linearize_terms(pose4, mu, ns, packed, sc, al).abs().sum(-1))
    c, m = NL.robust_cost_cuda(pose4, mu, packed, sc, al)
    cp, mp = NL.robust_cost_plain(pose4, mu, packed, sc, al)
    cs = NL.robust_cost_terms(pose4, mu, packed, sc, al)[0].abs().sum(-1)
    first = tuple(x[:1] for x in packed)
    one_a = NL.linearize_cuda(pose4[:1], mu[:1], ns[:1], first, sc, al)
    ub_a = NL.linearize_cuda(pose4[0], mu[0], ns[0], tuple(x[0] for x in packed), sc, al)
    one_b = NL.robust_cost_cuda(pose4[:1], mu[:1], first, sc, al)
    ub_b = NL.robust_cost_cuda(pose4[0], mu[0], tuple(x[0] for x in packed), sc, al)
    torch.cuda.synchronize()
    worst = max(float(((x - y).abs() / s.clamp(min=1e-30)).max())
                for x, y, s in ((H, Hp, Hs), (g, gp, gs), (rho, rhop, rhos), (c, cp, cs)))
    if not worst <= K3_REL:
        raise AssertionError(f"batched K3a/K3b differ from plain by {worst:.2e} of "
                             f"their scale (limit {K3_REL})")
    if not bool(((m - mp).abs() <= 1e-5 * mp).all()):
        raise AssertionError("batched K3b: r2max differs from plain beyond 1e-5 of itself")
    if not (all(torch.equal(x[0], y) for x, y in zip(one_a, ub_a))
            and all(torch.equal(x[0], y) for x, y in zip(one_b, ub_b))):
        raise AssertionError("K3a/K3b: B = 1 batched differs from the unbatched launch")
    Bm, W, N = packed[0].shape[0], packed[0].shape[1], packed[0].shape[-1]
    n_valid = int((packed[4] > 0).sum())
    nbytes_in = Bm * W * N * 4 + n_valid * 18 * 4 + Bm * W * 4 * 4
    out["ndt_linearize"] = (device_ms(lambda: NL.linearize_cuda(pose4, mu, ns, packed, sc, al)),
                            *bound_ms(nbytes_in + Bm * 2 * 4 + Bm * W * 13 * 4,
                                      n_valid * K3A_FLOPS_PER_PAIR))
    out["ndt_robust_cost"] = (device_ms(lambda: NL.robust_cost_cuda(pose4, mu, packed, sc, al)),
                              *bound_ms(nbytes_in + Bm * 4 + Bm * W * 2 * 4,
                                        n_valid * K3B_FLOPS_PER_PAIR))
    # K4: the systems of one LM iteration of all members, within the float32
    # Cholesky forward-error bound of a float64 solve and of plain
    A, b = chol[-1]
    Pn = A.shape[-1]
    x = K4.chol_solve_cuda(A, b)
    xp = K4.chol_solve_plain(A, b)
    x64 = torch.linalg.solve(A.double(), b.double())
    kappa = torch.linalg.cond(A.double())
    one = K4.chol_solve_cuda(A[:1].contiguous(), b[:1].contiguous())
    ub = K4.chol_solve_cuda(A[0].contiguous(), b[0].contiguous())
    torch.cuda.synchronize()
    bound = 4 * Pn * float(np.finfo(np.float32).eps) * kappa * x64.abs().amax(-1)
    if not bool((((x.double() - x64).abs().amax(-1) <= bound)
                 & ((x - xp).double().abs().amax(-1) <= bound)).all()):
        raise AssertionError("batched K4: off the float32 Cholesky bound")
    if not torch.equal(one[0], ub):
        raise AssertionError("K4: B = 1 batched differs from the unbatched launch")
    nbytes = Bm * (Pn * (Pn + 1) // 2 + 2 * Pn) * 4
    out["chol_solve"] = (device_ms(lambda: K4.chol_solve_cuda(A, b)),
                         *bound_ms(nbytes, Bm * (2 * Pn ** 3 // 3 + 2 * Pn * Pn)))
    print(f"batched kernels on one frame of the B = {Bm} run: K1 bitwise equal to "
          f"plain, K2 top-k equal to the CPU path's and moments within 1e-5 of "
          f"their scale, K3a/K3b within {worst:.2e} of plain's scale (limit "
          f"{K3_REL}) and r2max within 1e-5, K4 within the float32 Cholesky "
          f"bound of a float64 solve and of plain ({Bm} systems, P={Pn}); B = 1 "
          f"bitwise equal to the unbatched launch for all five; {n_valid} of "
          f"{Bm * W * N} pairs valid, {kept} points in the kept segments", flush=True)
    for name, (ms, bd, by) in out.items():
        print(f"  {name} at B = {Bm}: kernel {ms * 1e3:.2f} us, bound {bd * 1e3:.4f} us "
              f"({by})", flush=True)
    for name, r in check_lm_step(steps, f"one frame of the B = {Bm} run").items():
        out[name] = (r["ms"], r["bound_ms"], r["bound_by"])
    return out


def batch_drives(drive0):
    """Phase 11's drives: ``drive0`` (phase 4's: scans, az, ranges, stamps,
    gt) and ``render_frames`` seeds 1.. up to the largest batch, each
    N_BATCH frames, as (scans, stamps, gt)."""
    scans0, _, _, stamps0, gt0 = drive0
    drives = [(scans0[:N_BATCH], stamps0[:N_BATCH], gt0[:N_BATCH])]
    for i in range(1, max(BATCH_SIZES)):
        sc, _, _, st, gt = render_frames(N_BATCH, seed=i)
        drives.append((sc, st, gt))
    return drives


def batch_phase(cfg_on, cfg_off, drive0, dev, smi):
    """Phase 11: batched odometry, B distinct drives per card through
    ``parallel/batch.make_batched_scan``; ``drive0`` is phase 4's drive
    (scans, az, ranges, stamps, gt).  Returns the kernels' times and bounds
    at the largest B (:func:`check_batched_kernels`), the drives and the
    switches-on runs by B (outputs, fleet frames/s), which phase 12 is held
    to."""
    import torch

    from randt_slam_torch.io import formats
    from randt_slam_torch.parallel import batch
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam

    _, az, ranges, _, _ = drive0
    b_max = max(BATCH_SIZES)
    t0 = time.perf_counter()
    drives = batch_drives(drive0)
    frames = [slam.frames_from_arrays(sc, az, ranges, st, device=dev)
              for sc, st, _ in drives]
    print(f"phase 11, batched odometry ({smi}): {b_max} drives of {N_BATCH} frames "
          f"rendered and uploaded in {time.perf_counter() - t0:.1f} s; device memory "
          f"resident before: {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB",
          flush=True)

    def stack(B, n):
        return F.Frame(*(torch.stack([fr[k][:n] for fr in frames[:B]])
                         for k in range(len(F.Frame._fields))))

    # single-sequence runs of every member's first frames, per switch setting
    t0 = time.perf_counter()
    singles = {
        "on": [slam.run_odometry(cfg_on, F.Frame(*(x[:N_BATCH_CHECK] for x in fr)),
                                 device=dev) for fr in frames],
        "off": [slam.run_odometry(cfg_off, F.Frame(*(x[:N_BATCH_CHECK] for x in fr)),
                                  device=dev) for fr in frames[:BATCH_OFF_B]],
    }
    print(f"single-sequence runs of {N_BATCH_CHECK} frames ({b_max} switches on, "
          f"{BATCH_OFF_B} off): {time.perf_counter() - t0:.1f} s", flush=True)
    tables = ("node_id", "node_frame", "node_submap", "node_is_root",
              "edge_begin", "edge_end")

    def hold(label, outs, B, n):
        """(c) every member against its single run, (d) its ATE."""
        gaps, first_bits, ates = [], [], []
        for b in range(B):
            single = singles[label][b]
            mine = member_outputs(outs, b, N_BATCH_CHECK)
            tab = slam._unstack_outputs(mine)
            for k in tables:
                if not np.array_equal(tab[k], getattr(single, k)):
                    raise AssertionError(f"batch B={B} switches {label}: member {b}'s "
                                         f"{k} table differs from its single run")
            d = np.abs(mine.odom_pose - single.odom_poses)
            gt = drives[b][2]
            ate_gap = abs(formats.ate(mine.odom_pose, gt[:N_BATCH_CHECK])
                          - formats.ate(single.odom_poses, gt[:N_BATCH_CHECK]))
            if not (ate_gap < BATCH_BANDS[0] and d[:, 2].max() <= BATCH_BANDS[1]
                    and d[:, :2].max() <= BATCH_BANDS[2]):
                raise AssertionError(f"batch B={B} switches {label}: member {b} off its "
                                     f"single run: ATE gap {ate_gap:.2e} m, "
                                     f"{d[:, 2].max():.2e} rad, {d[:, :2].max():.2e} m")
            differ = np.flatnonzero((mine.odom_pose != single.odom_poses).any(axis=1))
            first_bits.append(int(differ[0]) if len(differ) else None)
            gaps.append(float(d[:, :2].max()))
            pose = outs.odom_pose[b, :n]
            if not (np.all(np.isfinite(pose)) and pose.shape == (n, 3)):
                raise AssertionError(f"batch B={B}: member {b}'s poses are not finite")
            ates.append(formats.ate(pose, gt[:n]))
            if not ates[-1] < ATE_BAND_M:
                raise AssertionError(f"batch B={B} switches {label}: member {b}'s ATE "
                                     f"{ates[-1]:.3f} m outside the band")
        return gaps, first_bits, ates

    def one(label, cfg, B, n, steady_from, capture):
        ctx = spying_solves(CAPTURE_FRAME) if capture else contextlib.nullcontext(
            (None, None, None, None))
        with ctx as (now, lin, chol, steps):
            outs, launches, solves, ms, fps, peak = batch_run(
                cfg, stack(B, n), steady_from, dev,
                on_frame=(lambda t, c: now.__setitem__(0, t)) if capture else None)
        want = expected_launches(cfg, n, solves)
        if launches != want:
            raise AssertionError(f"batch B={B} switches {label}: launches {launches} over "
                                 f"{n} batched frames and {solves} window solves, "
                                 f"expected one sequence's {want}")
        gaps, first_bits, ates = hold(label, outs, B, n)
        sub = stack(B, 2)
        _, wall, rows, total, _ = profile_window(
            lambda: batch.make_batched_scan(cfg, np.zeros(3), device=dev)(
                batch.init_batched_carry(cfg, B, device=dev), sub))
        m = cfg.matcher
        n_launch = sum(r[1] for r in rows)
        print(f"batch B={B}, switches {label}, {n} frames: steady (frames {steady_from}.."
              f"{n - 1}, timed inside the run) {ms:.1f} ms per batched frame = "
              f"{fps:.3f} fleet frames/s ({fps / B:.3f} per sequence); device busy "
              f"{100 * total / 1e6 / wall:.1f}% of a profiled 2-frame window "
              f"({wall * 1e3:.1f} ms wall), {n_launch / (m.gnc_steps * m.lm_max_iterations):.1f} "
              f"device launches per LM iteration; peak device memory "
              f"{peak / 2**30:.3f} GiB; launches {launches} = one sequence's "
              f"({solves} window solves); members against their single runs "
              f"(first {N_BATCH_CHECK} frames): tables identical, positions within "
              f"{max(gaps):.2e} m, first frame with other bits per member "
              f"{first_bits}; ATE per member {[round(a, 4) for a in ates]} m (band < "
              f"{ATE_BAND_M} m)", flush=True)
        return (lin, chol, steps), dict(ms=ms, fps=fps, peak=peak, outs=outs)

    record = {}
    for B in BATCH_SIZES:
        captured, record[("on", B)] = one("on", cfg_on, B, N_BATCH, N_SHORT, B == b_max)
    _, record[("off", BATCH_OFF_B)] = one("off", cfg_off, BATCH_OFF_B, N_BATCH_OFF,
                                          BATCH_OFF_STEADY, False)
    mid = N_BATCH // 2
    k1b, k2b = batch_kernel_inputs(cfg_on, np.stack([d[0][mid] for d in drives]),
                                   az, ranges, dev)
    kernels = check_batched_kernels(k1b, k2b, *captured, cfg_on, dev)
    base = record[("on", 1)]["fps"]
    print("batch curve, switches on (fleet frames/s, and against B = 1 in this call): "
          + "; ".join(f"B={B} {record[('on', B)]['fps']:.3f} "
                      f"({record[('on', B)]['fps'] / base:.2f}x)" for B in BATCH_SIZES),
          flush=True)
    return kernels, drives, {B: record[("on", B)] for B in BATCH_SIZES}


def flat_outputs(outs) -> dict:
    """A (B, T, ...) FrameOutput of numpy arrays as a flat dict of arrays."""
    out = {}
    for k, v in outs._asdict().items():
        if isinstance(v, tuple):
            out.update({f"{k}.{kk}": vv for kk, vv in v._asdict().items()})
        elif v is not None:
            out[k] = np.asarray(v)
    return out


def unflat_outputs(d):
    """The inverse of :func:`flat_outputs`."""
    from randt_slam_torch.pipeline import frontend as F

    def rec(cls, name):
        return cls(**{k: d[f"{name}.{k}"] for k in cls._fields})
    rest = {k: d.get(k) for k in F.FrameOutput._fields if k not in ("nodes", "edges")}
    return F.FrameOutput(nodes=rec(F.NodeRecord, "nodes"), edges=rec(F.EdgeRecord, "edges"),
                         **rest)


def md_rank(tmp, backend, world, spawned) -> int:
    """One rank of a phase-12 world, run as ``chip_smoke.py --md-rank TMP
    BACKEND W SPAWNED`` with ``RANDT_*`` set: (a) the sharded batch of the
    drives in ``TMP/inputs.npz``, (b) the sharded Schur solve of
    ``bench.py``'s graph at ``max_iterations=10``, (c) the edge-sharded
    dense solve of phase 7's pose graph (and of rank 0 alone), (d) the
    seconds from the spawn to this process's start, of its
    imports, of its ``init_distributed`` and of its first collective.  Writes
    ``TMP/<backend><W>_rank<r>.{json,npz}``; any failed check raises."""
    import hashlib
    import os

    t_start = time.time()
    import torch
    import torch.distributed as dist

    from randt_slam_torch import runtime
    from randt_slam_torch.config import GlobalFuserConfig, oxford_config
    from randt_slam_torch.graph import pose_graph as PG
    from randt_slam_torch.graph import schur
    from randt_slam_torch.parallel import mesh
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam

    t0 = time.time()
    import_s = t0 - t_start
    if not mesh.init_distributed(backend=backend):
        # one rank: init_distributed is a no-op there, as in the JAX package;
        # join a group of one all the same, so the backend's init and its
        # collectives run
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method="tcp://" + os.environ["RANDT_COORDINATOR"],
                                world_size=1, rank=0)
    init_s = time.time() - t0
    dev = runtime.resolve_device(None)
    group = mesh.data_group()
    rank = dist.get_rank()
    t0 = time.time()
    mesh.all_reduce_sum(torch.ones(1, device=dev), group)
    torch.cuda.synchronize()
    res = dict(rank=rank, device=str(dev), spawn_s=t_start - spawned, import_s=import_s,
               init_s=init_s, first_s=time.time() - t0)
    data = np.load(os.path.join(tmp, "inputs.npz"))
    arrays = {}

    # (a) the sharded batch, the ranks started together
    scans, stamps = data["scans"], data["stamps"]
    members = [slam.frames_from_arrays(scans[b], data["az"], data["ranges"], stamps[b],
                                       device="cpu") for b in range(len(scans))]
    frames = F.Frame(*(torch.stack(x) for x in zip(*members)))
    del members, scans
    cfg_on = oxford_config(**SWITCHES_ON)
    mesh.all_reduce_sum(torch.ones(1, device=dev), group)
    outs, launches, solves, ms, fps, peak = batch_run(cfg_on, frames, N_SHORT, dev,
                                                      group=group)
    want = expected_launches(cfg_on, N_BATCH, solves)
    if launches != want:
        raise AssertionError(f"rank {rank}: launches {launches} over {N_BATCH} batched "
                             f"frames and {solves} window solves, expected one "
                             f"sequence's {want}")
    flat = flat_outputs(outs)
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(flat[k]).tobytes()
                                     for k in sorted(flat))).hexdigest()
    res.update(batch_ms=ms, batch_fps=fps, peak=peak, launches=launches, solves=solves,
               members=int(mesh.shard_range(len(stamps), group)[1]
                           - mesh.shard_range(len(stamps), group)[0]),
               outs_sha256=digest)
    if rank == 0:
        arrays.update({f"outs.{k}": v for k, v in flat.items()})

    # (b) the submap-sharded Schur route, bench.py's graph, max_iterations=10
    poses, eb, ee, trans, sqrt_i, node_submap, node_is_root, _ = bench_graph(SCHUR_NODES)

    def put(x):
        return torch.from_numpy(x).to(dev)

    g = PG.PoseGraph(put(poses), put(eb), put(ee), put(trans), put(sqrt_i),
                     torch.ones(len(eb), dtype=torch.bool, device=dev))
    cfg10 = GlobalFuserConfig(max_iterations=10)

    def schur10(grp=group):
        with counting_schur_iterations() as its:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, info = schur.optimize_auto(g, cfg10, node_submap=node_submap,
                                          node_is_root=node_is_root, group=grp)
            p = p.cpu().numpy()
            wall = time.perf_counter() - t0
        if info["solver"] != "schur" or not info.get("two_stage"):
            raise AssertionError(f"rank {rank}: {SCHUR_NODES} nodes took {info}")
        return p, its[0], wall

    schur10()
    arrays["schur10"], res["schur_iterations"], res["schur_s"] = schur10()
    # the same solve unsharded in this process, for what the collectives cost
    schur10(None)
    res["schur_alone_s"] = schur10(None)[2]

    # (c) the edge-sharded dense route on phase 7's pose graph
    graph = PG.PoseGraph(*(put(data[f"graph.{k}"]) for k in PG.PoseGraph._fields))
    cfg = oxford_config().global_fuser
    schur.optimize_distributed(graph, cfg, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, info = schur.optimize_distributed(graph, cfg, group)
    arrays["dense"] = p.cpu().numpy()
    res.update(dense_s=time.perf_counter() - t0, dense_iterations=info["iterations"])
    alone = mesh.data_group(1)
    if rank == 0:
        p, info = schur.optimize_distributed(graph, cfg, alone)
        arrays["dense_one_rank"] = p.cpu().numpy()
        res["dense_one_rank_iterations"] = info["iterations"]

    label = f"{backend}{world}_rank{rank}"
    np.savez(os.path.join(tmp, label + ".npz"), **arrays)
    with open(os.path.join(tmp, label + ".json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def md_world(tmp, backend, world):
    """Spawn a world of ``world`` ranks (:func:`md_rank`), each on card
    ``rank % device_count``; wait for all, failing as soon as one fails.
    Returns each rank's (json, arrays) and the world's wall seconds."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spawned = time.time()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANDT_COORDINATOR=f"127.0.0.1:{port}",
                   RANDT_NUM_PROCESSES=str(world), RANDT_PROCESS_ID=str(rank))
        logs.append(os.path.join(tmp, f"{backend}{world}_rank{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--md-rank", tmp, backend,
                 str(world), repr(spawned)], env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.time() - spawned > MD_TIMEOUT:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - spawned
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            with open(logs[r]) as f:
                print(f"phase 12: {backend} rank {r} of {world} exited {procs[r].returncode}:\n"
                      + f.read()[-4000:], flush=True)
        raise AssertionError(f"phase 12: ranks {bad} of the {backend} world of {world} failed")
    out = []
    for r in range(world):
        label = os.path.join(tmp, f"{backend}{world}_rank{r}")
        with open(label + ".json") as f:
            out.append((json.load(f), dict(np.load(label + ".npz"))))
    return out, wall


def md_phase(refs, dev, smi):
    """Phase 12: multi-device.  The sharded batch of phase 11's 8 drives,
    the sharded Schur route at phase 9's cap of 10 iterations and the
    edge-sharded dense route on phase 7's pose graph, in a world of one rank
    per card under NCCL and, with one card, in a 2-rank gloo world whose
    ranks share it (collectives staged through the host).  ``refs``: the
    drives (scans, stamps, gt), az, ranges, phase 11's switches-on runs by
    B, phase 9's ``max_iterations=10`` figures and phase 7's pose graph (numpy
    fields).  Returns the kernels' launches per world and rank."""
    import os
    import shutil
    import tempfile

    import torch

    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.graph import pose_graph as PG
    from randt_slam_torch.graph import schur
    from randt_slam_torch.io import formats
    from randt_slam_torch.pipeline import slam

    n_dev = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        drives = refs["drives"]
        np.savez(os.path.join(tmp, "inputs.npz"), scans=np.stack([d[0] for d in drives]),
                 stamps=np.stack([d[1] for d in drives]), az=refs["az"],
                 ranges=refs["ranges"],
                 **{f"graph.{k}": v for k, v in refs["graph"].items()})
        graph = PG.PoseGraph(*(torch.from_numpy(refs["graph"][k]).to(dev)
                               for k in PG.PoseGraph._fields))
        gf = oxford_config().global_fuser
        dense_ref = PG.optimize(graph, gf)[0].cpu().numpy()
        N = graph.poses.shape[0]
        _, eb, ee, _, _, node_submap, node_is_root, gt_bench = bench_graph(SCHUR_NODES)
        worlds = [("nccl", n_dev)] + ([("gloo", 2)] if n_dev == 1 else [])
        b_max = max(BATCH_SIZES)
        ref8, ref4 = refs["batch"][b_max], refs["batch"][4]
        s10 = refs["schur10"]
        tables = ("node_id", "node_frame", "node_submap", "node_is_root",
                  "edge_begin", "edge_end")
        launches = {}
        for backend, W in worlds:
            ranks, wall = md_world(tmp, backend, W)
            label = f"{backend}{W}"
            js = [j for j, _ in ranks]
            print(f"phase 12, {label}: {W} rank(s) on {n_dev} card(s) "
                  f"({'; '.join(sorted(set(smi.splitlines())))}), the world "
                  f"{wall:.1f} s from spawn to exit; per rank: spawn to start "
                  f"{[round(j['spawn_s'], 2) for j in js]} s, torch and the port imported "
                  f"{[round(j['import_s'], 2) for j in js]} s, init_distributed "
                  f"{[round(j['init_s'], 2) for j in js]} s, first collective "
                  f"{[round(j['first_s'], 3) for j in js]} s", flush=True)
            # (a) the sharded batch
            if len({j["outs_sha256"] for j in js}) != 1:
                raise AssertionError(f"phase 12 {label}: the ranks' gathered outputs differ")
            outs = unflat_outputs({k[5:]: v for k, v in ranks[0][1].items()
                                   if k.startswith("outs.")})
            gaps, first_bits = [], []
            for b in range(b_max):
                mine, want = member_outputs(outs, b, N_BATCH), member_outputs(ref8["outs"], b,
                                                                                N_BATCH)
                t_tab, w_tab = slam._unstack_outputs(mine), slam._unstack_outputs(want)
                for k in tables:
                    if not np.array_equal(t_tab[k], w_tab[k]):
                        raise AssertionError(f"phase 12 {label}: member {b}'s {k} table "
                                             f"differs from phase 11's B = {b_max} run")
                d = np.abs(mine.odom_pose - want.odom_pose)
                gt = drives[b][2]
                ate_gap = abs(formats.ate(mine.odom_pose, gt) - formats.ate(want.odom_pose, gt))
                if not (ate_gap < BATCH_BANDS[0] and d[:, 2].max() <= BATCH_BANDS[1]
                        and d[:, :2].max() <= BATCH_BANDS[2]):
                    raise AssertionError(f"phase 12 {label}: member {b} off phase 11's run: "
                                         f"ATE gap {ate_gap:.2e} m, {d[:, 2].max():.2e} rad, "
                                         f"{d[:, :2].max():.2e} m")
                differ = np.flatnonzero((mine.odom_pose != want.odom_pose).any(axis=1))
                first_bits.append(int(differ[0]) if len(differ) else None)
                gaps.append(float(d[:, :2].max()))
            rank0 = "not checked (rank 0 holds other members than phase 11's B = 4 run)"
            if js[0]["members"] == 4:
                same = all(np.array_equal(a, b) for a, b in zip(
                    flat_outputs(member_outputs(outs, slice(0, 4), N_BATCH)).values(),
                    flat_outputs(ref4["outs"]).values()))
                if not same:
                    raise AssertionError(f"phase 12 {label}: rank 0's drives 0-3 differ from "
                                         f"phase 11's B = 4 run")
                rank0 = "bitwise phase 11's B = 4 run"
            fleet = min(j["batch_fps"] for j in js)
            print(f"  (a) sharded batch, {b_max} drives x {N_BATCH} frames, "
                  f"{js[0]['members']} per rank: {fleet:.3f} fleet frames/s (frames "
                  f"{N_SHORT}-{N_BATCH - 1}, B x frames over the slowest rank's wall) beside "
                  f"phase 11's one process at B = {b_max}: {ref8['fps']:.3f} in this call "
                  f"({fleet / ref8['fps']:.2f}x); ms per batched frame per rank "
                  f"{[round(j['batch_ms'], 1) for j in js]}; peak device memory per rank "
                  f"{[round(j['peak'] / 2**30, 3) for j in js]} GiB; launches per rank "
                  f"{[{k: v for k, v in j['launches'].items() if v} for j in js]} = one "
                  f"sequence's each ({js[0]['solves']} window solves); members' tables "
                  f"identical to phase 11's B = {b_max} run, positions within "
                  f"{max(gaps):.2e} m, first frame with other bits per member {first_bits}; "
                  f"rank 0: {rank0}", flush=True)
            # (b) the sharded Schur route
            lay = schur.build_layout(node_submap, node_is_root, eb, ee, pad_submaps_to=W)
            S, I = lay.int_node.shape
            L = lay.sep_ids.shape[1]
            gathered = S * (9 * L * L + 3 * L) * 4
            for j, (_, a) in zip(js, ranks):
                if j["schur_iterations"] != s10["iterations"]:
                    raise AssertionError(f"phase 12 {label}: the sharded Schur solve took "
                                         f"{j['schur_iterations']} iterations, phase 9's "
                                         f"{s10['iterations']}")
                if not np.array_equal(a["schur10"], ranks[0][1]["schur10"]):
                    raise AssertionError(f"phase 12 {label}: the ranks' Schur poses differ")
            # the gap is reported, not bounded: at the cap the solve is far from
            # its optimum, where other bits in a rank's slice (CUDA's scatter and
            # batched products depend on the batch size) move the poses by far
            # more than they do near it (PERF.md section 6)
            p10 = ranks[0][1]["schur10"]
            if not np.all(np.isfinite(p10)):
                raise AssertionError(f"phase 12 {label}: the sharded Schur poses are not finite")
            gap = ("bitwise" if np.array_equal(p10, s10["poses"])
                   else "{:.3e} m / {:.3e} rad".format(*se2_gap(p10, s10["poses"])))
            its = js[0]["schur_iterations"]
            print(f"  (b) sharded Schur route, bench.py's {SCHUR_NODES} nodes at "
                  f"max_iterations=10 (both DCS stages): {its} iterations as phase 9's; "
                  f"poses against phase 9's single-process solve: {gap} (from the ground "
                  f"truth {se2_gap(p10, gt_bench)[0]:.4g} m, phase 9's "
                  f"{se2_gap(s10['poses'], gt_bench)[0]:.4g} m); "
                  f"{max(j['schur_s'] for j in js) * 1e3 / its:.2f} ms per iteration (phase 9: "
                  f"{s10['ms'] / s10['iterations']:.2f}; unsharded in each rank's process "
                  f"{[round(j['schur_alone_s'] * 1e3 / its, 2) for j in js]}); {S} submaps ({S - lay.n_submaps} "
                  f"padded), L = {L}, I = {I}: all-gathered per iteration S(9L^2 + 3L) x 4 = "
                  f"{gathered} B of blocks and S x 3I x 4 = {S * 3 * I * 4} B of interior "
                  f"steps", flush=True)
            # (c) the edge-sharded dense route
            pd = ranks[0][1]["dense"]
            one = ranks[0][1]["dense_one_rank"]
            for j, (_, a) in zip(js, ranks):
                if not np.array_equal(a["dense"], pd):
                    raise AssertionError(f"phase 12 {label}: the ranks' dense poses differ")
            g_ref, g_one = se2_gap(pd, dense_ref), se2_gap(pd, one)
            if not (g_ref[0] <= MD_DENSE_BAND and g_one[0] <= MD_ONE_RANK_BAND):
                raise AssertionError(f"phase 12 {label}: optimize_distributed {g_ref[0]:.2e} m "
                                     f"from pose_graph.optimize (band {MD_DENSE_BAND}), "
                                     f"{g_one[0]:.2e} m from one rank (band "
                                     f"{MD_ONE_RANK_BAND})")
            its = js[0]["dense_iterations"]
            print(f"  (c) edge-sharded dense route, phase 7's pose graph ({N} nodes, "
                  f"{len(refs['graph']['id_begin'])} edges): {its} iterations (one rank "
                  f"{js[0]['dense_one_rank_iterations']}); {g_ref[0]:.2e} m / {g_ref[1]:.2e} "
                  f"rad from pose_graph.optimize on the card (band {MD_DENSE_BAND} m), "
                  f"{g_one[0]:.2e} m / {g_one[1]:.2e} rad from one rank (band "
                  f"{MD_ONE_RANK_BAND} m); {max(j['dense_s'] for j in js) * 1e3 / its:.2f} ms "
                  f"per iteration; all-reduced per iteration (9N^2 + 3N) x 4 = "
                  f"{(9 * N * N + 3 * N) * 4} B, and 2 x {4 * W} B of gathered costs",
                  flush=True)
            launches[label] = [j["launches"] for j in js]
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def se2_relative(a, b):
    """The pose of b in a's frame (numpy (3,) poses)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy,
                     np.angle(np.exp(1j * (b[2] - a[2])))])


def indoor_kernels(drive, dev):
    """Phase 3 at the indoor shapes: K1 and K2 on frame CAPTURE_FRAME of
    phase 13's drive, and K3a/K3b/K4 on the captured inputs of that frame's
    window solve at ``indoor_config()`` with the IMU on (the first
    CAPTURE_FRAME + 1 frames on the switches-on path; the bias column free
    at the reference's weight).  Returns the kernels' records."""
    import torch

    from randt_slam_torch.config import indoor_config
    from randt_slam_torch.ops import ndt_linearize as NL
    from randt_slam_torch.pipeline import slam
    from randt_slam_torch.registration import residuals as R

    scans, az, ranges, stamps, imu, _ = drive
    cfg = indoor_config(**SWITCHES_ON)
    if not (cfg.use_imu and cfg.matcher.use_imu):
        raise AssertionError("indoor_config() does not turn the IMU on")
    n = CAPTURE_FRAME + 1
    print(f"the kernels at phase 13's indoor shapes: frame {CAPTURE_FRAME} of its drive "
          f"({scans.shape[1]} x {scans.shape[2]} bins of {IN_BIN_W * 100:.0f} cm, "
          f"{cfg.capacity.max_scan_cells} scan cells), and its window solve with the "
          f"IMU on (weight_imu_bias {cfg.matcher.weight_imu_bias})", flush=True)
    k1_in, k2_in, _ = frame_inputs(cfg, scans[CAPTURE_FRAME], az, ranges, dev)
    out = dict(row_windows=check_k1([k1_in], dev, None),
               segment_topk_moments=check_k2([k2_in], dev, None))
    frames = slam.frames_from_arrays(scans[:n], az, ranges, stamps[:n],
                                     imu_yaw=imu[:n], device=dev)
    _, lin, chol, steps = capture_solve_inputs(cfg, frames, dev, CAPTURE_FRAME)
    k3_sets = [(NL.pose_inputs(poses), mu, ns, packed)
               for poses, mu, ns, packed in (lin[0], lin[-1])]
    out["ndt_linearize"], out["ndt_robust_cost"] = check_k3(k3_sets, cfg, dev, None)
    # a free bias column couples to its neighbours' (the walk); a frozen
    # one is an identity row
    A = torch.stack([a for a, _ in chol])
    free_bias = [c for c in range(R.BIAS, A.shape[-1], 9)
                 if float(A[0, c].abs().sum()) > 1.0]
    if not free_bias:
        raise AssertionError("indoor: no bias column free in the captured systems")
    print(f"K4's indoor systems have the bias free in columns {free_bias}", flush=True)
    out["chol_solve"] = check_k4(chol, dev, None)
    out.update(check_lm_step(steps, "indoor, the IMU on"))
    return out


def indoor_phase(drive, dev, smi):
    """Phase 13: the IMU-aided path at ``indoor_config()`` on the indoor
    drive ``drive`` (:func:`render_indoor`'s): (b) full SLAM from host
    memory in chunks; (c) its first frames against the gyro readings
    zeroed, and against the CPU; (d) ``OnlineSlam`` with a checkpoint and
    a bitwise resume.  Returns (the full-SLAM run's launches, the walls by
    part and its readings)."""
    import os
    import tempfile

    import torch

    from randt_slam_torch.config import indoor_config
    from randt_slam_torch.io import formats
    from randt_slam_torch.ops import build
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam
    from randt_slam_torch.pipeline.online import OnlineSlam
    from randt_slam_torch.registration import residuals as R

    walls = {}
    scans, az, ranges, stamps, imu, gt = drive
    cfg = indoor_config(**SWITCHES_ON)
    cfg_bias = indoor_config(**SWITCHES_ON, **BIAS_WEIGHT)
    drive_m = np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1).sum()
    print(f"phase 13, indoor with the IMU ({smi}): {N_INDOOR} frames of "
          f"{scans.shape[1]}x{scans.shape[2]} ({IN_BIN_W * 100:.0f} cm bins to "
          f"{IN_MAX_RANGE:.0f} m), {drive_m:.1f} m at {IN_SPEED} m/s, laps of "
          f"{INDOOR_LAP} frames, seed {IN_SEED}, gyro drift {IMU_BIAS} rad/s under "
          f"{IMU_NOISE} rad; capacities {cfg.capacity.max_scan_cells} "
          f"scan cells, {cfg.capacity.max_submap_cells} submap cells, grid "
          f"{cfg.ndt_map.size_x}x{cfg.ndt_map.size_y} of {cfg.ndt_map.resolution} m, "
          f"num_exclude_recent {cfg.scan_context.num_exclude_recent}", flush=True)

    # ---- (b) full SLAM: host-resident frames in chunks ------------------------
    t0 = time.perf_counter()
    frames = slam.frames_from_arrays(scans, az, ranges, stamps, imu_yaw=imu, host=True)
    with counting_solves() as solves:
        build.reset_launches()
        torch.cuda.synchronize(dev)
        t_run = time.perf_counter()
        res = slam.run_slam(cfg_bias, frames, device=dev, chunk=IN_CHUNK)
        torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        launches = dict(build.LAUNCHES)
    odo, loops = res.odometry, res.loops
    n_cand = loops.n_sc_candidates
    want = expected_launches(cfg_bias, N_INDOOR + n_cand, solves[0])
    if launches != want:
        raise AssertionError(f"indoor SLAM launched {launches} over {N_INDOOR} frames, "
                             f"{n_cand} candidate frames and {solves[0]} window "
                             f"solves, expected {want}")
    if not (np.all(np.isfinite(odo.odom_poses)) and np.all(np.isfinite(
            res.node_pose_optimized))):
        raise AssertionError("indoor SLAM: poses are not finite")
    ate = formats.ate(odo.odom_poses, gt)
    node_gt = gt[odo.node_frame]
    ate_odo = formats.ate(odo.node_pose, node_gt)
    ate_pgo = formats.ate(res.node_pose_optimized, node_gt)
    bias = float(odo.final_carry.states[-1, R.BIAS])
    # the odometry after its first chunk (the first upload and the first
    # frames' warm-up left out)
    steady_ms = 1e3 * odo.chunk_seconds[1:].sum() / (N_INDOOR - IN_CHUNK)
    t = res.timings
    print(f"phase 13 (b): run_slam ({N_INDOOR} frames from host memory in chunks of "
          f"{IN_CHUNK}, weight_imu_bias {cfg_bias.matcher.weight_imu_bias}): "
          f"{t_end - t_run:.2f} s; steady odometry (frames {IN_CHUNK}..{N_INDOOR - 1}, "
          f"the chunks after the first) {steady_ms:.1f} ms/frame; odometry "
          f"{t['odometry_s']} s, loop closure {t['loop_closure_s']} "
          f"s, pose graph {t['pgo_s']} s ({t['pgo_solver']}); chunk seconds "
          f"{[round(float(x), 3) for x in odo.chunk_seconds]}; launches {launches} "
          f"({solves[0]} window solves, {n_cand} candidate frames)", flush=True)
    errs = []
    for b, e, tr in zip(loops.edge_begin, loops.edge_end, loops.edge_trans):
        g = se2_relative(node_gt[b], node_gt[e])
        errs.append((int(b), int(e), float(np.abs(tr[:2] - g[:2]).max()),
                     abs(float(np.angle(np.exp(1j * (tr[2] - g[2])))))))
    print(f"phase 13 (b): odometry ATE {ate:.4f} m (band < {ATE_BAND_M} m); newest "
          f"bias state {bias:.5f} rad/s against the rendered {IMU_BIAS} "
          f"({bias / IMU_BIAS:.3f} x, band {BIAS_RANGE}); {len(odo.node_id)} nodes, "
          f"{odo.n_submaps} submaps; ScanContext candidates {n_cand}, accepted loop "
          f"edges {loops.n_accepted}; node ATE odometry {ate_odo:.4f} m, after the pose "
          f"graph {ate_pgo:.4f} m ({ate_pgo / ate_odo:.3f} x, limit 1.05 x); each "
          f"edge against the rendered ground truth (begin, end, m, rad; limit "
          f"{LOOP_TRUTH_M} m): {[(b, e, round(m, 4), round(r, 4)) for b, e, m, r in errs]}",
          flush=True)
    if not ate < ATE_BAND_M:
        raise AssertionError(f"indoor: odometry ATE {ate:.3f} m outside the band")
    if not BIAS_RANGE[0] * IMU_BIAS < bias < BIAS_RANGE[1] * IMU_BIAS:
        raise AssertionError(f"indoor: the bias estimate {bias} did not converge "
                             f"toward {IMU_BIAS}")
    if loops.n_accepted < 1:
        raise AssertionError("indoor: no loop edge accepted")
    if not max(m for _, _, m, _ in errs) <= LOOP_TRUTH_M:
        raise AssertionError(f"indoor: a loop edge lies more than {LOOP_TRUTH_M} m "
                             f"off the rendered ground truth: {errs}")
    if not ate_pgo <= 1.05 * ate_odo:
        raise AssertionError(f"indoor: post-PGO ATE {ate_pgo:.4f} m above 1.05 x "
                             f"odometry {ate_odo:.4f} m")
    # the occupancy grid: counting grids bitwise the CPU's
    t_ogm = time.perf_counter()
    occ, grids = slam.render_ogm(cfg_bias, res, frames, device=dev, chunk=OGM_CHUNK)
    ogm_s = time.perf_counter() - t_ogm
    occ_c, grids_c = slam.render_ogm(cfg_bias, res, frames, device="cpu",
                                     chunk=OGM_CHUNK)
    if not (np.array_equal(grids, grids_c) and grids.max() >= 2 and grids.min() < 0
            and np.isfinite(occ).all()):
        raise AssertionError("indoor: the OGM's counting grids differ from the CPU's, "
                             "or hold no hits or free space")
    walls["slam"] = time.perf_counter() - t0
    o = cfg_bias.ogm
    print(f"phase 13 (b): render_ogm ({o.size_y}x{o.size_x} at {o.resolution} m, "
          f"{grids.shape[0]} submap grids of {grids.shape[1]}x{grids.shape[2]}) "
          f"{ogm_s:.3f} s on the card; counting grids bitwise the CPU's, occupancy "
          f"within {float(np.abs(occ - occ_c).max()):.2e}; {walls['slam']:.1f} s",
          flush=True)

    # ---- (c) the IMU reaches the residual; the card against the CPU ----------
    t0 = time.perf_counter()
    n = N_IMU_CHECK
    zeroed = slam.run_odometry(cfg_bias, slam.frames_from_arrays(
        scans[:n], az, ranges, stamps[:n], device=dev), device=dev)
    moved = float(np.abs(odo.odom_poses[:n] - zeroed.odom_poses).max())
    if not moved > 1e-6:
        raise AssertionError(f"indoor: the IMU readings move the poses by {moved:.2e}")
    cpu = slam.run_odometry(cfg_bias, slam.frames_from_arrays(
        scans[:N_IMU_CPU], az, ranges, stamps[:N_IMU_CPU], imu_yaw=imu[:N_IMU_CPU],
        device="cpu"), device="cpu")
    m = len(cpu.node_id)
    for k in ("node_id", "node_frame", "node_submap", "node_is_root"):
        if not np.array_equal(getattr(cpu, k), getattr(odo, k)[:m]):
            raise AssertionError(f"indoor: CUDA and CPU {k} tables differ")
    e = len(cpu.edge_begin)
    for k in ("edge_begin", "edge_end"):
        if not np.array_equal(getattr(cpu, k), getattr(odo, k)[:e]):
            raise AssertionError(f"indoor: CUDA and CPU {k} tables differ")
    d = np.abs(cpu.odom_poses - odo.odom_poses[:N_IMU_CPU])
    pos = d[:, :2].max()
    if not (pos <= IMU_CPU_BAND[0] and d[:, 2].max() <= IMU_CPU_BAND[1]):
        raise AssertionError(f"indoor: CUDA and CPU poses differ: {pos:.2e} m, "
                             f"{d[:, 2].max():.2e} rad")
    walls["imu_check"] = time.perf_counter() - t0
    print(f"phase 13 (c): (b)'s first {n} frames against the same frames with the gyro "
          f"readings zeroed: poses {moved:.3e} apart (> 1e-6); its first {N_IMU_CPU} "
          f"frames once on the CPU: tables identical ({m} nodes), poses within "
          f"{pos:.2e} m / {d[:, 2].max():.2e} rad of the card's (band "
          f"{IMU_CPU_BAND}); {walls['imu_check']:.1f} s", flush=True)

    # ---- (d) online, with a checkpoint and a bitwise resume ------------------------
    t0 = time.perf_counter()
    n = N_IN_ONLINE
    pinned = tuple(x[:n].pin_memory() for x in frames)

    def frame(i):
        return F.Frame(*(x[i].to(dev, non_blocking=True) for x in pinned))

    ck = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "indoor.npz")
    eng = OnlineSlam(cfg, device=dev)
    for i in range(n):
        if i == IN_ONLINE_SAVE_AT:
            eng.save_checkpoint(ck)
            saved = dict(last_imu_yaw=float(eng.carry.last_imu_yaw),
                         have_imu_prev=eng.carry.have_imu_prev)
        eng.process_frame(frame(i))
    again = OnlineSlam(cfg, device=dev)
    again.load_checkpoint(ck)
    if not (again.carry.have_imu_prev is saved["have_imu_prev"] is True
            and float(again.carry.last_imu_yaw) == saved["last_imu_yaw"]
            == float(imu[IN_ONLINE_SAVE_AT - 1])):
        raise AssertionError(f"indoor online: the checkpoint's IMU carry "
                             f"{again.carry.last_imu_yaw}, {again.carry.have_imu_prev} "
                             f"is not the saved {saved}")
    for i in range(IN_ONLINE_SAVE_AT, n):
        again.process_frame(frame(i))
    same = (np.array_equal(np.stack(again.odom_trace), np.stack(eng.odom_trace))
            and np.array_equal(again.trajectory(), eng.trajectory())
            and [e[:2] for e in again.edges] == [e[:2] for e in eng.edges]
            and all(torch.equal(getattr(again.carry, k), getattr(eng.carry, k))
                    for k in ("states", "imu_meas", "last_imu_yaw")))
    if not same:
        raise AssertionError("indoor online: the resumed run differs from the "
                             "uninterrupted one")
    if not np.all(np.isfinite(np.stack(eng.odom_trace))):
        raise AssertionError("indoor online: poses are not finite")
    walls["online"] = time.perf_counter() - t0
    print(f"phase 13 (d): OnlineSlam over {n} frames, a checkpoint after frame "
          f"{IN_ONLINE_SAVE_AT} (not a cadence multiple; last_imu_yaw "
          f"{saved['last_imu_yaw']:.5f}, have_imu_prev {saved['have_imu_prev']}), the "
          f"resumed run bitwise the uninterrupted one (odometry, trajectory, edges, "
          f"window states, IMU ring and last yaw); {len(eng.node_pose)} nodes, "
          f"{eng.n_loop_edges} loop edges; {walls['online']:.1f} s", flush=True)
    return launches, dict(walls, ate=ate, bias=bias, steady_ms=steady_ms,
                          loops=loops.n_accepted, ate_odo=ate_odo, ate_pgo=ate_pgo)


def card_and_build():
    """Phases 1 and 2: the card (None without torch, CUDA or the port) and
    every kernel built, in parallel.  Returns (torch, device, name, smi)."""
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return None
    try:
        import randt_slam_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the randt_slam_torch package is not beside this script",
              file=sys.stderr)
        return None
    from randt_slam_torch.ops import build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}), "
          f"{torch.cuda.device_count()} card(s)")
    print(smi, flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for "
          f"{sorted(built) or 'nothing (cached)'}", flush=True)
    for n, (sec, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {n}: {sec:.2f} s; {'; '.join(regs)}", flush=True)
    return torch, dev, name, smi


def print_ok(torch, name):
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def md_only(graph_path) -> int:
    """``chip_smoke.py --multi-device GRAPH``: phases 1, 2 and 12 alone, for
    a machine of several cards.  What phase 12 is held to is made here as
    the full run makes it: phase 11's drives and its one-process runs at B
    = 4 and 8, phase 9's ``max_iterations=10`` solve; phase 7's pose graph
    is read from GRAPH (written by a full run's ``--save-slam-graph``)."""
    t_start = time.perf_counter()
    card = card_and_build()
    if card is None:
        return 1
    torch, dev, name, smi = card
    from randt_slam_torch.config import GlobalFuserConfig, oxford_config
    from randt_slam_torch.graph import pose_graph as PG
    from randt_slam_torch.graph import schur
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam

    cfg_on = oxford_config(**SWITCHES_ON)
    scans, az, ranges, stamps, gt = render_frames(N_RENDER)
    drives = batch_drives((scans, az, ranges, stamps, gt))
    frames = [slam.frames_from_arrays(sc, az, ranges, st, device=dev) for sc, st, _ in drives]
    runs = {}
    for B in (4, max(BATCH_SIZES)):
        fb = F.Frame(*(torch.stack([fr[k] for fr in frames[:B]])
                       for k in range(len(F.Frame._fields))))
        outs, _, _, ms, fps, _ = batch_run(cfg_on, fb, N_SHORT, dev)
        runs[B] = dict(outs=outs, fps=fps)
        print(f"one process, B = {B}: {ms:.1f} ms per batched frame, {fps:.3f} fleet "
              f"frames/s", flush=True)
    del frames
    poses, eb, ee, trans, sqrt_i, node_submap, node_is_root, _ = bench_graph(SCHUR_NODES)

    def put(x):
        return torch.from_numpy(x).to(dev)

    g = PG.PoseGraph(put(poses), put(eb), put(ee), put(trans), put(sqrt_i),
                     torch.ones(len(eb), dtype=torch.bool, device=dev))
    for _ in range(2):  # the second call is timed, as phase 9's
        with counting_schur_iterations() as its:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p10 = schur.optimize_auto(g, GlobalFuserConfig(max_iterations=10),
                                      node_submap=node_submap,
                                      node_is_root=node_is_root)[0].cpu().numpy()
            ms10 = (time.perf_counter() - t0) * 1e3
    launches = md_phase(dict(drives=drives, az=az, ranges=ranges, batch=runs,
                             schur10=dict(poses=p10, iterations=its[0], ms=ms10),
                             graph=dict(np.load(graph_path))), dev, smi)
    print(f"chip_smoke --multi-device: passed in {time.perf_counter() - t_start:.1f} s wall",
          flush=True)
    print(json.dumps({"multi_device_launches": launches}))
    print_ok(torch, name)
    return 0


def main(save_slam_graph=None) -> int:
    """The full run (no arguments); ``save_slam_graph``: a path to write
    phase 7's pose graph to, for :func:`md_only`."""
    t_start = time.perf_counter()
    card = card_and_build()
    if card is None:
        return 1
    torch, dev, name, smi = card
    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.pipeline import slam

    # ---- 3. kernels against their plain versions ---------------------------
    cfg = oxford_config()
    cfg_on = oxford_config(**SWITCHES_ON)
    t0 = time.perf_counter()
    scans, az, ranges, stamps, gt = render_frames(N_RENDER)
    print(f"rendered {N_RENDER} frames of {scans.shape[1]}x{scans.shape[2]} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(1)
    k1_frame, k2_frame, k5_entry = frame_inputs(cfg, scans[N_RENDER // 2], az,
                                                ranges, dev)
    setup_s = time.perf_counter() - t_start
    t_phase = time.perf_counter()
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
    k1_sets.append(k1_frame)
    k2_sets.append(k2_frame)
    # what one launch costs when timed as the kernels are: an empty kernel
    floor_ms = device_ms(lambda: torch.cuda._sleep(0))
    print(f"launch floor: an empty launch (torch.cuda._sleep(0)) timed as the "
          f"kernels are, {floor_ms * 1e3:.2f} us", flush=True)
    k1 = check_k1(k1_sets, dev)
    k2 = check_k2(k2_sets, dev)
    # K5's device launches per call, taken here: a profiler window this
    # short saw no device event once the odometry paths' windows had run
    from randt_slam_torch.ops import segment_moments as K5
    k5_per_call = only_kernel("K5 segment_moments",
                              lambda: K5.segment_moments(*k2_frame[:3]),
                              "segment_sum_kernel")
    # K1 to K4 at phase 13's indoor shapes, on its drive
    t0 = time.perf_counter()
    indoor = render_indoor(seed=IN_SEED)
    print(f"rendered phase 13's indoor drive ({N_INDOOR} frames) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    in_kernels = indoor_kernels(indoor, dev)

    # ---- 3. (cont.) K3a/K3b/K4 on the inputs of one frame's LM solve -----
    frames = slam.frames_from_arrays(scans, az, ranges, stamps, device=dev)
    short = type(frames)(*(x[:N_SHORT] for x in frames))
    t0 = time.perf_counter()
    # this run is also the first of phase 5's two switches-on CUDA runs
    r_on, lin, chol, steps = capture_solve_inputs(cfg_on, short, dev, CAPTURE_FRAME)
    print(f"switches-on run of {N_SHORT} frames (cold, capturing frame "
          f"{CAPTURE_FRAME}: {len(lin)} linearizations, {len(chol)} solves): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    from randt_slam_torch.ops import ndt_linearize as NL
    W, N = lin[0][3][0].shape[0], lin[0][3][0].shape[-1]
    rng3 = np.random.default_rng(3)
    m_mean = rng3.uniform(-60, 60, (W, N, 3))
    cov = rng3.normal(0, 0.5, (2, W, N, 3, 3))
    cov = cov @ np.swapaxes(cov, -1, -2) + 0.05 * np.eye(3)
    rand = [torch.tensor(x, dtype=torch.float32, device=dev) for x in
            (m_mean, cov[0], m_mean + rng3.normal(0, 1.0, (W, N, 3)), cov[1])]
    rand_packed = NL.pack_pairs(*rand, torch.from_numpy(
        rng3.random((W, N)) < 0.7).to(dev))
    rand_pose = torch.tensor(rng3.normal(0, 0.3, (W, 3)), dtype=torch.float32,
                             device=dev)
    k3_sets = [(NL.pose_inputs(rand_pose), torch.tensor(2.0, device=dev),
                torch.tensor(0.4, device=dev), rand_packed)]
    k3_sets += [(NL.pose_inputs(poses), mu, ns, packed)
                for poses, mu, ns, packed in (lin[0], lin[-1])]
    k3a, k3b = check_k3(k3_sets, cfg_on, dev)
    k4 = check_k4(chol, dev)
    lm = check_lm_step(steps, f"frame {CAPTURE_FRAME}'s window solve")

    # ---- 4./5./6. both odometry paths ------------------------------------
    launches = {}
    for label, c, first in (("on", cfg_on, r_on), ("off", cfg, None)):
        launches[label] = run_path(label, c, frames, short, first, gt, dev,
                                   scans, az, ranges, stamps)
    odometry_s = time.perf_counter() - t_phase

    # ---- 3. (cont.) K5 and its entry point -----------------------------------
    t_phase = time.perf_counter()
    k5_sets = []
    for P, S in ((5000, 700), (26000, 3249)):
        r5 = np.random.default_rng(P)
        k5_sets.append((torch.from_numpy(r5.normal(0, 30, (P, 13)).astype(
            np.float32)).to(dev), torch.from_numpy(r5.integers(
                -1, S + 2, P).astype(np.int32)).to(dev), S))
    k5_sets.append(k2_frame[:3])
    k5, k5_launches = check_k5(k5_sets, k5_entry, cfg, dev, k5_per_call)
    k5_s = time.perf_counter() - t_phase

    # ---- 7. full SLAM --------------------------------------------------------
    t_phase = time.perf_counter()
    slam_launches, slam_res, slam_frames, slam_gt = slam_phase(cfg_on, dev)
    for n in ("row_windows", "segment_topk_moments", "ndt_linearize",
              "ndt_robust_cost", "chol_solve"):
        if slam_launches[n] == 0:
            raise AssertionError(f"full SLAM launched no {n}")
    slam_s = time.perf_counter() - t_phase

    # ---- 8. the occupancy grid of that run ------------------------------------
    t_phase = time.perf_counter()
    ogm_k1 = ogm_phase(cfg_on, slam_res, slam_frames, dev)
    ogm_s = time.perf_counter() - t_phase

    slam_graph = {k: v.numpy() for k, v in slam.build_pose_graph(
        slam_res.odometry, slam_res.loops, "cpu")._asdict().items()}
    if save_slam_graph:
        np.savez(save_slam_graph, **slam_graph)

    # ---- 9. the Schur-complement pose graph at a full sequence's size -----
    t_phase = time.perf_counter()
    sch = schur_phase(dev, smi)
    schur_s = time.perf_counter() - t_phase

    # ---- 10. online SLAM over the same drive ------------------------------------
    t_phase = time.perf_counter()
    online = online_phase(cfg_on, slam_res, slam_frames, slam_gt, dev, smi)
    del slam_res, slam_frames
    online_s = time.perf_counter() - t_phase

    # ---- 11. batched odometry: B drives per card ---------------------------
    t_phase = time.perf_counter()
    batched, drives, runs = batch_phase(cfg_on, cfg, (scans, az, ranges, stamps, gt), dev,
                                        smi)
    batch_s = time.perf_counter() - t_phase

    # ---- 12. multi-device: worlds of ranks, one process each -----------------
    t_phase = time.perf_counter()
    md = md_phase(dict(drives=drives, az=az, ranges=ranges, batch=runs,
                       schur10=dict(poses=sch["max10_poses"], iterations=sch["max10_iterations"],
                                    ms=sch["max10_ms"]), graph=slam_graph), dev, smi)
    del runs
    md_s = time.perf_counter() - t_phase

    # ---- 13. indoor with the IMU ---------------------------------------------
    t_phase = time.perf_counter()
    in_launches, in_walls = indoor_phase(indoor, dev, smi)
    indoor_s = time.perf_counter() - t_phase

    def record(n, source, replaces, launches, measured):
        extra = {}
        if n in batched:  # the kernel at the largest batch of phase 11
            ms, bd, by = batched[n]
            extra = dict(batch_b=max(BATCH_SIZES), batch_ms=ms, batch_bound_ms=bd,
                         batch_bound_by=by)
        if n in in_kernels:  # the kernel at phase 13's indoor shapes
            k = in_kernels[n]
            extra.update(indoor_ms=k["ms"], indoor_plain_ms=k["plain_ms"],
                         indoor_library_ms=k["library_ms"], indoor_bound_ms=k["bound_ms"],
                         indoor_bound_by=k["bound_by"], indoor_max_abs_err=k["max_abs_err"])
        return dict(name=n, route="cuda", source="randt_slam_torch/csrc/" + source,
                    replaces="randt_slam_tpu/" + replaces, launches=launches,
                    online_launches=online[n], indoor_launches=in_launches[n],
                    multi_device_launches={w: [rank[n] for rank in per_rank]
                                           for w, per_rank in md.items()},
                    **measured, **extra)

    rows = [
        record("row_windows", "window_slice.cu", "ops/window_slice.py:49",
               launches["off"]["row_windows"], dict(k1, ogm_launches=ogm_k1)),
        record("segment_topk_moments", "segment_moments.cu", "ops/segment_moments.py:154",
               launches["off"]["segment_topk_moments"], k2),
        record("segment_moments", "segment_sum.cu", "ops/segment_moments.py:81",
               k5_launches, k5),
        record("ndt_linearize", "ndt_linearize.cu", "ops/ndt_linearize.py:251",
               launches["on"]["ndt_linearize"], k3a),
        record("ndt_robust_cost", "ndt_linearize.cu", "ops/ndt_linearize.py:282",
               launches["on"]["ndt_robust_cost"], k3b),
        record("chol_solve", "small_chol.cu", "ops/small_chol.py:77",
               launches["on"]["chol_solve"], k4),
        # the XLA ops of the LM loop's body: the aux Jacobian and normal
        # equations with the Jacobi scaling and damping, the trial step, the
        # acceptance
        record("lm_assemble", "lm_step.cu", "registration/matcher.py:272",
               launches["on"]["lm_assemble"], lm["lm_assemble"]),
        record("lm_trial", "lm_step.cu", "registration/solver.py:130",
               launches["on"]["lm_trial"], lm["lm_trial"]),
        record("lm_accept", "lm_step.cu", "registration/solver.py:135",
               launches["on"]["lm_accept"], lm["lm_accept"]),
    ]
    print(f"chip_smoke: passed in {time.perf_counter() - t_start:.1f} s wall (set-up "
          f"{setup_s:.1f} s, kernels and odometry {odometry_s:.1f} s, K5 {k5_s:.1f} s, "
          f"full SLAM {slam_s:.1f} s, OGM {ogm_s:.1f} s, Schur {schur_s:.1f} s, "
          f"online {online_s:.1f} s, batched {batch_s:.1f} s, multi-device {md_s:.1f} s, "
          f"indoor {indoor_s:.1f} s: {', '.join(f'{k} {v:.1f} s' for k, v in in_walls.items() if k in ('slam', 'imu_check', 'online'))})",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print_ok(torch, name)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--md-rank"]:
        sys.exit(md_rank(sys.argv[2], sys.argv[3], int(sys.argv[4]), float(sys.argv[5])))
    if sys.argv[1:2] == ["--multi-device"]:
        sys.exit(md_only(sys.argv[2]))
    if sys.argv[1:2] == ["--save-slam-graph"]:
        sys.exit(main(save_slam_graph=sys.argv[2]))
    sys.exit(main())
