"""The benchmark's drives: rendered radar sequences made from a seed.

Frozen copies of ``render_frames``, ``indoor_route``, ``render_indoor`` and
``bench_graph`` from ``chip_smoke.py``, with that script's constants as
defaults, so that the benchmark's inputs stay the same whatever the program
or its smoke test later change (``benchmark/tests/test_bench_inputs.py``
holds them equal for one seed).  numpy only.

* :func:`render_frames`: Oxford Radar RobotCar geometry (400 azimuths x 1157
  bins of 8.64 cm to 100 m, 4 Hz) on a 4 m/s drive through a scatterer
  world; with ``laps`` a circular drive, and with ``laps=1`` and
  ``n_frames`` frames a closed lap whose frame ``n_frames`` would be frame 0.
* :func:`render_indoor`: 400 azimuths x 400 bins of 3 cm to 12 m, 0.25 s
  frames at 0.8 m/s round a rounded rectangle, a gyro yaw that drifts at
  ``imu_bias`` rad/s under ``imu_noise`` rad of Gaussian noise; the route
  closes after ``lap_frames`` frames.
"""

from __future__ import annotations

import numpy as np

from . import synthetic as S

# Oxford geometry (chip_smoke.N_AZ, BIN_W, MAX_RANGE)
N_AZ = 400
BIN_W = 0.0864
MAX_RANGE = 100.0
# indoor geometry (chip_smoke.IN_*, IMU_*, ROUTE_HALF, INDOOR_LAP)
IN_AZ = 400
IN_MAX_RANGE = 12.0
IN_BIN_W = 0.03
IN_DT = 0.25
IN_SPEED = 0.8
IMU_BIAS = 0.02
IMU_NOISE = 0.001
ROUTE_HALF = (0.5, 0.5)
INDOOR_LAP = 112


def render_frames(n_frames, seed=0, laps=None, n_az=N_AZ, bin_w=BIN_W,
                  max_range=MAX_RANGE):
    """Oxford-geometry frames: a smooth drive through a scatterer world,
    rendered as polar intensity images; with ``laps``, a circular drive of
    that many laps.  Returns (scans, az, ranges, stamps, gt)."""
    rng = np.random.default_rng(seed)
    if laps is None:
        gt = S.make_trajectory(rng, n_frames, dt=0.25, speed=4.0)
    else:
        gt = S.make_trajectory(rng, n_frames, dt=0.25, speed=4.0, loop=True,
                               laps=laps)
    landmarks = S.make_world(rng, trajectory=gt, n_walls=120, corridor=50.0,
                             n_clutter=240)
    az = (np.arange(n_az) / n_az * 2 * np.pi - np.pi).astype(np.float32)
    n_bins = int(max_range / bin_w)
    ranges = ((np.arange(n_bins) + 0.5) * bin_w).astype(np.float32)
    scans = np.stack([
        S.render_scan_fast(
            p, landmarks[(np.abs(landmarks[:, 0] - p[0]) < max_range + 5)
                         & (np.abs(landmarks[:, 1] - p[1]) < max_range + 5)],
            az, ranges, rng)
        for p in gt
    ]).astype(np.float32)
    stamps = (np.arange(n_frames) * 0.25).astype(np.float32)
    return scans, az, ranges, stamps, gt


def indoor_route(n_frames, lap_frames, half=(3.0, 1.0), speed=IN_SPEED, dt=IN_DT):
    """The rounded-rectangle route (straights of 2 hx and 2 hy joined by
    quarter circles of radius a; ``half`` = (hx / a, hy / a)), one lap per
    ``lap_frames`` frames at ``speed`` x ``dt`` per frame, driven for
    ``n_frames`` frames from the middle of its bottom straight, heading +x,
    and expressed relative to that first pose (numpy (n_frames, 3))."""
    step = speed * dt
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


def render_indoor(n_frames=136, lap_frames=INDOOR_LAP, seed=0, half=ROUTE_HALF,
                  n_az=IN_AZ, max_range=IN_MAX_RANGE, bin_w=IN_BIN_W, dt=IN_DT,
                  speed=IN_SPEED, imu_bias=IMU_BIAS, imu_noise=IMU_NOISE):
    """Indoor frames: a wall-dense world around :func:`indoor_route`,
    rendered as polar images of ``n_az`` x ``max_range / bin_w`` bins, and a
    gyro yaw reading that drifts at ``imu_bias`` rad/s under ``imu_noise``
    rad of Gaussian noise.  Returns (scans, az, ranges, stamps, imu_yaw,
    gt)."""
    rng = np.random.default_rng(seed)
    gt = indoor_route(n_frames, lap_frames, half, speed, dt)
    landmarks = S.make_world(rng, trajectory=gt, n_walls=int(40 + n_frames / 10),
                             corridor=9.0, n_clutter=n_frames // 5, min_refl=40.0,
                             max_refl=120.0, wall_point_spacing=0.15)
    az = (np.arange(n_az) / n_az * 2 * np.pi - np.pi).astype(np.float32)
    n_bins = int(round(max_range / bin_w))
    ranges = ((np.arange(n_bins) + 0.5) * bin_w).astype(np.float32)
    scans = np.stack([S.render_scan_fast(p, landmarks, az, ranges, rng, speckle=2.0)
                      for p in gt]).astype(np.float32)
    stamps = (np.arange(n_frames) * dt).astype(np.float32)
    imu_yaw = (gt[:, 2] + imu_bias * stamps
               + rng.normal(0, imu_noise, n_frames)).astype(np.float32)
    return scans, az, ranges, stamps, imu_yaw, gt


def bench_graph(n_nodes):
    """A noisy two-lap circle pose graph of ``n_nodes`` nodes, odometry
    edges and loop edges every 100 nodes of the second lap back to the
    matching first-lap submap root, all measuring exact ground-truth
    relative poses (so the optimum is the ground truth); submaps of 8 nodes
    with a root each.  Returns (poses, id_begin, id_end, trans,
    sqrt_information, node_submap, node_is_root, gt).  No cell uses it yet;
    it is kept for a pose-graph cell."""
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


def drive_seed(seed: int, drive: int) -> int:
    """The renderer seed of drive ``drive`` of a run seeded ``seed``: any
    whole number, negative or beyond 64 bits, maps to one."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), drive])
    return int(ss.generate_state(1, np.uint64)[0])


def render_lap(kind: str, params: dict, seed: int) -> dict:
    """One closed lap of the drive ``kind`` (``oxford_loop`` or
    ``indoor_route``), rendered from ``seed`` with the geometry in
    ``params``: numpy arrays of its ``lap_frames`` frames, the lap's frame
    ``lap_frames`` being its frame 0 again.  For the indoor drive,
    ``imu_noise`` is the gyro's per-frame noise, so that a member that runs
    past the lap reads yaw + noise + bias x its own time."""
    lap = int(params["lap_frames"])
    if kind == "oxford_loop":
        scans, az, ranges, stamps, gt = render_frames(
            lap, seed=seed, laps=1, n_az=params["n_az"], bin_w=params["bin_w"],
            max_range=params["max_range"])
        imu_noise = np.zeros(lap, np.float32)
    elif kind == "indoor_route":
        scans, az, ranges, stamps, imu_yaw, gt = render_indoor(
            lap, lap_frames=lap, seed=seed, half=tuple(params["route_half"]),
            n_az=params["n_az"], max_range=params["max_range"],
            bin_w=params["bin_w"], dt=params["dt"], speed=params["speed"],
            imu_bias=params["imu_bias"], imu_noise=params["imu_noise"])
        imu_noise = (imu_yaw.astype(np.float64) - gt[:, 2]
                     - params["imu_bias"] * stamps.astype(np.float64)).astype(np.float32)
    else:
        raise ValueError(f"unknown drive kind {kind!r}")
    return dict(scans=scans, az=az, ranges=ranges, gt=gt, imu_noise=imu_noise)


class LapRender:
    """``drives`` laps of run seed ``seed`` rendered on ``workers`` threads of
    this process, one drive per task.  numpy releases the GIL in the work
    that counts (the speckle draws, the blob arithmetic, the scatter), and
    the laps (2.4 GB for eight Oxford laps) never cross a pipe.  Drive d's
    lap depends on (seed, d) alone, never on the number of workers."""

    def __init__(self, kind: str, params: dict, seed: int, drives: int, workers: int):
        from concurrent.futures import ThreadPoolExecutor

        self._ex = ThreadPoolExecutor(max(1, min(workers, drives)),
                                      thread_name_prefix="render")
        self._futs = [self._ex.submit(render_lap, kind, params, drive_seed(seed, d))
                      for d in range(drives)]

    def get(self) -> list:
        """The laps, in drive order, once all are rendered."""
        laps = [f.result() for f in self._futs]
        self.close()
        return laps

    def close(self):
        """Drop the laps not yet started, and wait for those running."""
        self._ex.shutdown(wait=True, cancel_futures=True)

