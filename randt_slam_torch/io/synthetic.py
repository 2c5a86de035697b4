"""Synthetic radar world generator for tests and benchmarks.

No radar datasets ship with this repository (the reference evaluates against
external rosbags, SURVEY.md §4/§6), so correctness and performance are
validated closed-loop: simulate a 2-D world of point scatterers, sweep a
simulated FMCW-style radar along a ground-truth trajectory, run SLAM on the
rendered polar intensity images, and compare the estimate against the known
trajectory (ATE/RPE, ``io/formats.py``).

The scan model mirrors what the reference's preprocessor expects
(``radar_preprocessor.cpp:45-125``): each scatterer produces an intensity blob
that decays over a few range bins away from its true range, on top of low
speckle noise, so the per-azimuth peak filter reconstructs the scatterer
positions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticSequence(NamedTuple):
    intensity: np.ndarray   # (T, A, R) float32 polar scans
    azimuths: np.ndarray    # (A,) beam angles
    ranges: np.ndarray      # (R,) bin centers [m]
    stamps: np.ndarray      # (T,) seconds
    gt_poses: np.ndarray    # (T, 3) ground-truth sensor poses (world frame)
    imu_yaw: np.ndarray     # (T,) absolute yaw readings (noisy, biased)
    landmarks: np.ndarray   # (L, 3) world scatterers [x, y, reflectivity]


def make_world(rng, trajectory=None, extent=220.0, min_refl=90.0, max_refl=180.0,
               n_walls=60, wall_point_spacing=0.5, corridor=60.0,
               n_clutter=120):
    """Extended structures (walls as scatterer chains) + point clutter.

    Radar NDT matching relies on cells holding structured multi-point
    distributions (building facades, vegetation lines); isolated point
    scatterers produce degenerate single-beam cells.  When a trajectory is
    given, walls are placed in a corridor around it so the sensor always sees
    nearby structure (as in urban radar data).
    """
    chunks = []
    for _ in range(n_walls):
        if trajectory is not None:
            anchor = trajectory[rng.integers(0, len(trajectory)), :2]
            c = anchor + rng.uniform(-corridor, corridor, 2)
        else:
            c = rng.uniform(-extent, extent, 2)
        th = rng.uniform(0, np.pi)
        length = rng.uniform(8.0, 40.0)
        n = max(2, int(length / wall_point_spacing))
        t = np.linspace(-length / 2, length / 2, n)
        pts = c[None, :] + np.outer(t, [np.cos(th), np.sin(th)])
        pts = pts + rng.normal(0, 0.15, pts.shape)  # surface roughness
        # Along-wall reflectivity TEXTURE (windows, doors, pillars): real
        # facades vary by >10 dB over a few meters, and that variation is
        # what gives the intensity-augmented NDT its along-wall (longitudinal)
        # constraint — a uniform-intensity wall is a slide rail for the
        # matcher (aperture degeneracy: shifted associations cost nothing in
        # the intensity channel, which enables velocity-runaway feedback in
        # straight corridors).  Spatially-correlated texture, ~2 m scale.
        base = rng.uniform(min_refl, max_refl)
        n_ctrl = max(2, int(length / 2.0) + 1)
        ctrl = rng.uniform(-1.0, 1.0, n_ctrl)
        tex = np.interp(np.linspace(0, n_ctrl - 1, n), np.arange(n_ctrl), ctrl)
        amp = 0.45 * (max_refl - min_refl)
        refl = np.clip(base + amp * tex + rng.normal(0, 5.0, n),
                       0.6 * min_refl, 1.25 * max_refl)[:, None]
        chunks.append(np.concatenate([pts, refl], axis=1))
    if n_clutter:
        if trajectory is not None:
            anchors = trajectory[rng.integers(0, len(trajectory), n_clutter), :2]
            pts = anchors + rng.uniform(-corridor, corridor, (n_clutter, 2))
        else:
            pts = rng.uniform(-extent, extent, (n_clutter, 2))
        refl = rng.uniform(min_refl, max_refl, (n_clutter, 1))
        chunks.append(np.concatenate([pts, refl], axis=1))
    return np.concatenate(chunks).astype(np.float32)


def make_trajectory(rng, n_frames, dt=0.25, speed=4.0, yaw_rate_scale=0.15,
                    loop=False, laps=1.25):
    """Smooth random drive; ``loop=True`` drives ``laps`` circles so later
    frames re-traverse the first lap's path (same-lane revisits, as in the
    Oxford sequences the reference evaluates on)."""
    if loop:
        total = n_frames * dt
        omega = 2.0 * np.pi * laps / total
        yaw_rates = np.full(n_frames, omega)
    else:
        yaw_rates = np.zeros(n_frames)
        w = 0.0
        for i in range(n_frames):
            w = 0.9 * w + rng.normal(0, yaw_rate_scale)
            yaw_rates[i] = w
    poses = np.zeros((n_frames, 3))
    th, x, y = 0.0, 0.0, 0.0
    for i in range(1, n_frames):
        th = th + yaw_rates[i] * dt
        x += speed * dt * np.cos(th)
        y += speed * dt * np.sin(th)
        poses[i] = (x, y, np.arctan2(np.sin(th), np.cos(th)))
    return poses.astype(np.float32)


def render_scan(pose, landmarks, azimuths, ranges, rng,
                blob_sigma_bins=1.5, speckle=8.0, beam_sigma_az=1.2):
    """Render one polar intensity image from a sensor pose.

    Each scatterer paints a 2-D blob: Gaussian over a few range bins AND over
    adjacent azimuths (finite antenna beamwidth, like the Navtech sensor the
    reference targets) — without the azimuth spread, NDT cells collapse to
    radial pencils and distribution matching degenerates.
    """
    A, R = len(azimuths), len(ranges)
    bin_width = float(ranges[1] - ranges[0])
    c, s = np.cos(pose[2]), np.sin(pose[2])
    rel = landmarks[:, :2] - pose[:2]
    lx = c * rel[:, 0] + s * rel[:, 1]
    ly = -s * rel[:, 0] + c * rel[:, 1]
    rr = np.hypot(lx, ly)
    aa = np.arctan2(ly, lx)
    img = rng.rayleigh(speckle, (A, R)).astype(np.float32)

    vis = (rr > ranges[0]) & (rr < ranges[-1])
    az_frac = (aa - azimuths[0]) / (azimuths[1] - azimuths[0])
    r_idx = (rr - ranges[0]) / bin_width
    az_off = np.arange(-2, 3)
    for k in np.nonzero(vis)[0]:
        rc = r_idx[k]
        lo = max(0, int(rc - 4))
        hi = min(R, int(rc + 5))
        bins = np.arange(lo, hi)
        r_prof = np.exp(-0.5 * ((bins - rc) / blob_sigma_bins) ** 2)
        for da in az_off:
            a = int(np.round(az_frac[k] + da)) % A
            w = np.exp(-0.5 * ((a - az_frac[k] + A / 2) % A - A / 2) ** 2
                       / beam_sigma_az**2)
            prof = landmarks[k, 2] * w * r_prof
            img[a, lo:hi] = np.maximum(img[a, lo:hi], prof)
    return img


def render_scan_fast(pose, landmarks, azimuths, ranges, rng,
                     blob_sigma_bins=1.5, speckle=8.0, beam_sigma_az=1.2,
                     saturate_at=None, multipath_ghost_prob=0.0,
                     multipath_atten=0.35, azimuth_jitter_deg=0.0):
    """Vectorized :func:`render_scan` (identical math, no per-landmark Python
    loop): paints every visible scatterer's (5 azimuth x 9 range-bin) blob
    with one ``np.maximum.at`` scatter.  Needed to simulate Oxford-length
    sequences (thousands of frames) in reasonable time.

    Sensor-fidelity ablations (all off by default; OXFORD_RESULTS.md §5):
      saturate_at: receiver saturation — clip the final image at this power
        (the Navtech sensor quantizes to uint8, hard-capping strong facades).
      multipath_ghost_prob: each visible scatterer spawns, with this
        probability, a ghost return at twice its range on the same azimuth
        with ``multipath_atten`` of its reflectivity (double-bounce echo).
      azimuth_jitter_deg: per-frame Gaussian jitter of every return's azimuth
        (encoder noise / timing skew), in degrees std.
    """
    A, R = len(azimuths), len(ranges)
    bin_width = float(ranges[1] - ranges[0])
    c, s = np.cos(pose[2]), np.sin(pose[2])
    rel = landmarks[:, :2] - pose[:2]
    lx = c * rel[:, 0] + s * rel[:, 1]
    ly = -s * rel[:, 0] + c * rel[:, 1]
    rr = np.hypot(lx, ly)
    vis = (rr > ranges[0]) & (rr < ranges[-1])
    img = rng.rayleigh(speckle, (A, R)).astype(np.float32)
    if not np.any(vis):
        return img
    lx, ly, rr = lx[vis], ly[vis], rr[vis]
    refl = landmarks[vis, 2]
    aa = np.arctan2(ly, lx)
    if multipath_ghost_prob > 0.0:
        ghost = rng.random(len(rr)) < multipath_ghost_prob
        g_rr = 2.0 * rr[ghost]
        g_ok = g_rr < ranges[-1]
        rr = np.concatenate([rr, g_rr[g_ok]])
        aa = np.concatenate([aa, aa[ghost][g_ok]])
        refl = np.concatenate([refl, multipath_atten * refl[ghost][g_ok]])
    if azimuth_jitter_deg > 0.0:
        aa = aa + rng.normal(0.0, np.deg2rad(azimuth_jitter_deg), aa.shape)
    az_frac = (aa - azimuths[0]) / (azimuths[1] - azimuths[0])
    r_idx = (rr - ranges[0]) / bin_width

    # (L, 5) azimuth rows + weights; (L, 9) range bins + profiles
    da = np.arange(-2, 3)
    a_rows = (np.round(az_frac)[:, None].astype(np.int64) + da[None, :]) % A
    circ = (a_rows - az_frac[:, None] + A / 2) % A - A / 2
    w_az = np.exp(-0.5 * circ**2 / beam_sigma_az**2)

    lo = np.maximum(0, (r_idx - 4).astype(np.int64))
    db = np.arange(9)
    bins = lo[:, None] + db[None, :]
    ok_r = bins < np.minimum(R, (r_idx + 5).astype(np.int64))[:, None]
    r_prof = np.exp(-0.5 * ((bins - r_idx[:, None]) / blob_sigma_bins) ** 2)

    prof = (refl[:, None, None] * w_az[:, :, None] * r_prof[:, None, :])
    prof = np.where(ok_r[:, None, :], prof, 0.0).astype(np.float32)
    flat = (a_rows[:, :, None] * R + np.minimum(bins, R - 1)[:, None, :])
    np.maximum.at(img.reshape(-1), flat.reshape(-1), prof.reshape(-1))
    if saturate_at is not None:
        np.minimum(img, np.float32(saturate_at), out=img)
    return img


def generate(
    seed=0,
    n_frames=60,
    n_azimuths=256,
    n_bins=256,
    max_range=80.0,
    dt=0.25,
    speed=4.0,
    loop=False,
    n_walls=60,
    imu_bias=0.01,
    imu_noise=0.002,
) -> SyntheticSequence:
    rng = np.random.default_rng(seed)
    poses = make_trajectory(rng, n_frames, dt=dt, speed=speed, loop=loop)
    landmarks = make_world(
        rng, trajectory=poses, extent=max_range * 1.6, n_walls=n_walls,
        corridor=0.6 * max_range,
    )
    azimuths = (np.arange(n_azimuths) / n_azimuths * 2.0 * np.pi - np.pi).astype(
        np.float32
    )
    ranges = (np.arange(n_bins) + 0.5) * (max_range / n_bins)
    ranges = ranges.astype(np.float32)
    scans = np.stack(
        [render_scan(p, landmarks, azimuths, ranges, rng) for p in poses]
    )
    stamps = (np.arange(n_frames) * dt).astype(np.float32)
    imu_yaw = poses[:, 2] + imu_bias * stamps + rng.normal(0, imu_noise, n_frames)
    return SyntheticSequence(
        intensity=scans.astype(np.float32),
        azimuths=azimuths,
        ranges=ranges,
        stamps=stamps,
        gt_poses=poses,
        imu_yaw=imu_yaw.astype(np.float32),
        landmarks=landmarks,
    )
