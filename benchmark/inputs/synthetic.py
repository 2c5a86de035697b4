"""The synthetic radar world: scatterer walls and clutter, smooth or looping
drives, and polar intensity images rendered from a pose.

A frozen copy of ``make_world``, ``make_trajectory`` and
``render_scan_fast`` from ``randt_slam_torch/io/synthetic.py``, so that the
benchmark's inputs stay the same whatever the program later changes there
(``benchmark/tests/test_bench_inputs.py`` holds them equal for one seed).
numpy only.
"""

from __future__ import annotations

import numpy as np

# ``np.maximum.at`` is buffered and fast from numpy 1.25 on; before it, a
# scatter of a frame's ~10^5 blob cells takes a tenth of a second.
_FAST_AT = tuple(int(v) for v in np.__version__.split(".")[:2]) >= (1, 25)


def _max_at(flat, idx, vals, fast=None):
    """``np.maximum.at(flat, idx, vals)``; where that is slow, the same
    maxima by a sort and ``np.maximum.reduceat`` (exact: a maximum does not
    depend on the order it is taken in)."""
    if _FAST_AT if fast is None else fast:
        np.maximum.at(flat, idx, vals)
        return
    order = np.argsort(idx, kind="stable")
    sidx, svals = idx[order], vals[order]
    uniq, start = np.unique(sidx, return_index=True)
    flat[uniq] = np.maximum(flat[uniq], np.maximum.reduceat(svals, start))


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
    _max_at(img.reshape(-1), flat.reshape(-1), prof.reshape(-1))
    if saturate_at is not None:
        np.minimum(img, np.float32(saturate_at), out=img)
    return img
