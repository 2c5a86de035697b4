"""Radar scan preprocessing: azimuth-wise intensity filtering + grid clustering.

Port of ``randt_slam_tpu/preprocess.py`` (``RadarPreprocessor::filterScan``,
``radar_preprocessor.cpp:45-125``).  The scan is a polar intensity image
``(A azimuths, R range bins)`` and the filter is

 1. a per-row masked argmax                      (the per-beam peak)
 2. a fixed window gathered around each peak     (kernel K1, ``ops/window_slice``)
 3. a cumulative "strictly-decreasing chain" mask inside the window
    (the reference's two expansion loops, computed as cumsums)

Grid clustering (``grid.cpp:7-14``) is a per-point cell-id hash.  The
deviations from the reference are the JAX package's: runs are capped at
``run_window`` bins each side of the peak, and cluster ids use
``floor((x + max_range) / res)``.

Both functions take an optional leading batch axis: B scans of one shape,
(B, A, R) images with (B, A) azimuths and (B, R) ranges, filtered in the
same operations (one K1 launch for all of them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from .config import PreprocessorConfig
from .geometry import transform_points
from .ops.window_slice import row_windows
from .utils import profiling


class PolarScan(NamedTuple):
    """Raw radar frame as a polar intensity image.

    intensity: (A, R) float32 return power per (azimuth, range-bin)
    azimuths:  (A,)   beam angles [rad] in the sensor frame
    ranges:    (R,)   range-bin centers [m]
    azimuth_mask: (A,) bool, False for padded azimuth rows
    """

    intensity: torch.Tensor
    azimuths: torch.Tensor
    ranges: torch.Tensor
    azimuth_mask: torch.Tensor


class FilteredScan(NamedTuple):
    """Filtered scan: per-azimuth peak runs, flattened to padded points.

    points:  (P, 3) [x, y, intensity] in the BASE frame
    polar:   (P, 2) [angle, range] in the sensor frame (for pNDT)
    mask:    (P,)   bool
    beams:   (A, 3) [angle, range, intensity] of the per-azimuth max return
    beam_mask: (A,) bool
    """

    points: torch.Tensor
    polar: torch.Tensor
    mask: torch.Tensor
    beams: torch.Tensor
    beam_mask: torch.Tensor


@profiling.span("randt.filter_scan")
def filter_scan(
    scan: PolarScan,
    cfg: PreprocessorConfig,
    sensor_to_base,
    run_window: int = 32,
) -> FilteredScan:
    """Vectorized ``RadarPreprocessor::filterScan``.

    sensor_to_base: (3,) SE(2) pose of the sensor in the base frame
    run_window: max run extent in bins on EACH side of the peak.
    Returns points flattened to P = A * (2*run_window+1), per scan of a
    batch.
    """
    img = scan.intensity
    lead = img.shape[:-2]
    A, R = img.shape[-2:]
    r = scan.ranges
    dtype = img.dtype

    range_ok = (r > cfg.min_range) & (r < cfg.max_range)  # (..., R)
    gated = torch.where(range_ok[..., None, :], img, float("-inf"))
    peak_idx = torch.argmax(gated, dim=-1)  # (..., A) first maximum
    peak_int = torch.gather(img, -1, peak_idx[..., None])[..., 0]
    # A beam has a peak iff some in-range return has intensity > 0
    # (``radar_preprocessor.cpp:71``).
    beam_valid = scan.azimuth_mask & (
        torch.amax(torch.where(range_ok[..., None, :], img, 0.0), dim=-1) > 0.0)

    peak_r = r[peak_idx] if r.dim() == 1 else torch.gather(r, -1, peak_idx)
    beams = torch.stack([scan.azimuths, peak_r, peak_int], dim=-1).to(dtype)

    # ---- fixed window around each peak (kernel K1) --------------------------
    # The image is pre-padded by the window radius; out-of-bounds columns
    # carry sentinel values (intensity 0, range -1e9) and are also excluded
    # by the arithmetic ``in_bounds`` mask.
    W = 2 * run_window + 1
    offsets = torch.arange(-run_window, run_window + 1, device=img.device)
    jw = peak_idx[..., None] + offsets  # (..., A, W)
    in_bounds = (jw >= 0) & (jw < R)
    img_pad = Fn.pad(img, (run_window, run_window))
    sentinel = torch.full(lead + (run_window,), -1e9, dtype=dtype,
                          device=img.device)
    r_pad = torch.cat([sentinel, r.to(dtype), sentinel], dim=-1)
    I_w, r_w = row_windows(img_pad, r_pad, peak_idx, W)  # (..., A, W)

    c = run_window  # center column
    # Step legality between adjacent window slots (both directions): strictly
    # decreasing intensity, SIGNED range contiguity (``:84,99``), previous
    # bin in range.
    thresh = cfg.beam_distance_increment_threshold
    dI_right = I_w[..., 1:] < I_w[..., :-1]
    dr_right = (r_w[..., :-1] - r_w[..., 1:]) <= thresh
    prev_in_range_right = r_w[..., :-1] >= cfg.min_range
    ok_right = dI_right & dr_right & prev_in_range_right & in_bounds[..., 1:]

    dI_left = I_w[..., :-1] < I_w[..., 1:]
    dr_left = (r_w[..., 1:] - r_w[..., :-1]) <= thresh
    prev_in_range_left = r_w[..., 1:] >= cfg.min_range
    ok_left = dI_left & dr_left & prev_in_range_left & in_bounds[..., :-1]

    # Chain from the center: bad-step cumsums (integer, so reproducible).
    bad_r = (~ok_right).to(torch.int32)
    cum_r = torch.cumsum(bad_r, dim=-1)
    base_r = cum_r[..., c - 1:c]  # bad steps up to the center
    in_run_right = torch.cat(
        [torch.zeros(lead + (A, c + 1), dtype=torch.bool, device=img.device),
         (cum_r[..., c:] - base_r) == 0], dim=-1)

    bad_l = (~ok_left).to(torch.int32)
    cum_l_rev = torch.flip(torch.cumsum(torch.flip(bad_l, (-1,)), dim=-1), (-1,))
    base_l = cum_l_rev[..., c:c + 1]
    in_run_left = torch.cat(
        [(cum_l_rev[..., :c] - base_l) == 0,
         torch.zeros(lead + (A, W - c), dtype=torch.bool, device=img.device)],
        dim=-1)

    in_run = in_run_left | in_run_right
    in_run[..., c] = True

    # Final inclusion gates (``radar_preprocessor.cpp:114``).
    keep = (
        in_run
        & in_bounds
        & beam_valid[..., None]
        & (r_w > cfg.min_range)
        & (r_w < cfg.max_range)
        & (I_w > cfg.min_intensity)
    )

    ang = scan.azimuths[..., None]  # (..., A, 1)
    xs = torch.cos(ang) * r_w
    ys = torch.sin(ang) * r_w
    pts_sensor = torch.stack([xs, ys], dim=-1).reshape(lead + (A * W, 2))
    pts_base = transform_points(sensor_to_base.to(dtype), pts_sensor)
    points = torch.cat([pts_base, I_w.reshape(lead + (A * W, 1))], dim=-1)
    polar = torch.stack([ang.expand(lead + (A, W)).reshape(lead + (-1,)),
                         r_w.reshape(lead + (-1,))], dim=-1)
    return FilteredScan(
        points=points,
        polar=polar,
        mask=keep.reshape(lead + (-1,)),
        beams=beams,
        beam_mask=beam_valid,
    )


def cluster_ids(points, mask, cfg: PreprocessorConfig):
    """Grid-hash cluster labels (``Grid::cluster``, ``grid.cpp:7-14``).

    Returns (ids (..., P), num_slots): id in [0, row_size^2), invalid points
    get id == num_slots (dropped by the segment sums).
    """
    rs = cfg.cluster_row_size
    res = cfg.cluster_resolution
    num_slots = rs * rs
    ix = torch.floor((points[..., 0] + cfg.max_range) / res).long()
    iy = torch.floor((points[..., 1] + cfg.max_range) / res).long()
    ok = mask & (ix >= 0) & (ix < rs) & (iy >= 0) & (iy < rs)
    ids = torch.where(ok, ix + rs * iy, num_slots)
    return ids, num_slots
