"""ScanContext loop-closure descriptors.

Port of the descriptor part of ``randt_slam_tpu/loops/scancontext.py``
(``Scancontext.cpp`` with RaNDT's radar modification: bins ACCUMULATE
intensity * intensity_factor, ``makeScancontext`` :156-203).  The front end
emits one descriptor per frame; the loop-closure pass retrieves and scores
candidates for a batch of queries at once:

* ring-key kNN -> one (Q, N) distance table, the causal
  ``num_exclude_recent`` mask and a stable sort (the nanoflann kd-tree of
  :275-301);
* shift alignment -> one (S, S) column-dot product per pair and a gather
  over the shifts (the ``circshift`` loops of :93-145);
* candidate scoring adds the odometry-consistency penalty
  (``distanceBtnScanContext``, :146-151).

Reference quirk reproduced on purpose: bins start at NO_POINT = -1000 and
z is ADDED, so occupied bins carry (sum_z - 1000)
(``legacy_no_point_offset``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import runtime
from ..config import ScanContextConfig
from ..utils import profiling

NO_POINT = -1000.0


def _remainder(x, y: float):
    """Floor-mod with the sign of ``y``, formed as ``jnp.remainder`` forms it
    (exact ``fmod``, then one correction) so bin edges fall identically."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


@profiling.span("randt.descriptor")
def make_descriptor(polar, intensity, mask, cfg: ScanContextConfig,
                    legacy_no_point_offset: bool = True):
    """One (num_ring, num_sector) descriptor from sensor-frame returns.

    polar: (P, 2) [angle rad, range m]; intensity: (P,); mask: (P,) bool.
    Ring/sector from ceil(frac * n) clamped to [1, n] (:184-185); additive z
    accumulation with the NO_POINT offset quirk (:164,190-198).  The bin sums
    are reproducible on CUDA (``runtime.index_add``).
    """
    Rn, Sn = cfg.num_ring, cfg.num_sector
    ang = polar[..., 0]
    rng = polar[..., 1]
    z = intensity * cfg.intensity_factor

    keep = mask & (rng <= cfg.max_radius)
    ring = torch.clamp(torch.ceil(rng / cfg.max_radius * Rn).long(), 1, Rn) - 1
    az_deg = _remainder(ang * (180.0 / math.pi), 360.0)
    sector = torch.clamp(torch.ceil(az_deg / 360.0 * Sn).long(), 1, Sn) - 1
    flat = torch.where(keep, ring * Sn + sector, Rn * Sn)

    zero = z.new_zeros(Rn * Sn + 1)
    sums = runtime.index_add(zero, flat, torch.where(keep, z, 0.0))[: Rn * Sn]
    counts = runtime.index_add(zero, flat, keep.to(z.dtype))[: Rn * Sn]
    occupied = counts > 0
    if legacy_no_point_offset:
        desc = torch.where(occupied, sums + NO_POINT, 0.0)
    else:
        desc = torch.where(occupied, sums, 0.0)
    return desc.reshape(Rn, Sn)


def ring_key(desc):
    """Row-wise mean (``makeRingkeyFromScancontext``, :206-219)."""
    return torch.mean(desc, dim=-1)


def sector_key(desc):
    """Column-wise mean (``makeSectorkeyFromScancontext``, :222-235)."""
    return torch.mean(desc, dim=-2)


def _shift_index(S: int, device):
    """(S, S) source columns: entry [s, j] = (j - s) mod S, column j of a
    descriptor shifted right by s (``circshift``)."""
    cols = torch.arange(S, device=device)
    return (cols[None, :] - cols[:, None]) % S


def _col_norm(d):
    """Column norms of (..., R, S) descriptors."""
    return torch.sqrt(torch.sum(d * d, dim=-2))


def _all_shift_cosine_dist(d1, d2):
    """distDirectSC at every column shift of d2 (:69-90 + ``circshift``).

    d1, d2: (..., R, S).  Returns (..., S): entry s compares column j of d1
    with column (j - s) mod S of d2.  All column-pair dot products come from
    one (S, S) product per pair, then a gather per shift."""
    S = d1.shape[-1]
    idx = _shift_index(S, d1.device)
    cols = torch.arange(S, device=d1.device)
    M = torch.matmul(d1.transpose(-1, -2), d2)       # M[j, k] = d1[:, j] . d2[:, k]
    dots = M[..., cols[None, :], idx]                # (..., S_shift, S_col)
    n1 = _col_norm(d1)
    n2 = _col_norm(d2)[..., idx]
    valid = (n1[..., None, :] > 0) & (n2 > 0)
    cos = torch.where(valid, dots / torch.clamp(n1[..., None, :] * n2, min=1e-20), 0.0)
    n_eff = torch.clamp(torch.sum(valid, dim=-1), min=1)
    return 1.0 - torch.sum(cos, dim=-1) / n_eff


def _sector_key_align(vk1, vk2):
    """fastAlignUsingVkey (:93-113): argmin over shifts of
    ||vk1 - roll(vk2)||^2 (first shift among ties)."""
    idx = _shift_index(vk1.shape[-1], vk1.device)
    diff = vk1[..., None, :] - vk2[..., idx]
    return torch.argmin(torch.sum(diff * diff, dim=-1), dim=-1)


def pair_distance(d1, d2, pos1, pos2, dist1, dist2, cfg: ScanContextConfig):
    """distanceBtnScanContext (:116-153) over broadcast leading dimensions:
    shift-searched cosine distance plus the odometry-drift penalty.
    d* (..., R, S), pos* (..., 2), dist* (...).  Returns (distance, argmin
    shift)."""
    S = cfg.num_sector
    center = _sector_key_align(sector_key(d1), sector_key(d2))
    radius = int(round(0.5 * cfg.search_ratio * S))
    offs = torch.arange(S, device=d1.device)
    c = center[..., None]
    ring_dist = torch.minimum((offs - c) % S, (c - offs) % S)
    dists = torch.where(ring_dist <= radius, _all_shift_cosine_dist(d1, d2),
                        float("inf"))
    best_shift = torch.argmin(dists, dim=-1)
    min_dist = torch.gather(dists, -1, best_shift[..., None])[..., 0]

    dp = pos2 - pos1
    t_err = torch.clamp(torch.sqrt(torch.sum(dp * dp, dim=-1)) - cfg.odom_eps,
                        min=0.0) / (dist2 - dist1)
    odom_dist = 1.0 - torch.exp(-(t_err * t_err) / (2.0 * cfg.assumed_drift ** 2))
    return min_dist + odom_dist * cfg.num_ring * cfg.odom_weight, best_shift


class LoopCandidate(NamedTuple):
    match_id: torch.Tensor   # (Q,) int64, -1 if none
    yaw_rad: torch.Tensor    # (Q,) aligned yaw offset
    distance: torch.Tensor   # (Q,) combined distance


@profiling.span("randt.loop_retrieval")
def detect(query_idx, descriptors, ring_keys, positions, distances, n_valid: int,
           cfg: ScanContextConfig) -> LoopCandidate:
    """detectLoopClosureID (:256-341) for a batch of queries (Q,) against the
    database: descriptors (N, R, S), ring keys (N, R), odometry positions
    (N, 2), traversed distances (N,).

    Candidates are the ring-key kNN among ids <= query - num_exclude_recent
    (the reference's tree cutoff, :280), nearest first and the lower id first
    among equal distances (``lax.top_k``'s order); the best shift-aligned
    combined distance is accepted if it is below dist_threshold
    (:330-333), the first candidate winning ties."""
    N = ring_keys.shape[0]
    q = query_idx.long()
    diff = ring_keys[None, :, :] - ring_keys[q][:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)                          # (Q, N)
    ids = torch.arange(N, device=ring_keys.device)
    eligible = (ids[None, :] <= q[:, None] - cfg.num_exclude_recent) & (ids < n_valid)
    d2 = torch.where(eligible, d2, float("inf"))
    k = min(cfg.num_candidates, N)
    cand = torch.sort(d2, dim=-1, stable=True)[1][:, :k]          # (Q, k)
    cand_ok = torch.isfinite(torch.gather(d2, -1, cand))

    dists, shifts = pair_distance(
        descriptors[q][:, None], descriptors[cand], positions[q][:, None],
        positions[cand], distances[q][:, None], distances[cand], cfg)
    dists = torch.where(cand_ok, dists, float("inf"))
    best = torch.argmin(dists, dim=-1, keepdim=True)
    min_dist = torch.gather(dists, -1, best)[:, 0]
    # deg2rad in float32, as ``jnp.deg2rad`` forms it
    unit = np.float32(cfg.unit_sector_angle_deg) * np.float32(np.pi / 180.0)
    yaw = torch.gather(shifts, -1, best)[:, 0].to(torch.float32) * float(unit)
    match = torch.where(min_dist < cfg.dist_threshold,
                        torch.gather(cand, -1, best)[:, 0], -1)
    return LoopCandidate(match_id=match, yaw_rad=yaw, distance=min_dist)
