"""ScanContext loop-closure descriptors.

Port of the descriptor part of ``randt_slam_tpu/loops/scancontext.py``
(``Scancontext.cpp`` with RaNDT's radar modification: bins ACCUMULATE
intensity * intensity_factor, ``makeScancontext`` :156-203).  The front end
emits one descriptor per frame; retrieval and scoring (loop closure) are not
ported yet.

Reference quirk reproduced on purpose: bins start at NO_POINT = -1000 and
z is ADDED, so occupied bins carry (sum_z - 1000)
(``legacy_no_point_offset``).
"""

from __future__ import annotations

import math

import torch

from .. import runtime
from ..config import ScanContextConfig

NO_POINT = -1000.0


def _remainder(x, y: float):
    """Floor-mod with the sign of ``y``, formed as ``jnp.remainder`` forms it
    (exact ``fmod``, then one correction) so bin edges fall identically."""
    r = torch.fmod(x, y)
    fix = (r != 0) & ((r < 0) != (y < 0))
    return torch.where(fix, r + y, r)


@torch.profiler.record_function("randt.descriptor")
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
