"""Global occupancy-grid assembly from per-submap counting grids.

Port of ``randt_slam_tpu/mapping/ogm.py``, the counterpart of
``MasterMap::getOGM`` (``RS/src/ndt_representation/ndt_master_map.cpp:
20-106``), which loops over submaps resampling each counting grid into the
global grid through an std::map of increments.  Here:

* 4-sample anti-aliased resampling per submap cell (:22-36,60-63);
* per submap and target cell, the max-|count| increment (:65-67), as a
  signed scatter-max pair (``scatter_reduce_`` with ``"amax"``: a max is the
  same in any order, so the result is exact);
* the sum of the increments over submaps (:72-77), integers in float32;
* the smoothstep count -> occupancy mapping (:97-103).

Also the submap-local OGM (``HierarchicalMap::getOGM``,
``ndt_hierarchical_map.cpp:40-66``).  The geometry uses the trig and the
true division of ``mapping/raytrace.py``, so the grids are the same on
every device.
"""

from __future__ import annotations

import torch

from ..geometry import normalize_angle
from .raytrace import cos_sin, divide


def compose(a, b):
    """SE(2) composition a*b, ``geometry.compose`` with :func:`cos_sin`."""
    ca, sa = cos_sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    return torch.stack([x, y, normalize_angle(a[..., 2] + b[..., 2])], dim=-1)


def inverse(a):
    """SE(2) inverse, ``geometry.inverse`` with :func:`cos_sin`."""
    c, s = cos_sin(a[..., 2])
    x = -(c * a[..., 0] + s * a[..., 1])
    y = -(-s * a[..., 0] + c * a[..., 1])
    return torch.stack([x, y, normalize_angle(-a[..., 2])], dim=-1)


def _smoothstep(counts, offset, top):
    z = divide(torch.clamp(offset + 0.1 * counts.to(torch.float32), 0.0, top), top)
    z2 = z * z
    return 100.0 * (-2.0 * (z2 * z) + 3.0 * z2)


def submap_occupancy(counts):
    """Submap-local OGM (``ndt_hierarchical_map.cpp:59-64``):
    zeta = clamp(2 + 0.1 c, 0, 4); occ = 100 (-2 (z/4)^3 + 3 (z/4)^2)."""
    return _smoothstep(counts, 2.0, 4.0)


def global_occupancy(counts_sum, unknown_mask=None):
    """Global OGM mapping (``ndt_master_map.cpp:97-103``):
    zeta = clamp(5 + 0.1 c, 0, 10); occ = 100 (-2 (z/10)^3 + 3 (z/10)^2);
    untouched cells are -1 (unknown)."""
    occ = _smoothstep(counts_sum, 5.0, 10.0)
    if unknown_mask is None:
        unknown_mask = counts_sum == 0
    return torch.where(unknown_mask, torch.full_like(occ, -1.0), occ)


_OFFSETS = ((-0.25, -0.25), (-0.25, 0.25), (0.25, -0.25), (0.25, 0.25))


def _submap_increments(counts, origin_rel, sub_res, glob_res, gh, gw):
    """Resample one submap counting grid into global-grid increments.

    counts: (sh, sw) submap counting grid; origin_rel: (3,) pose of the
    submap OGM origin in the global OGM-origin frame.  Returns (gh*gw,)
    increments by the 4-sample max-|count| rule.  Only the cells with a
    count are resampled: a zero count adds nothing to either max.
    """
    sw = counts.shape[1]
    cell = torch.nonzero(counts.reshape(-1)).reshape(-1)
    c = counts.reshape(-1)[cell].to(torch.float32)
    # submap-local cell positions (cell corner, matching :55-58)
    lx = (cell % sw).to(torch.float32) * sub_res
    ly = (cell // sw).to(torch.float32) * sub_res
    co, si = cos_sin(origin_rel[2])
    # the rotation as the JAX package's (M, 2) @ R^T, term by term
    bx = lx * co + ly * (-si) + origin_rel[0]
    by = lx * si + ly * co + origin_rel[1]
    pos_max = c.new_zeros(gh * gw + 1)
    neg_max = c.new_zeros(gh * gw + 1)
    for ox, oy in _OFFSETS:
        # the sample offset is applied in the submap frame (:60-63)
        offx, offy = ox * glob_res, oy * glob_res
        px = bx + (offx * co + offy * (-si))
        py = by + (offx * si + offy * co)
        gx = torch.floor(divide(px, glob_res)).to(torch.int64)
        gy = torch.floor(divide(py, glob_res)).to(torch.int64)
        ok = (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
        flat = torch.where(ok, gy * gw + gx, gh * gw)
        zero = torch.zeros_like(c)
        pos_max.scatter_reduce_(0, flat, torch.where(ok, c, zero), "amax")
        neg_max.scatter_reduce_(0, flat, torch.where(ok, -c, zero), "amax")
    inc = torch.where(pos_max >= neg_max, pos_max, -neg_max)
    return inc[: gh * gw]


def fuse_submaps(submap_counts, submap_origins, sub_res, glob_res,
                 global_origin, gh, gw):
    """Sum of the resampled increments over all submaps (``:40-79``).

    submap_counts: (NS, sh, sw); submap_origins: (NS, 3) global poses of each
    submap's OGM origin; global_origin: (3,) pose of the global OGM origin.
    Returns (gh, gw) float32.
    """
    rel = compose(inverse(global_origin).expand_as(submap_origins), submap_origins)
    total = submap_origins.new_zeros(gh * gw)
    for counts, o in zip(submap_counts, rel):
        total = total + _submap_increments(counts, o, sub_res, glob_res, gh, gw)
    return total.reshape(gh, gw)
