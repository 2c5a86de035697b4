"""Batched occupancy raytracing into per-submap counting grids.

Port of ``randt_slam_tpu/mapping/raytrace.py``, the counterpart of
``HierarchicalMap::raytraceLine`` / ``bresenham2D``
(``RS/src/ndt_representation/ndt_hierarchical_map.cpp:87-149``): every beam
is traced at once, the integer Bresenham recurrence evaluated in closed form
per step, so the cells match the reference's exactly (free space -1 per
traversed cell, +2 at the hit cell, :126-149).

The counts are int32 and the scatter adds integers, exact in any order.  The
float geometry before the integer walk is made the same on every device:
cos and sin are taken in float64 and rounded (:func:`cos_sin`), and every
division is by a tensor on the device, because CUDA divides a tensor by a
host scalar as a product with its reciprocal.  So a grid traced on the card
equals the one traced on the CPU bit for bit.
"""

from __future__ import annotations

import torch

from .. import runtime

# beams x steps per traced chunk: the (chunk, max_steps) int32 index tensors
# stay at 32 MB each
CHUNK_ELEMENTS = 1 << 23


def cos_sin(theta):
    """cos and sin of ``theta`` in float64, rounded to its dtype: correctly
    rounded (barring a double rounding), so the same on every device."""
    t = theta.double()
    return torch.cos(t).to(theta.dtype), torch.sin(t).to(theta.dtype)


def divide(x, v: float):
    """``x / v`` by true division on every device (``v`` as a device
    tensor: a host scalar divisor is a reciprocal product on CUDA)."""
    return x / runtime.const(v, x.dtype, x.device)


def ray_cells(origin_xy, angle, rng, res, size_x, size_y, max_steps: int):
    """Trace rays into grid cells -- the EXACT integer Bresenham walk.

    origin_xy (B, 2), angle (B,), rng (B,).  Replicates
    ``raytraceLine``/``bresenham2D`` cell for cell
    (``ndt_hierarchical_map.cpp:92-149``): origin cell from truncation of
    (o/res + size/2), displacement from truncation of ((end - origin)/res),
    then the minor-axis progression in closed form,
        b(i) = (abs_da/2 + i * abs_db) // abs_da,
    which equals the reference's incremental error accumulator.  Returns
    (flat_idx (B, S) int32, free_mask (B, S), end_idx (B,), end_ok (B,)).
    """
    c, s = cos_sin(angle)
    ox, oy = origin_xy[:, 0], origin_xy[:, 1]
    ex = ox + c * rng
    ey = oy + s * rng
    i32 = torch.int32
    x0 = torch.trunc(divide(ox, res) + size_x / 2).to(i32)
    y0 = torch.trunc(divide(oy, res) + size_y / 2).to(i32)
    dx = torch.trunc(divide(ex - ox, res)).to(i32)
    dy = torch.trunc(divide(ey - oy, res)).to(i32)

    abs_dx, abs_dy = dx.abs(), dy.abs()
    x_major = abs_dx >= abs_dy
    abs_da = torch.where(x_major, abs_dx, abs_dy)
    abs_db = torch.where(x_major, abs_dy, abs_dx)
    sa = torch.where(x_major, dx.sign(), dy.sign())
    sb = torch.where(x_major, dy.sign(), dx.sign())

    # ray-length cap (``raytraceLine`` scale, :105-106; max_length = 2*range
    # never binds in practice but is reproduced).  The JAX package takes the
    # hypot; dx and dy are integers, so the square root of the exact sum of
    # squares is the same value, correctly rounded on every device.
    fdx, fdy = dx.to(rng.dtype), dy.to(rng.dtype)
    dist = torch.sqrt(fdx * fdx + fdy * fdy)
    max_len_cells = divide(2.0 * rng, res)
    safe = torch.where(dist == 0.0, torch.ones_like(dist), dist)
    scale = torch.where(dist == 0.0, torch.ones_like(dist),
                        torch.clamp(max_len_cells / safe, max=1.0))
    end_steps = torch.trunc(scale * abs_da.to(rng.dtype)).to(i32)

    n = torch.minimum(end_steps, abs_da)[:, None]
    i = torch.arange(max_steps, dtype=i32, device=rng.device)[None, :]
    live = i < n
    da_safe = torch.clamp(abs_da, min=1)[:, None]
    half = (abs_da // 2)[:, None]
    b = (half + i * abs_db[:, None]) // da_safe      # minor-axis progression
    xm = x_major[:, None]
    ix = torch.where(xm, x0[:, None] + i * sa[:, None], x0[:, None] + b * sb[:, None])
    iy = torch.where(xm, y0[:, None] + b * sb[:, None], y0[:, None] + i * sa[:, None])
    inb = (ix >= 0) & (ix < size_x) & (iy >= 0) & (iy < size_y)
    flat = iy * size_x + ix

    # hit cell = position after the final step (the reference's post-loop +2)
    b_end = (half + n * abs_db[:, None]) // da_safe
    eix = torch.where(xm, x0[:, None] + n * sa[:, None], x0[:, None] + b_end * sb[:, None])[:, 0]
    eiy = torch.where(xm, y0[:, None] + b_end * sb[:, None], y0[:, None] + n * sa[:, None])[:, 0]
    end_ok = (eix >= 0) & (eix < size_x) & (eiy >= 0) & (eiy < size_y)
    end_idx = eiy * size_x + eix
    free = live & inb & (flat != end_idx[:, None])
    return flat, free, end_idx, end_ok


def raytrace_beams(counts, poses, beams, beam_valid, res, max_steps=512):
    """A counting grid with a batch of beams scattered into it.

    counts: (H, W) int32 counting grid (submap-local frame)
    poses:  (B, 3) sensor poses in the submap frame per beam
    beams:  (B, 3) [angle, range, intensity] in the sensor frame
            (the per-azimuth max detections, ``local_fuser.cpp:184-187``)

    The beams are traced in chunks of ``CHUNK_ELEMENTS // max_steps``.
    """
    H, W = counts.shape
    out = counts.reshape(-1).clone()
    chunk = max(1, CHUNK_ELEMENTS // max_steps)
    for lo in range(0, poses.shape[0], chunk):
        p, bm = poses[lo:lo + chunk], beams[lo:lo + chunk]
        ok = beam_valid[lo:lo + chunk]
        flat, free, end_idx, end_ok = ray_cells(
            p[:, :2], p[:, 2] + bm[:, 0], bm[:, 1], res, W, H, max_steps)
        idx = flat[ok[:, None] & free]
        out.index_add_(0, idx, torch.full_like(idx, -1))
        hit = end_idx[ok & end_ok]
        out.index_add_(0, hit, torch.full_like(hit, 2))
    return out.reshape(H, W)
