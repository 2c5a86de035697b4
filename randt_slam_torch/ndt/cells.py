"""Intensity-augmented NDT cells as sufficient statistics.

Port of ``randt_slam_tpu/ndt/cells.py``.  Every cell is kept in
sufficient-statistic form

    n   = number of points
    s   = sum of points p_i            (3,)   [x, y, intensity]
    ss  = sum of outer products p p^T  (3, 3)

so that cell creation is a segment sum, merging is an add and rigid
transforms are closed-form.  Mean/covariance are derived on demand
(``mean = s / n``, ``cov = ss / n - mean mean^T``, ``ndt_cell.cpp:65``), with
the eigenvalue regularization (``ndt_cell.cpp:102-112``) applied when the
covariance is read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import runtime
from ..geometry import rotmat
from ..utils import profiling


class CellStats(NamedTuple):
    """Batch of NDT cells in sufficient-statistic form.

    n:  (...,)       point counts (float32; 0 == empty slot)
    s:  (..., 3)     sum of [x, y, intensity]
    ss: (..., 3, 3)  sum of outer products
    """

    n: torch.Tensor
    s: torch.Tensor
    ss: torch.Tensor


def zeros(shape, dtype=torch.float32, device=None) -> CellStats:
    shape = tuple(shape)
    return CellStats(
        n=torch.zeros(shape, dtype=dtype, device=device),
        s=torch.zeros(shape + (3,), dtype=dtype, device=device),
        ss=torch.zeros(shape + (3, 3), dtype=dtype, device=device),
    )


def _unpack(out) -> CellStats:
    return CellStats(n=out[..., 0], s=out[..., 1:4],
                     ss=out[..., 4:13].reshape(out.shape[:-1] + (3, 3)))


def from_points(points, mask, segment_ids, num_segments,
                polar=None, beam_cov=None) -> CellStats:
    """Accumulate masked points into cells by segment id: all 13 moment
    channels in one segment sum (kernel K5 on CUDA tensors, its plain
    version on CPU tensors).

    points: (P, 3) [x, y, intensity]; mask: (P,) bool; segment_ids: (P,) int.
    Ids outside [0, num_segments) are dropped.  ``polar``/``beam_cov`` add the
    pNDT sensor-noise covariance (``ndt_cell.cpp:68-82``).
    """
    from ..ops.segment_moments import segment_moments

    chans = _moment_channels(points, mask, polar, beam_cov)
    return _unpack(segment_moments(chans, segment_ids, num_segments))


@profiling.span("randt.scan_ndt")
def from_points_compact(points, mask, segment_ids, num_segments, k,
                        polar=None, beam_cov=None):
    """:func:`from_points` + :func:`compact` fused: moments only for the ``k``
    most-populated segments (kernel K2).  Returns (CellStats (..., k), ids
    (..., k)); a leading batch axis on the points (..., P) gives each scan
    its own cells."""
    from ..ops.segment_moments import segment_topk_moments

    chans = _moment_channels(points, mask, polar, beam_cov)
    out, topi = segment_topk_moments(chans, segment_ids, num_segments, k)
    return _unpack(out), topi


def _moment_channels(points, mask, polar=None, beam_cov=None):
    """Per-point 13-channel moment vector [w | w·p | (w·ppᵀ + w·noise)],
    points (..., P, 3) -> (..., P, 13)."""
    w = mask.to(points.dtype)
    pts = points * w[..., None]
    outer = pts[..., :, None] * points[..., None, :]
    if polar is not None:
        a, r = polar[..., 0], polar[..., 1]
        sa, ca = torch.sin(a), torch.cos(a)
        zero = torch.zeros_like(a)
        one = torch.ones_like(a)
        J = torch.stack(
            [
                torch.stack([-r * sa, ca, zero], dim=-1),
                torch.stack([r * ca, sa, zero], dim=-1),
                torch.stack([zero, zero, one], dim=-1),
            ],
            dim=-2,
        )
        B = runtime.const(beam_cov, points.dtype, points.device)
        pcov = torch.einsum("pij,jk,plk->pil", J.reshape(-1, 3, 3), B,
                            J.reshape(-1, 3, 3)).reshape(J.shape)
        outer = outer + pcov * w[..., None, None]
    return torch.cat([w[..., None], pts, outer.reshape(w.shape + (9,))], dim=-1)


def merge(a: CellStats, b: CellStats) -> CellStats:
    """Exact pooled merge (replaces ``Cell::operator+=``)."""
    return CellStats(n=a.n + b.n, s=a.s + b.s, ss=a.ss + b.ss)


def mean(c: CellStats):
    n = torch.clamp(c.n, min=1.0)
    return c.s / n[..., None]


def raw_cov(c: CellStats):
    """Biased covariance ss/n - mean mean^T (no regularization)."""
    mu = mean(c)
    n = torch.clamp(c.n, min=1.0)
    return c.ss / n[..., None, None] - mu[..., :, None] * mu[..., None, :]


def regularize_cov(cov, eig_floor_ratio=0.001, intensity_jitter=1e-6):
    """Eigenvalue-floor regularization of the 2x2 position block
    (``ndt_cell.cpp:102-112``) by the closed-form symmetric 2x2 eigen
    decomposition, plus additive jitter on the diagonal."""
    a = cov[..., 0, 0]
    b = cov[..., 0, 1]
    d = cov[..., 1, 1]
    tr = a + d
    diff = a - d
    root = torch.sqrt(torch.clamp(diff * diff + 4.0 * b * b, min=0.0))
    lam_hi = 0.5 * (tr + root)
    lam_lo = 0.5 * (tr - root)
    lam_lo_reg = torch.maximum(lam_lo, eig_floor_ratio * lam_hi)

    # Eigenvector for lam_hi: v = [b, lam_hi - a] (or [lam_hi - d, b]).
    v1 = torch.stack([b, lam_hi - a], dim=-1)
    v2 = torch.stack([lam_hi - d, b], dim=-1)
    use_v2 = torch.sum(v1 * v1, dim=-1, keepdim=True) < torch.sum(
        v2 * v2, dim=-1, keepdim=True)
    v = torch.where(use_v2, v2, v1)
    nrm = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True),
                                 min=1e-30))
    iso = nrm[..., 0] < 1e-15  # isotropic: any unit vector works
    unit_x = torch.zeros_like(v)
    unit_x[..., 0] = 1.0
    v = torch.where(iso[..., None], unit_x, v / nrm)
    vx, vy = v[..., 0], v[..., 1]

    # Reassemble: lam_hi v v^T + lam_lo_reg v_perp v_perp^T.
    p00 = lam_hi * vx * vx + lam_lo_reg * vy * vy
    p01 = (lam_hi - lam_lo_reg) * vx * vy
    p11 = lam_hi * vy * vy + lam_lo_reg * vx * vx

    out = cov.clone()
    out[..., 0, 0] = p00 + intensity_jitter
    out[..., 0, 1] = p01
    out[..., 1, 0] = p01
    out[..., 1, 1] = p11 + intensity_jitter
    out[..., 2, 2] = cov[..., 2, 2] + intensity_jitter
    return out


def mean_cov(c: CellStats, eig_floor_ratio=0.001, intensity_jitter=1e-6,
             use_pndt=False):
    """Derived (mean, regularized covariance) pair.  With pNDT the reference
    skips the eigenvalue floor (``ndt_cell.cpp:102``); a tiny diagonal jitter
    is still applied for float32 solve stability."""
    mu = mean(c)
    cov = raw_cov(c)
    if use_pndt:
        eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
        return mu, cov + intensity_jitter * eye
    return mu, regularize_cov(cov, eig_floor_ratio, intensity_jitter)


def valid_mask(c: CellStats, min_points_per_cell: int):
    """A distribution exists iff n > min_points_per_cell (``ndt_cell.cpp:37``)."""
    return c.n > float(min_points_per_cell)


def _rigid3(pose):
    """(A (..., 3, 3), t3 (..., 3)) with A = [[R, 0], [0, 1]], t3 = [tx, ty, 0]."""
    R = rotmat(pose[..., 2])
    z = torch.zeros(pose.shape[:-1] + (2, 1), dtype=pose.dtype, device=pose.device)
    bot = torch.zeros(pose.shape[:-1] + (1, 3), dtype=pose.dtype, device=pose.device)
    bot[..., 0, 2] = 1.0
    A = torch.cat([torch.cat([R, z], dim=-1), bot], dim=-2)
    t3 = torch.cat([pose[..., :2], z[..., 0, :]], dim=-1)
    return A, t3


def transform(c: CellStats, pose) -> CellStats:
    """Rigid SE(2) transform of cells (intensity untouched), on sufficient
    statistics (``Cell::transformCell``, ``ndt_cell.cpp:117-136``):
        s'  = A s + n t3
        ss' = A ss A^T + A s t3^T + t3 s^T A^T + n t3 t3^T
    Broadcasts pose (..., 3) over the cell batch (..., C)."""
    A, t3 = _rigid3(pose)
    t_ = t3[..., None, :]
    As = torch.einsum("...ij,...cj->...ci", A, c.s)
    s_new = As + c.n[..., None] * t_
    ss_new = (
        torch.einsum("...ij,...cjk,...lk->...cil", A, c.ss, A)
        + As[..., :, None] * t_[..., None, :]
        + t_[..., :, None] * As[..., None, :]
        + c.n[..., None, None] * (t_[..., :, None] * t_[..., None, :])
    )
    return CellStats(n=c.n, s=s_new, ss=ss_new)


def transform_set(c: CellStats, pose) -> CellStats:
    """One set of cells (..., C) moved by its one pose (..., 3)."""
    m = transform(CellStats(c.n.unsqueeze(-2), c.s.unsqueeze(-3),
                            c.ss.unsqueeze(-4)), pose.unsqueeze(-2))
    return CellStats(m.n.squeeze(-2), m.s.squeeze(-3), m.ss.squeeze(-4))


def compact(c: CellStats, k: int):
    """Keep the k most-populated cells, lower index first among equal counts
    (the order of ``lax.top_k``).  Returns (CellStats (k,), order_idx)."""
    idx = torch.sort(c.n, descending=True, stable=True)[1][:k]
    return CellStats(n=c.n[idx], s=c.s[idx], ss=c.ss[idx]), idx


def mahalanobis_sq_position(mu_a, cov_a, mu_b, cov_b):
    """2-D position-block L2 distance between two distributions
    (``Cell::mahalanobisSquared``, ``ndt_cell.cpp:165-170``)."""
    dx = mu_b[..., 0] - mu_a[..., 0]
    dy = mu_b[..., 1] - mu_a[..., 1]
    s00 = cov_a[..., 0, 0] + cov_b[..., 0, 0]
    s01 = cov_a[..., 0, 1] + cov_b[..., 0, 1]
    s11 = cov_a[..., 1, 1] + cov_b[..., 1, 1]
    det = s00 * s11 - s01 * s01
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    return (s11 * dx * dx - 2.0 * s01 * dx * dy + s00 * dy * dy) / det


def mahalanobis_sq_intensity(mu_a, cov_a, mu_b, cov_b):
    """(mu_b - mu_a)^T (cov_a + cov_b)^{-1} (mu_b - mu_a)
    (``Cell::mahalanobisSquaredIntensity``, ``ndt_cell.cpp:172-176``)."""
    d = mu_b - mu_a
    S = cov_a + cov_b
    sol = solve3(S, d)
    return torch.sum(d * sol, dim=-1)


def solve3(S, d):
    """Batched 3x3 symmetric solve via the adjugate."""
    a, b, e = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    c_, f = S[..., 1, 1], S[..., 1, 2]
    g = S[..., 2, 2]
    A = c_ * g - f * f
    B = e * f - b * g
    C = b * f - c_ * e
    det = a * A + b * B + e * C
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    D = a * g - e * e
    E = b * e - a * f
    F = a * c_ - b * b
    x = (A * d[..., 0] + B * d[..., 1] + C * d[..., 2]) / det
    y = (B * d[..., 0] + D * d[..., 1] + E * d[..., 2]) / det
    z = (C * d[..., 0] + E * d[..., 1] + F * d[..., 2]) / det
    return torch.stack([x, y, z], dim=-1)


def pooled_quad_det(cov_a, cov_b, d):
    """``(d^T S^-1 d, det S)`` for S = cov_a + cov_b, broadcasting (..., 3, 3)
    covariances and a 3-list of (...) components of d.  The six entries of S
    that the adjugate solve reads are formed one by one, so broadcasting a
    (Q, 1) batch against a (1, F) one builds no (Q, F, 3, 3) tensor; the
    arithmetic is :func:`solve3` and :func:`det3`'s."""
    def e(i, j):
        return cov_a[..., i, j] + cov_b[..., i, j]

    a, b, e_ = e(0, 0), e(0, 1), e(0, 2)
    c_, f = e(1, 1), e(1, 2)
    g = e(2, 2)
    A = c_ * g - f * f
    B = e_ * f - b * g
    Cc = b * f - c_ * e_
    det = a * A + b * B + e_ * Cc
    dsafe = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    D = a * g - e_ * e_
    E = b * e_ - a * f
    F = a * c_ - b * b
    x = (A * d[0] + B * d[1] + Cc * d[2]) / dsafe
    y = (B * d[0] + D * d[1] + E * d[2]) / dsafe
    z = (Cc * d[0] + E * d[1] + F * d[2]) / dsafe
    return d[0] * x + d[1] * y + d[2] * z, det


def det3(S):
    a, b, e = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    c_, f = S[..., 1, 1], S[..., 1, 2]
    g = S[..., 2, 2]
    return a * (c_ * g - f * f) + b * (e * f - b * g) + e * (b * f - c_ * e)


def inv3(S):
    """Batched symmetric 3x3 inverse via the adjugate."""
    a, b, e = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    c_, f = S[..., 1, 1], S[..., 1, 2]
    g = S[..., 2, 2]
    A = c_ * g - f * f
    B = e * f - b * g
    C = b * f - c_ * e
    det = a * A + b * B + e * C
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    D = a * g - e * e
    E = b * e - a * f
    F = a * c_ - b * b
    row0 = torch.stack([A, B, C], dim=-1)
    row1 = torch.stack([B, D, E], dim=-1)
    row2 = torch.stack([C, E, F], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) / det[..., None, None]
