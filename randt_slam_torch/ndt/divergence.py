"""Cauchy-Schwarz divergence between two NDT mixtures, batched.

Port of ``randt_slam_tpu/ndt/divergence.py`` (``Map::calculateCSDivergence``,
``ndt_map.cpp:42-99``): the reference's nested loops become masked all-pairs
Gaussian-overlap sums.  The self-similarity term of each map is invariant
under rigid transforms, so it is exposed on its own (:func:`self_term`) and
computed once per submap and per scan; only :func:`interaction_term` depends
on the candidate loop transform.

The reference's constants are kept: the ``0.5/sqrt(pi^2 det(S))`` overlap
normalisation (``ndt_map.cpp:64``) and the ``det(cov) < 1e-5`` gate on
degenerate cells (``ndt_map.cpp:55,68,83``).  Every function broadcasts over
leading (candidate) dimensions.
"""

from __future__ import annotations

import math

import torch

from . import cells as C

_DET_GATE = 1e-5
# Rows of the self-term pair sum per chunk.  At the Oxford submap capacity
# (4096 cells) a (rows, 4096, 3, 3) float32 block would be 151 MB at 1024
# rows; the overlap forms only the six pooled-covariance entries that the
# adjugate solve reads, (rows, 4096) each (16.8 MB), and the chunk's
# temporaries stay at a few hundred MB.
ROW_CHUNK = 1024


def _safe_cells(mean, cov, valid):
    """Benign values for invalid (padded) cells, so masked terms never make
    inf/NaN through exp/log (inf * 0 == NaN)."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    v = valid[..., None]
    return torch.where(v, mean, 0.0), torch.where(v[..., None], cov, eye)


def _overlap(mu_a, cov_a, mu_b, cov_b):
    """Pairwise Gaussian overlap 0.5/sqrt(pi^2 det(S)) exp(-0.5 d^T S^-1 d),
    S = cov_a + cov_b, over broadcast (..., 3) / (..., 3, 3) inputs.

    The Mahalanobis exponent is clamped to [0, 120] (it is >= 0 for PSD
    covariances; degenerate float32 cells can go indefinite) and the
    determinant floored at 1e-30."""
    d = [mu_a[..., i] - mu_b[..., i] for i in range(3)]
    quad, det = C.pooled_quad_det(cov_a, cov_b, d)
    expo = torch.clamp(quad, 0.0, 120.0)
    det = torch.clamp(det, min=1e-30)
    return 0.5 / torch.sqrt(math.pi * math.pi * det) * torch.exp(-0.5 * expo)


def interaction_term(f_mean, f_cov, f_valid, m_mean, m_cov, m_valid):
    """Sum of the overlaps of every (gated) fixed cell with every moving
    cell: f_* (..., F, ...), m_* (..., M, ...) -> (...,).  Only fixed cells
    pass the determinant gate (the reference gates the outer loop only,
    ``ndt_map.cpp:55``)."""
    f_ok = f_valid & (C.det3(f_cov) >= _DET_GATE)
    f_mean, f_cov = _safe_cells(f_mean, f_cov, f_ok)
    m_mean, m_cov = _safe_cells(m_mean, m_cov, m_valid)
    g = _overlap(f_mean[..., :, None, :], f_cov[..., :, None, :, :],
                 m_mean[..., None, :, :], m_cov[..., None, :, :, :])
    w = (f_ok[..., :, None] & m_valid[..., None, :]).to(g.dtype)
    return torch.sum(g * w, dim=(-2, -1))


def self_term(mean, cov, valid, row_chunk: int = ROW_CHUNK):
    """Self-similarity of one map, sum_i sqrt(det(cov_i^-1))/(2 pi)
    + 2 sum_{j<i} overlap(i, j) over determinant-gated cells
    (``ndt_map.cpp:71-79``); (..., n, ...) -> (...,).

    Maps of more than ``row_chunk`` cells sum the pairs in row chunks, so the
    (n, n) pair tensors never materialise (at the Oxford submap capacity of
    4096 cells they would take tens of GB)."""
    ok = valid & (C.det3(cov) >= _DET_GATE)
    det = torch.clamp(C.det3(cov), min=1e-30)
    diag = torch.sum(torch.where(ok, torch.sqrt(1.0 / det) / (2.0 * math.pi), 0.0),
                     dim=-1)
    mean, cov = _safe_cells(mean, cov, ok)
    n = mean.shape[-2]
    rows = torch.arange(n, device=mean.device)
    pair_sum = None
    for lo in range(0, n, row_chunk):
        hi = min(lo + row_chunk, n)
        g = _overlap(mean[..., lo:hi, None, :], cov[..., lo:hi, None, :, :],
                     mean[..., None, :, :], cov[..., None, :, :, :])
        lower = rows[lo:hi, None] > rows[None, :]
        w = (ok[..., lo:hi, None] & ok[..., None, :] & lower).to(g.dtype)
        part = torch.sum(g * w, dim=(-2, -1))
        pair_sum = part if pair_sum is None else pair_sum + part
    return diag + 2.0 * pair_sum


def cs_divergence(f_mean, f_cov, f_valid, m_mean, m_cov, m_valid,
                  f_self=None, m_self=None):
    """CS divergence of the two mixtures; precomputed self terms skip the
    O(n^2) self-similarity work (they are pose-invariant)."""
    inter = interaction_term(f_mean, f_cov, f_valid, m_mean, m_cov, m_valid)
    if f_self is None:
        f_self = self_term(f_mean, f_cov, f_valid)
    if m_self is None:
        m_self = self_term(m_mean, m_cov, m_valid)
    eps = 1e-30
    return (-torch.log(torch.clamp(inter, min=eps))
            + 0.5 * torch.log(torch.clamp(f_self, min=eps))
            + 0.5 * torch.log(torch.clamp(m_self, min=eps)))
