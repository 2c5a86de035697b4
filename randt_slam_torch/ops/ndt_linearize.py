"""Fused NDT linearization and robust cost of the window smoother (kernels
K3a and K3b, ``csrc/ndt_linearize.cu``).

Port of ``randt_slam_tpu/ops/ndt_linearize.py``.  One LM iteration of
``registration/matcher.estimate_window`` needs, per window slot, over its N
(moving cell, fixed map, neighbour) pairs:

* the intensity-augmented D2D residual r = sqrt(max(d^T S^-1 d, eps)) with
  S = R Sigma_m R^T + Sigma_f and d = R mu_m + t - mu_f
  (``residuals.ndt_residual_sq``);
* its analytic Jacobian in (tx, ty, theta):
  dr2/dt = 2 q_xy and dr2/dtheta = 2 q . d_theta - q^T (dS/dtheta) q, with
  q = S^-1 d, d_theta = (-v, u, 0), (u, v) the rotated moving mean;
* the Barron IRLS weight rho'(r^2) (``registration/barron.weight``);
* the sums H = J^T W J (3x3), g = J^T W r (3) and the robust cost sum rho.

K3a (:func:`linearize`) returns all of them; K3b (:func:`robust_cost`) only
the cost sum and the largest squared residual (the LM trial cost and the
GNC mu initialisation).  Only the 3-D (``use_intensity_as_dimension``)
residual has a kernel; the matcher keeps the autograd path for the 2-D one.

Layout: pairs are packed channels-first once per frame by
:func:`pack_pairs`, (W, ch, N) with N = F*C*K in the row-major order of
(F, C, K), covariances as their 6 unique components ``SYM6``.

A leading batch axis is optional: poses (B, W, 3), packs (B, W, ch, N),
``mu`` and ``ndt_scale`` (B,) give (B, W, ...) blocks and (B,) cost sums,
maxima and rho sums, each over its own member's W slots, in one launch of
B * W slots.

On a CUDA tensor :func:`linearize`/:func:`robust_cost` launch the kernels;
on a CPU tensor they run :func:`linearize_plain`/:func:`robust_cost_plain`,
the same formulas as vectorised tensor code (no autograd), so that the CPU
tests hold the kernels' own math.  ``mu`` and ``ndt_scale`` are device
tensors and go to the kernels by pointer: reading them on the host would
wait on the device inside the LM loop.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..registration import barron
from ..utils import profiling
from . import build

SYM6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def pack_pairs(m_mean, m_cov, a_mean, a_cov, valid, slot_dims: int = 1):
    """(*S, ..., 3) / (*S, ..., 3, 3) / (*S, ...) bool -> channels-first pack,
    with ``S`` the first ``slot_dims`` dims ((W,), or (B, W) for a batch).

    Returns contiguous (m_mean3, m_cov6, a_mean3, a_cov6, valid1), each
    (*S, ch, N) float32; broadcast (expanded) inputs are materialised here.
    """
    S = m_mean.shape[:slot_dims]
    mm = m_mean.reshape(S + (-1, 3))
    am = a_mean.reshape(S + (-1, 3))
    mc = m_cov.reshape(S + (-1, 3, 3))
    ac = a_cov.reshape(S + (-1, 3, 3))
    v = valid.reshape(S + (-1,))

    def sym(c):
        return torch.stack([c[..., i, j] for (i, j) in SYM6], dim=slot_dims)

    return (
        mm.transpose(-1, -2).contiguous(),          # (*S, 3, N)
        sym(mc),                                     # (*S, 6, N)
        am.transpose(-1, -2).contiguous(),          # (*S, 3, N)
        sym(ac),                                     # (*S, 6, N)
        v[..., None, :].to(torch.float32).contiguous(),  # (*S, 1, N)
    )


def pose_inputs(poses):
    """(..., W, 3) poses -> (..., W, 4) [tx, ty, cos, sin], as the JAX
    package forms them outside its kernel."""
    th = poses[..., 2]
    return torch.stack([poses[..., 0], poses[..., 1], torch.cos(th),
                        torch.sin(th)], dim=-1).contiguous()


def _per_slot(x):
    """A per-member scalar (...) broadcast against (..., W, N) terms."""
    return x[..., None, None]


def _pair_terms(c, s, tx, ty, mm, mc, am, ac):
    """Shared per-pair math over (..., W, N); c, s, tx, ty are (..., W, 1).

    Returns (r2, q0, q1, q2, dth0, dth1, dS) with dS the 5 nonzero
    components of dS/dtheta.  The same expansion as ``ndt_residual_sq``.
    """
    mx, my, mi = mm.unbind(-2)
    a, b, e, cc, f, g = mc.unbind(-2)
    fx, fy, fi = am.unbind(-2)
    f00, f01, f02, f11, f12, f22 = ac.unbind(-2)

    u = c * mx - s * my
    v = s * mx + c * my
    d0 = u + tx - fx
    d1 = v + ty - fy
    d2 = mi - fi

    # S = R Sigma_m R^T + Sigma_f
    r00 = c * (c * a - s * b) - s * (c * b - s * cc)
    r01 = c * (s * a + c * b) - s * (s * b + c * cc)
    r11 = s * (s * a + c * b) + c * (s * b + c * cc)
    r02 = c * e - s * f
    r12 = s * e + c * f
    s00 = r00 + f00
    s01 = r01 + f01
    s02 = r02 + f02
    s11 = r11 + f11
    s12 = r12 + f12
    s22 = g + f22

    # q = S^-1 d via the adjugate; |det| < 1e-30 (a small negative det too)
    # becomes +1e-30
    A = s11 * s22 - s12 * s12
    B = s02 * s12 - s01 * s22
    C = s01 * s12 - s11 * s02
    det = s00 * A + s01 * B + s02 * C
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    D = s00 * s22 - s02 * s02
    E = s01 * s02 - s00 * s12
    F = s00 * s11 - s01 * s01
    q0 = (A * d0 + B * d1 + C * d2) / det
    q1 = (B * d0 + D * d1 + E * d2) / det
    q2 = (C * d0 + E * d1 + F * d2) / det
    r2 = d0 * q0 + d1 * q1 + d2 * q2

    # dS/dtheta = P + P^T, P = (R' Sigma_m) R^T
    n00 = -s * a - c * b
    n01 = -s * b - c * cc
    n02 = -s * e - c * f
    n10 = c * a - s * b
    n11 = c * b - s * cc
    n12 = c * e - s * f
    p00 = n00 * c - n01 * s
    p01 = n00 * s + n01 * c
    p10 = n10 * c - n11 * s
    p11 = n10 * s + n11 * c
    dS = (2.0 * p00, p01 + p10, n02, 2.0 * p11, n12)
    return r2, q0, q1, q2, -v, u, dS


def _slot_pose(pose4):
    return (pose4[..., 2:3], pose4[..., 3:4], pose4[..., 0:1], pose4[..., 1:2])


def linearize_terms(pose4, mu, ndt_scale, packed, scale: float, alpha: float,
                    eps: float = 1e-12):
    """Per-pair terms (..., W, 10, N) of K3a: wJ0J0, wJ0J1, wJ0J2, wJ1J1,
    wJ1J2, wJ2J2, wrJ0, wrJ1, wrJ2, rho; their sums over N are its outputs.
    ``mu`` and ``ndt_scale`` hold one value per member (...)."""
    mm, mc, am, ac, v = packed
    mu, ndt_scale = _per_slot(mu), _per_slot(ndt_scale)
    c, s, tx, ty = _slot_pose(pose4)
    r2, q0, q1, q2, dth0, dth1, dS = _pair_terms(c, s, tx, ty, mm, mc, am, ac)
    dS00, dS01, dS02, dS11, dS12 = dS
    w_valid = v[..., 0, :]

    r = torch.sqrt(torch.clamp(r2, min=eps))
    qdSq = (q0 * (dS00 * q0 + dS01 * q1 + dS02 * q2)
            + q1 * (dS01 * q0 + dS11 * q1 + dS12 * q2)
            + q2 * (dS02 * q0 + dS12 * q1))
    inv2r = 0.5 / r
    # the derivative of sqrt(max(r2, eps)): zero where the clamp holds
    live = (r2 > eps).to(r.dtype)
    J0 = 2.0 * q0 * inv2r * live
    J1 = 2.0 * q1 * inv2r * live
    J2 = (2.0 * (q0 * dth0 + q1 * dth1) - qdSq) * inv2r * live

    sq = r * r
    wgt = ndt_scale * barron.weight(sq, scale, alpha, mu) * w_valid
    wr = wgt * r
    return torch.stack([
        wgt * J0 * J0, wgt * J0 * J1, wgt * J0 * J2,
        wgt * J1 * J1, wgt * J1 * J2, wgt * J2 * J2,
        wr * J0, wr * J1, wr * J2,
        barron.rho(sq, scale, alpha, mu) * w_valid,
    ], dim=-2)


def sums_to_blocks(sums):
    """(..., W, 10) sums -> H (..., W, 3, 3), g (..., W, 3), rho (..., W)."""
    h00, h01, h02, h11, h12, h22, g0, g1, g2, rho = sums.unbind(-1)
    H = torch.stack([torch.stack([h00, h01, h02], -1),
                     torch.stack([h01, h11, h12], -1),
                     torch.stack([h02, h12, h22], -1)], -2)
    return H, torch.stack([g0, g1, g2], -1), rho


def linearize_plain(pose4, mu, ndt_scale, packed, scale: float, alpha: float,
                    eps: float = 1e-12):
    """K3a's plain version: per slot H (..., W, 3, 3), g (..., W, 3), rho
    (..., W)."""
    return sums_to_blocks(linearize_terms(pose4, mu, ndt_scale, packed, scale,
                                          alpha, eps).sum(-1))


def robust_cost_terms(pose4, mu, packed, scale: float, alpha: float,
                      eps: float = 1e-12):
    """Per-pair (rho * valid, r^2 of the valid pairs else 0), each
    (..., W, N)."""
    mm, mc, am, ac, v = packed
    c, s, tx, ty = _slot_pose(pose4)
    r2 = _pair_terms(c, s, tx, ty, mm, mc, am, ac)[0]
    w_valid = v[..., 0, :]
    r = torch.sqrt(torch.clamp(r2, min=eps))
    sq = r * r
    return (barron.rho(sq, scale, alpha, _per_slot(mu)) * w_valid,
            torch.where(w_valid > 0.0, sq, 0.0))


def robust_cost_plain(pose4, mu, packed, scale: float, alpha: float,
                      eps: float = 1e-12):
    """K3b's plain version: per slot rho sum (..., W) and max r^2 (..., W)."""
    rho, sq = robust_cost_terms(pose4, mu, packed, scale, alpha, eps)
    return rho.sum(-1), sq.amax(-1)


# ---- the kernels ------------------------------------------------------------

def _barron_args(scale: float, alpha: float, eps: float):
    """Host constants of ``barron.weight``/``rho``, rounded to float32 as
    the tensor code rounds them: (scale, alpha, eps, branch, |alpha-2|,
    alpha/2, alpha/2 - 1); the branch is taken with the host's doubles."""
    branch = 0 if alpha >= 2.0 else (1 if abs(alpha) <= 0.05 else 2)
    exponent = 0.5 * alpha
    f = ctypes.c_float
    return (f(scale), f(alpha), f(eps), ctypes.c_int(branch), f(abs(alpha - 2.0)),
            f(exponent), f(exponent - 1.0))


def _fn(name):
    fn = getattr(build.library("ndt_linearize"), name)
    if fn.argtypes is None:
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        n_out = 3 if name == "ndt_linearize_f32" else 2
        n_scalar = 2 if name == "ndt_linearize_f32" else 1
        fn.argtypes = ([p] * (1 + n_scalar + 5 + n_out) + [i, i, i]
                       + [f, f, f, i, f, f, f] + [p])
        fn.restype = ctypes.c_int
    return fn


def _check(who, pose4, scalars, packed):
    mm, mc, am, ac, v = packed
    dev = pose4.device
    ts = (pose4, *scalars, *packed)
    if not (pose4.is_cuda and all(t.device == dev for t in ts)):
        raise ValueError(f"{who}: all tensors must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{who}: float32 tensors expected")
    lead, (W, N) = mm.shape[:-3], (mm.shape[-3], mm.shape[-1])
    shapes = tuple(lead + (W, ch, N) for ch in (3, 6, 3, 6, 1))
    if len(lead) > 1 or pose4.shape != lead + (W, 4) \
            or tuple(t.shape for t in packed) != shapes:
        raise ValueError(f"{who}: shapes pose4 ([B,] W, 4) and packs "
                         f"([B,] W, 3|6|3|6|1, N) expected")
    if any(t.shape != lead for t in scalars):
        raise ValueError(f"{who}: mu and ndt_scale must hold one value per member")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{who}: inputs must be contiguous")
    return lead, W, N


def linearize_cuda(pose4, mu, ndt_scale, packed, scale: float, alpha: float,
                   eps: float = 1e-12):
    """Launch K3a over all slots of all members; raises on anything it does
    not take."""
    lead, W, N = _check("linearize_cuda", pose4, (mu, ndt_scale), packed)
    H = pose4.new_empty(lead + (W, 3, 3))
    g = pose4.new_empty(lead + (W, 3))
    rho = pose4.new_empty(lead + (W,))
    stream = torch.cuda.current_stream(pose4.device).cuda_stream
    err = _fn("ndt_linearize_f32")(
        pose4.data_ptr(), mu.data_ptr(), ndt_scale.data_ptr(),
        *(t.data_ptr() for t in packed), H.data_ptr(), g.data_ptr(),
        rho.data_ptr(), math.prod(lead) * W, W, N,
        *_barron_args(scale, alpha, eps), stream)
    if err != 0:
        raise RuntimeError(f"ndt_linearize kernel launch failed: CUDA error {err}")
    profiling.count("kernel.ndt_linearize")
    return H, g, rho


def robust_cost_cuda(pose4, mu, packed, scale: float, alpha: float,
                     eps: float = 1e-12):
    """Launch K3b over all slots of all members; raises on anything it does
    not take."""
    lead, W, N = _check("robust_cost_cuda", pose4, (mu,), packed)
    rho = pose4.new_empty(lead + (W,))
    r2max = pose4.new_empty(lead + (W,))
    stream = torch.cuda.current_stream(pose4.device).cuda_stream
    err = _fn("ndt_robust_cost_f32")(
        pose4.data_ptr(), mu.data_ptr(), *(t.data_ptr() for t in packed),
        rho.data_ptr(), r2max.data_ptr(), math.prod(lead) * W, W, N,
        *_barron_args(scale, alpha, eps), stream)
    if err != 0:
        raise RuntimeError(f"ndt_robust_cost kernel launch failed: CUDA error {err}")
    profiling.count("kernel.ndt_robust_cost")
    return rho, r2max


def _per_member(who, poses, *scalars):
    """Refuse a scalar that is not one value per member of ``poses``
    (..., W, 3): broadcast, it would give every output the wrong shape."""
    if any(t.shape != poses.shape[:-2] for t in scalars):
        raise ValueError(f"{who}: mu and ndt_scale must have the batch shape "
                         f"{tuple(poses.shape[:-2])}")


def linearize(poses, mu, ndt_scale, packed, scale: float, alpha: float,
              eps: float = 1e-12):
    """Per-slot normal-equation blocks: poses (..., W, 3), packed from
    :func:`pack_pairs`, ``mu`` and ``ndt_scale`` (...).  Returns (H (..., W,
    3, 3), g (..., W, 3), rho_sum (...)), the rho sum over each member's
    slots."""
    _per_member("linearize", poses, mu, ndt_scale)
    pose4 = pose_inputs(poses)
    if pose4.device.type == "cuda":
        H, g, rho = linearize_cuda(pose4, mu, ndt_scale, packed, scale, alpha, eps)
    elif pose4.device.type == "cpu":
        H, g, rho = linearize_plain(pose4, mu, ndt_scale, packed, scale, alpha, eps)
    else:
        raise ValueError(f"linearize: unsupported device {pose4.device}")
    return H, g, rho.sum(-1)


def robust_cost(poses, mu, packed, scale: float, alpha: float,
                eps: float = 1e-12):
    """Residual-only pass: (rho_sum (...), r2max (...)) over each member's
    slots' valid pairs."""
    _per_member("robust_cost", poses, mu)
    pose4 = pose_inputs(poses)
    if pose4.device.type == "cuda":
        rho, r2max = robust_cost_cuda(pose4, mu, packed, scale, alpha, eps)
    elif pose4.device.type == "cpu":
        rho, r2max = robust_cost_plain(pose4, mu, packed, scale, alpha, eps)
    else:
        raise ValueError(f"robust_cost: unsupported device {pose4.device}")
    return rho.sum(-1), r2max.amax(-1)
