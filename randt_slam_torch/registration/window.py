"""The aux (motion and IMU) residuals of the odometry window solve, their
normal equations, and its LM iteration as six stages.

``matcher._window_solve`` builds a :class:`WindowAux` per solve.  The
tensor ops here and in ``solver.lm_solve`` are the plain path, which every
CPU tensor and every other combination of the kernel switches runs:

* :func:`aux_jacobian`: the aux residuals' Jacobian by reverse mode on
  per-residual copies of the states;
* :func:`assemble_normal`: J^T W J and J^T W r with the per-slot NDT blocks
  added at the slot poses.

With both kernel switches on, on a CUDA tensor, :func:`window_loop` runs
each LM iteration as six launches, K3a, ``lm_assemble``, K4, ``lm_trial``,
K3b, ``lm_accept`` (``ops/ndt_linearize``, ``ops/small_chol``,
``ops/lm_step``).  :func:`assemble_plain`, :func:`trial_plain` and
:func:`accept_plain` are the three ``ops/lm_step`` kernels' plain
versions, built from these ops and ``solver``'s; with them and the plain
K3a/K3b/K4 as its stages the loop gives the tensor ops' bits.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import runtime
from ..ops import lm_step
from ..ops import ndt_linearize as NL
from ..ops import small_chol
from . import residuals as R
from . import solver

NA = lm_step.NA  # aux residuals per transition: 8 motion + 2 IMU


class WindowAux(NamedTuple):
    """What a window's aux residuals and its LM step read besides the
    parameters: the masks, the assembly's index tensors, and where the
    kernels run the iteration their ``ops.lm_step.Window``."""

    lead: tuple               # the batch shape, () or (B,)
    W: int
    dts: torch.Tensor         # (..., W)
    imu_meas: torch.Tensor    # (..., W)
    sqrt_info: torch.Tensor   # (8, 8) motion sqrt information
    w_imu: float
    w_bias: float
    aux_valid: torch.Tensor   # (10 W,) bool: motion rows j * 8 + m, IMU rows 8 W + 2 j + m
    active_mask: torch.Tensor  # (P,) bool
    angle_mask: torch.Tensor  # (P,) bool
    active_f: torch.Tensor    # (P,) the active mask as the parameters' dtype
    wa: torch.Tensor          # (10 W,) aux_valid as the parameters' dtype
    aux_rows: torch.Tensor    # (W, 10) row of transition j, component m
    aux_cols: torch.Tensor    # (W, 10) j: the first of its two states
    af_blk: torch.Tensor      # (W, 3) active_f at the slot pose columns
    h_at: tuple               # index of the slot blocks in (..., P, P)
    g_at: tuple               # and in (..., P)
    kern: lm_step.Window | None


def window_aux(mcfg, lead: tuple, slot_active, active, angle, dts, imu_meas,
               kernels: bool = False) -> WindowAux:
    """The :class:`WindowAux` of a window with host masks ``slot_active``
    (W,), ``active`` and ``angle`` (P,) (``matcher._window_masks``);
    ``kernels``: with the kernels' ``Window`` (CUDA tensors only)."""
    W = mcfg.smoothing_steps
    dtype, dev = dts.dtype, dts.device
    # float32 product, as the JAX package forms it
    sqrtI = runtime.const(
        np.asarray(mcfg.motion_sqrt_information, np.float32)
        * np.float32(mcfg.covariance_scaling_factor), dtype, dev)
    valid = np.concatenate([
        np.repeat(slot_active, 8),
        np.repeat(slot_active & bool(mcfg.use_imu), 2),
    ])
    aux_valid = runtime.const(valid, torch.bool, dev)
    active_mask = runtime.const(active, torch.bool, dev)
    active_f = active_mask.to(dtype)
    wa = aux_valid.to(dtype)
    # aux Jacobian layout: transition j, component m -> row, and the column
    # blocks of its two states
    rows_np = np.array([[j * 8 + m if m < 8 else W * 8 + j * 2 + (m - 8)
                         for m in range(NA)] for j in range(W)])
    aux_rows = runtime.const(rows_np, torch.long, dev)
    aux_cols = runtime.const(np.arange(W)[:, None].repeat(NA, 1), torch.long, dev)
    # rows/cols of slot j's 3x3 pose block in the (P, P) system
    blk = 9 * (np.arange(W)[:, None] + 1) + np.arange(3)  # (W, 3)
    blk_r = runtime.const(np.broadcast_to(blk[:, :, None], (W, 3, 3)), torch.long, dev)
    blk_c = runtime.const(np.broadcast_to(blk[:, None, :], (W, 3, 3)), torch.long, dev)
    blk_g = runtime.const(blk, torch.long, dev)
    af_blk = active_f[blk_g]  # (W, 3)
    if lead:  # the problem index of every block entry
        b = torch.arange(lead[0], device=dev)
        h_at, g_at = (b[:, None, None, None], blk_r, blk_c), (b[:, None, None], blk_g)
    else:
        h_at, g_at = (blk_r, blk_c), (blk_g,)
    kern = None
    if kernels:  # the kernels take their inputs dense
        kern = lm_step.Window(
            dts.contiguous(), imu_meas.contiguous(), sqrtI,
            runtime.const(valid, torch.float32, dev),
            runtime.const(active, torch.float32, dev),
            runtime.const(angle, torch.float32, dev),
            mcfg.weight_imu, mcfg.weight_imu_bias)
    return WindowAux(
        lead=lead, W=W, dts=dts, imu_meas=imu_meas, sqrt_info=sqrtI,
        w_imu=mcfg.weight_imu, w_bias=mcfg.weight_imu_bias, aux_valid=aux_valid,
        active_mask=active_mask, angle_mask=runtime.const(angle, torch.bool, dev),
        active_f=active_f, wa=wa, aux_rows=aux_rows, aux_cols=aux_cols,
        af_blk=af_blk, h_at=h_at, g_at=g_at, kern=kern)


def aux_residuals(aux: WindowAux, p_flat):
    """(..., 10 W) motion and IMU residuals of the parameters (..., P)."""
    lead, W = aux.lead, aux.W
    # Both residuals broadcast over the W transitions.
    p = p_flat.reshape(lead + (W + 1, 9))
    r_mot = R.motion_residual(p[..., :-1, :], p[..., 1:, :], aux.dts, aux.sqrt_info)
    r_imu = R.imu_residual(p[..., :-1, :], p[..., 1:, :], aux.dts, aux.imu_meas,
                           aux.w_imu, aux.w_bias)
    return torch.cat([r_mot.reshape(lead + (-1,)), r_imu.reshape(lead + (-1,))],
                     dim=-1)


def aux_cost(aux: WindowAux, p_flat):
    """Sum of the valid aux residuals' squares (...)."""
    ra = aux_residuals(aux, p_flat)
    return torch.sum(torch.where(aux.aux_valid, ra * ra, 0.0), dim=-1)


def aux_jacobian(aux: WindowAux, p):
    """(r_aux (..., Na), J_aux (..., Na, P)) at the states p (..., W+1, 9):
    copy m of each transition's two states yields component m of its
    residual."""
    lead, W = aux.lead, aux.W
    at = (slice(None),) * len(lead)  # the batch dims, whole
    dts, imu_meas = aux.dts, aux.imu_meas
    with torch.enable_grad():
        s0 = p[..., :-1, :].detach()[..., :, None, :].expand(
            lead + (W, NA, 9)).clone().requires_grad_(True)
        s1 = p[..., 1:, :].detach()[..., :, None, :].expand(
            lead + (W, NA, 9)).clone().requires_grad_(True)
        r_all = torch.cat([
            R.motion_residual(s0, s1, dts[..., :, None], aux.sqrt_info),
            R.imu_residual(s0, s1, dts[..., :, None], imu_meas[..., :, None],
                           aux.w_imu, aux.w_bias),
        ], dim=-1)  # (..., W, NA copies, NA components)
        picked = torch.diagonal(r_all, dim1=-2, dim2=-1)  # (..., W, NA)
        g0, g1 = torch.autograd.grad(picked.sum(), (s0, s1))
    picked = picked.detach()
    ra = torch.cat([picked[..., :8].reshape(lead + (-1,)),
                    picked[..., 8:].reshape(lead + (-1,))], dim=-1)
    J = p.new_zeros(lead + (W * NA, W + 1, 9))
    J[at + (aux.aux_rows, aux.aux_cols)] = g0
    J[at + (aux.aux_rows, aux.aux_cols + 1)] = g1
    return ra, J.reshape(lead + (W * NA, (W + 1) * 9))


def assemble_normal(aux: WindowAux, p, Hj, gj):
    """The aux normal equations (H (..., P, P), g (..., P)) at the states p
    (..., W+1, 9) plus the per-slot NDT blocks Hj (..., W, 3, 3), gj (...,
    W, 3)."""
    ra, Ja = aux_jacobian(aux, p)
    Jm = Ja * aux.active_f[None, :]
    JW = Jm * aux.wa[:, None]
    H = Jm.mT @ JW
    # a batch as row vectors: on the CPU each member's sums come out as
    # the unbatched matrix-vector product's
    g = JW.mT @ ra if not aux.lead else (ra[..., None, :] @ JW)[..., 0, :]
    af_blk = aux.af_blk
    H = H.index_put(aux.h_at, Hj * af_blk[:, :, None] * af_blk[:, None, :],
                    accumulate=True)
    g = g.index_put(aux.g_at, gj * af_blk, accumulate=True)
    return H, g


def slot_poses(p_flat):
    """The slot poses (..., W, 3) of the parameters (..., (W + 1) * 9)."""
    return p_flat.unflatten(-1, (-1, 9))[..., 1:, :3]


# ---- the plain versions of ops/lm_step's kernels ------------------------------

def assemble_plain(aux: WindowAux, Hj, gj, p, lam):
    """``lm_assemble``'s plain version: (A (..., P, P), rhs, dscale (..., P))."""
    H, g = assemble_normal(aux, p.reshape(aux.lead + (aux.W + 1, 9)), Hj, gj)
    return solver.scaled_system(H, g, lam, aux.active_f)


def trial_plain(aux: WindowAux, p, x, dscale):
    """``lm_trial``'s plain version: (trial (..., P), its slot poses (..., W,
    4), |delta|, |p * active| (...))."""
    delta, trial = solver.trial_step(p, x, dscale, aux.angle_mask)
    return (trial, NL.pose_inputs(slot_poses(trial)),
            *solver.step_norms(delta, p, aux.active_f))


def accept_plain(aux: WindowAux, rho, trial, dnorm, pnorm, ndt_scale, tol: float,
                 ftol: float, p, c, lam, done, live=None):
    """``lm_accept``'s plain version: the trial cost from the per-slot rho
    (..., W), then (p, c, lam, done, slot poses (..., W, 4) of the new p);
    ``live`` (int32, or None) less ``done`` in place."""
    c_new = 0.5 * (ndt_scale * rho.sum(-1) + aux_cost(aux, trial))
    if live is not None:
        live.add_(done, alpha=-1)
    p, c, lam, done = solver.accept_step(p, c, lam, done, trial, c_new, dnorm, pnorm,
                                         tol, ftol)
    return p, c, lam, done, NL.pose_inputs(slot_poses(p))


# ---- the iteration ------------------------------------------------------------

class Stages(NamedTuple):
    """One LM iteration's six stages, the window bound where they read it."""

    linearize: Callable  # (pose4, mu, ndt_scale, packed, scale, alpha) -> (Hj, gj, rho)
    assemble: Callable   # (Hj, gj, p, lam) -> (A, rhs, dscale)
    solve: Callable      # (A, rhs) -> x
    trial: Callable      # (p, x, dscale) -> (trial, pose4, |delta|, |p * active|)
    cost: Callable       # (pose4, mu, packed, scale, alpha) -> (rho, r2max)
    accept: Callable     # (rho, trial, |delta|, |p * active|, ndt_scale, tol, ftol,
                         #  p, c, lam, done, live) -> (p, c, lam, done, pose4)


def kernel_stages(aux: WindowAux) -> Stages:
    """K3a, ``lm_assemble``, K4, ``lm_trial``, K3b, ``lm_accept``: the card's."""
    return Stages(NL.linearize_cuda, partial(lm_step.assemble_cuda, aux.kern),
                  small_chol.chol_solve_cuda, partial(lm_step.trial_cuda, aux.kern),
                  NL.robust_cost_cuda, partial(lm_step.accept_cuda, aux.kern))


def window_loop(aux: WindowAux, packed, ndt_scale, scale: float, alpha: float,
                tol: float, ftol: float, stages: Stages | None = None):
    """The LM iterations of a window solve as six stages each,
    :func:`kernel_stages` unless ``stages`` is given: ``loop(p0, c, lam,
    done, mu, live, max_iters) -> (p, c)`` for ``solver.lm_solve``, from the
    round's start (its cost c, damping lam and ``done`` flags, which the
    kernels update in place)."""
    st = kernel_stages(aux) if stages is None else stages
    ndt_scale = ndt_scale.contiguous()

    def loop(p0, c, lam, done, mu, live, max_iters: int):
        p = torch.clone(p0, memory_format=torch.contiguous_format)
        pose4 = NL.pose_inputs(slot_poses(p))
        for _ in range(max_iters):
            Hj, gj, _ = st.linearize(pose4, mu, ndt_scale, packed, scale, alpha)
            A, rhs, dscale = st.assemble(Hj, gj, p, lam)
            trial, pose4_t, dnorm, pnorm = st.trial(p, st.solve(A, rhs), dscale)
            rho, _ = st.cost(pose4_t, mu, packed, scale, alpha)
            p, c, lam, done, pose4 = st.accept(rho, trial, dnorm, pnorm, ndt_scale,
                                               tol, ftol, p, c, lam, done, live)
        return p, c

    return loop
