"""One LM iteration of the odometry window solve (``csrc/lm_step.cu``): the
damped system's assembly, the trial step and the acceptance, beside K3a/K3b
(``ops/ndt_linearize``) and K4 (``ops/small_chol``).

The JAX package runs these as XLA ops inside its LM ``while_loop``.  Here
one iteration of ``registration/matcher._window_solve``'s solve on the card,
with both kernel switches on, is six launches:

    K3a -> lm_assemble -> K4 -> lm_trial -> K3b -> lm_accept

(``registration/window.window_loop``), where the tensor ops take ~460.

* ``lm_assemble``: the motion and IMU residuals of the W transitions and
  their Jacobian in closed form, J^T W J and J^T W r over the P = (W + 1) * 9
  parameters with K3a's per-slot NDT blocks added at the slot poses, then
  the Jacobi scaling and the damping: A (..., P, P), rhs and dscale (...,
  P) in K4's layout.
* ``lm_trial``: the trial step of K4's solution with its angles wrapped,
  its slot poses [tx, ty, cos, sin] for K3b, and the norms of the
  parameter tolerance.
* ``lm_accept``: the trial cost 0.5 (ndt_scale sum rho + sum r_aux^2) from
  K3b's per-slot rho, then the acceptance, damping update and freeze, the
  live-iteration counter (less the ``done`` flags from before the
  iteration) and the new iterate's slot poses for the next K3a.

Their plain versions are ``registration/window``'s ``assemble_plain``,
``trial_plain`` and ``accept_plain``: the tensor ops the CPU runs.

Shapes: parameters (..., P), with ``...`` empty or one batch axis (B,); a
member's answer does not depend on the others.  The wrappers count their
launches as ``kernel.lm_assemble``, ``kernel.lm_trial`` and
``kernel.lm_accept`` and raise on anything the kernels do not take:
1 <= W <= :data:`MAX_W` (every window P that K4 takes), float32, one CUDA
device, contiguous.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..utils import profiling
from . import build

MAX_W = 6   # P = (W + 1) * 9 <= 63, within K4's 64
NA = 10     # aux residuals per transition: 8 motion + 2 IMU


class Window(NamedTuple):
    """What the kernels read of a window besides the iterate: float32
    tensors on the parameters' device, contiguous."""

    dts: torch.Tensor        # (..., W) transition times
    imu_meas: torch.Tensor   # (..., W) gyro readings
    sqrt_info: torch.Tensor  # (8, 8) motion sqrt information
    valid: torch.Tensor      # (10 W,) aux rows used, 0/1: motion j * 8 + m, IMU 8 W + 2 j + m
    active: torch.Tensor     # (P,) free parameters, 0/1
    angle: torch.Tensor      # (P,) parameters wrapped to (-pi, pi], 0/1
    w_imu: float
    w_bias: float


def _fn(name):
    fn = getattr(build.library("lm_step"), name)
    if fn.argtypes is None:
        p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        fn.argtypes = {
            "lm_assemble_f32": [p] * 9 + [f, f] + [p] * 3 + [i, i, p],
            "lm_trial_f32": [p] * 9 + [i, i, p],
            "lm_accept_f32": [p] * 9 + [f] * 4 + [p] * 6 + [i, i, p],
        }[name]
        fn.restype = ctypes.c_int
    return fn


def _check(who, win: Window, p, **given):
    """Refuse what the kernels do not take; ``given`` maps a name to
    (tensor, shape[, dtype]), float32 by default.  Returns the member count
    B."""
    lead, W = tuple(win.dts.shape[:-1]), win.dts.shape[-1]
    if not 1 <= W <= MAX_W:
        raise ValueError(f"{who}: 1 <= W <= {MAX_W} (P = (W + 1) * 9 <= 63) expected")
    if len(lead) > 1 or p.shape[-1] != (W + 1) * 9 or tuple(p.shape[:-1]) != lead:
        raise ValueError(f"{who}: parameters ([B,] (W + 1) * 9) of the window expected")
    P = (W + 1) * 9
    checked = {"p": (p, p.shape), "sqrt_info": (win.sqrt_info, (8, 8)),
               "valid": (win.valid, (NA * W,)), "active": (win.active, (P,)),
               "angle": (win.angle, (P,)), "dts": (win.dts, lead + (W,)),
               "imu_meas": (win.imu_meas, lead + (W,)), **given}
    for k, (t, shape, *dtype) in checked.items():
        want = dtype[0] if dtype else torch.float32
        if not (t.is_cuda and t.device == p.device):
            raise ValueError(f"{who}: {k} must be on the parameters' CUDA device")
        if t.dtype != want:
            raise TypeError(f"{who}: {k} must be {want}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{who}: {k} of shape {tuple(shape)} expected, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {k} must be contiguous")
    return math.prod(lead)


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    profiling.count(f"kernel.{name}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def assemble_cuda(win: Window, Hj, gj, p, lam):
    """Launch ``lm_assemble`` on K3a's blocks Hj (..., W, 3, 3), gj (..., W,
    3), the parameters p (..., P) and the damping lam (...): (A (..., P, P),
    rhs, dscale (..., P))."""
    lead, P, W = p.shape[:-1], p.shape[-1], win.dts.shape[-1]
    B = _check("assemble_cuda", win, p, Hj=(Hj, lead + (W, 3, 3)),
               gj=(gj, lead + (W, 3)), lam=(lam, lead))
    A = p.new_empty(lead + (P, P))
    rhs, dscale = torch.empty_like(p), torch.empty_like(p)
    f = ctypes.c_float
    _launched("lm_assemble", _fn("lm_assemble_f32")(
        Hj.data_ptr(), gj.data_ptr(), p.data_ptr(), win.dts.data_ptr(),
        win.imu_meas.data_ptr(), lam.data_ptr(), win.sqrt_info.data_ptr(),
        win.valid.data_ptr(), win.active.data_ptr(), f(win.w_imu),
        f(win.w_bias), A.data_ptr(), rhs.data_ptr(), dscale.data_ptr(), B, W,
        _stream(p)))
    return A, rhs, dscale


def trial_cuda(win: Window, p, x, dscale):
    """Launch ``lm_trial`` on K4's solution x: (trial (..., P), its slot
    poses (..., W, 4), |delta|, |p * active| (...))."""
    lead, W = p.shape[:-1], win.dts.shape[-1]
    B = _check("trial_cuda", win, p, x=(x, p.shape), dscale=(dscale, p.shape))
    trial = torch.empty_like(p)
    pose4 = p.new_empty(lead + (W, 4))
    dnorm, pnorm = p.new_empty(lead), p.new_empty(lead)
    _launched("lm_trial", _fn("lm_trial_f32")(
        p.data_ptr(), x.data_ptr(), dscale.data_ptr(), win.active.data_ptr(),
        win.angle.data_ptr(), trial.data_ptr(), pose4.data_ptr(), dnorm.data_ptr(),
        pnorm.data_ptr(), B, W, _stream(p)))
    return trial, pose4, dnorm, pnorm


def accept_cuda(win: Window, rho, trial, dnorm, pnorm, ndt_scale, tol: float,
                ftol: float, p, c, lam, done, live=None):
    """Launch ``lm_accept`` on K3b's per-slot rho (..., W) at the trial: p,
    c, lam, done and ``live`` (int32, or None) are updated in place and
    returned with the new p's slot poses (..., W, 4)."""
    lead, W = p.shape[:-1], win.dts.shape[-1]
    counters = {"live": (live, lead, torch.int32)} if live is not None else {}
    B = _check("accept_cuda", win, p, rho=(rho, lead + (W,)), trial=(trial, p.shape),
               dnorm=(dnorm, lead), pnorm=(pnorm, lead), ndt_scale=(ndt_scale, lead),
               c=(c, lead), lam=(lam, lead), done=(done, lead, torch.bool), **counters)
    pose4 = p.new_empty(lead + (W, 4))
    f = ctypes.c_float
    _launched("lm_accept", _fn("lm_accept_f32")(
        rho.data_ptr(), trial.data_ptr(), dnorm.data_ptr(), pnorm.data_ptr(),
        ndt_scale.data_ptr(), win.dts.data_ptr(), win.imu_meas.data_ptr(),
        win.sqrt_info.data_ptr(), win.valid.data_ptr(), f(win.w_imu), f(win.w_bias),
        f(tol), f(ftol), p.data_ptr(), c.data_ptr(), lam.data_ptr(), done.data_ptr(),
        None if live is None else live.data_ptr(), pose4.data_ptr(), B, W, _stream(p)))
    return p, c, lam, done, pose4
