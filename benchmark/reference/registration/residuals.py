"""Residual functions of the sliding-window estimator.

Port of ``randt_slam_tpu/registration/residuals.py``.  State layout (per
state, 9 floats; ``trajectory_representation.h:12-22``):

    [x, y, theta, vx, vy, omega, ax, ay, imu_bias]

Each residual mirrors its Ceres counterpart in ``ceres_residuals.h`` and
broadcasts over leading axes; the window estimator differentiates them with
autograd.
"""

from __future__ import annotations

import torch

from ..geometry import normalize_angle
from ..ndt import cells as C

# State vector slot indices.
X, Y, TH, VX, VY, OM, AX, AY, BIAS = range(9)
STATE_DIM = 9
MIN_DT = 0.2  # duplicate-stamp guard (``ceres_residuals.h:38``)


def predict_state(state, raw_dt):
    """Constant-velocity/acceleration kinematic prediction
    (``ceres_residuals.h:25-55``), with the dt >= 0.2 s clamp and the
    midpoint-heading rotation of the body-frame displacement."""
    dt = torch.clamp(raw_dt, min=MIN_DT)
    th, om = state[..., TH], state[..., OM]
    vx, vy, ax, ay = state[..., VX], state[..., VY], state[..., AX], state[..., AY]
    rot_mid = normalize_angle(th + 0.5 * dt * om)
    sy, cy = torch.sin(rot_mid), torch.cos(rot_mid)
    dx = vx * dt + 0.5 * ax * dt * dt
    dy = vy * dt + 0.5 * ay * dt * dt
    return torch.stack(
        [
            state[..., X] + (cy * dx - sy * dy),
            state[..., Y] + (sy * dx + cy * dy),
            normalize_angle(th + dt * om),
            vx + dt * ax,
            vy + dt * ay,
            om,
            ax,
            ay,
            state[..., BIAS],
        ],
        dim=-1,
    )


def motion_residual(s0, s1, raw_dt, sqrt_information):
    """8-dim motion-model residual (``ceres_residuals.h:554-619``)."""
    pred = predict_state(s0, raw_dt)
    r = torch.stack(
        [
            s1[..., X] - pred[..., X],
            s1[..., Y] - pred[..., Y],
            normalize_angle(s1[..., TH] - pred[..., TH]),
            s1[..., VX] - pred[..., VX],
            s1[..., VY] - pred[..., VY],
            s1[..., OM] - pred[..., OM],
            s1[..., AX] - pred[..., AX],
            s1[..., AY] - pred[..., AY],
        ],
        dim=-1,
    )
    return torch.einsum("ij,...j->...i", sqrt_information, r)


def imu_residual(s0, s1, raw_dt, rot_meas, weight_imu, weight_bias):
    """2-dim IMU rotation + bias-walk residual (``ceres_residuals.h:307-336``);
    dt is not clamped here, as in the reference (``ndt_matcher.cpp:147``)."""
    r0 = weight_imu * (
        rot_meas - normalize_angle(s1[..., TH] - s0[..., TH] + s1[..., BIAS] * raw_dt)
    )
    r1 = weight_bias * (s1[..., BIAS] - s0[..., BIAS])
    return torch.stack([r0, r1], dim=-1)


def ndt_residual_sq(pose, m_mean, m_cov, f_mean, f_cov):
    """Squared intensity-augmented D2D residual (``ceres_residuals.h:486-518``):
    r^2 = d^T (R3 cov_m R3^T + cov_f)^{-1} d,  d = R3 mu_m + t3 - mu_f."""
    th = pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    mx, my, mi = m_mean[..., 0], m_mean[..., 1], m_mean[..., 2]
    dx = c * mx - s * my + pose[..., 0] - f_mean[..., 0]
    dy = s * mx + c * my + pose[..., 1] - f_mean[..., 1]
    di = mi - f_mean[..., 2]
    dx, dy, di = torch.broadcast_tensors(dx, dy, di)
    d = torch.stack([dx, dy, di], dim=-1)

    a, b, e = m_cov[..., 0, 0], m_cov[..., 0, 1], m_cov[..., 0, 2]
    cc, f = m_cov[..., 1, 1], m_cov[..., 1, 2]
    g = m_cov[..., 2, 2]
    r00 = c * (c * a - s * b) - s * (c * b - s * cc)
    r01 = c * (s * a + c * b) - s * (s * b + c * cc)
    r11 = s * (s * a + c * b) + c * (s * b + c * cc)
    r02 = c * e - s * f
    r12 = s * e + c * f
    s00, s01, s02, s11, s12, s22 = torch.broadcast_tensors(
        r00 + f_cov[..., 0, 0], r01 + f_cov[..., 0, 1], r02 + f_cov[..., 0, 2],
        r11 + f_cov[..., 1, 1], r12 + f_cov[..., 1, 2], g + f_cov[..., 2, 2],
    )
    S = torch.stack(
        [
            torch.stack([s00, s01, s02], dim=-1),
            torch.stack([s01, s11, s12], dim=-1),
            torch.stack([s02, s12, s22], dim=-1),
        ],
        dim=-2,
    )
    sol = C.solve3(S, d)
    return torch.sum(d * sol, dim=-1)


def ndt_residual_sq_2d(pose, m_mean, m_cov, f_mean, f_cov):
    """Squared 2-D (position-only) D2D residual (``ceres_residuals.h:421-451``)."""
    th = pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    mx, my = m_mean[..., 0], m_mean[..., 1]
    dx = c * mx - s * my + pose[..., 0] - f_mean[..., 0]
    dy = s * mx + c * my + pose[..., 1] - f_mean[..., 1]

    a, b, d = m_cov[..., 0, 0], m_cov[..., 0, 1], m_cov[..., 1, 1]
    r00 = c * (c * a - s * b) - s * (c * b - s * d)
    r01 = c * (s * a + c * b) - s * (s * b + c * d)
    r11 = s * (s * a + c * b) + c * (s * b + c * d)
    s00 = r00 + f_cov[..., 0, 0]
    s01 = r01 + f_cov[..., 0, 1]
    s11 = r11 + f_cov[..., 1, 1]
    det = s00 * s11 - s01 * s01
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    return (s11 * dx * dx - 2.0 * s01 * dx * dy + s00 * dy * dy) / det


def ndt_residual(pose, m_mean, m_cov, f_mean, f_cov, eps=1e-12,
                 use_intensity: bool = True):
    """Whitened D2D residual r = sqrt(r^2), clamped away from zero for a
    finite Jacobian (``ceres_residuals.h:240-247``)."""
    if use_intensity:
        r2 = ndt_residual_sq(pose, m_mean, m_cov, f_mean, f_cov)
    else:
        r2 = ndt_residual_sq_2d(pose, m_mean, m_cov, f_mean, f_cov)
    return torch.sqrt(torch.clamp(r2, min=eps))
