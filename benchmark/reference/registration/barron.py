"""Barron's general adaptive robust loss with GNC, as IRLS weights.

Port of ``randt_slam_tpu/registration/barron.py`` (``ceres::BarronLoss``,
``ceres_loss_functions.h:27-48``, ``ceres_loss_functions.cpp:19-39``): the GNC
control parameter mu is folded into the scale, b = mu * a^2, c = 1/b, and

    alpha >= 2:        rho(s) = s
    |alpha| <= 0.05:   rho(s) = b log(1 + s c)                    (Cauchy)
    otherwise:         rho(s) = b |a-2|/a ((s 2c/|a-2| + 1)^(a/2) - 1)

with s the SQUARED residual.  rho'(s) is the IRLS weight of the Gauss-Newton
step.  ``alpha`` is a static config value, so the branch is taken in Python.
"""

from __future__ import annotations

import math

import torch


def rho(s, scale: float, alpha: float, mu):
    """Robust loss value. s: squared residuals, mu: scalar tensor."""
    b = mu * scale * scale
    c = 1.0 / b
    if alpha >= 2.0:
        return s
    if abs(alpha) <= 0.05:
        return b * torch.log1p(s * c)
    factor = abs(alpha - 2.0)
    exponent = 0.5 * alpha
    pre = b * factor / alpha
    times_s = 2.0 * c / factor
    return pre * (torch.pow(s * times_s + 1.0, exponent) - 1.0)


def weight(s, scale: float, alpha: float, mu):
    """IRLS weight rho'(s) (``ceres_loss_functions.cpp:19-39``)."""
    b = mu * scale * scale
    c = 1.0 / b
    if alpha >= 2.0:
        return torch.ones_like(s)
    if abs(alpha) <= 0.05:
        return torch.clamp(1.0 / (1.0 + s * c), min=torch.finfo(s.dtype).tiny)
    factor = abs(alpha - 2.0)
    exponent = 0.5 * alpha
    pre = b * factor / alpha
    times_s = 2.0 * c / factor
    return pre * exponent * torch.pow(s * times_s + 1.0, exponent - 1.0) * times_s


def gnc_mu_init(max_sq_residual, scale: float, gnc_steps: int, divisor: float):
    """Initial GNC control parameter (``ndt_matcher.cpp:387-389``):
    mu = min(2 * max_r^2 / scale^2, divisor^(gnc_steps-1))."""
    mu = 2.0 * max_sq_residual / (scale * scale)
    return torch.clamp(mu, max=divisor ** (gnc_steps - 1))


def gnc_continue(mu, divisor: float):
    """Loop condition of the GNC schedule (``ndt_matcher.cpp:397``):
    iterate while mu > 1/sqrt(divisor) (mu has already been divided)."""
    return mu > 1.0 / math.sqrt(divisor)
