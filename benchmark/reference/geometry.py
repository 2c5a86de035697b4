"""SE(2) geometry primitives on tensors.

Port of ``randt_slam_tpu/geometry.py``: a single ``(..., 3)`` tensor
``[x, y, theta]`` everywhere; batched ops broadcast over leading axes.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi


def normalize_angle(theta):
    """Wrap angle to (-pi, pi], branch-free (``state_manifold.h:17-23``)."""
    return theta - _TWO_PI * torch.floor((theta + math.pi) / _TWO_PI)


def rotmat(theta):
    """2x2 rotation matrix; broadcasts: theta (...) -> (..., 2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def compose(a, b):
    """SE(2) composition a*b for pose tensors (..., 3)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = normalize_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, th], dim=-1)


def inverse(a):
    """SE(2) inverse for pose tensors (..., 3)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(c * a[..., 0] + s * a[..., 1])
    y = -(-s * a[..., 0] + c * a[..., 1])
    return torch.stack([x, y, normalize_angle(-a[..., 2])], dim=-1)


def relative(a, b):
    """a^{-1} * b."""
    return compose(inverse(a), b)


def transform_points(pose, pts):
    """Apply pose (..., 3) to 2-D points (..., N, 2)."""
    R = rotmat(pose[..., 2])
    return torch.einsum("...ij,...nj->...ni", R, pts) + pose[..., None, :2]


def exp(tangent):
    """SE(2) exponential map from twist (..., 3) = [vx, vy, omega]."""
    vx, vy, w = tangent[..., 0], tangent[..., 1], tangent[..., 2]
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    sin_w, cos_w = torch.sin(w_safe), torch.cos(w_safe)
    a = torch.where(small, 1.0 - w * w / 6.0, sin_w / w_safe)
    b = torch.where(small, w / 2.0 - w**3 / 24.0, (1.0 - cos_w) / w_safe)
    x = a * vx - b * vy
    y = b * vx + a * vy
    return torch.stack([x, y, normalize_angle(w)], dim=-1)


def log(pose):
    """SE(2) logarithm to twist (..., 3)."""
    x, y, th = pose[..., 0], pose[..., 1], normalize_angle(pose[..., 2])
    small = torch.abs(th) < 1e-6
    th_safe = torch.where(small, torch.ones_like(th), th)
    half = 0.5 * th_safe
    a = torch.where(small, 1.0 - th * th / 12.0, half / torch.tan(half))
    vx = a * x + 0.5 * th * y
    vy = -0.5 * th * x + a * y
    return torch.stack([vx, vy, th], dim=-1)


def pose_matrix(pose):
    """Homogeneous 3x3 matrix of pose (..., 3)."""
    R = rotmat(pose[..., 2])
    t = pose[..., :2]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=pose.dtype,
                          device=pose.device).expand(top.shape[:-2] + (1, 3))
    return torch.cat([top, bottom], dim=-2)
