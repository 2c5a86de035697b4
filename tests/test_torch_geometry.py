"""SE(2) geometry of the PyTorch port against the JAX package.

Inputs come from numpy with a seed and go through both packages on the CPU.
Tolerance 2e-6 absolute: the two frameworks' float32 sin/cos may differ by
one unit in the last place, which moves a pose of |x| <= 10 m by ~1e-6 m.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from randt_slam_tpu import geometry as jgeo
from randt_slam_torch import geometry as tgeo
from tests.torch_threads import one_thread  # noqa: F401

ATOL = 2e-6


def _poses(seed, n=64):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


@pytest.mark.parametrize("name", ["compose", "relative"])
def test_binary_ops_match_jax(name):
    a, b = _poses(0), _poses(1)
    out_t = getattr(tgeo, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    out_j = np.asarray(getattr(jgeo, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


@pytest.mark.parametrize("name", ["inverse", "pose_matrix", "exp", "log"])
def test_unary_ops_match_jax(name):
    a = _poses(2)
    a[:4, 2] = [0.0, 1e-8, -1e-7, np.pi]  # small-angle branches of exp/log
    out_t = getattr(tgeo, name)(torch.from_numpy(a)).numpy()
    out_j = np.asarray(getattr(jgeo, name)(jnp.asarray(a)))
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_normalize_angle_and_transform_points_match_jax():
    th = np.asarray([0.0, np.pi, -np.pi, 3 * np.pi, -2.5 * np.pi, 0.1, 7.0],
                    np.float32)
    np.testing.assert_array_equal(
        tgeo.normalize_angle(torch.from_numpy(th)).numpy(),
        np.asarray(jgeo.normalize_angle(jnp.asarray(th))))
    pose = _poses(3, 1)[0]
    pts = np.random.default_rng(4).uniform(-50, 50, (32, 2)).astype(np.float32)
    out_t = tgeo.transform_points(torch.from_numpy(pose), torch.from_numpy(pts))
    out_j = jgeo.transform_points(jnp.asarray(pose), jnp.asarray(pts))
    # |p| <= 60 m: one float32 ulp of the rotation is ~4e-6 m
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
