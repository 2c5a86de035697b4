"""Kernels K3a/K3b (``ops/ndt_linearize``): the port's plain versions against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

The inputs come from a numpy seed, as in ``tests/test_ndt_linearize.py``.

* ``pack_pairs``: equal to the JAX pack (a copy of the same numbers).
* ``linearize_plain`` for alpha in {-2, 0, 2} (the general, Cauchy and
  quadratic Barron branches): H, g and the cost sum within 1e-5 of each
  output's scale, the sum of the absolute values of its per-pair terms.
  Both sides evaluate the same formulas in float32; what differs is the
  order of the N-term sums (n * 6e-8 of the scale at most) and the ulps of
  cos, sin and pow (a few 1e-7 of each term).
* ``robust_cost_plain``: the cost sum within 1e-5 of its scale, the largest
  squared residual within 1e-6 of itself (a maximum involves no sum).
* A valid NaN pair makes the cost sum and the maximum NaN, as in the JAX
  kernel.
* An all-invalid slot gives exact zeros.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from randt_slam_tpu.ops import ndt_linearize as jNL
from randt_slam_torch.ops import ndt_linearize as tNL
from tests.torch_threads import one_thread  # noqa: F401

REL = 1e-5


def _random_pairs(rng, W, N):
    def spd(n):
        A = rng.normal(0, 0.3, (n, 3, 3))
        return (A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(3)).astype(np.float32)

    m_mean = rng.uniform(-20, 20, (W, N, 3)).astype(np.float32)
    a_mean = (m_mean + rng.normal(0, 1.0, (W, N, 3))).astype(np.float32)
    m_cov = np.stack([spd(N) for _ in range(W)])
    a_cov = np.stack([spd(N) for _ in range(W)])
    valid = rng.random((W, N)) < 0.7
    poses = rng.normal(0, 0.5, (W, 3)).astype(np.float32)
    return poses, m_mean, m_cov, a_mean, a_cov, valid


def _packs(pairs):
    _, m_mean, m_cov, a_mean, a_cov, valid = pairs
    pj = jNL.pack_pairs(*(jnp.asarray(x) for x in (m_mean, m_cov, a_mean, a_cov, valid)))
    pt = tNL.pack_pairs(*(torch.from_numpy(x) for x in (m_mean, m_cov, a_mean, a_cov, valid)))
    return pj, pt


def _close(got, want, scale):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= REL * np.asarray(scale) + 1e-30), (err.max(), np.asarray(scale).max())


def test_pack_pairs_matches_jax():
    rng = np.random.default_rng(5)
    # (W, F, C, K) pairs with the moving cells broadcast over F and K, as the
    # matcher hands them over (expanded views)
    W, F, C, K = 3, 2, 16, 2
    m_mean = torch.from_numpy(rng.normal(0, 5, (W, 1, C, 1, 3)).astype(np.float32))
    m_cov = torch.from_numpy(rng.normal(0, 1, (W, 1, C, 1, 3, 3)).astype(np.float32))
    a_mean = rng.normal(0, 5, (W, F, C, K, 3)).astype(np.float32)
    a_cov = rng.normal(0, 1, (W, F, C, K, 3, 3)).astype(np.float32)
    valid = rng.random((W, F, C, K)) < 0.5
    pt = tNL.pack_pairs(m_mean.expand(W, F, C, K, 3), m_cov.expand(W, F, C, K, 3, 3),
                        torch.from_numpy(a_mean), torch.from_numpy(a_cov),
                        torch.from_numpy(valid))
    pj = jNL.pack_pairs(jnp.broadcast_to(jnp.asarray(m_mean.numpy()), (W, F, C, K, 3)),
                        jnp.broadcast_to(jnp.asarray(m_cov.numpy()), (W, F, C, K, 3, 3)),
                        jnp.asarray(a_mean), jnp.asarray(a_cov), jnp.asarray(valid))
    for a, b in zip(pt, pj):
        assert a.is_contiguous() and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("alpha", [-2.0, 0.0, 2.0])
def test_linearize_plain_matches_jax_kernel(alpha):
    rng = np.random.default_rng(0)
    W, N = 3, 256
    pairs = _random_pairs(rng, W, N)
    poses = pairs[0]
    scale, mu, ndt_scale = 1.0, 4.0, 0.37
    pj, pt = _packs(pairs)
    Hj, gj, rhoj = jNL.linearize(jnp.asarray(poses), mu, ndt_scale, pj,
                                 scale=scale, alpha=alpha, interpret=True)

    pose4 = tNL.pose_inputs(torch.from_numpy(poses))
    mu_t, ns_t = torch.tensor(mu), torch.tensor(ndt_scale)
    H, g, rho = tNL.linearize_plain(pose4, mu_t, ns_t, pt, scale, alpha)
    Hs, gs, rhos = tNL.sums_to_blocks(
        tNL.linearize_terms(pose4, mu_t, ns_t, pt, scale, alpha).abs().sum(-1))
    _close(H.numpy(), Hj, Hs.numpy())
    _close(g.numpy(), gj, gs.numpy())
    _close(rho.sum().item(), float(rhoj), rhos.sum().item())
    # the dispatching entry point takes the plain version on a CPU tensor
    H2, g2, rho2 = tNL.linearize(torch.from_numpy(poses), mu_t, ns_t, pt, scale, alpha)
    assert torch.equal(H2, H) and torch.equal(g2, g) and torch.equal(rho2, rho.sum())


def test_robust_cost_plain_matches_jax_kernel():
    rng = np.random.default_rng(1)
    W, N = 2, 128
    pairs = _random_pairs(rng, W, N)
    scale, alpha, mu = 1.5, 0.0, 2.0
    pj, pt = _packs(pairs)
    rhoj, r2mj = jNL.robust_cost(jnp.asarray(pairs[0]), mu, pj, scale=scale,
                                 alpha=alpha, interpret=True)
    pose4 = tNL.pose_inputs(torch.from_numpy(pairs[0]))
    rho, r2m = tNL.robust_cost_plain(pose4, torch.tensor(mu), pt, scale, alpha)
    terms, _ = tNL.robust_cost_terms(pose4, torch.tensor(mu), pt, scale, alpha)
    _close(rho.sum().item(), float(rhoj), terms.abs().sum().item())
    np.testing.assert_allclose(r2m.amax().item(), float(r2mj), rtol=1e-6)
    rho2, r2m2 = tNL.robust_cost(torch.from_numpy(pairs[0]), torch.tensor(mu), pt,
                                 scale, alpha)
    assert rho2.item() == rho.sum().item() and r2m2.item() == r2m.amax().item()


def test_nan_pair_passes_on_like_jax_kernel():
    """A valid pair with a non-finite mean: the cost sum and the largest
    squared residual are NaN on both sides (a maximum that dropped the NaN
    would hand the GNC mu initialisation a finite value)."""
    rng = np.random.default_rng(7)
    pairs = list(_random_pairs(rng, 2, 64))
    pairs[5][1, 3] = True
    pairs[3][1, 3, 0] = np.nan
    pj, pt = _packs(pairs)
    rhoj, r2mj = jNL.robust_cost(jnp.asarray(pairs[0]), 2.0, pj, scale=1.0,
                                 alpha=-2.0, interpret=True)
    rho, r2m = tNL.robust_cost(torch.from_numpy(pairs[0]), torch.tensor(2.0), pt,
                               1.0, -2.0)
    assert np.isnan(float(rhoj)) and np.isnan(float(r2mj))
    assert rho.isnan() and r2m.isnan()


def test_all_invalid_slot_is_zero():
    rng = np.random.default_rng(2)
    W, N = 1, 64
    poses, m_mean, m_cov, a_mean, a_cov, _ = _random_pairs(rng, W, N)
    valid = np.zeros((W, N), bool)
    _, pt = _packs((poses, m_mean, m_cov, a_mean, a_cov, valid))
    one = torch.tensor(1.0)
    H, g, rho = tNL.linearize(torch.from_numpy(poses), one, one, pt, 1.0, -2.0)
    assert float(H.abs().max()) == 0.0
    assert float(g.abs().max()) == 0.0
    assert float(rho) == 0.0
    rho, r2m = tNL.robust_cost(torch.from_numpy(poses), one, pt, 1.0, -2.0)
    assert float(rho) == 0.0 and float(r2m) == 0.0
