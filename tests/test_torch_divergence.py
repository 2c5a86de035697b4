"""Cauchy-Schwarz divergence (``ndt/divergence.py``): the port against the
JAX package on identical cells.

The cells are random Gaussians with SPD covariances, some invalid (padding)
and some degenerate (det(cov) below the 1e-5 gate).  Every term is a float32
sum of positive overlaps over up to millions of pairs, taken in another order
on each side (the JAX package's XLA reduction against PyTorch's): the sums
agree within 1e-5 of themselves (a float32 sum of n positive terms carries
O(log n * 6e-8) relative error in a pairwise reduction, O(n * 6e-8) in the
worst order).  The divergence, a sum of logarithms of such terms, agrees
within 1e-4 relative.  The self term is checked below and above its row
chunk (one chunk, and several with a ragged last one), and batched.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randt_slam_torch.ndt import divergence as tD
from tests.torch_threads import one_thread  # noqa: F401

jD = importlib.import_module("randt_slam_tpu.ndt.divergence")

SUM_REL = 1e-5
CS_REL = 1e-4


def _cells(n, seed, spread=40.0):
    rng = np.random.default_rng(seed)
    mean = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                           rng.uniform(50, 150, (n, 1))], 1)
    A = rng.normal(0, 1.0, (n, 3, 3)) * np.array([1.0, 1.0, 5.0])[:, None]
    cov = A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(3)
    cov[: n // 20] *= 1e-3                  # degenerate: det below the gate
    valid = rng.random(n) < 0.85
    return (mean.astype(np.float32), cov.astype(np.float32), valid)


def _both(fn_j, fn_t, *arrays, **kw):
    j = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    t = fn_t(*(torch.from_numpy(np.asarray(a)) for a in arrays), **kw).numpy()
    return j, t


@pytest.mark.parametrize("nf,nm", [(300, 200), (1500, 512)])
def test_interaction_term_matches_jax(nf, nm):
    f = _cells(nf, 1)
    m = _cells(nm, 2)
    j, t = _both(jD.interaction_term, tD.interaction_term, *f, *m)
    assert j > 0
    np.testing.assert_allclose(t, j, rtol=SUM_REL)


@pytest.mark.parametrize("n,row_chunk", [(400, 1024), (2100, 1024), (700, 256)])
def test_self_term_matches_jax(n, row_chunk):
    c = _cells(n, 3)
    j, t = _both(jD.self_term, tD.self_term, *c, row_chunk=row_chunk)
    np.testing.assert_allclose(t, j, rtol=SUM_REL)


def test_self_term_batched_equals_one_by_one():
    """The loop pass gates many candidates at once: a batch of maps gives
    each map's own self term."""
    maps = [_cells(600, s) for s in (4, 5, 6)]
    batch = tD.self_term(*(torch.from_numpy(np.stack(x)) for x in zip(*maps)),
                         row_chunk=256)
    for i, c in enumerate(maps):
        one = tD.self_term(*(torch.from_numpy(x) for x in c), row_chunk=256)
        np.testing.assert_allclose(batch[i].numpy(), one.numpy(), rtol=SUM_REL)


@pytest.mark.parametrize("precomputed", [False, True])
def test_cs_divergence_matches_jax(precomputed):
    f = _cells(1200, 7)
    m = _cells(400, 8, spread=30.0)
    kw = {}
    if precomputed:
        kw = dict(f_self=jD.self_term(*(jnp.asarray(a) for a in f)),
                  m_self=jD.self_term(*(jnp.asarray(a) for a in m)))
    j = np.asarray(jD.cs_divergence(*(jnp.asarray(a) for a in f + m), **kw))
    tkw = {k: torch.from_numpy(np.array(v)) for k, v in kw.items()}
    t = tD.cs_divergence(*(torch.from_numpy(a) for a in f + m), **tkw).numpy()
    assert np.isfinite(j)
    np.testing.assert_allclose(t, j, rtol=CS_REL)
