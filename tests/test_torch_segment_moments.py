"""Kernel K2 (``segment_topk_moments``): the port against the JAX package.

On the CPU both sides take their plain paths: a segment sum in point order,
then the rows of the top-k segments.  ``topi`` must be identical, including
the order among equal counts (``lax.top_k`` puts the lower segment id first;
the port's stable sort must do the same).  Moments agree within 1e-5 of the
sum of the absolute values of their terms: a float32 sum of n terms carries
O(n * 6e-8) of that scale in rounding, whatever the order.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from randt_slam_torch.ops import segment_moments as tsm

# the JAX package's ``ops`` re-exports a function under the module's name
jsm = importlib.import_module("randt_slam_tpu.ops.segment_moments")

REL = 1e-5


def _values(P, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 30.0, (P, 3)).astype(np.float32)
    w = (rng.random(P) < 0.8).astype(np.float32)
    outer = (pts[:, :, None] * pts[:, None, :]).reshape(P, 9)
    vals = np.concatenate([w[:, None], pts * w[:, None], outer * w[:, None]], 1)
    return vals.astype(np.float32)


def _check(vals, ids, S, k):
    out_j, topi_j = jsm.segment_topk_moments(jnp.asarray(vals), jnp.asarray(ids), S, k)
    out_t, topi_t = tsm.segment_topk_moments(torch.from_numpy(vals),
                                             torch.from_numpy(ids), S, k)
    np.testing.assert_array_equal(topi_t.numpy(), np.asarray(topi_j))
    scale, _ = jsm.segment_topk_moments(jnp.asarray(np.abs(vals)), jnp.asarray(ids), S, k)
    err = np.abs(out_t.numpy() - np.asarray(out_j))
    assert np.all(err <= REL * np.asarray(scale) + 1e-30), err.max()
    return topi_t.numpy(), out_t.numpy()


@pytest.mark.parametrize("P,S,k", [(4000, 900, 256), (26000, 3249, 512)])
def test_segment_topk_moments_matches_jax(P, S, k):
    rng = np.random.default_rng(P)
    ids = rng.integers(-1, S + 2, P).astype(np.int32)  # includes dropped ids
    _check(_values(P, 1), ids, S, k)


def test_tied_counts_keep_lax_top_k_order():
    # 300 segments hold exactly 4 points each and 200 hold 2: every count
    # ties, and k cuts through the 4-point group; the lower id must win.
    S, k = 700, 150
    rng = np.random.default_rng(7)
    four = rng.permutation(np.r_[0:400, 600:S])[:300]
    ids = np.concatenate([np.repeat(four, 4),
                          np.repeat(np.arange(400, 600), 2)]).astype(np.int32)
    ids = ids[rng.permutation(len(ids))]
    vals = _values(len(ids), 2)
    vals[:, 0] = 1.0
    topi, _ = _check(vals, ids, S, k)
    counts = np.bincount(ids, minlength=S)
    assert np.all(counts[topi] == 4)
    assert np.all(np.diff(topi) > 0)  # equal counts: ascending segment id
