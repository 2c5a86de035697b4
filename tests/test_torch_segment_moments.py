"""Kernels K2 (``segment_topk_moments``) and K5 (``segment_moments``): the
port against the JAX package.

On the CPU both sides take their plain paths: a segment sum in point order
(then, for K2, the rows of the top-k segments).  ``topi`` must be identical,
including the order among equal counts (``lax.top_k`` puts the lower segment
id first; the port's stable sort must do the same).  Moments agree within
1e-5 of the sum of the absolute values of their terms: a float32 sum of n
terms carries O(n * 6e-8) of that scale in rounding, whatever the order.

K5's CUDA kernel sums each segment's run of the segment-sorted points; the
order and the runs (``segment_order``) are plain PyTorch and are checked
here by summing the runs on the CPU.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from randt_slam_torch.ndt import cells as tC
from randt_slam_torch.ops import segment_moments as tsm

jC = importlib.import_module("randt_slam_tpu.ndt.cells")

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


def _within_scale(got, want, scale):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.all(err <= REL * np.asarray(scale) + 1e-30), err.max()


@pytest.mark.parametrize("P,S", [(5000, 700), (26000, 3249)])
def test_segment_moments_matches_jax(P, S):
    rng = np.random.default_rng(P + 1)
    ids = rng.integers(-1, S + 2, P).astype(np.int32)  # includes dropped ids
    vals = _values(P, 3)
    out_j = jsm.segment_moments(jnp.asarray(vals), jnp.asarray(ids), S)
    out_t = tsm.segment_moments(torch.from_numpy(vals), torch.from_numpy(ids), S)
    scale = jsm.segment_moments(jnp.asarray(np.abs(vals)), jnp.asarray(ids), S)
    assert out_t.shape == (S, vals.shape[1])
    _within_scale(out_t.numpy(), out_j, scale)


@pytest.mark.parametrize("P,S", [(5000, 700), (26000, 3249)])
def test_segment_order_runs_sum_to_plain(P, S):
    """The kernel's decomposition: the stable order and the run offsets give
    every kept point to its own segment's run, once, in point order."""
    rng = np.random.default_rng(P + 2)
    ids = torch.from_numpy(rng.integers(-1, S + 2, P).astype(np.int32))
    vals = torch.from_numpy(_values(P, 4))
    perm, offsets = tsm.segment_order(ids, S)
    assert perm.dtype == offsets.dtype == torch.int32
    assert offsets.shape == (S + 1,) and int(offsets[0]) == 0
    assert int(offsets[-1]) == int(((ids >= 0) & (ids < S)).sum())
    p, o = perm.long(), offsets.long()
    for s in range(0, S, max(1, S // 50)):
        run = p[o[s]:o[s + 1]]
        assert torch.all(ids[run] == s) and torch.all(run[1:] > run[:-1])
    runs = torch.stack([vals[p[o[s]:o[s + 1]]].sum(0) for s in range(S)])
    plain = tsm.segment_moments_plain(vals, ids, S)
    scale = tsm.segment_moments_plain(vals.abs(), ids, S)
    _within_scale(runs.numpy(), plain.numpy(), scale.numpy())


def test_from_points_with_pndt_matches_jax():
    rng = np.random.default_rng(11)
    P, S = 6000, 900
    pts = np.concatenate([rng.normal(0, 30, (P, 2)), rng.uniform(40, 200, (P, 1))],
                         1).astype(np.float32)
    mask = rng.random(P) < 0.7
    ids = rng.integers(-1, S + 1, P).astype(np.int32)
    polar = np.stack([rng.uniform(-np.pi, np.pi, P), rng.uniform(2, 80, P)],
                     1).astype(np.float32)
    beam_cov = np.diag([1e-4, 0.01, 4.0]).astype(np.float32)
    cj = jC.from_points(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(ids), S,
                        polar=jnp.asarray(polar), beam_cov=jnp.asarray(beam_cov))
    ct = tC.from_points(torch.from_numpy(pts), torch.from_numpy(mask),
                        torch.from_numpy(ids), S, polar=torch.from_numpy(polar),
                        beam_cov=beam_cov)
    # scale: each channel's sum of the absolute values of its per-point terms
    chans = tC._moment_channels(torch.from_numpy(pts), torch.from_numpy(mask),
                                torch.from_numpy(polar), beam_cov)
    sc = tC._unpack(tsm.segment_moments_plain(chans.abs(), torch.from_numpy(ids), S))
    for a, b, m in zip(ct, cj, sc):
        _within_scale(a.numpy(), b, m.numpy())
