"""Kernels K2 (``segment_topk_moments``) and K5 (``segment_moments``): the
port against the JAX package.

On the CPU both sides take their plain paths: a segment sum in point order
(then, for K2, the rows of the top-k segments).  ``topi`` must be identical,
including the order among equal counts (``lax.top_k`` puts the lower segment
id first; the port's stable sort must do the same).  Moments agree within
1e-5 of the sum of the absolute values of their terms: a float32 sum of n
terms carries O(n * 6e-8) of that scale in rounding, whatever the order.

K5 is held on the CPU on dense random ids, on every id dropped and on a
sparse frame-like set (about 7 % of the rows kept, ids in runs along the
beams, the rest past the last segment as ``cluster_ids`` gives them); its
CUDA kernel is held against the plain version in
``test_torch_kernels_cuda.py``.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from randt_slam_torch.ndt import cells as tC
from randt_slam_torch.ops import segment_moments as tsm
from tests.torch_threads import one_thread  # noqa: F401

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


def _frame_like_ids(rng, P, S, beam=65):
    """About 7 % of the rows kept: runs of a few neighbouring points along
    a beam share a cell, every other id is S (dropped)."""
    ids = np.full(P, S, np.int64)
    keep = rng.random(P) < 0.07
    cells = np.repeat(rng.integers(0, S, P // beam + 1), beam)[:P]
    ids[keep] = cells[keep]
    return ids


@pytest.mark.parametrize("P,S,kind", [(5000, 700, "random"), (26000, 3249, "random"),
                                      (26000, 3249, "random_int64"),
                                      (26000, 3249, "all_dropped"),
                                      (26000, 3249, "frame_like")])
def test_segment_moments_matches_jax(P, S, kind):
    rng = np.random.default_rng(P + 1)
    if kind.startswith("random"):  # includes dropped ids
        ids = rng.integers(-1, S + 2, P).astype(np.int64 if kind.endswith("64") else np.int32)
    elif kind == "all_dropped":
        ids = np.full(P, -1, np.int32)
    else:
        ids = _frame_like_ids(rng, P, S)
    vals = _values(P, 3)
    out_j = jsm.segment_moments(jnp.asarray(vals), jnp.asarray(ids), S)
    out_t = tsm.segment_moments(torch.from_numpy(vals), torch.from_numpy(ids), S)
    scale = jsm.segment_moments(jnp.asarray(np.abs(vals)), jnp.asarray(ids), S)
    assert out_t.shape == (S, vals.shape[1])
    _within_scale(out_t.numpy(), out_j, scale)
    if kind == "all_dropped":
        assert not out_t.any()


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
