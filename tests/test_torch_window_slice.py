"""Kernel K1 (``row_windows``): the port against the JAX package.

On the CPU both sides take their plain paths (the JAX package's
``take_along_axis`` fallback, the port's ``row_windows_plain``); a gather
moves values unchanged, so they must agree exactly, including the
per-element clamp at both image edges.  The CUDA kernel is held against the
plain version in ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from randt_slam_tpu.ops import window_slice as jws
from randt_slam_torch.ops import window_slice as tws
from tests.torch_threads import one_thread  # noqa: F401

A, R = 48, 300


def _inputs(win, where, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((A, R), dtype=np.float32) * 200.0
    rng_row = (np.arange(R, dtype=np.float32) + 0.5) * 0.25
    if where == "random":
        starts = rng.integers(0, R - win + 1, A)
    elif where == "left":
        starts = np.zeros(A, np.int64)
    elif where == "right":
        starts = np.full(A, R - win)
    else:  # outside the caller's contract: the per-element clamp decides
        starts = rng.integers(-win - 3, R + 3, A)
    return img, rng_row, starts.astype(np.int32)


@pytest.mark.parametrize("win", [1, 65, 128])
@pytest.mark.parametrize("where", ["random", "left", "right", "clamped"])
def test_row_windows_matches_jax_exactly(win, where):
    img, rng_row, starts = _inputs(win, where)
    iw_j, rw_j = jws.row_windows(jnp.asarray(img), jnp.asarray(rng_row),
                                 jnp.asarray(starts), win)
    iw_t, rw_t = tws.row_windows(torch.from_numpy(img), torch.from_numpy(rng_row),
                                 torch.from_numpy(starts), win)
    assert iw_t.shape == (A, win) and rw_t.shape == (A, win)
    np.testing.assert_array_equal(iw_t.numpy(), np.asarray(iw_j))
    np.testing.assert_array_equal(rw_t.numpy(), np.asarray(rw_j))
