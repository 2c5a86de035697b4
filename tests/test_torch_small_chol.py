"""Kernel K4 (``ops/small_chol``): the port's plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) and a float64 solve.

The systems are those the LM loop solves: a Gauss-Newton H with curvatures
over several decades, Jacobi-scaled so that active diagonals are 1, damped
by lambda, with exact identity rows on frozen parameters (the anchor pose
and bias, AX/AY under the constant-velocity model).  P = 36.

Tolerance: the textbook forward-error bound of a float32 Cholesky solve,
|x - x64|_inf <= 4 P eps32 kappa(A) |x64|_inf, with kappa the 2-norm
condition number computed in float64.  The plain version and the JAX kernel
run the same steps in float32, so they are held to each other by the same
bound.  The residual |A x - b| of the plain solve is held to
4 P eps32 |A| |x| (backward stability, independent of kappa).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from randt_slam_tpu.ops import small_chol as jSC
from randt_slam_torch.ops import small_chol as tSC
from tests.torch_threads import one_thread  # noqa: F401

P = 36
EPS32 = float(np.finfo(np.float32).eps)


def _frozen():
    f = np.zeros(P, bool)
    f[[0, 1, 2, 8]] = True          # anchor pose and bias
    f[6::9] = f[7::9] = True        # AX, AY under the constant-velocity model
    return f


def _system(rng, lam):
    # singular values over 3 decades along random directions (which Jacobi
    # scaling cannot undo), columns over 5 decades (which it does)
    Q = np.linalg.qr(rng.normal(0, 1, (P, P)))[0]
    J = rng.normal(0, 1, (3 * P, P)) @ (Q * np.logspace(-3, 0, P)) @ Q.T
    J = J * np.logspace(-3, 2, P)[None, :]
    H = J.T @ J
    active = ~_frozen()
    H = H * active[:, None] * active[None, :]
    d = np.where(active, 1.0 / np.sqrt(np.maximum(np.diag(H), 1e-10)), 0.0)
    A = H * d[:, None] * d[None, :] + np.diag(np.where(active, lam, 1.0))
    b = rng.normal(0, 1, P) * active + 0.3 * (~active)
    return A.astype(np.float32), b.astype(np.float32)


def _bound(A, x64):
    kappa = np.linalg.cond(A.astype(np.float64))
    return 4 * P * EPS32 * kappa * np.abs(x64).max()


@pytest.mark.parametrize("lam", [1e-4, 1e-2, 1.0])
def test_chol_solve_plain_matches_jax_and_float64(lam):
    rng = np.random.default_rng(int(lam * 1e4))
    A, b = _system(rng, lam)
    x64 = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    bound = _bound(A, x64)
    x = tSC.chol_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    xj = np.asarray(jSC.chol_solve(jnp.asarray(A), jnp.asarray(b), interpret=True))
    assert np.abs(x - x64).max() <= bound, (np.abs(x - x64).max(), bound)
    assert np.abs(x - xj).max() <= bound, (np.abs(x - xj).max(), bound)
    res = np.abs(A.astype(np.float64) @ x - b).max()
    assert res <= 4 * P * EPS32 * np.abs(A).max() * np.abs(x).max()
    # frozen rows are identity rows: their solution is b exactly
    fz = _frozen()
    np.testing.assert_array_equal(x[fz], b[fz])


def test_chol_solve_plain_batched_equals_one_by_one():
    rng = np.random.default_rng(11)
    systems = [_system(rng, lam) for lam in (1e-4, 1e-1, 10.0)]
    A = torch.from_numpy(np.stack([s[0] for s in systems]))
    b = torch.from_numpy(np.stack([s[1] for s in systems]))
    xb = tSC.chol_solve(A, b)
    for i in range(len(systems)):
        assert torch.equal(xb[i], tSC.chol_solve(A[i], b[i]))
