"""Damped SPD solve of the window smoother (kernel K4, ``csrc/small_chol.cu``).

Port of ``randt_slam_tpu/ops/small_chol.py``.  Each LM iteration solves the
Jacobi-scaled, damped (P, P) normal equations, P = (W + 1) * 9 = 36: an
unblocked right-looking Cholesky, then forward and back substitution.  The
system must be SPD (Gauss-Newton H after Jacobi scaling, positive damping,
identity rows on frozen parameters; ``registration/solver.py``).

A leading batch dimension is allowed: A (B, P, P), b (B, P), one warp per
system, its lower triangle and b in the warp's shared memory.  On a CUDA
tensor :func:`chol_solve` launches the kernel; on a CPU tensor it runs
:func:`chol_solve_plain`, the same factorization as a P-step loop of tensor
ops (the kernel sums each entry's products in the same order, but
multiplies by the pivots' rsqrt where the plain version divides by L_jj,
and orders the substitutions' sums by column).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import build

MAX_P = 64  # each lane of the kernel's warp owns at most 3 of the P + 1 rows


def chol_solve_plain(A, b):
    """x with A x = b for SPD A (..., P, P), b (..., P); K4's plain version."""
    P = A.shape[-1]
    L = A.clone()
    for j in range(P):
        d = torch.rsqrt(torch.clamp(L[..., j, j], min=1e-30))
        lcol = L[..., j:, j] * d[..., None]
        L[..., j:, j] = lcol
        L[..., j + 1:, j + 1:] -= lcol[..., 1:, None] * lcol[..., None, 1:]
    y = torch.zeros_like(b)
    for j in range(P):
        acc = torch.sum(L[..., j, :j] * y[..., :j], dim=-1)
        y[..., j] = (b[..., j] - acc) / L[..., j, j]
    x = torch.zeros_like(b)
    for j in reversed(range(P)):
        acc = torch.sum(L[..., j + 1:, j] * x[..., j + 1:], dim=-1)
        x[..., j] = (y[..., j] - acc) / L[..., j, j]
    return x


def _lib():
    fn = build.library("small_chol").chol_solve_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def chol_solve_cuda(A, b):
    """Launch K4 on A (P, P) or (B, P, P) and b (P,) or (B, P); raises on
    anything it does not take."""
    if not (A.is_cuda and b.device == A.device):
        raise ValueError("chol_solve_cuda: A and b must be on one CUDA device")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("chol_solve_cuda: float32 A and b expected")
    if A.dim() not in (2, 3) or A.shape[-1] != A.shape[-2] \
            or b.shape != A.shape[:-1]:
        raise ValueError("chol_solve_cuda: shapes (B, P, P) and (B, P), or "
                         "(P, P) and (P,), expected")
    P = A.shape[-1]
    if not 1 <= P <= MAX_P:
        raise ValueError(f"chol_solve_cuda: 1 <= P <= {MAX_P}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("chol_solve_cuda: inputs must be contiguous")
    B = A.shape[0] if A.dim() == 3 else 1
    x = torch.empty_like(b)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _lib()(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, P, stream)
    if err != 0:
        raise RuntimeError(f"chol_solve kernel launch failed: CUDA error {err}")
    profiling.count("kernel.chol_solve")
    return x


def chol_solve(A, b):
    """Solve SPD A x = b (see :func:`chol_solve_plain`).  CUDA tensors go
    through the kernel, CPU tensors through the plain version."""
    if A.device.type == "cuda":
        return chol_solve_cuda(A, b)
    if A.device.type == "cpu":
        return chol_solve_plain(A, b)
    raise ValueError(f"chol_solve: unsupported device {A.device}")
