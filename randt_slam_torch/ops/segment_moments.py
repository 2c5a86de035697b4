"""Segment sums of the per-point moment channels (kernels K2 and K5).

Port of ``randt_slam_tpu/ops/segment_moments.py``.

:func:`segment_topk_moments` (K2, ``csrc/segment_moments.cu``): the
scan-NDT build keeps only the ``k`` most-populated cluster cells of a scan,
so the multi-channel moment reduction only covers those ``k`` segments:

1. per-segment point counts (channel 0, the 0/1 point weight) -- plain
   PyTorch; the sums are exact integers, so their order does not matter;
2. the ``k`` largest counts, lower segment id first among equal counts (the
   order of ``lax.top_k``; counts tie all the time, so a stable sort);
3. the moment pass over those ``k`` segments -- the kernel on CUDA tensors,
   :func:`topi_moments_plain` on CPU tensors.

A leading batch axis is optional: values (B, P, CH), ids (B, P) give
(B, k, CH) and (B, k), each scan's counts, order and sums its own (one
``index_add`` over member-offset ids, one sort along the last axis, one
kernel launch with a grid axis over the scans).

:func:`segment_moments` (K5, ``csrc/segment_sum.cu``): the full segment sum
behind ``ndt/cells.from_points``.  On a CUDA tensor the whole function is
one kernel launch: each of a cluster's blocks sums its stretch of the
points per segment in point order (a stable counting sort in shared memory),
and the stretches' sums are added in order, reading the ids
as the caller has them (int32 or int64).  CPU tensors take
:func:`segment_moments_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import runtime
from ..utils import profiling
from . import build

MAX_CHANNELS = 16
# K5's limits (``csrc/segment_sum.cu``): a block keeps its share of the
# points in shared memory
MAX_POINTS = 1 << 17
MAX_SEGMENTS = 1 << 16


def _member_ids(ids, num_segments: int):
    """Ids outside [0, num_segments) set to num_segments, as int64; with a
    batch axis, member b's shifted by b * (num_segments + 1) so that one
    flat segment sum keeps the members apart."""
    ok = (ids >= 0) & (ids < num_segments)
    safe = torch.where(ok, ids, num_segments).long()
    if ids.dim() > 1:
        n = num_segments + 1
        safe = safe + torch.arange(0, ids.shape[0] * n, n,
                                   device=ids.device)[:, None]
    return safe.reshape(-1)


def topi_moments_plain(values, ids, topi, num_segments: int):
    """out[s] = sum_p [ids[p] == topi[s]] values[p] as the JAX package's plain
    path computes it: the full segment sum, then the rows of ``topi``.
    ``ids`` outside [0, num_segments) are dropped.  values (..., P, CH),
    ids (..., P), topi (..., k)."""
    CH = values.shape[-1]
    full = runtime.index_add(
        values.new_zeros((math.prod(ids.shape[:-1]) * (num_segments + 1), CH)),
        _member_ids(ids, num_segments), values.reshape(-1, CH))
    if ids.dim() == 1:
        return full[:num_segments][topi.long()]
    full = full.reshape(ids.shape[0], num_segments + 1, CH)
    return torch.gather(full, 1, topi.long()[..., None].expand(*topi.shape, CH))


def _lib():
    lib = build.library("segment_moments")
    fn = lib.topi_moments_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def topi_moments_cuda(values, ids, topi):
    """Launch the K2 moment kernel on values (P, CH), ids (P,) int32 with -1
    for dropped points and topi (k,) int32 segment ids, or a batch of them
    (B, P, CH), (B, P), (B, k); raises on anything else."""
    if not (values.is_cuda and ids.device == values.device
            and topi.device == values.device):
        raise ValueError("topi_moments_cuda: all tensors must be on one CUDA device")
    if values.dtype != torch.float32 or ids.dtype != torch.int32 \
            or topi.dtype != torch.int32:
        raise TypeError("topi_moments_cuda: float32 values, int32 ids and topi")
    if values.dim() not in (2, 3) or ids.shape != values.shape[:-1] \
            or topi.dim() != ids.dim() or topi.shape[:-1] != ids.shape[:-1]:
        raise ValueError("topi_moments_cuda: shapes (P, CH), (P,), (k,) or "
                         "(B, P, CH), (B, P), (B, k) expected")
    if not 1 <= values.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"topi_moments_cuda: 1 <= CH <= {MAX_CHANNELS}")
    if not (values.is_contiguous() and ids.is_contiguous()
            and topi.is_contiguous()):
        raise ValueError("topi_moments_cuda: inputs must be contiguous")
    P, CH = values.shape[-2:]
    k = topi.shape[-1]
    B = values.shape[0] if values.dim() == 3 else 1
    out = values.new_empty(topi.shape + (CH,))
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _lib()(values.data_ptr(), ids.data_ptr(), topi.data_ptr(),
                 out.data_ptr(), B, P, CH, k, stream)
    if err != 0:
        raise RuntimeError(f"segment_topk_moments kernel launch failed: CUDA error {err}")
    profiling.count("kernel.segment_topk_moments")
    return out


def segment_topk_moments(values, ids, num_segments: int, k: int):
    """Reduce ``values`` (..., P, CH) into the ``k`` segments with the
    largest channel-0 sums: returns ``(out (..., k, CH), seg_ids (..., k))``
    ordered by descending count, per scan of a batch."""
    ok = (ids >= 0) & (ids < num_segments)
    # Channel 0 holds 0/1 point weights: the float sums are exact integers,
    # identical in any order, so the plain scatter-add is reproducible here.
    counts = torch.index_add(
        values.new_zeros(math.prod(ids.shape[:-1]) * (num_segments + 1)), 0,
        _member_ids(ids, num_segments), values[..., 0].reshape(-1))
    counts = counts.reshape(ids.shape[:-1] + (num_segments + 1,))[..., :num_segments]
    topi = torch.sort(counts, dim=-1, descending=True, stable=True)[1][..., :k]
    if values.device.type == "cuda":
        ids32 = torch.where(ok, ids, -1).to(torch.int32)
        out = topi_moments_cuda(values.contiguous(), ids32,
                                topi.to(torch.int32))
        return out, topi
    if values.device.type == "cpu":
        return topi_moments_plain(values, ids, topi, num_segments), topi
    raise ValueError(f"segment_topk_moments: unsupported device {values.device}")


def segment_moments_plain(values, ids, num_segments: int):
    """out[s] = sum_p [ids[p] == s] values[p], s < num_segments; ids outside
    [0, num_segments) are dropped (the JAX package's plain segment sum)."""
    ok = (ids >= 0) & (ids < num_segments)
    safe = torch.where(ok, ids, num_segments).long()
    out = runtime.index_add(
        values.new_zeros((num_segments + 1, values.shape[1])), safe, values)
    return out[:num_segments]


def _sum_fn(ids_dtype):
    lib = build.library("segment_sum")
    fn = (lib.segment_sum_i64_f32 if ids_dtype == torch.int64
          else lib.segment_sum_i32_f32)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def segment_moments_cuda(values, ids, num_segments: int):
    """Launch the K5 kernel: ``values`` (P, CH) float32, ``ids`` (P,) int32
    or int64, ``num_segments`` <= MAX_SEGMENTS, P <= MAX_POINTS; raises on
    anything else."""
    if not (values.is_cuda and ids.device == values.device):
        raise ValueError("segment_moments_cuda: all tensors must be on one CUDA device")
    if values.dtype != torch.float32 or ids.dtype not in (torch.int32, torch.int64):
        raise TypeError("segment_moments_cuda: float32 values, int32 or int64 ids")
    if values.dim() != 2 or ids.shape != (values.shape[0],):
        raise ValueError("segment_moments_cuda: shapes (P, CH), (P,) expected")
    if not 1 <= values.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"segment_moments_cuda: 1 <= CH <= {MAX_CHANNELS}")
    if not 0 <= num_segments <= MAX_SEGMENTS:
        raise ValueError(f"segment_moments_cuda: 0 <= S <= {MAX_SEGMENTS}")
    if values.shape[0] > MAX_POINTS:
        raise ValueError(f"segment_moments_cuda: P <= {MAX_POINTS}")
    if not (values.is_contiguous() and ids.is_contiguous()):
        raise ValueError("segment_moments_cuda: inputs must be contiguous")
    P, CH = values.shape
    out = torch.empty((num_segments, CH), dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _sum_fn(ids.dtype)(values.data_ptr(), ids.data_ptr(), out.data_ptr(),
                             P, num_segments, CH, stream)
    if err != 0:
        raise RuntimeError(f"segment_moments kernel launch failed: CUDA error {err}")
    profiling.count("kernel.segment_moments")
    return out


def segment_moments(values, ids, num_segments: int):
    """Masked segment sum: out[s] = sum_p [ids[p] == s] values[p] for
    s < num_segments, ids outside [0, num_segments) dropped.  ``values``
    (P, CH) float32: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if values.device.type == "cuda":
        return segment_moments_cuda(values.contiguous(), ids.contiguous(),
                                    num_segments)
    if values.device.type == "cpu":
        return segment_moments_plain(values, ids, num_segments)
    raise ValueError(f"segment_moments: unsupported device {values.device}")
