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

:func:`segment_moments` (K5, ``csrc/segment_sum.cu``): the full segment sum
behind ``ndt/cells.from_points``.  The points are ordered by segment with a
stable sort of the ids and each segment's run is found by a binary search
(plain PyTorch, exact integer work); the kernel then sums each run in a
fixed order.  CPU tensors take :func:`segment_moments_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import runtime
from . import build

MAX_CHANNELS = 16


def topi_moments_plain(values, ids, topi, num_segments: int):
    """out[s] = sum_p [ids[p] == topi[s]] values[p] as the JAX package's plain
    path computes it: the full segment sum, then the rows of ``topi``.
    ``ids`` outside [0, num_segments) are dropped."""
    ok = (ids >= 0) & (ids < num_segments)
    safe = torch.where(ok, ids, num_segments).long()
    full = runtime.index_add(
        values.new_zeros((num_segments + 1, values.shape[1])), safe, values)
    return full[:num_segments][topi.long()]


def _lib():
    lib = build.library("segment_moments")
    fn = lib.topi_moments_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def topi_moments_cuda(values, ids, topi):
    """Launch the K2 moment kernel.  ``ids`` (P,) int32 with -1 for dropped
    points, ``topi`` (k,) int32 segment ids; raises on anything else."""
    if not (values.is_cuda and ids.device == values.device
            and topi.device == values.device):
        raise ValueError("topi_moments_cuda: all tensors must be on one CUDA device")
    if values.dtype != torch.float32 or ids.dtype != torch.int32 \
            or topi.dtype != torch.int32:
        raise TypeError("topi_moments_cuda: float32 values, int32 ids and topi")
    if values.dim() != 2 or ids.shape != (values.shape[0],) or topi.dim() != 1:
        raise ValueError("topi_moments_cuda: shapes (P, CH), (P,), (k,) expected")
    if not 1 <= values.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"topi_moments_cuda: 1 <= CH <= {MAX_CHANNELS}")
    if not (values.is_contiguous() and ids.is_contiguous()
            and topi.is_contiguous()):
        raise ValueError("topi_moments_cuda: inputs must be contiguous")
    P, CH = values.shape
    k = topi.shape[0]
    out = torch.empty((k, CH), dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _lib()(values.data_ptr(), ids.data_ptr(), topi.data_ptr(),
                 out.data_ptr(), P, CH, k, stream)
    if err != 0:
        raise RuntimeError(f"segment_topk_moments kernel launch failed: CUDA error {err}")
    build.LAUNCHES["segment_topk_moments"] += 1
    return out


def segment_topk_moments(values, ids, num_segments: int, k: int):
    """Reduce ``values`` (P, CH) into the ``k`` segments with the largest
    channel-0 sums: returns ``(out (k, CH), seg_ids (k,))`` ordered by
    descending count."""
    ok = (ids >= 0) & (ids < num_segments)
    safe = torch.where(ok, ids, num_segments).long()
    # Channel 0 holds 0/1 point weights: the float sums are exact integers,
    # identical in any order, so the plain scatter-add is reproducible here.
    counts = torch.index_add(values.new_zeros(num_segments + 1), 0, safe,
                             values[:, 0])[:num_segments]
    topi = torch.sort(counts, descending=True, stable=True)[1][:k]
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


def segment_order(ids, num_segments: int):
    """``(perm, offsets)``: the point order sorted by segment (stable, so the
    order within a segment is the point order) and the run boundaries,
    segment s owning sorted positions [offsets[s], offsets[s + 1]); dropped
    ids sort after every segment.  Both int32."""
    ok = (ids >= 0) & (ids < num_segments)
    key = torch.where(ok, ids, num_segments).long()
    sorted_key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, device=ids.device)
    offsets = torch.searchsorted(sorted_key, bounds)
    return perm.to(torch.int32), offsets.to(torch.int32)


def _sum_lib():
    lib = build.library("segment_sum")
    fn = lib.segment_sum_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def segment_sum_cuda(values, perm, offsets):
    """Launch the K5 kernel.  ``values`` (P, CH) float32, ``perm`` (P,) and
    ``offsets`` (S + 1,) int32 from :func:`segment_order`; raises on
    anything else."""
    if not (values.is_cuda and perm.device == values.device
            and offsets.device == values.device):
        raise ValueError("segment_sum_cuda: all tensors must be on one CUDA device")
    if values.dtype != torch.float32 or perm.dtype != torch.int32 \
            or offsets.dtype != torch.int32:
        raise TypeError("segment_sum_cuda: float32 values, int32 perm and offsets")
    if values.dim() != 2 or perm.shape != (values.shape[0],) \
            or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError("segment_sum_cuda: shapes (P, CH), (P,), (S + 1,) expected")
    if not 1 <= values.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"segment_sum_cuda: 1 <= CH <= {MAX_CHANNELS}")
    if not (values.is_contiguous() and perm.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("segment_sum_cuda: inputs must be contiguous")
    S = offsets.shape[0] - 1
    CH = values.shape[1]
    out = torch.empty((S, CH), dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = _sum_lib()(values.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                     out.data_ptr(), S, CH, stream)
    if err != 0:
        raise RuntimeError(f"segment_moments kernel launch failed: CUDA error {err}")
    build.LAUNCHES["segment_moments"] += 1
    return out


def segment_moments(values, ids, num_segments: int):
    """Masked segment sum: out[s] = sum_p [ids[p] == s] values[p] for
    s < num_segments, ids outside [0, num_segments) dropped.  ``values``
    (P, CH) float32: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if values.device.type == "cuda":
        perm, offsets = segment_order(ids, num_segments)
        return segment_sum_cuda(values.contiguous(), perm, offsets)
    if values.device.type == "cpu":
        return segment_moments_plain(values, ids, num_segments)
    raise ValueError(f"segment_moments: unsupported device {values.device}")
