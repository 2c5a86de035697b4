"""Per-row contiguous window extraction (kernel K1, ``csrc/window_slice.cu``).

Port of ``randt_slam_tpu/ops/window_slice.py``.  The radar intensity filter
gathers a fixed window of range bins around each azimuth's peak
(``RadarPreprocessor::filterScan``, ``radar_preprocessor.cpp:45-125``).  On a
CUDA tensor :func:`row_windows` launches the hand-written kernel; on a CPU
tensor it runs :func:`row_windows_plain`, the same function in plain PyTorch.

A leading batch axis is optional: img (B, A, R), rng_row (B, R), starts
(B, A) take B scans in one launch, each row reading its own scan's range
row.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import build

MAX_WIN = 1024  # the widest window the wrapper takes


def row_windows_plain(img, rng_row, starts, win: int):
    """out_img[..., a, w] = img[..., a, j], out_rng[..., a, w] = rng_row[..., j]
    with j = clamp(starts[..., a] + w, 0, R - 1) (the JAX package's plain
    path); img (..., A, R), rng_row (..., R), starts (..., A)."""
    R = img.shape[-1]
    jw = starts[..., None].long() + torch.arange(win, device=img.device)
    jw = jw.clamp(0, R - 1)
    if rng_row.dim() == 1:
        return torch.gather(img, -1, jw), rng_row[jw]
    return (torch.gather(img, -1, jw),
            torch.gather(rng_row[..., None, :].expand(img.shape), -1, jw))


def _lib():
    lib = build.library("window_slice")
    fn = lib.row_windows_f32
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def row_windows_cuda(img, rng_row, starts, win: int):
    """Launch the K1 kernel on (A, R), (R,), (A,) or a batch (B, A, R),
    (B, R), (B, A): ``starts`` int64, as ``torch.argmax`` gives them; raises
    on anything the kernel does not take."""
    if not (img.is_cuda and rng_row.device == img.device
            and starts.device == img.device):
        raise ValueError("row_windows_cuda: all tensors must be on one CUDA device")
    if img.dtype != torch.float32 or rng_row.dtype != torch.float32:
        raise TypeError("row_windows_cuda: img and rng_row must be float32")
    if starts.dtype != torch.int64:
        raise TypeError("row_windows_cuda: starts must be int64")
    if img.dim() not in (2, 3) or rng_row.shape != img.shape[:-2] + img.shape[-1:] \
            or starts.shape != img.shape[:-1]:
        raise ValueError("row_windows_cuda: shapes (A, R), (R,), (A,) or "
                         "(B, A, R), (B, R), (B, A) expected")
    if not 1 <= win <= MAX_WIN or img.shape[-1] < 1:
        raise ValueError(f"row_windows_cuda: need 1 <= win <= {MAX_WIN}, R >= 1")
    if not (img.is_contiguous() and rng_row.is_contiguous()
            and starts.is_contiguous()):
        raise ValueError("row_windows_cuda: inputs must be contiguous")
    A, R = img.shape[-2:]
    B = img.shape[0] if img.dim() == 3 else 1
    out_img = img.new_empty(img.shape[:-1] + (win,))
    out_rng = img.new_empty(img.shape[:-1] + (win,))
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _lib()(img.data_ptr(), rng_row.data_ptr(), starts.data_ptr(),
                 out_img.data_ptr(), out_rng.data_ptr(), B, A, R, win, stream)
    if err != 0:
        raise RuntimeError(f"row_windows kernel launch failed: CUDA error {err}")
    profiling.count("kernel.row_windows")
    return out_img, out_rng


def row_windows(img, rng_row, starts, win: int):
    """Extract ``win``-wide contiguous windows per row (see
    :func:`row_windows_plain`).  CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    if img.device.type == "cuda":
        return row_windows_cuda(img, rng_row, starts, win)
    if img.device.type == "cpu":
        return row_windows_plain(img, rng_row, starts, win)
    raise ValueError(f"row_windows: unsupported device {img.device}")
