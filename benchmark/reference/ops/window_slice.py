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


import torch


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



def row_windows(img, rng_row, starts, win: int):
    """Extract ``win``-wide contiguous windows per row (see
    :func:`row_windows_plain`).  CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    return row_windows_plain(img, rng_row, starts, win)
