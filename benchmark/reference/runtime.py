"""Device selection, cached device constants and deterministic scatter-adds.

* :func:`resolve_device` -- entry points run on CUDA unless the caller asks
  for the CPU; with no device given and no CUDA present they raise.
* :func:`const` -- small constant tensors (sqrt-information matrices, masks)
  uploaded once per device.  Building them per frame with ``torch.tensor``
  would copy from pageable host memory, which synchronises the stream.
* :func:`index_add` -- out-of-place ``index_add`` whose float sums do not
  depend on the run: CUDA's default path accumulates duplicates with atomics
  in a run-dependent order, so the call runs under
  ``torch.use_deterministic_algorithms`` there (a sort-based accumulate).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


_CONSTS: dict = {}


def const(value, dtype, device) -> torch.Tensor:
    """A cached device copy of ``value`` (treat it as read-only)."""
    arr = np.ascontiguousarray(value)
    device = torch.device(device)
    key = (arr.tobytes(), arr.shape, arr.dtype.str, dtype, device.type,
           device.index)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.from_numpy(arr.copy()).to(dtype).to(device)
        _CONSTS[key] = t
    return t


@contextlib.contextmanager
def deterministic(device):
    """Run the enclosed CUDA ops with their deterministic implementations."""
    if torch.device(device).type != "cuda":
        yield
        return
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def index_add(dst: torch.Tensor, index: torch.Tensor, src: torch.Tensor):
    """``dst`` with ``src`` rows added at ``index`` along dim 0, reproducibly."""
    with deterministic(dst.device):
        return torch.index_add(dst, 0, index, src)
