"""Front-end state carried across: numpy trees <-> the port's carry.

:func:`carry_from_numpy` turns a ``FrontendCarry`` whose leaves are numpy
arrays -- for example the JAX package's carry after ``np.asarray`` on every
leaf -- into this package's carry on a device; :func:`carry_to_numpy` goes
back.  Fields are matched by name through ``_asdict()``, nested ``CellStats``
and ``SparseGrid`` included, so neither side needs to import the other.  The
cadence counters (``frontend.HOST_FIELDS``) become Python values.
"""

from __future__ import annotations

import numpy as np
import torch

from .ndt.cells import CellStats
from .ndt.grid import SparseGrid
from .pipeline.frontend import HOST_FIELDS, FrontendCarry

_NESTED = {"kq_stats": CellStats, "store_cells": CellStats,
           "submap": SparseGrid, "prev_submap": SparseGrid}


def _from(kind, value, device):
    if kind is CellStats or kind is SparseGrid:
        d = value._asdict()
        sub = {"stats": CellStats} if kind is SparseGrid else {}
        return kind(**{k: _from(sub.get(k), d[k], device) for k in kind._fields})
    return torch.from_numpy(np.array(value)).to(device)


def _host(value):
    v = np.asarray(value)
    return bool(v) if v.dtype == bool else int(v)


def carry_from_numpy(tree, device) -> FrontendCarry:
    """A ``FrontendCarry`` on ``device`` from a tree of numpy leaves."""
    d = tree._asdict()
    out = {}
    for name in FrontendCarry._fields:
        if name in HOST_FIELDS:
            out[name] = _host(d[name])
        else:
            out[name] = _from(_NESTED.get(name), d[name], device)
    return FrontendCarry(**out)


def _to(value):
    if isinstance(value, tuple):  # CellStats / SparseGrid
        return type(value)(*(_to(v) for v in value))
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, bool):
        return np.bool_(value)
    return np.int32(value)


def carry_to_numpy(carry: FrontendCarry) -> FrontendCarry:
    """The same carry with numpy leaves (counters as 0-d numpy scalars)."""
    return FrontendCarry(*(_to(v) for v in carry))
