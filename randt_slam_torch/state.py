"""State carried across: numpy trees <-> the port's carries and results.

:func:`carry_from_numpy` turns a ``FrontendCarry`` whose leaves are numpy
arrays -- for example the JAX package's carry after ``np.asarray`` on every
leaf -- into this package's carry on a device; :func:`carry_to_numpy` goes
back.  Fields are matched by name through ``_asdict()``, nested ``CellStats``
and ``SparseGrid`` included, so neither side needs to import the other.  The
cadence counters (``frontend.HOST_FIELDS``) become Python values.

:func:`carry_to_npz_dict` and :func:`carry_from_npz` do the same for a
checkpoint: the JAX package's ``.npz`` key layout (``<prefix><field>`` and
``<prefix><field>/<sub>`` for the nested tuples) with its dtypes, the
counters as 0-d ``int32`` / ``bool`` arrays, so either package resumes the
other's checkpoint.

:func:`odometry_from_numpy` and :func:`pose_graph_from_numpy` do the same
for an odometry result and a pose graph, so that loop closure and the pose
graph can be held to the reference from identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import runtime
from .graph.pose_graph import PoseGraph
from .ndt.cells import CellStats
from .ndt.grid import SparseGrid
from .pipeline.frontend import HOST_FIELDS, FrontendCarry
from .pipeline.slam import OdometryResult

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


def carry_to_npz_dict(tree, prefix: str = "") -> dict:
    """``{prefix + "field[/sub]": numpy}`` of a carry (or any tuple of named
    tuples of tensors and counters)."""
    out = {}
    for k, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(carry_to_npz_dict(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _to(v)
    return out


def carry_from_npz(data, template, prefix: str = "", optional=frozenset()):
    """A carry shaped as ``template`` from a mapping of ``.npz`` keys (see
    :func:`carry_to_npz_dict`), on the template's devices and dtypes.  A
    missing key whose field name is in ``optional`` keeps the template's
    value; any other missing key raises ``KeyError``."""
    def rebuild(node, pre, name):
        if hasattr(node, "_asdict"):
            return type(node)(**{k: rebuild(v, f"{pre}{k}/", k)
                                 for k, v in node._asdict().items()})
        key = pre.rstrip("/")
        if key not in data:
            if name in optional:
                return node
            raise KeyError(key)
        if not isinstance(node, torch.Tensor):
            return _host(data[key])
        return torch.from_numpy(np.array(data[key])).to(node.device, node.dtype)

    return rebuild(template, prefix, None)


_DEVICE_FIELDS = ("submap_cells_n", "submap_cells_s", "submap_cells_ss")


def odometry_from_numpy(tree, device) -> OdometryResult:
    """An ``OdometryResult`` whose submap store lies on ``device`` (CUDA
    unless ``device="cpu"``), from an object with the same field names and
    numpy (or array-like) values -- for example the JAX package's result
    after ``np.asarray`` on its store.  The final carry is not carried
    across."""
    device = runtime.resolve_device(device)
    out = {}
    for f in dataclasses.fields(OdometryResult):
        value = getattr(tree, f.name, None)
        if f.name in _DEVICE_FIELDS:
            out[f.name] = torch.from_numpy(np.array(value)).to(device)
        elif f.name == "final_carry":
            out[f.name] = None
        elif f.name == "saturation":
            out[f.name] = dict(value or {})
        elif f.name == "n_submaps":
            out[f.name] = int(value)
        elif value is not None:
            out[f.name] = np.asarray(value)
    return OdometryResult(**out)


def pose_graph_from_numpy(tree, device) -> PoseGraph:
    """A ``PoseGraph`` on ``device`` (CUDA unless ``device="cpu"``) from one
    with numpy leaves, by field name (ids as int64)."""
    device = runtime.resolve_device(device)
    d = tree._asdict()
    out = {}
    for name in PoseGraph._fields:
        t = torch.from_numpy(np.array(d[name]))
        if name in ("id_begin", "id_end"):
            t = t.long()
        out[name] = t.to(device)
    return PoseGraph(**out)
