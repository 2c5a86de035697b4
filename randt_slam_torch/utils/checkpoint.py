"""Checkpoint / resume for long runs (port of
``randt_slam_tpu/utils/checkpoint.py``).

The reference has no persistence: its state lives in RAM and its results
are exported at shutdown.  A long run snapshots the front-end carry and the
host-side node/edge tables to one ``.npz``, in the JAX package's key layout
and dtypes (``state.carry_to_npz_dict``), so a checkpoint written by either
package resumes in the other.
"""

from __future__ import annotations

import numpy as np

from .. import state


def _flatten(tree, prefix=""):
    """``{prefix + "field[/sub]": numpy}`` of a carry; the cadence counters
    become 0-d arrays of the JAX package's dtypes."""
    return state.carry_to_npz_dict(tree, prefix)


def save_carry(path: str, carry, extra: dict | None = None):
    """Snapshot a ``FrontendCarry`` to ``.npz``."""
    flat = _flatten(carry)
    if extra:
        for k, v in extra.items():
            flat[f"__extra__/{k}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


# Fields added after checkpoints already existed: only these may fall back to
# the template's value when a snapshot lacks them (they are derived caches,
# rebuilt at the next keyframe exit).  Any other missing field means a
# truncated or mismatched file and raises.
MIGRATED_FIELDS = frozenset({
    "submap_fmean", "submap_fcov", "submap_fvalid",
    "prev_fmean", "prev_fcov", "prev_fvalid",
})


def load_carry(path: str, template):
    """A carry with the structure, devices and dtypes of ``template`` from
    ``.npz``.  Fields in :data:`MIGRATED_FIELDS` missing from the snapshot
    keep the template's value; any other missing field raises ``KeyError``."""
    data = np.load(path)
    try:
        return state.carry_from_npz(data, template, optional=MIGRATED_FIELDS)
    except KeyError as e:
        raise KeyError(
            f"checkpoint {path!r} is missing field {e.args[0]!r} (not a known "
            f"migrated field): refusing to resume from a truncated or "
            f"mismatched snapshot") from None


def load_extra(path: str) -> dict:
    data = np.load(path)
    return {k.split("/", 1)[1]: data[k] for k in data.files
            if k.startswith("__extra__/")}
