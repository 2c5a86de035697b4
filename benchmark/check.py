"""What decides ``correct`` for the fleet traffic: each checked step of the
timed path held against the plain reference (``benchmark/reference``).

The reference cannot replay a member from its first frame to the window's
end: a float32 LM solve parts from another float32 implementation by
ulp-decided steps, so two free runs drift apart with nothing wrong in
either.  So it follows the program step by step.  For a checked frame t it
takes the program's carry before t (the primary state: window states, scan
window, keyframe queue, submaps, counters), works out again from it every
field that the program caches (the submaps' derived fields), and runs its
own step on the same frame.  Its output and its carry after t are then held
against the program's.  Two stages that this skips are checked by
themselves: the program's initial carry against the reference's, and the
program's cached submap fields against the reference's recomputation.

The numbers compared (each with its limit in the workload file; a number
without a limit there is not compared in that cell):

* ``pose_gap_m``: the largest translation gap (m) of the step's odometry
  pose, its node poses, edge measurements and the window states;
* ``pose_gap_median_m``: the median over the checked (frame, member) pairs
  of each pair's largest translation gap of its odometry pose and window
  states: steady from seed to seed where the largest swings with the
  ulp-decided LM steps of a few members;
* ``yaw_gap_rad``: the same for headings, wrapped;
* ``scan_gap_m``: the largest gap (m) of the new scan's NDT cell means,
  the filter, clustering and scan NDT (K1, K2) of the step;
* ``cell_gap_rel``: the largest gap of the cells' other statistics (scan
  covariances and intensities, the keyframe queue, the submap after the
  merge and its derived fields, the previous submap's totals, the cached
  derived fields), each tensor's gap over its largest magnitude;
* ``exact_mismatches``: elements that must agree exactly and do not:
  counters, validity flags, node and edge ids, the keyframe frame indices,
  the submap's index grid, the pose-jump rejections, and the initial carry;
* ``velocity_gap``: the largest gap of the window states' velocities and
  accelerations (vx, vy in m/s, the yaw rate in rad/s, ax, ay in m/s^2);
* ``bias_gap``: the largest gap of the window states' gyro bias (rad/s).

Every number is worked out in every cell; those without a limit are
reported beside the compared ones, so that a cell added later can name
them with readings in hand.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("pose_gap_m", "pose_gap_median_m", "yaw_gap_rad", "scan_gap_m",
           "cell_gap_rel", "exact_mismatches", "velocity_gap", "bias_gap")

HOST_FIELDS = ("traj_len", "kq_len", "n_finished", "has_prev", "node_count",
               "have_imu_prev", "store_count")
STORE_FIELDS = ("store_cells", "store_origin", "store_root")


class Gaps:
    """Running maxima of the compared numbers over the checked steps."""

    def __init__(self):
        self.v = {k: 0.0 for k in NUMBERS}
        self.v["exact_mismatches"] = 0
        self.where = {}
        self.per_pair = []

    def pair_gaps(self, odom_a, odom_b, states_a, states_b):
        """Each checked member's largest translation gap of one step."""
        d1 = np.abs(_np(odom_a)[..., :2].astype(np.float64) - _np(odom_b)[..., :2])
        d2 = np.abs(_np(states_a)[..., :2].astype(np.float64) - _np(states_b)[..., :2])
        g = np.maximum(d1.reshape(d1.shape[0], -1).max(1), d2.reshape(d2.shape[0], -1).max(1))
        self.per_pair.extend(g.tolist())
        self.v["pose_gap_median_m"] = float(np.median(self.per_pair))

    def gap(self, key, a, b, mask=None, label=""):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        if key == "yaw_gap_rad":
            d = np.abs(np.arctan2(np.sin(a - b), np.cos(a - b)))
        else:
            d = np.abs(a - b)
        if mask is not None:
            d = d[np.broadcast_to(_np(mask), d.shape)]
        g = float(d.max()) if d.size else 0.0
        if not math.isfinite(g) and d.size:
            g = math.inf
        self._keep(key, g, label)

    def rel(self, a, b, mask=None, label=""):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        if mask is not None:
            m = np.broadcast_to(_np(mask), a.shape[:_np(mask).ndim])
            a, b = a[m], b[m]
        if not a.size:
            return
        scale = max(float(np.abs(b).max()), 1e-30)
        g = float(np.abs(a - b).max()) / scale
        if not math.isfinite(g):
            g = math.inf
        self._keep("cell_gap_rel", g, label)

    def exact(self, a, b, label=""):
        a, b = _np(a), _np(b)
        if a.shape != b.shape:
            n = max(a.size, b.size, 1)
        else:
            n = int(np.count_nonzero(a != b))
        if n:
            self.v["exact_mismatches"] += n
            self.where.setdefault("exact_mismatches", label)

    def _keep(self, key, g, label):
        if g > self.v[key] or (math.isnan(g)):
            self.v[key] = g
            self.where[key] = label


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def take(x, m):
    """Members ``m`` of every tensor of a carry or record (host values
    shared by the members stay as they are)."""
    if isinstance(x, tuple):
        return type(x)(*(take(v, m) for v in x))
    if isinstance(x, torch.Tensor):
        return x.index_select(0, m)
    return x


def to_ref(x, like):
    """A program NamedTuple as the reference's class of the same fields."""
    if not isinstance(x, tuple):
        return x
    fields = {}
    for name in like._fields:
        v = getattr(x, name)
        sub = _ref_class(name)
        fields[name] = to_ref(v, sub) if sub is not None else v
    return like(**fields)


def _ref_class(name):
    from .reference.ndt import cells as RC
    from .reference.ndt import grid as RG
    return {"kq_stats": RC.CellStats, "store_cells": RC.CellStats,
            "submap": RG.SparseGrid, "prev_submap": RG.SparseGrid,
            "stats": RC.CellStats}.get(name)


def reference_input(ref_cfg, pre, m):
    """The reference's carry before the checked step: members ``m`` of the
    program's primary state, its cached fields worked out again and a
    store of one row (the step writes one row and reads none)."""
    from .reference.ndt import cells as RC
    from .reference.ndt import grid as RG
    from .reference.pipeline import frontend as RF

    c = to_ref(take(pre, m), RF.FrontendCarry)
    S = c.submap.stats.n.shape[-1]
    b = m.shape[0]
    dev = c.states.device
    sf = RG.derive_sparse_fields(c.submap, ref_cfg.ndt_map.min_points_per_cell,
                                 ref_cfg.ndt_map.cell)
    pf = RG.derive_sparse_fields(c.prev_submap, ref_cfg.ndt_map.min_points_per_cell,
                                 ref_cfg.ndt_map.cell)
    return c._replace(
        submap_fmean=sf[0], submap_fcov=sf[1], submap_fvalid=sf[2],
        prev_fmean=pf[0], prev_fcov=pf[1], prev_fvalid=pf[2],
        store_cells=RC.zeros((b, 1, S), c.states.dtype, dev),
        store_origin=torch.zeros((b, 1, 3), dtype=c.states.dtype, device=dev),
        store_root=torch.zeros((b, 1), dtype=torch.int32, device=dev),
    )


def compare_caches(g: Gaps, pre_m, ref_in, label):
    """The program's cached submap fields against the reference's
    recomputation from the program's own submap statistics."""
    for side in ("submap", "prev"):
        fv = getattr(pre_m, f"{side}_fvalid")
        rv = getattr(ref_in, f"{side}_fvalid")
        g.exact(fv, rv, f"{label} {side}_fvalid")
        both = _np(fv) & _np(rv)
        g.rel(getattr(pre_m, f"{side}_fmean"), getattr(ref_in, f"{side}_fmean"),
              both, f"{label} {side}_fmean")
        g.rel(getattr(pre_m, f"{side}_fcov"), getattr(ref_in, f"{side}_fcov"),
              both, f"{label} {side}_fcov")


def compare_step(g: Gaps, out_m, post_m, ref_out, ref_post, label):
    """One checked step: the program's output record (numpy, members m) and
    carry after the step (members m) against the reference's."""
    # the host-known cadence state
    for f in HOST_FIELDS:
        g.exact(getattr(post_m, f), getattr(ref_post, f), f"{label} {f}")
    # poses: the odometry output, node poses, edge measurements
    po, pr = _np(out_m.odom_pose), _np(ref_out.odom_pose)
    g.gap("pose_gap_m", po[..., :2], pr[..., :2], label=f"{label} odom_pose")
    g.gap("yaw_gap_rad", po[..., 2], pr[..., 2], label=f"{label} odom_pose")
    nv = _np(ref_out.nodes.valid)
    g.exact(_np(out_m.nodes.valid), np.broadcast_to(nv, _np(out_m.nodes.valid).shape),
            f"{label} nodes.valid")
    for f in ("node_id", "submap_id", "is_root"):
        a = _np(getattr(out_m.nodes, f))
        g.exact(a, np.broadcast_to(_np(getattr(ref_out.nodes, f)), a.shape),
                f"{label} nodes.{f}")
    ev = _np(ref_out.edges.valid)
    a = _np(out_m.edges.valid)
    g.exact(a, np.broadcast_to(ev, a.shape), f"{label} edges.valid")
    for f in ("id_begin", "id_end"):
        a = _np(getattr(out_m.edges, f))
        g.exact(a, np.broadcast_to(_np(getattr(ref_out.edges, f)), a.shape),
                f"{label} edges.{f}")
    if nv.any():
        g.exact(_np(out_m.nodes.frame_idx)[..., nv], _np(ref_out.nodes.frame_idx)[..., nv],
                f"{label} nodes.frame_idx")
        pn, rn = _np(out_m.nodes.pose)[..., nv, :], _np(ref_out.nodes.pose)[..., nv, :]
        g.gap("pose_gap_m", pn[..., :2], rn[..., :2], label=f"{label} nodes.pose")
        g.gap("yaw_gap_rad", pn[..., 2], rn[..., 2], label=f"{label} nodes.pose")
    if ev.any():
        pe, re_ = _np(out_m.edges.trans)[..., ev, :], _np(ref_out.edges.trans)[..., ev, :]
        g.gap("pose_gap_m", pe[..., :2], re_[..., :2], label=f"{label} edges.trans")
        g.gap("yaw_gap_rad", pe[..., 2], re_[..., 2], label=f"{label} edges.trans")
    g.exact(_np(out_m.rejected), _np(ref_out.rejected), f"{label} rejected")
    # the window after the solve
    s, r = post_m.states, ref_post.states
    g.pair_gaps(po, pr, s, r)
    g.gap("pose_gap_m", s[..., :2], r[..., :2], label=f"{label} states.xy")
    g.gap("yaw_gap_rad", s[..., 2], r[..., 2], label=f"{label} states.yaw")
    g.gap("velocity_gap", s[..., 3:8], r[..., 3:8], label=f"{label} states.velocity")
    g.gap("bias_gap", s[..., 8], r[..., 8], label=f"{label} states.bias")
    for f in ("cur_pose", "submap_origin", "last_node_pose"):
        a, b = getattr(post_m, f), getattr(ref_post, f)
        g.gap("pose_gap_m", _np(a)[..., :2], _np(b)[..., :2], label=f"{label} {f}")
        g.gap("yaw_gap_rad", _np(a)[..., 2], _np(b)[..., 2], label=f"{label} {f}")
    g.gap("pose_gap_m", post_m.last_node_dist, ref_post.last_node_dist,
          label=f"{label} last_node_dist")
    # the scan window: the new scan's cells (filter, clustering, K1, K2)
    sv, rv = _np(post_m.scan_valid), _np(ref_post.scan_valid)
    g.exact(sv, rv, f"{label} scan_valid")
    both = sv & rv
    g.gap("scan_gap_m", _np(post_m.scan_mean)[..., :2], _np(ref_post.scan_mean)[..., :2],
          both[..., None], f"{label} scan_mean.xy")
    g.rel(_np(post_m.scan_mean)[..., 2], _np(ref_post.scan_mean)[..., 2], both,
          f"{label} scan_mean.intensity")
    g.rel(post_m.scan_cov, ref_post.scan_cov, both, f"{label} scan_cov")
    # the keyframe queue
    g.exact(post_m.kq_frame, ref_post.kq_frame, f"{label} kq_frame")
    for f in ("n", "s", "ss"):
        g.rel(getattr(post_m.kq_stats, f), getattr(ref_post.kq_stats, f),
              label=f"{label} kq_stats.{f}")
    g.gap("pose_gap_m", post_m.kq_stamp, ref_post.kq_stamp, label=f"{label} kq_stamp")
    # the submap after the merge, and the previous submap
    g.exact(post_m.submap.index, ref_post.submap.index, f"{label} submap.index")
    g.exact(post_m.submap.count, ref_post.submap.count, f"{label} submap.count")
    for f in ("n", "s", "ss"):
        g.rel(getattr(post_m.submap.stats, f), getattr(ref_post.submap.stats, f),
              label=f"{label} submap.{f}")
    fv, rv2 = _np(post_m.submap_fvalid), _np(ref_post.submap_fvalid)
    g.exact(fv, rv2, f"{label} submap_fvalid")
    both = fv & rv2
    g.rel(post_m.submap_fmean, ref_post.submap_fmean, both, f"{label} submap_fmean")
    g.rel(post_m.submap_fcov, ref_post.submap_fcov, both, f"{label} submap_fcov")
    # The previous submap is the finished one re-keyed into the new submap's
    # frame at the solved switch pose: a cell whose mean the two solves put
    # on either side of a cell boundary lands in another slot, so its cells
    # are compared by their totals, which re-keying keeps; the program's
    # cached fields of it are checked against its own statistics at the
    # next checked frame (``compare_caches``).
    for f in ("n", "s", "ss"):
        g.rel(getattr(post_m.prev_submap.stats, f).sum(-3 if f == "ss" else
                                                       (-2 if f == "s" else -1)),
              getattr(ref_post.prev_submap.stats, f).sum(-3 if f == "ss" else
                                                        (-2 if f == "s" else -1)),
              label=f"{label} prev_submap.{f} totals")


def compare_init(g: Gaps, init_m, ref_init):
    """The program's initial carry (members m) against the reference's
    single-sequence initial carry broadcast over them: exact."""
    def walk(a, b, name):
        if isinstance(a, tuple):
            for f in a._fields:
                walk(getattr(a, f), getattr(b, f), f"{name}.{f}")
            return
        if name.split(".")[1] in STORE_FIELDS:
            a_, b_ = _np(a), _np(b)
            if a_.shape[1:] != b_.shape:
                g.exact(np.zeros(1), np.ones(1), f"init {name} shape")
            return
        if isinstance(a, torch.Tensor):
            a_ = _np(a)
            g.exact(a_, np.broadcast_to(_np(b), a_.shape), f"init {name}")
        else:
            g.exact(np.asarray(a), np.asarray(b), f"init {name}")
    walk(init_m, ref_init, "carry")
