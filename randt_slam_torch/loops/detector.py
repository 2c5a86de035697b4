"""Batched loop-closure detection (phase B of the offline pipeline).

Port of ``randt_slam_tpu/loops/detector.py`` (``LocalFuser::
detectLoopClosures``, ``local_fuser.cpp:318-416``).  Offline, loop edges
never feed back into odometry before the one final pose-graph solve
(``ndt_slam.cpp:124,176``), so the whole search runs as one batched pass
after odometry:

1. ScanContext retrieval for every querying keyframe at once, from the
   descriptors the front end emitted per frame;
2. same-submap rejection (``local_fuser.cpp:325``: only non-root keyframes
   query, :221);
3. the scan NDT cells of the candidate keyframes only, rebuilt by
   ``frontend.build_scan_cells`` (the kernels K1 and K2, once per
   candidate frame);
4. GNC refinement of all candidates together against their stored
   submaps (``matcher.estimate_loop``), from the guess
   ``root^-1 * match * Rz(-yaw)`` (:329-333);
5. the Cauchy-Schwarz divergence gate (:338-340), with the pose-invariant
   self terms computed once per submap and per scan, then the
   odometry-consistency gate;
6. loop edges for the pose graph.

:func:`detect_loops_mahalanobis` is the position-association variant
(``use_scan_context_as_loop_closure: false``, :350-410).

The JAX package memoizes and prewarms its loop-phase executables to avoid
TPU compile round trips; PyTorch runs eagerly and needs neither.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import runtime
from ..config import SlamConfig
from ..geometry import compose, inverse
from ..ndt import cells as C
from ..ndt import divergence as D
from ..pipeline import frontend as F
from ..registration import matcher as M
from ..utils import profiling
from . import scancontext as SC


@dataclasses.dataclass
class LoopResult:
    edge_begin: np.ndarray   # (L,) int -- root node of the matched submap
    edge_end: np.ndarray     # (L,) int -- query node
    edge_trans: np.ndarray   # (L, 3)
    edge_sqrt_information: np.ndarray  # (L, 3, 3)
    # diagnostics
    n_sc_candidates: int
    n_accepted: int
    cs_divergences: np.ndarray
    # candidates that passed the CS gate but failed the odometry gate
    n_odom_gate_rejected: int = 0
    # per querying keyframe (empty for the Mahalanobis variant): the query
    # node, its ScanContext match (-1 if none), the match's distance and what
    # happened -- 0 no candidate under dist_threshold, 1 candidate in the
    # query's own submap, 2 rejected by a gate, 3 accepted as a loop edge
    query_node: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    query_match: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    query_sc_dist: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))
    query_stage: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int8))
    # wall seconds per stage: features / retrieval / candidate features /
    # refine + gate
    timings: dict = dataclasses.field(default_factory=dict)


# Chunk sizes of the batched passes, as the JAX package sized them.  At the
# Oxford configuration, 34 candidates refined in one chunk took the loop
# phase to a peak of 7.8 GiB of device memory on an H100 80GB (chip_smoke;
# the all-pairs association, (CCH, 512, 4096) pair terms, sets it).
QCH = 256      # retrieval queries per call
CCH = 64       # candidates refined and gated per call
SCH = 8        # submap self terms per call (each an O(S^2) pair sum)
# The JAX package's FCH (frames per feature dispatch) has no counterpart:
# the candidate frames are rebuilt one by one, as odometry builds them.


def _empty(**diag) -> LoopResult:
    return LoopResult(
        edge_begin=np.zeros(0, np.int64), edge_end=np.zeros(0, np.int64),
        edge_trans=np.zeros((0, 3)), edge_sqrt_information=np.zeros((0, 3, 3)),
        n_sc_candidates=0, n_accepted=0, cs_divergences=np.zeros(0), **diag)


def odom_consistency_gate(lcfg, edge_trans, rel_odom, span_m):
    """Odometry-consistency gate on refined loop edges (the JAX package's
    extension, ``LocalFuserConfig.loop_odom_gate``): accept only edges whose
    discrepancy against the odometry-chained relative pose stays inside a
    drift envelope growing with the traversed span between the endpoints.

    edge_trans, rel_odom: (L, 3) relative SE(2); span_m: (L,) metres.
    Returns a (L,) bool accept mask (all True when the gate is off)."""
    if not lcfg.loop_odom_gate:
        return np.ones(len(edge_trans), bool)
    edge_trans = np.asarray(edge_trans)
    rel_odom = np.asarray(rel_odom)
    span_m = np.abs(np.asarray(span_m))
    dyaw = np.abs(np.arctan2(np.sin(edge_trans[:, 2] - rel_odom[:, 2]),
                             np.cos(edge_trans[:, 2] - rel_odom[:, 2])))
    dt = np.linalg.norm(edge_trans[:, :2] - rel_odom[:, :2], axis=1)
    rot_lim = np.radians(lcfg.loop_odom_gate_rot_base_deg
                         + lcfg.loop_odom_gate_rot_deg_per_100m * span_m / 100.0)
    trans_lim = (lcfg.loop_odom_gate_trans_base_m
                 + lcfg.loop_odom_gate_trans_pct / 100.0 * span_m)
    return (dyaw <= rot_lim) & (dt <= trans_lim)


def _guess(root, match, yaw):
    """root^-1 * match * Rz(-yaw) (``local_fuser.cpp:329-333``)."""
    zero = torch.zeros_like(yaw)
    return compose(compose(inverse(root), match),
                   torch.stack([zero, zero, -yaw], dim=-1))


def _put(x, dev, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(dev)


def _store_fields(cfg: SlamConfig, odo, dev):
    """(mean, cov, valid) of the stored submaps, derived once."""
    n = min(int(odo.n_submaps), odo.submap_cells_n.shape[0])
    st = C.CellStats(n=odo.submap_cells_n[:n].to(dev),
                     s=odo.submap_cells_s[:n].to(dev),
                     ss=odo.submap_cells_ss[:n].to(dev))
    cc = cfg.ndt_map.cell
    mu, cov = C.mean_cov(st, cc.eig_floor_ratio, cc.intensity_var_jitter,
                         use_pndt=cc.use_pndt)
    return mu, cov, C.valid_mask(st, cfg.ndt_map.min_points_per_cell)


def _candidate_features(cfg: SlamConfig, frames, node_frames, sensor_to_base, dev):
    """Scan NDT fields (mean, cov, valid), stacked (B, C, ...), of the given
    frames only: the one preprocessor re-run of the loop pass."""
    s2b = (torch.zeros(3, device=dev) if sensor_to_base is None
           else _put(np.asarray(sensor_to_base, np.float32), dev))
    means, covs, valids = [], [], []
    for f in np.asarray(node_frames, np.int64):
        fr = F.Frame(*(x[int(f)].to(dev) for x in frames))
        scan, _ = F.build_scan_cells(cfg, fr, s2b)
        means.append(scan.mean)
        covs.append(scan.cov)
        valids.append(scan.valid)
    return torch.stack(means), torch.stack(covs), torch.stack(valids)


def _self_terms(u_mean, u_cov, u_valid, submaps) -> dict:
    """Self term of each listed submap, SCH submaps per call."""
    uniq = np.unique(submaps).astype(np.int64)
    out = {}
    for lo in range(0, len(uniq), SCH):
        idx = uniq[lo:lo + SCH]
        t = torch.from_numpy(idx).to(u_mean.device)
        vals = D.self_term(u_mean[t], u_cov[t], u_valid[t]).cpu().numpy()
        out.update({int(s): float(v) for s, v in zip(idx, vals)})
    return out


@profiling.span("randt.cs_gate")
def _cs_gate(pose, f_mean, f_cov, f_valid, m_mean, m_cov, m_valid, f_self):
    """CS divergence of each candidate's moving cells at its refined pose
    against its submap; the moving self terms are pose-invariant."""
    m_self = D.self_term(m_mean, m_cov, m_valid)
    mm, mc = M.transform_mean_cov(pose, m_mean, m_cov)
    return D.cs_divergence(f_mean, f_cov, f_valid, mm, mc, m_valid,
                           f_self=f_self, m_self=m_self)


def _refine_and_gate(cfg, guess, sub_idx, fields, moving, f_self):
    """Refine every candidate and gate it, CCH candidates per call.
    Returns (refined poses (L, 3), CS divergences (L,)) as numpy."""
    u_mean, u_cov, u_valid = fields
    m_mean, m_cov, m_valid = moving
    dev = u_mean.device
    poses, cs = [], []
    for lo in range(0, guess.shape[0], CCH):
        sl = slice(lo, lo + CCH)
        sub = torch.from_numpy(sub_idx[sl]).to(dev)
        fm, fc, fv = u_mean[sub], u_cov[sub], u_valid[sub]
        est = M.estimate_loop(cfg, guess[sl], fm, fc, fv, m_mean[sl], m_cov[sl],
                              m_valid[sl])
        c = _cs_gate(est.pose, fm, fc, fv, m_mean[sl], m_cov[sl], m_valid[sl],
                     _put(f_self[sl], dev))
        poses.append(est.pose.cpu().numpy())
        cs.append(c.cpu().numpy())
    return np.concatenate(poses), np.concatenate(cs)


def _presearch(cfg, guess, sub_idx, fields, moving, **kw):
    """CSM pre-alignment of every candidate, CCH per call."""
    u_mean, u_cov, u_valid = fields
    out = []
    for lo in range(0, guess.shape[0], CCH):
        sl = slice(lo, lo + CCH)
        sub = torch.from_numpy(sub_idx[sl]).to(u_mean.device)
        best, _ = M.global_grid_search(
            cfg, guess[sl], u_mean[sub], u_cov[sub], u_valid[sub],
            moving[0][sl], moving[1][sl], moving[2][sl],
            use_intensity=bool(cfg.local_fuser.use_intensity_in_loop_closure),
            **kw)
        out.append(best)
    return torch.cat(out)


def _edges(cfg, odo, q_nodes, root_nodes, est_pose, cs, dev):
    """CS gate, odometry gate and the accepted loop edges."""
    lcfg = cfg.local_fuser
    accept = cs < lcfg.loop_closure_max_cs_divergence
    node_pose = np.asarray(odo.node_pose, np.float32)
    rel_odom = _guess(_put(node_pose[root_nodes], dev), _put(node_pose[q_nodes], dev),
                      torch.zeros(len(q_nodes), device=dev)).cpu().numpy()
    trav = np.asarray(odo.node_traversed)
    odom_ok = odom_consistency_gate(lcfg, est_pose, rel_odom,
                                    trav[q_nodes] - trav[root_nodes])
    n_odom_rej = int((accept & ~odom_ok).sum())
    accept &= odom_ok
    sqrtI = lcfg.loop_closure_weight * np.asarray(lcfg.loop_sqrt_information,
                                                  np.float64)
    keep = np.nonzero(accept)[0]
    return accept, dict(
        edge_begin=np.asarray(root_nodes)[keep],
        edge_end=np.asarray(q_nodes)[keep],
        edge_trans=est_pose[keep],
        edge_sqrt_information=np.broadcast_to(sqrtI, (len(keep), 3, 3)).copy(),
        n_sc_candidates=int(len(q_nodes)),
        n_accepted=int(len(keep)),
        cs_divergences=cs,
        n_odom_gate_rejected=n_odom_rej,
    )


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def detect_loops(cfg: SlamConfig, odo, frames, sensor_to_base=None,
                 device=None) -> LoopResult:
    """ScanContext loop closure (variant A) over an odometry result, on
    ``device`` (CUDA unless ``device="cpu"``; the submap store and the
    frames are moved there)."""
    dev = runtime.resolve_device(device)
    sc_cfg = cfg.scan_context
    lcfg = cfg.local_fuser
    timings = {}

    t0 = time.perf_counter()
    N = len(odo.node_id)
    desc = _put(odo.node_desc, dev)
    ring_keys = SC.ring_key(desc)
    _sync(dev)
    timings["features_s"] = round(time.perf_counter() - t0, 3)

    # ---- ScanContext retrieval for all queries ------------------------------
    t0 = time.perf_counter()
    positions = _put(np.asarray(odo.node_pose)[:, :2], dev)
    distances = _put(odo.node_traversed, dev)
    node_submap = np.asarray(odo.node_submap)
    query_ids = np.nonzero(~np.asarray(odo.node_is_root, bool))[0]
    parts = []
    for lo in range(0, len(query_ids), QCH):
        q = torch.from_numpy(query_ids[lo:lo + QCH]).to(dev)
        parts.append(SC.detect(q, desc, ring_keys, positions, distances, N, sc_cfg))
    if parts:
        match_id = torch.cat([c.match_id for c in parts]).cpu().numpy()
        yaw = torch.cat([c.yaw_rad for c in parts]).cpu().numpy()
        sc_dist = torch.cat([c.distance for c in parts]).cpu().numpy()
    else:
        match_id = np.zeros(0, np.int64)
        yaw = sc_dist = np.zeros(0, np.float32)
    timings["retrieval_s"] = round(time.perf_counter() - t0, 3)

    found = match_id >= 0
    same_submap = node_submap[query_ids] == np.where(
        found, node_submap[np.maximum(match_id, 0)], -1)
    stage = np.zeros(len(query_ids), np.int8)
    stage[found & same_submap] = 1
    found = found & ~same_submap
    sel = np.nonzero(found)[0]
    diag = dict(query_node=query_ids.astype(np.int64),
                query_match=match_id.astype(np.int64),
                query_sc_dist=sc_dist.astype(np.float32), query_stage=stage,
                timings=timings)
    if len(sel) == 0:
        return _empty(**diag)

    q_nodes = query_ids[sel]
    m_nodes = match_id[sel]
    m_submaps = node_submap[m_nodes]
    root_nodes = np.asarray(odo.submap_root)[m_submaps]

    # ---- moving scan cells of the candidate keyframes only --------------------
    t0 = time.perf_counter()
    moving = _candidate_features(cfg, frames, np.asarray(odo.node_frame)[q_nodes],
                                 sensor_to_base, dev)
    _sync(dev)
    timings["cand_features_s"] = round(time.perf_counter() - t0, 3)

    # ---- guesses, refinement and the gates -------------------------------------
    t0 = time.perf_counter()
    node_pose = np.asarray(odo.node_pose, np.float32)
    guess = _guess(_put(node_pose[root_nodes], dev), _put(node_pose[m_nodes], dev),
                   _put(yaw[sel], dev))
    fields = _store_fields(cfg, odo, dev)
    sub_idx = m_submaps.astype(np.int64)
    if lcfg.csm_prealign_loops:
        guess = _presearch(cfg, guess, sub_idx, fields, moving)
    by_sub = _self_terms(*fields, m_submaps)
    f_self = np.asarray([by_sub[int(s)] for s in m_submaps], np.float32)
    est_pose, cs = _refine_and_gate(cfg, guess, sub_idx, fields, moving, f_self)
    timings["refine_gate_s"] = round(time.perf_counter() - t0, 3)

    accept, res = _edges(cfg, odo, q_nodes, root_nodes, est_pose, cs, dev)
    stage[sel] = np.where(accept, 3, 2).astype(np.int8)
    return LoopResult(**res, **diag)


def detect_loops_mahalanobis(cfg: SlamConfig, odo, frames, sensor_to_base=None,
                             node_cov=None, device=None) -> LoopResult:
    """Position-association loop closure (variant B,
    ``use_scan_context_as_loop_closure: false``, ``local_fuser.cpp:350-410``):

    * per (query, node) Mahalanobis distance of the positions under the
      node's marginal covariance (:357), one (Q, N) table;
    * per query, the best match in every finished foreign submap under
      ``max_data_association_mahalanobis_dist`` (:358-363), causal;
    * guess root^-1 * query pose (:374-376);
    * optional CSM search (``compute_dfs_loop_closure``) with the window from
      the match covariances (:379-391), one window for the whole batch;
    * the shared refinement and gates.

    ``node_cov`` comes from ``pose_graph.recover_covariances``; without it
    the covariance is the identity and the distance Euclidean."""
    dev = runtime.resolve_device(device)
    lcfg = cfg.local_fuser
    timings = {}
    t0 = time.perf_counter()

    N = len(odo.node_id)
    node_pose = np.asarray(odo.node_pose)
    node_submap = np.asarray(odo.node_submap)
    n_sub = odo.n_submaps
    if node_cov is None:
        node_cov = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
    node_cov = np.asarray(node_cov)

    # ---- association (host, numpy, as the JAX package computes it) ------------
    query_ids = np.nonzero(~np.asarray(odo.node_is_root, bool))[0]
    Q = len(query_ids)
    d = node_pose[query_ids, None, :2] - node_pose[None, :, :2]     # (Q, N, 2)
    cov2 = node_cov[:, :2, :2] + 1e-9 * np.eye(2, dtype=np.float32)
    inv2 = np.linalg.inv(cov2)
    dist = np.sqrt(np.maximum(np.einsum("qni,nij,qnj->qn", d, inv2, d), 0.0))
    foreign = node_submap[None, :] != node_submap[query_ids][:, None]
    finished = node_submap[None, :] < n_sub
    causal = np.arange(N)[None, :] < query_ids[:, None]
    ok = (foreign & finished & causal
          & (dist < lcfg.max_data_association_mahalanobis_dist))
    dist = np.where(ok, dist, np.inf)
    best = np.full((Q, n_sub), np.inf)
    np.minimum.at(best.T, node_submap, dist.T)
    qq, ss = np.nonzero(np.isfinite(best))
    m_of = np.where(node_submap[None, :] == ss[:, None], dist[qq], np.inf).argmin(axis=1)
    timings["retrieval_s"] = round(time.perf_counter() - t0, 3)
    if len(qq) == 0:
        return _empty(timings=timings)
    q_nodes = query_ids[qq]
    m_nodes = np.asarray(m_of)
    m_submaps = node_submap[m_nodes]
    root_nodes = np.asarray(odo.submap_root)[m_submaps]

    t0 = time.perf_counter()
    moving = _candidate_features(cfg, frames, np.asarray(odo.node_frame)[q_nodes],
                                 sensor_to_base, dev)
    _sync(dev)
    timings["cand_features_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    np32 = node_pose.astype(np.float32)
    guess = compose(inverse(_put(np32[root_nodes], dev)), _put(np32[q_nodes], dev))
    fields = _store_fields(cfg, odo, dev)
    sub_idx = m_submaps.astype(np.int64)
    if lcfg.compute_dfs_loop_closure:
        # the search window from the match covariances (:380-386), shared
        eig_max = np.linalg.eigvalsh(node_cov[m_nodes][:, :2, :2]).max()
        win_l = float(lcfg.max_data_association_mahalanobis_dist * abs(eig_max))
        win_a = float(min(2.0 * np.pi, lcfg.max_data_association_mahalanobis_dist
                          * np.sqrt(node_cov[m_nodes][:, 2, 2].max())))
        if win_l > 0 and win_a > 0:
            guess = _presearch(cfg, guess, sub_idx, fields, moving,
                               search_window_linear=win_l,
                               search_window_angular=win_a)
    by_sub = _self_terms(*fields, m_submaps)
    f_self = np.asarray([by_sub[int(s)] for s in m_submaps], np.float32)
    est_pose, cs = _refine_and_gate(cfg, guess, sub_idx, fields, moving, f_self)
    timings["refine_gate_s"] = round(time.perf_counter() - t0, 3)

    _, res = _edges(cfg, odo, q_nodes, root_nodes, est_pose, cs, dev)
    return LoopResult(**res, timings=timings)
