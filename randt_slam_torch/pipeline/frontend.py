"""Per-frame SLAM front end as one step function over fixed-shape tensors.

Port of ``randt_slam_tpu/pipeline/frontend.py`` (``LocalFuser::processScan``,
``local_fuser.cpp:99-300``, plus the submap lifecycle of
``NDTSlam::radarCb``, ``ndt_slam.cpp:211-223``): a function
``(carry, frame) -> (carry, output)``.

Cadences (deterministic, as in the reference):
  * every frame: preprocess -> scan NDT -> predict -> sliding-window GNC solve
  * every ``insertion_step`` frames: keyframe pushed on the insertion queue
  * ``insertion_delay`` frames later: keyframe exits the smoother -- its scan
    is merged into the submap at the smoothed pose and becomes a pose-graph
    node (+ odometry edge)
  * when the submap trajectory reaches ``submap_size_poses``: the submap is
    finished and THE SAME frame is re-processed as the first frame of the new
    submap (``ndt_slam.cpp:219-223``)

Every branch of the step depends only on the cadence counters.  The carry
therefore keeps those counters (and what follows from them alone: node
count, store count, the has-previous-submap and have-IMU flags) as Python
values beside its device tensors, and the step branches on the host without
ever waiting on the device.  Values the host knows in an output record
(validity flags, node and edge ids) are numpy; the rest are tensors.

The submap store (``store_*``, up to ~100 MB at the Oxford capacities) is
updated in place, row by row: a carry passed to :func:`frontend_step` must
not be used again afterwards.

The deliberate fixes over the reference are the JAX package's: the
previous-submap overlap map is transformed by the INVERSE switch pose and
re-keyed, and IMU measurements pair with their own transition.

Batch: the same step runs B sequences of one length at once
(``parallel/batch.py``), as the JAX package runs it under ``jax.vmap``.
Every tensor of the carry, the frame and the output then has a leading
(B,) axis; the cadence counters and the host-known record fields stay one
shared value, since they depend only on the frame count, which the members
share.  Store and queue rows are indexed by those shared host values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import preprocess as pp
from .. import runtime
from ..config import SlamConfig
from ..geometry import compose, inverse, normalize_angle, relative
from ..loops import scancontext as SC
from ..ndt import cells as C
from ..ndt import grid as G
from ..ndt.cells import CellStats
from ..registration import matcher
from ..registration import residuals as R
from ..utils import profiling

# Carry fields kept as Python values (the cadence state).
HOST_FIELDS = ("traj_len", "kq_len", "n_finished", "has_prev", "node_count",
               "have_imu_prev", "store_count")


class Frame(NamedTuple):
    """One radar frame (tensors on the step's device; a batch of frames has
    a leading (B,) on every field)."""

    intensity: torch.Tensor     # (A, Rb) float32, float16 or uint8
    azimuths: torch.Tensor      # (A,)
    ranges: torch.Tensor        # (Rb,)
    azimuth_mask: torch.Tensor  # (A,)
    stamp: torch.Tensor         # () seconds
    imu_yaw: torch.Tensor       # () absolute yaw reading (rad)
    index: torch.Tensor         # () global frame index


class ScanCells(NamedTuple):
    """Compacted scan NDT: raw sufficient statistics + derived fields."""

    stats: CellStats       # (C,)
    mean: torch.Tensor     # (C, 3)
    cov: torch.Tensor      # (C, 3, 3)
    valid: torch.Tensor    # (C,)


class FrontendCarry(NamedTuple):
    # (shapes of one sequence; a batch adds a leading (B,) to every tensor)
    # sliding-window smoother (newest at index TBUF-1)
    states: torch.Tensor        # (TBUF, 9)
    stamps: torch.Tensor        # (TBUF,)
    imu_meas: torch.Tensor      # (TBUF,) relative yaw of transition INTO state i
    traj_len: int               # states in current submap trajectory
    # moving-scan window (newest at index W-1), derived fields only
    scan_mean: torch.Tensor     # (W, C, 3)
    scan_cov: torch.Tensor      # (W, C, 3, 3)
    scan_valid: torch.Tensor    # (W, C)
    # keyframe insertion queue (FIFO, slot 0 = front)
    kq_stats: CellStats         # (KQ, C)
    kq_frame: torch.Tensor      # (KQ,) int32 source frame index
    kq_stamp: torch.Tensor      # (KQ,)
    kq_len: int
    # submaps (sparse: dense int32 index grid + compact cell table)
    submap: G.SparseGrid        # current submap
    prev_submap: G.SparseGrid   # previous submap in current frame
    has_prev: bool
    # cached derived fields of both submap tables (recomputed only when the
    # submap changes: keyframe exit and submap switch)
    submap_fmean: torch.Tensor  # (S, 3)
    submap_fcov: torch.Tensor   # (S, 3, 3)
    submap_fvalid: torch.Tensor  # (S,)
    prev_fmean: torch.Tensor    # (S, 3)
    prev_fcov: torch.Tensor     # (S, 3, 3)
    prev_fvalid: torch.Tensor   # (S,)
    submap_origin: torch.Tensor  # (3,) global pose of current submap origin
    n_finished: int
    # pose bookkeeping
    cur_pose: torch.Tensor      # (3,) newest robot pose in submap frame
    last_state: torch.Tensor    # (9,) snapshot for next submap init
    node_count: int
    last_node_pose: torch.Tensor  # (3,) global pose of last emitted node
    last_node_dist: torch.Tensor  # () traversed distance at last node
    last_imu_yaw: torch.Tensor  # ()
    have_imu_prev: bool
    # finished-submap store (compacted cells; read by the loop-closure pass)
    store_cells: CellStats      # (NS, KS)
    store_origin: torch.Tensor  # (NS, 3) submap origin (global) at finish time
    store_root: torch.Tensor    # (NS,) int32 root node id per submap
    store_count: int


class NodeRecord(NamedTuple):
    """Two slots per frame (keyframe exit, submap root); numpy leaves are
    host-known, tensor leaves live on the device."""

    valid: np.ndarray           # (2,) bool
    node_id: np.ndarray         # (2,) int
    pose: torch.Tensor          # (2, 3) global
    stamp: torch.Tensor         # (2,)
    traversed: torch.Tensor     # (2,)
    submap_id: np.ndarray       # (2,) int
    frame_idx: torch.Tensor     # (2,) int32 source frame (for the loop pass)
    is_root: np.ndarray         # (2,) bool


class EdgeRecord(NamedTuple):
    valid: np.ndarray           # (2,) bool
    id_begin: np.ndarray        # (2,) int
    id_end: np.ndarray          # (2,) int
    trans: torch.Tensor         # (2, 3) relative SE(2)
    sqrt_information: np.ndarray  # (2, 3, 3)


class FrameOutput(NamedTuple):
    odom_pose: torch.Tensor     # (3,) global robot pose after this frame
    nodes: NodeRecord
    edges: EdgeRecord
    submap_finished: bool       # a submap was completed this frame
    finished_origin: torch.Tensor  # (3,) origin pose of the finished submap
    rejected: object            # bool tensor (or False) -- pose-jump rejection
    n_residuals: object         # int tensor (or 0)
    # capacity-saturation telemetry
    scan_saturated: object = False
    submap_saturated: object = False
    store_saturated: bool = False
    # ScanContext descriptor of this frame's filtered scan (sensor frame)
    sc_desc: torch.Tensor | None = None
    # online extras (``with_scan_cells=True``): the scan's derived cells and
    # its max-intensity beams, for the keyframe exit of ``OnlineSlam``;
    # None otherwise, so the offline runs never stack them
    scan_cells: tuple | None = None    # (mean (C, 3), cov (C, 3, 3), valid (C,))
    beams: torch.Tensor | None = None  # (A, 3) angle, range, intensity
    beam_mask: torch.Tensor | None = None  # (A,)


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------


def init_carry(cfg: SlamConfig, initial_pose=None, dtype=torch.float32,
               device=None) -> FrontendCarry:
    """Empty front-end state on ``device`` (CUDA unless ``device="cpu"``);
    :func:`init_batched_carry` broadcasts it over a batch."""
    dev = runtime.resolve_device(device)
    cap = cfg.capacity
    W = cfg.matcher.smoothing_steps
    Cc = cap.max_scan_cells
    TB = cap.traj_buffer
    KQ = cap.keyframe_queue
    S = cap.max_submap_cells
    geom = G.GridGeom.from_config(cfg.ndt_map)
    if initial_pose is None:
        pose0 = torch.zeros(3, dtype=dtype, device=dev)
    else:
        pose0 = torch.as_tensor(np.asarray(initial_pose, np.float32)).to(dtype).to(dev)
    init_state = torch.zeros(9, dtype=dtype, device=dev)
    init_state[R.BIAS] = cfg.matcher.initial_imu_bias

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return FrontendCarry(
        states=z(TB, 9), stamps=z(TB), imu_meas=z(TB), traj_len=0,
        scan_mean=z(W, Cc, 3), scan_cov=z(W, Cc, 3, 3),
        scan_valid=z(W, Cc, dt=torch.bool),
        kq_stats=C.zeros((KQ, Cc), dtype, dev), kq_frame=z(KQ, dt=torch.int32),
        kq_stamp=z(KQ), kq_len=0,
        submap=G.empty_sparse(geom, S, dtype, dev),
        prev_submap=G.empty_sparse(geom, S, dtype, dev),
        has_prev=False,
        submap_fmean=z(S, 3), submap_fcov=z(S, 3, 3),
        submap_fvalid=z(S, dt=torch.bool),
        prev_fmean=z(S, 3), prev_fcov=z(S, 3, 3), prev_fvalid=z(S, dt=torch.bool),
        submap_origin=pose0.clone(), n_finished=0,
        cur_pose=z(3), last_state=init_state, node_count=0,
        last_node_pose=pose0.clone(), last_node_dist=z(),
        last_imu_yaw=z(), have_imu_prev=False,
        store_cells=C.zeros((cap.max_submaps, S), dtype, dev),
        store_origin=z(cap.max_submaps, 3),
        store_root=z(cap.max_submaps, dt=torch.int32),
        store_count=0,
    )


def node_source_horizon(cfg: SlamConfig) -> int:
    """How many frames before the frame that emits it a node's source frame
    can lie: a keyframe queued at frame t exits ``insertion_delay`` frames
    later at the earliest, and can back up behind up to ``keyframe_queue``
    earlier entries spaced ``insertion_step`` apart."""
    lf = cfg.local_fuser
    return lf.insertion_delay + lf.insertion_step * cfg.capacity.keyframe_queue + 2


def init_batched_carry(cfg: SlamConfig, batch: int, initial_pose=None,
                       dtype=torch.float32, device=None) -> FrontendCarry:
    """:func:`init_carry` broadcast over ``batch`` sequences: every tensor
    gains a leading (batch,) axis (its own memory, as the store is updated
    in place), the cadence counters stay shared."""
    def spread(x):
        if isinstance(x, tuple):  # CellStats, SparseGrid
            return type(x)(*(spread(v) for v in x))
        if isinstance(x, torch.Tensor):
            return x.expand((batch,) + x.shape).clone()
        return x

    return spread(init_carry(cfg, initial_pose, dtype, device))


def build_scan_cells(cfg: SlamConfig, frame: Frame, sensor_to_base) -> tuple:
    """Preprocess + scan NDT (``processScan`` steps 1-2): filter, cluster,
    per-cluster moments of the most-populated cells, derived fields.  Scans
    may arrive as float16 or uint8; all math runs in float32."""
    scan = pp.PolarScan(
        intensity=frame.intensity.to(torch.float32),
        azimuths=frame.azimuths,
        ranges=frame.ranges,
        azimuth_mask=frame.azimuth_mask,
    )
    filt = pp.filter_scan(scan, cfg.preprocessor, sensor_to_base)
    ids, num = pp.cluster_ids(filt.points, filt.mask, cfg.preprocessor)
    cell_cfg = cfg.ndt_map.cell
    stats, _ = C.from_points_compact(
        filt.points, filt.mask, ids, num, cfg.capacity.max_scan_cells,
        polar=filt.polar if cell_cfg.use_pndt else None,
        beam_cov=np.asarray(cell_cfg.beam_cov) if cell_cfg.use_pndt else None,
    )
    mu, cov = C.mean_cov(
        stats,
        cell_cfg.eig_floor_ratio,
        cell_cfg.intensity_var_jitter,
        use_pndt=cell_cfg.use_pndt,
    )
    valid = C.valid_mask(stats, cfg.ndt_map.min_points_per_cell)
    return ScanCells(stats=stats, mean=mu, cov=cov, valid=valid), filt


def _odom_sqrt_information(cfg: SlamConfig):
    return np.asarray(cfg.local_fuser.odom_sqrt_information, np.float32)


def _nodes(slot0: dict | None, slot1: dict | None, like) -> NodeRecord:
    """A two-slot NodeRecord; a missing slot is an invalid (zero) record.
    ``like`` is a pose (..., 3); the slots stack after its batch dims."""
    lead = like.shape[:-1]
    nl = len(lead)
    zeros = dict(valid=False, node_id=0, pose=like.new_zeros(lead + (3,)),
                 stamp=like.new_zeros(lead), traversed=like.new_zeros(lead),
                 submap_id=0,
                 frame_idx=torch.zeros(lead, dtype=torch.int32, device=like.device),
                 is_root=False)
    a, b = slot0 or zeros, slot1 or zeros
    return NodeRecord(
        valid=np.array([a["valid"], b["valid"]]),
        node_id=np.array([a["node_id"], b["node_id"]]),
        pose=torch.stack([a["pose"], b["pose"]], dim=nl),
        stamp=torch.stack([a["stamp"], b["stamp"]], dim=nl),
        traversed=torch.stack([a["traversed"], b["traversed"]], dim=nl),
        submap_id=np.array([a["submap_id"], b["submap_id"]]),
        frame_idx=torch.stack([a["frame_idx"].to(torch.int32),
                               b["frame_idx"].to(torch.int32)], dim=nl),
        is_root=np.array([a["is_root"], b["is_root"]]),
    )


def _edges(slot0: dict | None, slot1: dict | None, like) -> EdgeRecord:
    lead = like.shape[:-1]
    zeros = dict(valid=False, id_begin=0, id_end=0,
                 trans=like.new_zeros(lead + (3,)),
                 sqrt_information=np.zeros((3, 3), np.float32))
    a, b = slot0 or zeros, slot1 or zeros
    return EdgeRecord(
        valid=np.array([a["valid"], b["valid"]]),
        id_begin=np.array([a["id_begin"], b["id_begin"]]),
        id_end=np.array([a["id_end"], b["id_end"]]),
        trans=torch.stack([a["trans"], b["trans"]], dim=len(lead)),
        sqrt_information=np.stack([a["sqrt_information"], b["sqrt_information"]]),
    )


def _push_ring(buf, value, nl: int = 0):
    """Shift-append into a small ring buffer (newest at the end) on axis
    ``nl``, after the batch dims."""
    return torch.cat([buf.narrow(nl, 1, buf.shape[nl] - 1), value.unsqueeze(nl)],
                     dim=nl)


def _row(nl: int, idx: int) -> tuple:
    """Index of row ``idx`` of a table whose rows follow ``nl`` batch dims."""
    return (slice(None),) * nl + (idx,)


def _store_row(store: CellStats, idx: int, stats: CellStats) -> None:
    """Write one submap's compact stats into store row ``idx`` in place."""
    at = _row(stats.n.dim() - 1, idx)
    store.n[at].copy_(stats.n)
    store.s[at].copy_(stats.s)
    store.ss[at].copy_(stats.ss)


def flush_submap(cfg: SlamConfig, c: FrontendCarry) -> FrontendCarry:
    """Persist the current (unfinished) submap into the store at sequence end
    so the loop/PGO passes see every submap."""
    idx = min(c.n_finished, cfg.capacity.max_submaps - 1)
    _store_row(c.store_cells, idx, c.submap.stats)
    return c._replace(store_count=c.n_finished + 1)


# ---------------------------------------------------------------------------
# the per-frame step
# ---------------------------------------------------------------------------


@profiling.span("randt.frontend_step")
def frontend_step(cfg: SlamConfig, carry: FrontendCarry, frame: Frame,
                  sensor_to_base, with_descriptor: bool = True,
                  with_scan_cells: bool = False, graphs=None) -> tuple:
    """One radar frame through the front end, including the submap-completion
    re-processing of the same frame (``ndt_slam.cpp:219-223``), for one
    sequence or a batch of them (see the module docstring).  Without
    ``with_descriptor`` no ScanContext descriptor is made (``sc_desc`` is
    None), as the batched fleet runs go; a batch takes no descriptor.  With
    ``with_scan_cells`` the output also carries the scan's derived cells and
    beams, tensors the step computes anyway.  ``graphs`` is the run's cache
    of window-solve CUDA graphs (``registration/solve_graph``), or None to
    solve eagerly."""
    if with_descriptor and carry.cur_pose.dim() > 1:
        raise ValueError("frontend_step: a batch takes with_descriptor=False")
    scan, filt = build_scan_cells(cfg, frame, sensor_to_base)
    desc = None
    if with_descriptor:
        # ScanContext from the sensor-frame filtered returns
        # (``local_fuser.h:139-141``), emitted for the loop-closure pass.
        desc = SC.make_descriptor(filt.polar, filt.points[:, 2], filt.mask,
                                  cfg.scan_context)
    carry1, out1 = _process_scan(cfg, carry, frame, scan, graphs)

    # Persist the RUNNING submap's compact stats into its store row every
    # step; rows at or beyond ``store_count`` are never read, and on the
    # completion step this writes exactly the finished submap's stats.
    cap = cfg.capacity
    _store_row(carry1.store_cells, min(carry1.n_finished, cap.max_submaps - 1),
               carry1.submap.stats)

    if carry1.traj_len >= cfg.local_fuser.submap_size_poses:
        c2 = _start_new_submap(cfg, carry1)
        carry2, out2 = _process_scan(cfg, c2, frame, scan, graphs)
        # out2 only ever produces the root node of the new submap in slot 1;
        # keep out1's slot-0 node (keyframe exit of the old submap).
        nl = carry.cur_pose.dim() - 1
        out = FrameOutput(
            odom_pose=out2.odom_pose,
            nodes=NodeRecord(*(_slots(a, b, nl) for a, b in zip(out1.nodes, out2.nodes))),
            edges=EdgeRecord(*(_slots(a, b, nl) for a, b in zip(out1.edges, out2.edges))),
            submap_finished=True,
            finished_origin=carry1.submap_origin,
            rejected=out1.rejected,
            n_residuals=out1.n_residuals,
        )
    else:
        carry2, out = carry1, out1
    # Saturation telemetry: the smallest kept scan cell still being a valid
    # distribution means valid cells may have been dropped by the top-k
    # budget; table/store fullness means scatter drops.
    out = out._replace(
        scan_saturated=torch.amin(scan.stats.n, dim=-1)
        > float(cfg.ndt_map.min_points_per_cell),
        submap_saturated=carry2.submap.count >= cap.max_submap_cells,
        store_saturated=carry2.n_finished >= cap.max_submaps,
        sc_desc=desc,
    )
    if with_scan_cells:
        out = out._replace(scan_cells=(scan.mean, scan.cov, scan.valid),
                           beams=filt.beams, beam_mask=filt.beam_mask)
    return carry2, out


def _slots(a, b, nl: int):
    """Slot 0 of ``a`` and slot 1 of ``b``; tensor slots follow ``nl``
    batch dims."""
    if isinstance(a, torch.Tensor):
        return torch.stack([a.select(nl, 0), b.select(nl, 1)], dim=nl)
    return np.stack([a[0], b[1]])


def _start_new_submap(cfg: SlamConfig, c: FrontendCarry) -> FrontendCarry:
    """``LocalFuser::initializeNewSubmap`` (``local_fuser.cpp:40-63``)."""
    geom = G.GridGeom.from_config(cfg.ndt_map)
    dev = c.states.device
    dtype = c.states.dtype
    lead = c.cur_pose.shape[:-1]  # the batch dims
    switch_pose = c.states[..., -1, :3]  # robot pose in old submap frame
    new_origin = compose(c.submap_origin, switch_pose)
    # Previous submap expressed in the NEW submap frame (inverse transform +
    # grid re-keying -- fix over ``local_fuser.cpp:45-46``).
    prev = G.transform_sparse(geom, c.submap, inverse(switch_pose))
    pf = G.derive_sparse_fields(prev, cfg.ndt_map.min_points_per_cell,
                                cfg.ndt_map.cell)
    # The finished submap's stats were persisted by the store-row write in
    # ``frontend_step``; only the finished count advances here.
    Cc = cfg.capacity.max_scan_cells
    return c._replace(
        store_count=c.n_finished + 1,
        states=torch.zeros_like(c.states),
        stamps=torch.zeros_like(c.stamps),
        imu_meas=torch.zeros_like(c.imu_meas),
        traj_len=0,
        scan_mean=torch.zeros_like(c.scan_mean),
        scan_cov=torch.zeros_like(c.scan_cov),
        scan_valid=torch.zeros_like(c.scan_valid),
        kq_stats=C.zeros(lead + (cfg.capacity.keyframe_queue, Cc), dtype, dev),
        kq_frame=torch.zeros_like(c.kq_frame),
        kq_stamp=torch.zeros_like(c.kq_stamp),
        kq_len=0,
        submap=G.empty_sparse(geom, cfg.capacity.max_submap_cells, dtype, dev,
                              batch=lead),
        prev_submap=prev,
        has_prev=True,
        submap_fmean=torch.zeros_like(c.submap_fmean),
        submap_fcov=torch.zeros_like(c.submap_fcov),
        submap_fvalid=torch.zeros_like(c.submap_fvalid),
        prev_fmean=pf[0],
        prev_fcov=pf[1],
        prev_fvalid=pf[2],
        submap_origin=new_origin,
        n_finished=c.n_finished + 1,
        cur_pose=torch.zeros(lead + (3,), dtype=dtype, device=dev),
        last_state=c.states[..., -1, :],
    )


def _process_scan(cfg: SlamConfig, c: FrontendCarry, frame: Frame,
                  scan: ScanCells, graphs) -> tuple:
    if c.traj_len == 0:
        return _first_scan(cfg, c, frame, scan)
    return _regular_scan(cfg, c, frame, scan, graphs)


def _first_scan(cfg: SlamConfig, c: FrontendCarry, frame: Frame,
                scan: ScanCells) -> tuple:
    """First scan of a submap (``local_fuser.cpp:226-295``): seed the
    trajectory, merge the scan at the current pose, emit the submap root node
    + connecting edge."""
    dtype = c.states.dtype
    geom = G.GridGeom.from_config(cfg.ndt_map)
    lead = c.cur_pose.shape[:-1]  # the batch dims
    nl = len(lead)

    if c.n_finished > 0:  # carry the velocities and bias into the new submap
        init_state = torch.cat([c.cur_pose, c.last_state[..., 3:]], dim=-1)
    else:
        tail = c.cur_pose.new_zeros(lead + (6,))
        tail[..., 5] = cfg.matcher.initial_imu_bias
        init_state = torch.cat([c.cur_pose, tail], dim=-1)
    stamp = frame.stamp.to(dtype)

    states = _push_ring(c.states, init_state, nl)
    stamps = _push_ring(c.stamps, stamp, nl)
    imu_meas = _push_ring(c.imu_meas, c.imu_meas.new_zeros(lead), nl)

    # Merge the scan at the current pose (identity except for the very first
    # frame with a non-trivial initial transform).
    submap = G.scatter_sparse(geom, c.submap, C.transform_set(scan.stats, c.cur_pose),
                              scan.valid)
    sf = G.derive_sparse_fields(submap, cfg.ndt_map.min_points_per_cell,
                                cfg.ndt_map.cell)

    # Root node + edge from the previous node (if any).
    node_pose = c.submap_origin
    have_prev_node = c.node_count > 0
    trans = relative(c.last_node_pose, node_pose)
    traversed = c.last_node_dist
    if have_prev_node:
        traversed = traversed + torch.linalg.vector_norm(trans[..., :2], dim=-1)
    node = dict(valid=True, node_id=c.node_count, pose=node_pose, stamp=stamp,
                traversed=traversed, submap_id=c.n_finished,
                frame_idx=frame.index, is_root=True)
    edge = dict(valid=have_prev_node, id_begin=c.node_count - 1,
                id_end=c.node_count, trans=trans,
                sqrt_information=_odom_sqrt_information(cfg))
    out = FrameOutput(
        odom_pose=compose(c.submap_origin, c.cur_pose),
        nodes=_nodes(None, node, trans),
        edges=_edges(None, edge, trans),
        submap_finished=False,
        finished_origin=trans.new_zeros(lead + (3,)),
        rejected=False,
        n_residuals=0,
    )
    # Record this submap's root node id and origin in the store
    # (``local_fuser.cpp:274``), in place.
    sidx = min(c.n_finished, cfg.capacity.max_submaps - 1)
    c.store_origin[_row(nl, sidx)].copy_(c.submap_origin)
    c.store_root[_row(nl, sidx)] = c.node_count
    new_c = c._replace(
        states=states,
        stamps=stamps,
        imu_meas=imu_meas,
        traj_len=1,
        submap=submap,
        submap_fmean=sf[0],
        submap_fcov=sf[1],
        submap_fvalid=sf[2],
        node_count=c.node_count + 1,
        last_node_pose=node_pose,
        last_node_dist=traversed,
        last_imu_yaw=frame.imu_yaw.to(dtype),
        have_imu_prev=True,
    )
    return new_c, out


def _regular_scan(cfg: SlamConfig, c: FrontendCarry, frame: Frame,
                  scan: ScanCells, graphs) -> tuple:
    """Odometry path (``local_fuser.cpp:108-224``)."""
    dtype = c.states.dtype
    dev = c.states.device
    mcfg = cfg.matcher
    lcfg = cfg.local_fuser
    W = mcfg.smoothing_steps
    TB = cfg.capacity.traj_buffer
    geom = G.GridGeom.from_config(cfg.ndt_map)
    stamp = frame.stamp.to(dtype)
    lead = c.cur_pose.shape[:-1]  # the batch dims
    nl = len(lead)

    # --- IMU relative yaw (``local_fuser.cpp:110-120``) --------------------
    if mcfg.use_imu and c.have_imu_prev:
        imu_rel = normalize_angle(frame.imu_yaw.to(dtype) - c.last_imu_yaw)
    else:
        imu_rel = c.imu_meas.new_zeros(lead)

    # --- prediction (``Matcher::predictTransform``) -------------------------
    prior_pose = c.states[..., -1, :3]  # pre-prediction pose = rejection reference
    dt = stamp - c.stamps[..., -1]
    pred = matcher.predict_next_state(c.states[..., -1, :], dt)
    states = _push_ring(c.states, pred, nl)
    stamps = _push_ring(c.stamps, stamp, nl)
    imu_meas = _push_ring(c.imu_meas, imu_rel, nl)
    traj_len = c.traj_len + 1

    # --- scan window push; slots beyond the trajectory are stale -------------
    n_scans = min(traj_len - 1, W)
    slot_has_scan = runtime.const(np.arange(W) >= (W - n_scans), torch.bool, dev)
    scan_mean = _push_ring(c.scan_mean, scan.mean, nl)
    scan_cov = _push_ring(c.scan_cov, scan.cov, nl)
    scan_valid = _push_ring(c.scan_valid, scan.valid, nl) & slot_has_scan[:, None]

    # --- fixed maps (cached derived fields) -----------------------------------
    use_prev = c.has_prev and traj_len < lcfg.submap_overlap
    fixed = matcher.FixedMaps(
        index=(c.submap.index, c.prev_submap.index),
        mean=torch.stack([c.submap_fmean, c.prev_fmean], dim=nl),
        cov=torch.stack([c.submap_fcov, c.prev_fcov], dim=nl),
        valid=torch.stack([c.submap_fvalid, c.prev_fvalid], dim=nl),
        use=(True, use_prev),
    )

    # --- sliding-window solve -------------------------------------------------
    state_exists = np.arange(W + 1) >= (W + 1 - min(traj_len, W + 1))
    est = matcher.estimate_window(
        cfg,
        states[..., TB - W - 1:, :],
        stamps[..., TB - W - 1:],
        state_exists,
        imu_meas[..., TB - W:],
        matcher.ScanWindow(mean=scan_mean, cov=scan_cov, valid=scan_valid),
        fixed,
        prior_pose,
        graphs,
    )
    states = torch.cat([states[..., :TB - W - 1, :], est.states], dim=-2)
    cur_pose = states[..., -1, :3]

    # --- keyframe queue push (``local_fuser.cpp:155-161``) --------------------
    kq_stats, kq_frame, kq_stamp, kq_len = c.kq_stats, c.kq_frame, c.kq_stamp, c.kq_len
    if traj_len % lcfg.insertion_step == 0:
        idx = _row(nl, min(kq_len, cfg.capacity.keyframe_queue - 1))
        kq_stats = CellStats(*(_set_row(a, idx, b) for a, b in zip(kq_stats, scan.stats)))
        kq_frame = _set_row(kq_frame, idx, frame.index.to(torch.int32))
        kq_stamp = _set_row(kq_stamp, idx, stamp)
        kq_len = kq_len + 1

    # --- delayed keyframe exit (``local_fuser.cpp:164-223``) ------------------
    delay = lcfg.insertion_delay
    do_exit = (traj_len >= delay + lcfg.insertion_step
               and (traj_len - delay) % lcfg.insertion_step == 0
               and kq_len > 0)
    submap = c.submap
    sfields = (c.submap_fmean, c.submap_fcov, c.submap_fvalid)
    node = edge = None
    node_count, last_node_pose, last_node_dist = (
        c.node_count, c.last_node_pose, c.last_node_dist)
    if do_exit:
        smoothed_pose = states[..., TB - delay - 1, :3]  # end[-(delay+1)], :165
        front = CellStats(*(a[_row(nl, 0)] for a in kq_stats))
        front_valid = C.valid_mask(front, cfg.ndt_map.min_points_per_cell)
        submap = G.scatter_sparse(geom, submap, C.transform_set(front, smoothed_pose),
                                  front_valid)
        sfields = G.derive_sparse_fields(submap, cfg.ndt_map.min_points_per_cell,
                                         cfg.ndt_map.cell)
        node_pose = compose(c.submap_origin, smoothed_pose)
        trans = relative(c.last_node_pose, node_pose)
        traversed = c.last_node_dist + torch.linalg.vector_norm(trans[..., :2], dim=-1)
        node = dict(valid=True, node_id=c.node_count, pose=node_pose,
                    stamp=kq_stamp[..., 0], traversed=traversed,
                    submap_id=c.n_finished, frame_idx=kq_frame[..., 0],
                    is_root=False)
        edge = dict(valid=True, id_begin=c.node_count - 1, id_end=c.node_count,
                    trans=trans, sqrt_information=_odom_sqrt_information(cfg))
        node_count, last_node_pose, last_node_dist = (
            c.node_count + 1, node_pose, traversed)
        # pop the front of the queue
        kq_stats = CellStats(*(_pop_front(a, nl) for a in kq_stats))
        kq_frame = _pop_front(kq_frame, nl)
        kq_stamp = _pop_front(kq_stamp, nl)
        kq_len = kq_len - 1

    out = FrameOutput(
        odom_pose=compose(c.submap_origin, cur_pose),
        nodes=_nodes(node, None, cur_pose),
        edges=_edges(edge, None, cur_pose),
        submap_finished=False,
        finished_origin=cur_pose.new_zeros(lead + (3,)),
        rejected=est.rejected,
        n_residuals=est.n_residuals,
    )
    new_c = c._replace(
        states=states,
        stamps=stamps,
        imu_meas=imu_meas,
        traj_len=traj_len,
        scan_mean=scan_mean,
        scan_cov=scan_cov,
        scan_valid=scan_valid,
        kq_stats=kq_stats,
        kq_frame=kq_frame,
        kq_stamp=kq_stamp,
        kq_len=kq_len,
        submap=submap,
        submap_fmean=sfields[0],
        submap_fcov=sfields[1],
        submap_fvalid=sfields[2],
        cur_pose=cur_pose,
        node_count=node_count,
        last_node_pose=last_node_pose,
        last_node_dist=last_node_dist,
        last_imu_yaw=frame.imu_yaw.to(dtype),
        have_imu_prev=True,
    )
    return new_c, out


def _set_row(buf, idx, value):
    out = buf.clone()
    out[idx] = value
    return out


def _pop_front(buf, nl: int = 0):
    """Drop row 0 (after ``nl`` batch dims) and append a zero row."""
    n = buf.shape[nl]
    return torch.cat([buf.narrow(nl, 1, n - 1), torch.zeros_like(buf.narrow(nl, 0, 1))],
                     dim=nl)
