"""Offline SLAM replay (``NDTSlam::initializeOffline``,
``ndt_slam.cpp:94-209``), port of ``randt_slam_tpu/pipeline/slam.py``, in
three phases:

A. odometry (:func:`run_odometry`): the front-end step over all frames,
   giving per-frame poses, the pose-graph node/edge tables and the compacted
   submap store;
B. loop closure (``loops/detector.py``): one batched pass over the
   keyframes, after odometry (loop edges never feed back into odometry
   before the final solve, ``ndt_slam.cpp:124,176``);
C. one pose-graph solve (``graph/schur.optimize_auto``) and the submap
   re-anchoring (``GlobalFuser::optimizePoseGraph`` +
   ``LocalFuser::updateSubmaps``).

:func:`run_slam` runs all three.  The frames live on the device for the
whole run and the odometry step never waits on it; its outputs are fetched
once, after the last frame.  :func:`render_ogm` makes the occupancy grid of
a finished run.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import runtime
from ..config import SlamConfig
from . import frontend as F


@dataclasses.dataclass
class OdometryResult:
    """Host-side phase-A output (numpy), plus the device submap store."""

    odom_poses: np.ndarray      # (T, 3) per-frame global poses (/ndt_odom)
    node_id: np.ndarray         # (N,) int
    node_pose: np.ndarray       # (N, 3) global node poses (odometry estimate)
    node_stamp: np.ndarray      # (N,)
    node_traversed: np.ndarray  # (N,)
    node_submap: np.ndarray     # (N,) int
    node_frame: np.ndarray      # (N,) int -- source frame index
    node_is_root: np.ndarray    # (N,) bool
    edge_begin: np.ndarray      # (E,) int
    edge_end: np.ndarray        # (E,) int
    edge_trans: np.ndarray      # (E, 3)
    edge_sqrt_information: np.ndarray  # (E, 3, 3)
    # submap store (device tensors kept for phases B/C)
    submap_cells_n: torch.Tensor   # (NS, KS)
    submap_cells_s: torch.Tensor
    submap_cells_ss: torch.Tensor
    submap_origin: np.ndarray   # (NS, 3)
    submap_root: np.ndarray     # (NS,) int
    n_submaps: int
    rejected_frames: np.ndarray  # (T,) bool
    final_carry: object = None
    # frames where a padded capacity saturated (possible silent data drop)
    saturation: dict = dataclasses.field(default_factory=dict)
    # ScanContext descriptors of every node's source frame (float32)
    node_desc: np.ndarray | None = None


def frames_from_arrays(intensity, azimuths, ranges, stamps, imu_yaw=None,
                       device=None):
    """Stack a sequence into a Frame of (T, ...) tensors on ``device`` (CUDA
    unless ``device="cpu"``).  float16/uint8 scans keep their type (a half or
    a quarter of the float32 upload); the front end upcasts on the device."""
    dev = runtime.resolve_device(device)
    intensity = np.asarray(intensity)
    T, A, Rb = intensity.shape
    if imu_yaw is None:
        imu_yaw = np.zeros(T, np.float32)
    if intensity.dtype not in (np.float16, np.uint8):
        intensity = intensity.astype(np.float32)

    def put(x, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

    return F.Frame(
        intensity=torch.from_numpy(np.ascontiguousarray(intensity)).to(dev),
        azimuths=put(np.broadcast_to(np.asarray(azimuths, np.float32), (T, A))),
        ranges=put(np.broadcast_to(np.asarray(ranges, np.float32), (T, Rb))),
        azimuth_mask=put(np.ones((T, A), bool), bool),
        stamp=put(stamps),
        imu_yaw=put(imu_yaw),
        index=put(np.arange(T), np.int32),
    )


def _stack_leaf(values, batch: int | None = None) -> np.ndarray:
    """Stack one output field over frames: tensors in one device copy,
    host values as they are; with a batch (tensors (B, ...)), host values
    (shared by the members) repeated over it, and the result (B, T, ...)."""
    out = [None] * len(values)
    dev = [i for i, v in enumerate(values) if isinstance(v, torch.Tensor)]
    if dev:
        arr = torch.stack([values[i] for i in dev]).cpu().numpy()
        for j, i in enumerate(dev):
            out[i] = arr[j]
    for i, v in enumerate(values):
        if out[i] is None:
            out[i] = np.asarray(v)
            if batch is not None:
                out[i] = np.broadcast_to(out[i], (batch,) + out[i].shape)
    return np.stack(out) if batch is None else np.stack(out, axis=1)


def stack_outputs(outs: list, batch: int | None = None) -> F.FrameOutput:
    """Per-frame outputs -> one FrameOutput of numpy (T, ...) arrays, or
    (B, T, ...) for the outputs of a batch of ``batch`` sequences."""
    def field(name, rec=None):
        vals = [getattr(o, name) if rec is None else getattr(getattr(o, rec), name)
                for o in outs]
        return None if vals[0] is None else _stack_leaf(vals, batch)

    nodes = F.NodeRecord(*(field(k, "nodes") for k in F.NodeRecord._fields))
    edges = F.EdgeRecord(*(field(k, "edges") for k in F.EdgeRecord._fields))
    rest = {k: field(k) for k in F.FrameOutput._fields if k not in ("nodes", "edges")}
    return F.FrameOutput(nodes=nodes, edges=edges, **rest)


def _unstack_outputs(outs: F.FrameOutput) -> dict:
    """Gather valid node/edge records from stacked (T, 2, ...) outputs."""
    nodes, edges = outs.nodes, outs.edges
    nv = nodes.valid.reshape(-1).astype(bool)
    ev = edges.valid.reshape(-1).astype(bool)
    node = {
        "node_id": nodes.node_id.reshape(-1)[nv],
        "node_pose": nodes.pose.reshape(-1, 3)[nv],
        "node_stamp": nodes.stamp.reshape(-1)[nv],
        "node_traversed": nodes.traversed.reshape(-1)[nv],
        "node_submap": nodes.submap_id.reshape(-1)[nv],
        "node_frame": nodes.frame_idx.reshape(-1)[nv],
        "node_is_root": nodes.is_root.reshape(-1)[nv],
    }
    edge = {
        "edge_begin": edges.id_begin.reshape(-1)[ev],
        "edge_end": edges.id_end.reshape(-1)[ev],
        "edge_trans": edges.trans.reshape(-1, 3)[ev],
        "edge_sqrt_information": edges.sqrt_information.reshape(-1, 3, 3)[ev],
    }
    order = np.argsort(node["node_id"], kind="stable")
    for k in node:
        node[k] = node[k][order]
    return {**node, **edge}


def run_odometry(
    cfg: SlamConfig,
    frames: F.Frame,
    sensor_to_base=None,
    initial_pose=None,
    device=None,
    on_frame=None,
) -> OdometryResult:
    """Phase A over a full sequence, on ``device`` (CUDA unless
    ``device="cpu"``).  Frames on another device are moved there once.

    ``on_frame(t, carry)``, if given, is called on the host before frame
    ``t`` is stepped, with the carry that enters it (for progress, timing or
    snapshots).  The carry's tensors are updated in place later: copy what
    you keep, and do not modify it."""
    dev = runtime.resolve_device(device)
    dtype = torch.float32
    if sensor_to_base is None:
        s2b = torch.zeros(3, dtype=dtype, device=dev)
    else:
        s2b = torch.as_tensor(np.asarray(sensor_to_base, np.float32)).to(dev)
    if frames.stamp.device != dev:
        frames = F.Frame(*(x.to(dev) for x in frames))
    carry = F.init_carry(cfg, initial_pose=initial_pose, device=dev)
    T = int(frames.stamp.shape[0])

    outs = []
    for t in range(T):
        if on_frame is not None:
            on_frame(t, carry)
        fr = F.Frame(*(x[t] for x in frames))
        carry, out = F.frontend_step(cfg, carry, fr, s2b)
        outs.append(out)
    carry = F.flush_submap(cfg, carry)

    host = stack_outputs(outs)
    tables = _unstack_outputs(host)
    node_desc = host.sc_desc[tables["node_frame"]].astype(np.float32)
    return OdometryResult(
        odom_poses=host.odom_pose,
        node_id=tables["node_id"],
        node_pose=tables["node_pose"],
        node_stamp=tables["node_stamp"],
        node_traversed=tables["node_traversed"],
        node_submap=tables["node_submap"],
        node_frame=tables["node_frame"],
        node_is_root=tables["node_is_root"],
        edge_begin=tables["edge_begin"],
        edge_end=tables["edge_end"],
        edge_trans=tables["edge_trans"],
        edge_sqrt_information=tables["edge_sqrt_information"],
        submap_cells_n=carry.store_cells.n,
        submap_cells_s=carry.store_cells.s,
        submap_cells_ss=carry.store_cells.ss,
        submap_origin=carry.store_origin.cpu().numpy(),
        submap_root=carry.store_root.cpu().numpy(),
        n_submaps=int(carry.store_count),
        rejected_frames=host.rejected.astype(bool),
        final_carry=carry,
        saturation={
            "scan_cell_budget_frames": int(host.scan_saturated.sum()),
            "submap_table_full_frames": int(host.submap_saturated.sum()),
            "submap_store_full": bool(host.store_saturated.any()),
        },
        node_desc=node_desc,
    )


@dataclasses.dataclass
class SlamResult:
    odometry: OdometryResult
    loops: object                    # loops.detector.LoopResult
    node_pose_optimized: np.ndarray  # (N, 3) after pose-graph optimization
    node_stamp: np.ndarray
    node_frame: np.ndarray
    submap_origin_optimized: np.ndarray  # (NS, 3) re-anchored submap origins
    pgo_cost: float
    pgo_iterations: int
    timings: dict = dataclasses.field(default_factory=dict)


def build_pose_graph(odo: OdometryResult, loops, device):
    """The pose graph of odometry edges plus loop edges (``loops`` may be
    None) at the odometry node poses, on ``device``."""
    from ..graph.pose_graph import PoseGraph

    parts = [odo] if loops is None else [odo, loops]
    eb = np.concatenate([p.edge_begin for p in parts]).astype(np.int64)

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(device)

    return PoseGraph(
        poses=put(odo.node_pose, torch.float32),
        id_begin=put(eb, torch.long),
        id_end=put(np.concatenate([p.edge_end for p in parts]), torch.long),
        trans=put(np.concatenate([p.edge_trans for p in parts]), torch.float32),
        sqrt_information=put(np.concatenate(
            [p.edge_sqrt_information for p in parts]), torch.float32),
        valid=torch.ones(len(eb), dtype=torch.bool, device=device),
    )


def run_slam(cfg: SlamConfig, frames: F.Frame, sensor_to_base=None,
             initial_pose=None, device=None) -> SlamResult:
    """Full offline SLAM on ``device`` (CUDA unless ``device="cpu"``):
    odometry, batched loop closure (ScanContext, or position association
    with ``use_scan_context_as_loop_closure`` off), one final pose-graph
    solve and the submap re-anchoring (``ndt_slam.cpp:94-209`` offline
    semantics: loop search per frame, the pose graph once at the end).
    ``timings`` holds the wall seconds of each phase."""
    from ..graph import pose_graph as PG
    from ..graph import schur
    from ..loops import detector

    dev = runtime.resolve_device(device)
    timings = {}
    t0 = time.perf_counter()
    odo = run_odometry(cfg, frames, sensor_to_base=sensor_to_base,
                       initial_pose=initial_pose, device=dev)
    timings["odometry_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    if cfg.local_fuser.use_scan_context_as_loop_closure:
        loops = detector.detect_loops(cfg, odo, frames, sensor_to_base, device=dev)
    else:
        # node covariances from one covariance-recovery pass over the
        # odometry-only graph
        g0 = build_pose_graph(odo, None, dev)
        node_cov = PG.recover_covariances(g0, g0.poses, cfg.global_fuser)
        loops = detector.detect_loops_mahalanobis(
            cfg, odo, frames, sensor_to_base, node_cov=node_cov.cpu().numpy(),
            device=dev)
    timings["loop_closure_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    opt, info = schur.optimize_auto(
        build_pose_graph(odo, loops, dev), cfg.global_fuser,
        node_submap=odo.node_submap, node_is_root=odo.node_is_root)
    opt = opt.cpu().numpy()
    timings["pgo_s"] = round(time.perf_counter() - t0, 3)
    timings["pgo_solver"] = info["solver"]
    timings["pgo_two_stage"] = bool(info.get("two_stage", False))

    # submap re-anchoring (``LocalFuser::updateSubmaps``): every submap
    # origin moves to its root node's optimized pose
    n_sub = odo.n_submaps
    origin = odo.submap_origin.copy()
    origin[:n_sub] = opt[odo.submap_root[:n_sub]]
    return SlamResult(
        odometry=odo, loops=loops, node_pose_optimized=opt,
        node_stamp=odo.node_stamp, node_frame=odo.node_frame,
        submap_origin_optimized=origin, pgo_cost=float(info["cost"]),
        pgo_iterations=int(info["iterations"]), timings=timings)


def ogm_max_steps(cfg: SlamConfig) -> int:
    """Steps of the device ray walk: twice a full-range beam's cells, which
    walks every beam to its end as the native walk does."""
    return min(2048, 2 * int(cfg.preprocessor.max_range / cfg.ogm.resolution))


@torch.profiler.record_function("randt.ogm")
def render_ogm(cfg: SlamConfig, result: SlamResult, frames: F.Frame,
               sensor_to_base=None, device=None):
    """Occupancy-grid post-pass (``raytrace`` + ``visualizeMap`` timers,
    ``ndt_slam.cpp:366-368,308-348``) on ``device`` (CUDA unless
    ``device="cpu"``): re-extract every keyframe node's max-intensity beams
    (one ``preprocess.filter_scan``, so one K1 launch, per node), raytrace
    them into per-submap counting grids at the odometry-time sensor poses,
    fuse the grids into the global OGM at the optimized submap origins, and
    apply the smoothstep occupancy mapping.

    Returns (global occupancy (gh, gw) float32, counting grids (NS, sh, sw)
    int32) as numpy.  The JAX package counts on the host through its native
    C++ and keeps its device trace as the fallback; here the device trace is
    the path.  A submap's beams are traced in chunks
    (``raytrace.CHUNK_ELEMENTS``).
    """
    from .. import preprocess as pp
    from ..mapping import ogm as OGM
    from ..mapping import raytrace as RT

    dev = runtime.resolve_device(device)
    dtype = torch.float32
    s2b = torch.zeros(3, dtype=dtype, device=dev) if sensor_to_base is None else (
        torch.as_tensor(np.asarray(sensor_to_base, np.float32)).to(dev))
    odo = result.odometry
    o = cfg.ogm
    sh, sw = o.submap_size_y, o.submap_size_x
    n_sub = odo.n_submaps

    beams, masks = [], []
    for f in np.asarray(odo.node_frame, np.int64):
        scan = pp.PolarScan(
            intensity=frames.intensity[f].to(dev).to(dtype),
            azimuths=frames.azimuths[f].to(dev), ranges=frames.ranges[f].to(dev),
            azimuth_mask=frames.azimuth_mask[f].to(dev))
        filt = pp.filter_scan(scan, cfg.preprocessor, s2b)
        beams.append(filt.beams)
        masks.append(filt.beam_mask)
    beams = torch.stack(beams) if beams else torch.zeros(0, 1, 3, device=dev)
    masks = torch.stack(masks) if masks else torch.zeros(0, 1, dtype=torch.bool,
                                                          device=dev)

    # sensor poses in each node's submap frame (odometry-time geometry)
    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    origins = put(odo.submap_origin[np.asarray(odo.node_submap)])
    local = OGM.compose(OGM.inverse(origins), put(odo.node_pose))
    sensor_pose = OGM.compose(local, s2b.expand_as(local))

    A = beams.shape[1]
    max_steps = ogm_max_steps(cfg)
    node_sub = torch.from_numpy(np.asarray(odo.node_submap, np.int64)).to(dev)
    grids = torch.zeros(n_sub, sh, sw, dtype=torch.int32, device=dev)
    for s in range(n_sub):
        sel = torch.nonzero(node_sub == s).reshape(-1)
        grids[s] = RT.raytrace_beams(
            grids[s], torch.repeat_interleave(sensor_pose[sel], A, dim=0),
            beams[sel].reshape(-1, 3), masks[sel].reshape(-1), o.resolution,
            max_steps=max_steps)

    # fuse at the optimized origins; corner offset = -size/2 * res
    corner = put([-0.5 * sw * o.resolution, -0.5 * sh * o.resolution, 0.0])
    sub_corners = OGM.compose(put(result.submap_origin_optimized[:n_sub]),
                              corner.expand(n_sub, 3))
    g_corner = put([-0.5 * o.size_x * o.resolution,
                    -0.5 * o.size_y * o.resolution, 0.0])
    total = OGM.fuse_submaps(grids, sub_corners, o.resolution, o.resolution,
                             g_corner, o.size_y, o.size_x)
    return (OGM.global_occupancy(total).cpu().numpy(), grids.cpu().numpy())
