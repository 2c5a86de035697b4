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
once, after the last frame.  For sequences too long for that
(``frames_from_arrays(..., host=True)`` and ``run_odometry(..., chunk=)``)
the frames stay in host memory and go to the device one chunk at a time,
the next chunk's upload overlapping the current chunk, and each chunk's
outputs come back to the host at its end.  :func:`render_ogm` makes the
occupancy grid of a finished run.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import runtime
from ..config import SlamConfig
from ..registration import solve_graph
from ..utils import profiling
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
    # wall seconds of each chunk of a chunked run (empty otherwise): from
    # the end of the previous chunk to this chunk's outputs on the host
    chunk_seconds: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float64))


def frames_from_arrays(intensity, azimuths, ranges, stamps, imu_yaw=None,
                       device=None, host=False):
    """Stack a sequence into a Frame of (T, ...) tensors on ``device`` (CUDA
    unless ``device="cpu"``), or with ``host=True`` in host memory, where
    long sequences wait for ``run_odometry(..., chunk=)`` to upload them
    chunk by chunk.  float16/uint8 scans keep their type (a half or a
    quarter of the float32 memory and upload); the front end upcasts on the
    device."""
    dev = torch.device("cpu") if host else runtime.resolve_device(device)
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


def _chunk_uploads(frames: F.Frame, chunk: int, dev):
    """Host-resident ``frames`` on ``dev``, one chunk of ``chunk`` frames at
    a time: yields (lo, hi, Frame of frames lo..hi-1 on ``dev``).

    On CUDA each chunk is copied on a side stream from one of two pinned
    staging buffers, which alternate between chunks.  Chunk i+1's copy is
    issued when chunk i is handed out, so it runs while the host dispatches
    chunk i; the compute stream waits on the copy's event before the chunk's
    first frame, and ``record_stream`` keeps a chunk's memory from being
    reused while work queued on the compute stream may still read it.  The
    host waits only on copy events, never on the compute stream."""
    T = int(frames.stamp.shape[0])
    bounds = [(lo, min(lo + chunk, T)) for lo in range(0, T, chunk)]
    if dev.type != "cuda" or frames.stamp.device == dev:
        for lo, hi in bounds:
            yield lo, hi, F.Frame(*(x[lo:hi].to(dev) for x in frames))
        return
    side = torch.cuda.Stream(dev)
    compute = torch.cuda.current_stream(dev)
    staging = [[torch.empty((chunk,) + tuple(x.shape[1:]), dtype=x.dtype).pin_memory()
                for x in frames] for _ in range(2)]
    copied = [None, None]  # the last copy out of each staging buffer

    def upload(i):
        lo, hi = bounds[i]
        buf = staging[i % 2]
        if copied[i % 2] is not None:
            copied[i % 2].synchronize()
        with torch.cuda.stream(side):
            parts = []
            for x, b in zip(frames, buf):
                b[:hi - lo].copy_(x[lo:hi])
                parts.append(b[:hi - lo].to(dev, non_blocking=True))
            done = torch.cuda.Event()
            done.record(side)
        copied[i % 2] = done
        return done, parts

    nxt = upload(0)
    for i, (lo, hi) in enumerate(bounds):
        done, parts = nxt
        compute.wait_event(done)
        for x in parts:
            x.record_stream(compute)
        if i + 1 < len(bounds):
            nxt = upload(i + 1)
        yield lo, hi, F.Frame(*parts)


def _concat_outputs(parts: list) -> F.FrameOutput:
    """Chunks of host outputs (numpy (T_i, ...)) -> one FrameOutput."""
    def cat(vals):
        return None if vals[0] is None else np.concatenate(vals)

    def rec(kind, of):
        return kind(*(cat([getattr(of(p), k) for p in parts]) for k in kind._fields))

    rest = {k: cat([getattr(p, k) for p in parts])
            for k in F.FrameOutput._fields if k not in ("nodes", "edges")}
    return F.FrameOutput(nodes=rec(F.NodeRecord, lambda p: p.nodes),
                         edges=rec(F.EdgeRecord, lambda p: p.edges), **rest)


def run_odometry(
    cfg: SlamConfig,
    frames: F.Frame,
    sensor_to_base=None,
    initial_pose=None,
    device=None,
    on_frame=None,
    chunk: int = 0,
) -> OdometryResult:
    """Phase A over a full sequence, on ``device`` (CUDA unless
    ``device="cpu"``).  Frames on another device are moved there once; with
    ``0 < chunk < T`` they are moved one chunk at a time instead (the next
    chunk's upload overlapping the current one on CUDA) and each chunk's
    outputs are copied to the host at its end, so neither the frames nor
    the outputs of the whole sequence sit on the device.  The results are
    bitwise those of the run without chunks; ``chunk_seconds`` holds each
    chunk's wall seconds.

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
    T = int(frames.stamp.shape[0])
    chunked = 0 < chunk < T
    if frames.stamp.device != dev and not chunked:
        frames = F.Frame(*(x.to(dev) for x in frames))
    carry = F.init_carry(cfg, initial_pose=initial_pose, device=dev)
    graphs = solve_graph.SolveGraphs()

    def steps(part, lo, hi):
        nonlocal carry
        outs = []
        for t in range(lo, hi):
            if on_frame is not None:
                on_frame(t, carry)
            fr = F.Frame(*(x[t - lo] for x in part))
            carry, out = F.frontend_step(cfg, carry, fr, s2b, graphs=graphs)
            outs.append(out)
        return outs

    chunk_seconds = []
    if chunked:
        # A node leaves the front end some frames after its source frame,
        # which may lie in an earlier chunk: the float32 descriptor rows of
        # the frames within that horizon are kept across chunks.
        keep = F.node_source_horizon(cfg)
        rows, node_rows, parts = {}, {}, []
        t_c = time.perf_counter()
        for lo, hi, part in _chunk_uploads(frames, chunk, dev):
            host = stack_outputs(steps(part, lo, hi))  # one copy per chunk
            rows.update((lo + i, d) for i, d in enumerate(host.sc_desc))
            for f in host.nodes.frame_idx[host.nodes.valid.astype(bool)]:
                if int(f) not in rows:
                    raise RuntimeError(f"node source frame {int(f)} is older than the "
                                       f"{keep}-frame descriptor window at frame {hi}")
                node_rows[int(f)] = rows[int(f)].copy()
            for k in [k for k in rows if k < hi - keep]:
                del rows[k]
            parts.append(host._replace(sc_desc=None))
            now = time.perf_counter()
            chunk_seconds.append(now - t_c)
            t_c = now
        carry = F.flush_submap(cfg, carry)
        host = _concat_outputs(parts)
        tables = _unstack_outputs(host)
        # frame 0 always emits a node (the first submap's root)
        node_desc = np.stack([node_rows[int(f)] for f in tables["node_frame"]])
    else:
        outs = steps(frames, 0, T)
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
        chunk_seconds=np.asarray(chunk_seconds, np.float64),
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
             initial_pose=None, device=None, chunk: int = 0) -> SlamResult:
    """Full offline SLAM on ``device`` (CUDA unless ``device="cpu"``):
    odometry, batched loop closure (ScanContext, or position association
    with ``use_scan_context_as_loop_closure`` off), one final pose-graph
    solve and the submap re-anchoring (``ndt_slam.cpp:94-209`` offline
    semantics: loop search per frame, the pose graph once at the end).
    ``timings`` holds the wall seconds of each phase.  ``chunk`` goes to
    :func:`run_odometry`; the loop pass moves each candidate frame it
    rebuilds to the device on its own, so host-resident frames stay where
    they are."""
    from ..graph import pose_graph as PG
    from ..graph import schur
    from ..loops import detector

    dev = runtime.resolve_device(device)
    timings = {}
    t0 = time.perf_counter()
    odo = run_odometry(cfg, frames, sensor_to_base=sensor_to_base,
                       initial_pose=initial_pose, device=dev, chunk=chunk)
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


@profiling.span("randt.ogm")
def render_ogm(cfg: SlamConfig, result: SlamResult, frames: F.Frame,
               sensor_to_base=None, device=None, chunk: int = 32):
    """Occupancy-grid post-pass (``raytrace`` + ``visualizeMap`` timers,
    ``ndt_slam.cpp:366-368,308-348``) on ``device`` (CUDA unless
    ``device="cpu"``): re-extract every keyframe node's max-intensity beams
    (the node frames gathered ``chunk`` at a time, from the host or the
    device where ``frames`` lie, the last chunk padded with its final
    frame, and one batched ``preprocess.filter_scan``, so one K1 launch, per
    chunk), raytrace them into per-submap counting grids at the
    odometry-time sensor poses, fuse the grids into the global OGM at the
    optimized submap origins, and apply the smoothstep occupancy mapping.

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

    node_frames = np.asarray(odo.node_frame, np.int64)
    n_nodes = len(node_frames)
    beams, masks = [], []
    for lo in range(0, n_nodes, chunk):
        idx = node_frames[lo:lo + chunk]
        idx = np.concatenate([idx, np.full(chunk - len(idx), idx[-1])])
        at = torch.from_numpy(idx).to(frames.stamp.device)
        scan = pp.PolarScan(
            intensity=frames.intensity[at].to(dev).to(dtype),
            azimuths=frames.azimuths[at].to(dev), ranges=frames.ranges[at].to(dev),
            azimuth_mask=frames.azimuth_mask[at].to(dev))
        filt = pp.filter_scan(scan, cfg.preprocessor, s2b)
        beams.append(filt.beams)
        masks.append(filt.beam_mask)
    beams = torch.cat(beams)[:n_nodes] if beams else torch.zeros(0, 1, 3, device=dev)
    masks = torch.cat(masks)[:n_nodes] if masks else torch.zeros(
        0, 1, dtype=torch.bool, device=dev)

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
