"""Offline odometry over a whole sequence (phase A of the offline SLAM replay).

Port of the odometry part of ``randt_slam_tpu/pipeline/slam.py``
(``NDTSlam::initializeOffline``, ``ndt_slam.cpp:94-209``): the front-end step
runs over all frames, producing per-frame poses, the pose-graph node/edge
tables and the compacted submap store that loop closure (phase B) and
pose-graph optimization (phase C) consume.  Phases B and C, ``run_slam`` and
``render_ogm`` are not ported yet.

The frames live on the device for the whole run and the step never waits on
it; the outputs are fetched once, after the last frame.
"""

from __future__ import annotations

import dataclasses

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


def _stack_leaf(values) -> np.ndarray:
    """Stack one output field over frames: tensors in one device copy,
    host values as they are."""
    out = [None] * len(values)
    dev = [i for i, v in enumerate(values) if isinstance(v, torch.Tensor)]
    if dev:
        arr = torch.stack([values[i] for i in dev]).cpu().numpy()
        for j, i in enumerate(dev):
            out[i] = arr[j]
    for i, v in enumerate(values):
        if out[i] is None:
            out[i] = np.asarray(v)
    return np.stack(out)


def stack_outputs(outs: list) -> F.FrameOutput:
    """Per-frame outputs -> one FrameOutput of numpy (T, ...) arrays."""
    def field(name, rec=None):
        vals = [getattr(o, name) if rec is None else getattr(getattr(o, rec), name)
                for o in outs]
        return None if vals[0] is None else _stack_leaf(vals)

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
