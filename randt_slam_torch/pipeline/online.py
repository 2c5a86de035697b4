"""Online (incremental) SLAM, port of ``randt_slam_tpu/pipeline/online.py``:
the reference's live mode, ROS-free.

``NDTSlam::initializeOnline`` (``ndt_slam.cpp:67-92``) runs the front end on
the subscriber callback plus three timers (loop search, pose-graph
optimization, raytracing) that mutate shared state under mutexes.  Here the
cadences run synchronously between frames, deterministic and lock-free, with
the one feedback path the offline mode lacks: pose-graph results re-anchor
the ACTIVE submap (``LocalFuser::updateSubmaps``), steering later odometry
and edges.

Cadences (defaults match the reference timer frequencies at the 4 Hz radar
rate):
  * loop search every ``loop_every`` frames (0.8 Hz timer, ~5 frames), one
    pending query at a time;
  * pose graph + re-anchoring every ``pgo_every`` frames (0.2 Hz, ~20
    frames), with the reference's ``max_update_index`` gating of loop edges
    (``ndt_slam.cpp:351-360``);
  * raytracing of each keyframe's beams into its submap's counting grid at
    keyframe exit (with ``visualize_ogm``), on the device.

Per frame the host reads everything its graph logic needs (node poses,
stamps, distances and source frames, edge transforms, the odometry pose,
the rejection flag) in ONE device-to-host copy.  The ScanContext database
and the per-node scan cells stay on the device; so does the counting grid
of each submap that can still receive nodes, while a finished submap's
grid moves to host memory, as the JAX package keeps all of them there.
"""

from __future__ import annotations

from time import perf_counter as _pc

import numpy as np
import torch

from .. import runtime, state
from ..config import SlamConfig
from ..geometry import compose, inverse
from ..graph import pose_graph as PG
from ..graph import schur
from ..loops import detector
from ..loops import scancontext as SC
from ..mapping import ogm as OGM
from ..mapping import raytrace as RT
from ..ndt import cells as C
from ..ndt import divergence as D
from ..registration import matcher
from ..registration import solve_graph
from ..utils import checkpoint as CK
from ..utils import profiling
from . import frontend as F
from .slam import ogm_max_steps


class OnlineSlam:
    """Incremental engine: feed frames one at a time, read poses and graph.

    Runs on ``device`` (CUDA unless ``device="cpu"``).  The host tables
    (``node_*``, ``edges``, ``odom_trace``) hold numpy values as the JAX
    package's engine does; ``loop_trace`` records each refined loop
    candidate as ``(query, match, root, refined pose, cs, accepted)``."""

    def __init__(self, cfg: SlamConfig, sensor_to_base=None, initial_pose=None,
                 loop_every: int = 5, pgo_every: int = 20, device=None):
        self.cfg = cfg
        self.device = dev = runtime.resolve_device(device)
        self.s2b = (torch.zeros(3, device=dev) if sensor_to_base is None else
                    torch.as_tensor(np.asarray(sensor_to_base, np.float32)).to(dev))
        self.carry = F.init_carry(cfg, initial_pose=initial_pose, device=dev)
        self.graphs = solve_graph.SolveGraphs()   # the window solves' CUDA graphs
        self.loop_every = loop_every
        self.pgo_every = pgo_every
        # the ScanContext database, padded to max_nodes and written in place
        # at keyframe exit (the reference's incremental kd-tree rebuild,
        # ``Scancontext.cpp:275-287``, becomes one fixed-shape kNN)
        cap = cfg.capacity.max_nodes
        sc = cfg.scan_context
        self._sc_desc = torch.zeros((cap, sc.num_ring, sc.num_sector), device=dev)
        self._sc_key = torch.zeros((cap, sc.num_ring), device=dev)
        self._sc_pos = torch.zeros((cap, 2), device=dev)
        self._sc_trav = torch.zeros((cap,), device=dev)
        self._ids = torch.arange(cap, device=dev)  # one-query batches, no upload
        self._frame_count = 0
        # host-side graph state (the reference's nodes_/edges_ containers)
        self.node_pose: list[np.ndarray] = []
        self.node_stamp: list[float] = []
        self.node_traversed: list[float] = []
        self.node_submap: list[int] = []
        self.node_frame: list[int] = []
        self.node_is_root: list[bool] = []
        self.edges: list[tuple] = []  # (begin, end, trans, sqrtI)
        self.n_loop_edges = 0
        self.loop_trace: list[tuple] = []
        self._pending_loop_queries: list[int] = []
        self._node_cells: dict[int, tuple] = {}
        self._recent_frames: dict[int, F.Frame] = {}
        # per-frame features harvested from each step's output: the keyframe
        # exit (``insertion_delay`` frames later) reuses them instead of
        # running the preprocessor again
        self._recent_feats: dict[int, tuple] = {}
        # per-frame pose-jump rejections (``ndt_matcher.cpp:411-422``)
        self.rejected_trace: list[bool] = []
        self.odom_trace: list[np.ndarray] = []
        # per-submap OGM counting grids, (sh, sw) int32: a tensor on the
        # device while the submap can still receive nodes, a numpy array in
        # host memory once it cannot (``_retire_grids``); a node traced into
        # a grid on the host brings it back and is counted here
        self._count_grids: dict[int, torch.Tensor | np.ndarray] = {}
        self.grid_reuploads = 0
        # per-stage wall clocks
        self.stage_walls: dict[str, list] = {
            "step": [], "record": [], "loops": [], "pgo": []}

    # -- helpers -------------------------------------------------------------

    def _put(self, x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, np.float32)).to(self.device)

    def _node_features(self, frame: F.Frame) -> tuple:
        """A restored frame's features, as the step would have harvested them
        (one preprocessor run: K1 and K2 once)."""
        scan, filt = F.build_scan_cells(self.cfg, frame, self.s2b)
        desc = SC.make_descriptor(filt.polar, filt.points[:, 2], filt.mask,
                                  self.cfg.scan_context)
        return desc, (scan.mean, scan.cov, scan.valid), filt.beams, filt.beam_mask

    def _submap_origin(self, submap_id: int, store_root: np.ndarray) -> np.ndarray:
        """The submap's origin in the CURRENT graph state: its root node's
        pose, or the stored origin while the root has not been emitted."""
        root = int(store_root[min(submap_id, self.cfg.capacity.max_submaps - 1)])
        if root < len(self.node_pose):
            return self.node_pose[root]
        return self.carry.store_origin[submap_id].cpu().numpy()

    @staticmethod
    def _fetch(out: F.FrameOutput, frame: F.Frame) -> dict:
        """Everything the host reads of one step, in one device-to-host copy
        (float64 holds every float32 and int32 value exactly)."""
        parts = [out.nodes.pose.reshape(-1), out.nodes.stamp, out.nodes.traversed,
                 out.nodes.frame_idx, out.edges.trans.reshape(-1), out.odom_pose,
                 frame.index.reshape(1)]
        rejected = out.rejected
        if isinstance(rejected, torch.Tensor):
            parts.append(rejected.reshape(1))
        v = torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()
        f32 = np.float32
        return dict(pose=v[0:6].astype(f32).reshape(2, 3), stamp=v[6:8].astype(f32),
                    traversed=v[8:10].astype(f32), frame_idx=v[10:12].astype(np.int64),
                    trans=v[12:18].astype(f32).reshape(2, 3),
                    odom_pose=v[18:21].astype(f32), index=int(v[21]),
                    rejected=bool(v[22]) if len(v) > 22 else bool(rejected))

    @profiling.span("randt.online_record")
    def _record_outputs(self, out: F.FrameOutput, h: dict):
        nodes, edges = out.nodes, out.edges
        cap = self._sc_desc.shape[0]
        store_root = None
        for k in range(2):
            if not nodes.valid[k]:
                continue
            nid = int(nodes.node_id[k])
            if nid != len(self.node_pose):
                raise RuntimeError(f"node {nid} emitted after {len(self.node_pose)} nodes")
            self.node_pose.append(h["pose"][k])
            self.node_stamp.append(float(h["stamp"][k]))
            self.node_traversed.append(float(h["traversed"][k]))
            self.node_submap.append(int(nodes.submap_id[k]))
            self.node_frame.append(int(h["frame_idx"][k]))
            self.node_is_root.append(bool(nodes.is_root[k]))
            # ScanContext insert (``makeAndSaveScancontextAndKeys``).  Nodes
            # are emitted ``insertion_delay`` frames late: their features come
            # from the harvest, or for frames restored from a checkpoint from
            # one preprocessor run.  The history horizon is sized from the
            # queue capacity, so a miss is a bug and raises.
            src = int(h["frame_idx"][k])
            feats = self._recent_feats.get(src)
            if feats is None:
                if src not in self._recent_frames:
                    raise RuntimeError(
                        f"keyframe node {nid}'s source frame {src} aged out of "
                        f"the {len(self._recent_frames)}-frame history buffer "
                        f"(current frame {h['index']}); horizon sizing bug")
                feats = self._node_features(self._recent_frames[src])
            desc, cells, beams, beam_mask = feats
            if nid < cap:
                self._sc_desc[nid] = desc
                self._sc_key[nid] = SC.ring_key(desc)
                self._sc_pos[nid] = nodes.pose[k, :2]
                self._sc_trav[nid] = nodes.traversed[k]
            self._node_cells[nid] = cells
            if not nodes.is_root[k]:
                self._pending_loop_queries.append(nid)
            # online raytracing cadence: the reference enqueues the node's
            # max-intensity beams at keyframe exit (``local_fuser.cpp:181-188``)
            # and a 20 Hz timer drains them (``ndt_slam.cpp:366-368``); here
            # the drain is synchronous
            if self.cfg.visualize_ogm:
                if store_root is None:
                    store_root = self.carry.store_root.cpu().numpy()
                self._raytrace_node(int(nodes.submap_id[k]), nodes.pose[k], beams,
                                    beam_mask, store_root)
        for k in range(2):
            if edges.valid[k]:
                self.edges.append((int(edges.id_begin[k]), int(edges.id_end[k]),
                                   h["trans"][k], edges.sqrt_information[k]))

    def _raytrace_node(self, submap_id: int, node_pose, beams, beam_mask,
                       store_root):
        """Walk the node's beams into its submap's counting grid from the
        submap-local sensor pose (``HierarchicalMap::raytraceLine``)."""
        o = self.cfg.ogm
        grid = self._count_grids.get(submap_id)
        if grid is None:
            grid = torch.zeros((o.submap_size_y, o.submap_size_x), dtype=torch.int32,
                               device=self.device)
        elif isinstance(grid, np.ndarray):
            self.grid_reuploads += 1
            grid = torch.from_numpy(grid).to(self.device)
        # root and node move together under the pose graph, so their
        # relative pose stays consistent
        origin = self._put(self._submap_origin(submap_id, store_root))
        sensor = compose(compose(inverse(origin), node_pose), self.s2b)
        self._count_grids[submap_id] = RT.raytrace_beams(
            grid, sensor.expand(beams.shape[0], 3), beams, beam_mask, o.resolution,
            max_steps=ogm_max_steps(self.cfg))

    def _retire_grids(self):
        """Move to host memory the counting grids of the submaps the front
        end can no longer emit a node into.  A node record's ``submap_id``
        is the front end's ``n_finished`` at the step that emits it: a
        keyframe exit goes into the submap its scan was queued in, a root
        node into the submap it starts.  The step that finishes submap s
        (its trajectory reaches ``submap_size_poses``) emits s's last
        keyframe exit in slot 0, then starts s + 1 with an empty keyframe
        queue, so the keyframes still queued in s are dropped, never
        emitted.  After that step has been recorded, every submap below
        ``n_finished`` is finished; ``submap_overlap`` only lets the new
        submap register against s, it sends no node there."""
        done = self.carry.n_finished
        for s, grid in self._count_grids.items():
            if s < done and isinstance(grid, torch.Tensor):
                self._count_grids[s] = grid.cpu().numpy()

    def _grid_on_device(self, submap_id: int) -> torch.Tensor:
        grid = self._count_grids[submap_id]
        if isinstance(grid, np.ndarray):
            return torch.from_numpy(grid).to(self.device)
        return grid

    def count_grids(self) -> dict:
        """Every counting grid as a host int32 array, by submap id."""
        return {s: g.cpu().numpy() if isinstance(g, torch.Tensor) else g
                for s, g in sorted(self._count_grids.items())}

    def grid_placement(self) -> dict:
        """How many counting grids, and how many bytes, are on the device
        and in host memory."""
        dev = [g.nbytes for g in self._count_grids.values() if isinstance(g, torch.Tensor)]
        host = [g.nbytes for g in self._count_grids.values() if isinstance(g, np.ndarray)]
        return dict(device=len(dev), device_bytes=sum(dev), host=len(host),
                    host_bytes=sum(host), reuploads=self.grid_reuploads)

    @profiling.span("randt.online_refine")
    def _refine_and_gate(self, sub: int, poses: torch.Tensor, yaw, cells):
        """GNC loop refinement and the CS-divergence gate of one candidate
        (``estimateLoopConstraint`` + ``calculateCSDivergence``) against the
        full store row of its submap; ``poses`` holds the root, match and
        query node poses.  Returns (refined pose, CS, root^-1 * query) as
        one float32 numpy vector of 7."""
        cfg = self.cfg
        root, match, query = poses
        zero = torch.zeros_like(yaw)
        guess = compose(compose(inverse(root), match), torch.stack([zero, zero, -yaw]))
        store = self.carry.store_cells
        stats = C.CellStats(n=store.n[sub], s=store.s[sub], ss=store.ss[sub])
        cc = cfg.ndt_map.cell
        f_mean, f_cov = C.mean_cov(stats, cc.eig_floor_ratio, cc.intensity_var_jitter,
                                   use_pndt=cc.use_pndt)
        f_valid = C.valid_mask(stats, cfg.ndt_map.min_points_per_cell)
        fixed = (f_mean[None], f_cov[None], f_valid[None])
        moving = tuple(x[None] for x in cells)
        est = matcher.estimate_loop(cfg, guess[None], *fixed, *moving)
        mm, mc = matcher.transform_mean_cov(est.pose, moving[0], moving[1])
        cs = D.cs_divergence(*fixed, mm, mc, moving[2])
        rel_odom = compose(inverse(root), query)
        return torch.cat([est.pose[0], cs.reshape(1), rel_odom]).cpu().numpy()

    # -- public API ------------------------------------------------------------

    def process_frame(self, frame: F.Frame) -> np.ndarray:
        """One radar frame (tensors on the engine's device); returns the
        current global pose (/ndt_odom)."""
        t0 = _pc()
        with profiling.span("randt.online_step"):
            self.carry, out = F.frontend_step(self.cfg, self.carry, frame, self.s2b,
                                              with_scan_cells=True, graphs=self.graphs)
            h = self._fetch(out, frame)
        self.stage_walls["step"].append(_pc() - t0)
        t0 = _pc()
        idx = h["index"]
        self._recent_frames[idx] = frame
        self._recent_feats[idx] = (out.sc_desc, out.scan_cells, out.beams,
                                   out.beam_mask)
        horizon = F.node_source_horizon(self.cfg)
        for buf in (self._recent_frames, self._recent_feats):
            for k in [k for k in buf if k < idx - horizon]:
                del buf[k]
        self._record_outputs(out, h)
        self._retire_grids()
        self.odom_trace.append(h["odom_pose"])
        self.rejected_trace.append(h["rejected"])
        self.stage_walls["record"].append(_pc() - t0)
        self._frame_count += 1
        if self._frame_count % self.loop_every == 0:
            t0 = _pc()
            self.detect_loops()
            self.stage_walls["loops"].append(_pc() - t0)
        if self._frame_count % self.pgo_every == 0:
            t0 = _pc()
            self.optimize_pose_graph()
            self.stage_walls["pgo"].append(_pc() - t0)
        return self.odom_trace[-1]

    @profiling.span("randt.online_loops")
    def detect_loops(self):
        """``LocalFuser::detectLoopClosures`` over the pending keyframe
        queue, one query at a time: ScanContext retrieval (one fetch), then
        for a candidate in another submap the refinement and the CS gate
        (one fetch) and the odometry gate."""
        cfg = self.cfg
        lf = cfg.local_fuser
        N = min(len(self.node_pose), self._sc_desc.shape[0])
        if N == 0:
            self._pending_loop_queries.clear()
            return
        store_root = None
        for q in self._pending_loop_queries:
            if q >= N:  # beyond the padded capacity: cannot query
                continue
            cand = SC.detect(self._ids[q:q + 1], self._sc_desc, self._sc_key,
                             self._sc_pos, self._sc_trav, N, cfg.scan_context)
            m = int(cand.match_id[0])
            if m < 0 or self.node_submap[m] == self.node_submap[q]:
                continue
            sub = self.node_submap[m]
            if store_root is None:
                store_root = self.carry.store_root.cpu().numpy()
            root = int(store_root[sub])
            poses = self._put(np.stack([self.node_pose[root], self.node_pose[m],
                                        self.node_pose[q]]))
            v = self._refine_and_gate(sub, poses, cand.yaw_rad[0], self._node_cells[q])
            pose, cs, rel_odom = v[:3], v[3], v[4:]
            span_m = np.asarray([self.node_traversed[q] - self.node_traversed[root]])
            odom_ok = bool(detector.odom_consistency_gate(
                lf, pose[None], rel_odom[None], span_m)[0])
            accepted = odom_ok and float(cs) < lf.loop_closure_max_cs_divergence
            self.loop_trace.append((q, m, root, pose, float(cs), accepted))
            if accepted:
                sqrtI = lf.loop_closure_weight * np.asarray(
                    lf.loop_sqrt_information, np.float32)
                self.edges.append((root, q, pose, sqrtI))
                self.n_loop_edges += 1
        self._pending_loop_queries.clear()

    def finalize(self):
        """Bag-end semantics (``ndt_slam.cpp:176-178``): drain the pending
        loop queue, then one final pose-graph solve over EVERY edge
        (max_update_index = last node) and the re-anchoring."""
        self.detect_loops()
        self.optimize_pose_graph(final=True)

    @profiling.span("randt.online_pgo")
    def optimize_pose_graph(self, final: bool = False):
        """``NDTSlam::optimizePoseGraph`` + ``LocalFuser::updateSubmaps``."""
        cfg = self.cfg
        N = len(self.node_pose)
        if N < 2 or not self.edges or self.n_loop_edges == 0:
            return
        lf = cfg.local_fuser
        n_per = int(np.ceil((lf.submap_size_poses - (cfg.matcher.smoothing_steps - 1))
                            / lf.insertion_step))
        # ``ndt_slam.cpp:354-355``; at the end every edge counts
        max_update = N - 1 if final else (N - 1) // n_per * n_per
        dev = self.device

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dtype).to(dev)

        e = self.edges
        g = PG.PoseGraph(
            poses=put(np.stack(self.node_pose), torch.float32),
            id_begin=put(np.asarray([x[0] for x in e]), torch.long),
            id_end=put(np.asarray([x[1] for x in e]), torch.long),
            trans=put(np.stack([x[2] for x in e]), torch.float32),
            sqrt_information=put(np.stack([x[3] for x in e]), torch.float32),
            valid=torch.ones(len(e), dtype=torch.bool, device=dev))
        # size-routed: dense normal equations while the graph is small, the
        # submap Schur complement beyond 2048 nodes
        poses, _ = schur.optimize_auto(
            g, cfg.global_fuser, node_submap=np.asarray(self.node_submap),
            node_is_root=np.asarray(self.node_is_root), max_update_index=max_update)
        poses = poses.cpu().numpy()
        self.node_pose = list(poses)
        # re-anchor: the ACTIVE submap's origin moves to its root node's
        # optimized pose and the last emitted node is refreshed, steering
        # later odometry and edges (``local_fuser.cpp:65-88``)
        cur = min(self.carry.n_finished, cfg.capacity.max_submaps - 1)
        root = int(self.carry.store_root[cur])
        if root < N:
            self.carry = self.carry._replace(submap_origin=self._put(poses[root]),
                                             last_node_pose=self._put(poses[N - 1]))

    def trajectory(self) -> np.ndarray:
        return np.stack(self.node_pose) if self.node_pose else np.zeros((0, 3))

    @profiling.span("randt.online_ogm")
    def render_ogm(self) -> np.ndarray:
        """Fuse the counting grids at the CURRENT (post-pose-graph) submap
        origins into the global occupancy grid (``MasterMap::getOGM``)."""
        o = self.cfg.ogm
        if not self._count_grids:
            return np.full((o.size_y, o.size_x), 0.5, np.float32)
        subs = sorted(self._count_grids)
        store_root = self.carry.store_root.cpu().numpy()
        origins = self._put(np.stack([self._submap_origin(s, store_root) for s in subs]))
        corner = self._put([-0.5 * o.submap_size_x * o.resolution,
                            -0.5 * o.submap_size_y * o.resolution, 0.0])
        g_corner = self._put([-0.5 * o.size_x * o.resolution,
                              -0.5 * o.size_y * o.resolution, 0.0])
        # one grid on the device at a time beside the live ones
        total = OGM.fuse_submaps(
            (self._grid_on_device(s) for s in subs),
            OGM.compose(origins, corner.expand_as(origins)), o.resolution,
            o.resolution, g_corner, o.size_y, o.size_x)
        return OGM.global_occupancy(total).cpu().numpy()

    # -- checkpoint / resume ---------------------------------------------------
    # The reference has no persistence; long online runs need it.  The carry
    # goes through ``state.carry_to_npz_dict``, the host-side graph,
    # ScanContext and queue state under ``host/``, in the JAX package's keys
    # and dtypes, so a resumed engine reproduces the uninterrupted run
    # bit for bit and either package resumes the other's file.

    def save_checkpoint(self, path: str):
        def stacked(tensors):
            return torch.stack(tensors).cpu().numpy()

        N = len(self.node_pose)
        e = self.edges
        host = {
            "node_pose": (np.stack(self.node_pose) if N
                          else np.zeros((0, 3), np.float32)),
            "node_stamp": np.asarray(self.node_stamp, np.float64),
            "node_traversed": np.asarray(self.node_traversed, np.float64),
            "node_submap": np.asarray(self.node_submap, np.int64),
            "node_frame": np.asarray(self.node_frame, np.int64),
            "node_is_root": np.asarray(self.node_is_root, bool),
            "edge_begin": np.asarray([x[0] for x in e], np.int64),
            "edge_end": np.asarray([x[1] for x in e], np.int64),
            "edge_trans": (np.stack([x[2] for x in e]) if e
                           else np.zeros((0, 3), np.float32)),
            "edge_sqrtI": (np.stack([x[3] for x in e]) if e
                           else np.zeros((0, 3, 3), np.float32)),
            "n_loop_edges": np.int64(self.n_loop_edges),
            "frame_count": np.int64(self._frame_count),
            "pending": np.asarray(self._pending_loop_queries, np.int64),
            "odom_trace": (np.stack(self.odom_trace) if self.odom_trace
                           else np.zeros((0, 3), np.float32)),
            "sc_desc": self._sc_desc[:N].cpu().numpy(),
            "sc_key": self._sc_key[:N].cpu().numpy(),
            "sc_pos": self._sc_pos[:N].cpu().numpy(),
            "sc_trav": self._sc_trav[:N].cpu().numpy(),
        }
        ids = sorted(self._node_cells)
        host["cells_ids"] = np.asarray(ids, np.int64)
        if ids:
            for j, name in enumerate(("cells_mean", "cells_cov", "cells_valid")):
                host[name] = stacked([self._node_cells[i][j] for i in ids])
        grids = self.count_grids()
        host["ogm_ids"] = np.asarray(list(grids), np.int64)
        if grids:
            host["ogm_grids"] = np.stack(list(grids.values()))
        fids = sorted(self._recent_frames)
        host["recent_ids"] = np.asarray(fids, np.int64)
        if fids:
            frames = [self._recent_frames[i] for i in fids]
            for field in F.Frame._fields:
                host[f"recent/{field}"] = stacked([getattr(fr, field) for fr in frames])
        np.savez_compressed(path, **state.carry_to_npz_dict(self.carry, "carry/"),
                            **{f"host/{k}": v for k, v in host.items()})

    def load_checkpoint(self, path: str):
        data = np.load(path)
        self.carry = state.carry_from_npz(data, self.carry, "carry/",
                                          optional=CK.MIGRATED_FIELDS)
        if "carry/submap_fmean" not in data.files:
            # the checkpoint predates the derived-field caches: rebuild them
            # from the loaded submaps (template zeros would degrade the next
            # registrations).  Checkpoints that carry them are trusted as
            # they are: recomputing here would break bit-exact resume.
            from ..ndt import grid as G

            mp = self.cfg.ndt_map.min_points_per_cell
            cc = self.cfg.ndt_map.cell
            sf = G.derive_sparse_fields(self.carry.submap, mp, cc)
            pf = G.derive_sparse_fields(self.carry.prev_submap, mp, cc)
            self.carry = self.carry._replace(
                submap_fmean=sf[0], submap_fcov=sf[1], submap_fvalid=sf[2],
                prev_fmean=pf[0], prev_fcov=pf[1], prev_fvalid=pf[2])
        dev = self.device

        def h(k):
            return data[f"host/{k}"]

        def put(x):
            return torch.from_numpy(np.array(x)).to(dev)

        self.node_pose = list(h("node_pose"))
        self.node_stamp = [float(v) for v in h("node_stamp")]
        self.node_traversed = [float(v) for v in h("node_traversed")]
        self.node_submap = [int(v) for v in h("node_submap")]
        self.node_frame = [int(v) for v in h("node_frame")]
        self.node_is_root = [bool(v) for v in h("node_is_root")]
        self.edges = [(int(b), int(e), t, s) for b, e, t, s in zip(
            h("edge_begin"), h("edge_end"), h("edge_trans"), h("edge_sqrtI"))]
        self.n_loop_edges = int(h("n_loop_edges"))
        self._frame_count = int(h("frame_count"))
        self._pending_loop_queries = [int(v) for v in h("pending")]
        self.odom_trace = list(h("odom_trace"))
        for name, table in (("sc_desc", self._sc_desc), ("sc_key", self._sc_key),
                            ("sc_pos", self._sc_pos), ("sc_trav", self._sc_trav)):
            v = h(name)
            table[:len(v)] = put(v)
        # each stacked array is read (decompressed) once
        ids = [int(v) for v in h("cells_ids")]
        cells = [h(name) for name in ("cells_mean", "cells_cov", "cells_valid")] if ids else []
        self._node_cells = {i: tuple(put(a[j]) for a in cells)
                            for j, i in enumerate(ids)}
        subs = [int(v) for v in h("ogm_ids")]
        grids = h("ogm_grids") if subs else None
        # the grids of finished submaps stay in host memory
        self._count_grids = {s: grids[j] if s < self.carry.n_finished else put(grids[j])
                             for j, s in enumerate(subs)}
        fids = [int(v) for v in h("recent_ids")]
        fields = {f: h(f"recent/{f}") for f in F.Frame._fields} if fids else {}
        self._recent_frames = {
            i: F.Frame(**{f: put(fields[f][j]) for f in F.Frame._fields})
            for j, i in enumerate(fids)}
        # restored frames predate the feature harvest
        self._recent_feats = {}
