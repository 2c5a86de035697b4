"""Size routing of the pose-graph solve.

Port of ``optimize_auto`` from ``randt_slam_tpu/graph/schur.py`` (:708-771),
the counterpart of the reference handing every solve to Ceres'
``SPARSE_NORMAL_CHOLESKY`` + ``SCHUR_JACOBI`` (``global_fuser.cpp:52-59``):

* graphs of at most ``dense_node_limit`` nodes take the dense normal
  equations (:func:`pose_graph.optimize`);
* larger graphs with submap structure take the submap Schur complement.
  That path (``build_layout``, ``optimize_schur``) is not ported yet
  (ROADMAP, modules to port: the Schur complement); until it is, such a
  graph raises ``NotImplementedError`` instead of being solved densely.

The shipped DCS loop defense runs as a two-stage schedule: plain least
squares to convergence, then DCS on the loop edges only, from that optimum.
"""

from __future__ import annotations

import dataclasses

from ..config import GlobalFuserConfig
from . import pose_graph as PG


def optimize_auto(g: PG.PoseGraph, cfg: GlobalFuserConfig, node_submap=None,
                  node_is_root=None, max_update_index=None,
                  dense_node_limit: int = 2048):
    """Route the pose-graph solve by size; returns ``(poses, info)`` with
    ``info["solver"]`` the path taken and ``info["two_stage"]`` set when the
    two-stage robust schedule ran."""
    N = g.poses.shape[0]
    g = PG._filter_loops(g, max_update_index)
    if N > dense_node_limit and node_submap is not None and node_is_root is not None:
        raise NotImplementedError(
            f"pose graph of {N} nodes (> {dense_node_limit}) with submap "
            "structure: the JAX package solves it by the submap Schur "
            "complement, which this port does not have yet (ROADMAP: the "
            "Schur complement, graph/schur.py build_layout/optimize_schur)")

    def solve(graph, c):
        poses, info = PG.optimize(graph, c)
        info["solver"] = "dense"
        return poses, info

    if not PG.robust_two_stage(cfg):
        return solve(g, cfg)
    # Stage 1: plain least squares.  Stage 2: robust IRLS from that optimum,
    # where an inconsistent loop edge's residual concentrates on itself.
    pre = dataclasses.replace(cfg, use_robust_loss=False, dcs_loop_defense=False)
    poses1, _ = solve(g, pre)
    if cfg.dcs_loop_defense:
        stage2 = dataclasses.replace(
            cfg, dcs_loop_defense=False, use_robust_loss=True,
            robust_kernel="dcs", robust_loop_edges_only=True,
            loss_function_scale=cfg.dcs_scale)
    else:
        stage2 = cfg
    poses, info = solve(g._replace(poses=poses1), stage2)
    info["two_stage"] = True
    return poses, info
