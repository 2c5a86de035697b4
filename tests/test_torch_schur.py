"""Submap Schur-complement pose graph (``graph/schur.py``): the port against
the JAX package on the same graphs.

The graphs are the JAX package's own Schur test graphs
(``tests/test_schur.py::_slam_graph``: noisy circular drives split into
submaps whose roots take the loop edges, including single-node submaps whose
consecutive edges join two roots) and ``bench.py``'s construction at 77
nodes, whose last submap holds two roots.

* ``build_layout`` gives the JAX function's arrays exactly.
* ``optimize_schur`` lands within ``TOL`` = 1e-4 (m, rad) plus 1e-5 of the
  pose's size of the JAX ``optimize_schur(mesh=None)``, the pose-graph
  test's tolerance: both run float32 Gauss-Newton with LM damping through
  the same Schur steps and differ in float order only (batched LAPACK
  against XLA's Cholesky).  It lands within 2e-3 of the port's dense solve,
  the JAX test's band for Schur against dense.
* ``optimize_auto`` routes as the JAX package does (dense at or below the
  node limit, Schur above it with submap structure), filters loop edges by
  ``max_update_index`` on either route, and runs the two-stage DCS schedule
  through the Schur route; there the poses agree within ``TWO_STAGE_TOL``
  (the DCS weights depend on the stage-1 residuals, which carry the stage-1
  difference).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import bench_graph
from randt_slam_tpu.config import GlobalFuserConfig as jGFC
from randt_slam_tpu.graph import pose_graph as jPG
from randt_slam_tpu.graph import schur as jschur
from randt_slam_torch import state
from randt_slam_torch.config import GlobalFuserConfig as tGFC
from randt_slam_torch.graph import pose_graph as tPG
from randt_slam_torch.graph import schur as tschur
from tests.test_schur import _slam_graph
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-4
POSE_REL = 1e-5
DENSE_TOL = 2e-3
TWO_STAGE_TOL = 1e-3

GRAPHS = {
    "slam": {},
    "sharded": dict(n_submaps=8, nodes_per=12, n_loops=6),
    "single_node_submaps": dict(n_submaps=4, nodes_per=1, n_loops=0),
    "many_loops": dict(seed=1, n_submaps=3, nodes_per=25, n_loops=8),
}


def _jax_graph(g):
    return jPG.PoseGraph(*(np.asarray(x) for x in g))


def _graph(name):
    """(JAX graph, port graph on the CPU, node_submap, node_is_root)."""
    if name == "bench_77":
        poses, eb, ee, trans, sqrt_i, node_submap, node_is_root, _ = bench_graph(77)
        jg = jPG.PoseGraph(poses, eb.astype(np.int32), ee.astype(np.int32), trans,
                           sqrt_i, np.ones(len(eb), bool))
    else:
        g, node_submap, node_is_root, _ = _slam_graph(**GRAPHS[name])
        jg = _jax_graph(g)
    return jg, state.pose_graph_from_numpy(jg, "cpu"), node_submap, node_is_root


def _se2_close(a, b, atol, rel=0.0):
    """Pose equality with yaw compared modulo 2 pi (a solve may normalize an
    angle onto the other side of the wrap), within atol + rel |b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = a - b
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    bound = atol + rel * np.abs(b)
    assert np.all(np.abs(d) <= bound), (np.abs(d).max(axis=0), (np.abs(d) / bound).max())


ALL = list(GRAPHS) + ["bench_77"]


@pytest.mark.parametrize("name", ALL)
def test_build_layout_equals_jax(name):
    jg, _, node_submap, node_is_root = _graph(name)
    want = jschur.build_layout(node_submap, node_is_root, jg.id_begin, jg.id_end)
    got = tschur.build_layout(node_submap, node_is_root, jg.id_begin, jg.id_end)
    for f in want._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    if name == "bench_77":  # the last submap's interiors and both its roots
        assert len(got.root_node) == got.n_submaps
        assert (got.int_node[-1] < 0).all() and got.sep_ids[-2].max() == len(got.root_node) - 1
    if name == "single_node_submaps":
        assert len(got.ss_idx) > 0


@pytest.mark.parametrize("name", ALL)
def test_optimize_schur_matches_jax_and_dense(name):
    jg, tg, node_submap, node_is_root = _graph(name)
    jp, jinfo = jschur.optimize_schur(jg, jGFC(), node_submap, node_is_root)
    tp, tinfo = tschur.optimize_schur(tg, tGFC(), node_submap, node_is_root)
    dense, _ = tPG.optimize(tg, tGFC())
    assert tinfo["iterations"] >= 1 and np.isfinite(tinfo["cost"])
    _se2_close(tp.numpy(), np.asarray(jp), TOL, POSE_REL)
    _se2_close(tp.numpy(), dense.numpy(), DENSE_TOL)
    # the gauge: the first root stays where it was
    root0 = int(np.nonzero(node_is_root)[0][0])
    assert np.array_equal(tp[root0].numpy(), tg.poses[root0].numpy())


@pytest.mark.parametrize("max_update_index", [None, 0, 35])
def test_optimize_auto_routes_as_jax(max_update_index):
    """Dense at the default limit, Schur above it, both with loop edges
    filtered by ``max_update_index``; the default configuration runs the
    two-stage DCS schedule on both routes."""
    jg, tg, node_submap, node_is_root = _graph("slam")
    kw = dict(node_submap=node_submap, node_is_root=node_is_root,
              max_update_index=max_update_index)
    for limit, route in ((2048, "dense"), (8, "schur")):
        jp, jinfo = jschur.optimize_auto(jg, jGFC(), dense_node_limit=limit, **kw)
        tp, tinfo = tschur.optimize_auto(tg, tGFC(), dense_node_limit=limit, **kw)
        assert jinfo["solver"] == tinfo["solver"] == route
        assert jinfo["two_stage"] and tinfo["two_stage"]
        _se2_close(tp.numpy(), np.asarray(jp), TWO_STAGE_TOL)
    if max_update_index == 0:  # every loop edge filtered: the odometry chain
        consecutive = jg.id_begin + 1 == jg.id_end
        chain, _ = tPG.optimize(
            tg._replace(valid=tg.valid & torch.from_numpy(consecutive)), tGFC())
        _se2_close(tp.numpy(), chain.numpy(), DENSE_TOL)


def _with_outlier(jg, node_submap, node_is_root):
    """One gross outlier loop edge from the first root to an interior node
    of the third submap: the measured relative pose is off by 8 m and 0.8
    rad."""
    roots = np.nonzero(node_is_root)[0]
    q = int(np.nonzero((node_submap == 2) & ~node_is_root)[0][3])
    return jPG.PoseGraph(
        jg.poses, np.append(jg.id_begin, roots[0]).astype(np.int32),
        np.append(jg.id_end, q).astype(np.int32),
        np.concatenate([jg.trans, [[8.0, -8.0, 0.8]]]).astype(np.float32),
        np.concatenate([jg.sqrt_information, jg.sqrt_information[-1:]]),
        np.append(jg.valid, True))


@pytest.mark.parametrize("shipped", [True, False])
def test_two_stage_schedule_through_schur_matches_jax(shipped):
    """The shipped DCS loop defense, and the opt-in two-stage robust knob
    with DCS on the loop edges only, on a graph with one gross outlier loop
    edge: the Schur route on both sides, the same poses."""
    jg, _, node_submap, node_is_root = _graph("sharded")
    jg = _with_outlier(jg, node_submap, node_is_root)
    tg = state.pose_graph_from_numpy(jg, "cpu")
    kw = {} if shipped else dict(
        dcs_loop_defense=False, use_robust_loss=True, loss_function_scale=1.0,
        robust_kernel="dcs", robust_loop_edges_only=True, robust_two_stage=True)
    route = dict(node_submap=node_submap, node_is_root=node_is_root,
                 dense_node_limit=8)
    jp, jinfo = jschur.optimize_auto(jg, jGFC(**kw), **route)
    tp, tinfo = tschur.optimize_auto(tg, tGFC(**kw), **route)
    assert jinfo["solver"] == tinfo["solver"] == "schur"
    assert jinfo["two_stage"] and tinfo["two_stage"]
    _se2_close(tp.numpy(), np.asarray(jp), TWO_STAGE_TOL)
    # the robust spec reaches the submap blocks in stage 2: without it the
    # outlier edge pulls the poses far from the defended optimum
    plain, _ = tschur.optimize_auto(tg, dataclasses.replace(
        tGFC(**kw), dcs_loop_defense=False, use_robust_loss=False), **route)
    assert np.abs(plain.numpy() - tp.numpy())[:, :2].max() > 10 * TWO_STAGE_TOL


def test_bench_graph_solves_to_ground_truth():
    """``bench.py``'s graph measures exact ground-truth relative poses, so
    its optimum is the ground truth (the first root, node 0, starts there)."""
    poses, eb, ee, trans, sqrt_i, node_submap, node_is_root, gt = bench_graph(77)
    jg = jPG.PoseGraph(poses, eb.astype(np.int32), ee.astype(np.int32), trans,
                       sqrt_i, np.ones(len(eb), bool))
    tp, info = tschur.optimize_auto(state.pose_graph_from_numpy(jg, "cpu"), tGFC(),
                                    node_submap=node_submap,
                                    node_is_root=node_is_root, dense_node_limit=64)
    assert info["solver"] == "schur"
    _se2_close(tp.numpy(), gt, TOL, POSE_REL)
