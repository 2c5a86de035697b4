"""Pose graph (``graph/pose_graph.py``, ``graph/schur.optimize_auto``): the
port against the JAX package on the same graphs.

The graphs are the JAX package's own test graphs (``tests/test_pose_graph``):
a drifting circle closed by exact loop edges, and a 160-node loop with one
gross outlier loop edge for the robust two-stage schedule.  Both sides run
float32 Gauss-Newton with LM damping on a dense Cholesky solve; the float
order differs (the JAX package's blocked XLA factorization against LAPACK's),
and the solves are well conditioned, so poses agree within 1e-4 (m, rad)
plus 1e-5 of their size (float32 positions of tens of metres round at
~1e-6 of themselves, and the solve amplifies that a few times) and marginal
covariances within 1e-4 relative to their scale.  Where the two-stage
schedule re-weights, the tolerance is 1e-3: the DCS weights depend on the
stage-1 residuals, which carry the stage-1 difference.
"""

import dataclasses

import numpy as np
import pytest
import torch

from randt_slam_tpu.config import GlobalFuserConfig as jGFC
from randt_slam_tpu.graph import pose_graph as jPG
from randt_slam_tpu.graph import schur as jschur
from randt_slam_torch import state
from randt_slam_torch.config import GlobalFuserConfig as tGFC
from randt_slam_torch.graph import pose_graph as tPG
from randt_slam_torch.graph import schur as tschur
from tests.test_pose_graph import _outlier_loop_graph, make_circle_graph
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-4
POSE_REL = 1e-5
TWO_STAGE_TOL = 1e-3
CFGS = {
    "plain": dict(dcs_loop_defense=False),
    "huber": dict(dcs_loop_defense=False, use_robust_loss=True,
                  loss_function_scale=0.5),
    "dcs_loops": dict(dcs_loop_defense=False, use_robust_loss=True,
                      robust_kernel="dcs", robust_loop_edges_only=True,
                      loss_function_scale=1.0),
}


def _port(g):
    return state.pose_graph_from_numpy(
        type(g)(*(np.asarray(x) for x in g)), "cpu")


@pytest.fixture(scope="module")
def circle():
    g, gt, _ = make_circle_graph(np.random.default_rng(5), n=60, drift=0.03,
                                 n_loops=4)
    return g, _port(g)


@pytest.mark.parametrize("name", list(CFGS))
def test_optimize_matches_jax(circle, name):
    jg, tg = circle
    jp, jinfo = jPG.optimize(jg, jGFC(**CFGS[name]))
    tp, tinfo = tPG.optimize(tg, tGFC(**CFGS[name]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=POSE_REL, atol=TOL)
    assert tinfo["iterations"] >= 1
    np.testing.assert_allclose(tinfo["cost"], float(jinfo["cost"]), rtol=1e-3,
                               atol=1e-6)


def test_residuals_and_assembly_match_jax(circle):
    jg, tg = circle
    cfg = CFGS["huber"]
    jH, jgrad, jc = jPG._assemble(jg.poses, jg, jPG.robust_spec(jGFC(**cfg)), 0.5)
    tH, tgrad, tc = tPG._assemble(tg.poses, tg, tPG.robust_spec(tGFC(**cfg)), 0.5)
    scale = np.abs(np.asarray(jH)).max()
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jgrad)).max())
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)


def test_max_update_index_matches_jax(circle):
    jg, tg = circle
    jp, _ = jPG.optimize(jg, jGFC(dcs_loop_defense=False), max_update_index=55)
    tp, _ = tPG.optimize(tg, tGFC(dcs_loop_defense=False), max_update_index=55)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=POSE_REL, atol=TOL)


def test_recover_covariances_matches_jax(circle):
    jg, tg = circle
    jc = np.asarray(jPG.recover_covariances(jg, jg.poses, jGFC()))
    tc = tPG.recover_covariances(tg, tg.poses, tGFC()).numpy()
    assert tc.shape == (60, 3, 3) and np.all(tc[0] == 0)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4 * np.abs(jc).max())


@pytest.mark.parametrize("shipped", [True, False])
def test_optimize_auto_two_stage_matches_jax(shipped):
    """The shipped DCS loop defense, and the opt-in two-stage robust knob,
    on the outlier graph: the same two-stage route and poses."""
    g, _ = _outlier_loop_graph(np.random.default_rng(7), n=160)
    kw = {} if shipped else dict(
        dcs_loop_defense=False, use_robust_loss=True, loss_function_scale=1.0,
        robust_kernel="dcs", robust_loop_edges_only=True, robust_two_stage=True)
    jp, jinfo = jschur.optimize_auto(g, jGFC(**kw))
    tp, tinfo = tschur.optimize_auto(_port(g), tGFC(**kw))
    assert jinfo["two_stage"] and tinfo["two_stage"]
    assert jinfo["solver"] == tinfo["solver"] == "dense"
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=TWO_STAGE_TOL)


def test_optimize_auto_raises_where_the_jax_package_takes_schur(circle):
    """Above the dense limit with submap structure the JAX package routes to
    its Schur complement, and so does the port (it raised here before the
    Schur route was ported; the name is kept): the same route and poses.
    Without submap structure it stays dense on both sides."""
    jg, tg = circle
    n = tg.poses.shape[0]
    node_submap = np.arange(n) // 10
    node_is_root = np.arange(n) % 10 == 0
    kw = dict(node_submap=node_submap, node_is_root=node_is_root,
              dense_node_limit=n - 1)
    tp, tinfo = tschur.optimize_auto(tg, tGFC(), **kw)
    jp, jinfo = jschur.optimize_auto(jg, jGFC(), **kw)
    assert tinfo["solver"] == jinfo["solver"] == "schur"
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=TWO_STAGE_TOL)
    tp, tinfo = tschur.optimize_auto(tg, tGFC(), dense_node_limit=n - 1)
    jp, jinfo = jschur.optimize_auto(jg, jGFC(), dense_node_limit=n - 1)
    assert tinfo["solver"] == jinfo["solver"] == "dense"
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=TWO_STAGE_TOL)


def test_configs_equal():
    for kw in CFGS.values():
        assert dataclasses.asdict(jGFC(**kw)) == dataclasses.asdict(tGFC(**kw))


def test_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    g, _, _ = make_circle_graph(np.random.default_rng(1), n=8, n_loops=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state.pose_graph_from_numpy(type(g)(*(np.asarray(x) for x in g)), None)
