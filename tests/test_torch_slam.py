"""Full offline SLAM (``pipeline/slam.run_slam``): the port on the CPU
against the JAX package on the reference's loop sequence
(``tests/test_slam_full.py``: seed 7, 130 frames on 1.25 laps, CSM
pre-alignment of the loop candidates).

Both sides run odometry, ScanContext loop closure and the pose graph from
the same frames.  Free-running odometry differs by ulp-decided LM steps
(ROADMAP section 3), so the loop phase is judged from identical odometry in
``test_torch_loops.py``; here the whole run is held to what the reference's
own test asks of it, and to the reference's result:

* at least one loop edge, each from a submap root to a later query node;
* the post-PGO node ATE no worse than 1.05 x the odometry node ATE, and
  within 1 cm of the JAX package's post-PGO ATE;
* the submap origins re-anchored on their root nodes' optimized poses;
* the dense pose-graph route with the two-stage DCS schedule, on both sides.
"""

import numpy as np
import pytest

from randt_slam_tpu.config import ScanContextConfig as jSCC
from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.io import formats, synthetic
from randt_slam_tpu.pipeline import slam as jS
from randt_slam_torch.config import ScanContextConfig as tSCC
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.pipeline import slam as tS
from tests.test_torch_loops import _loop_cfg, one_thread  # noqa: F401

ATE_GAP = 1e-2


@pytest.fixture(scope="module")
def runs():
    seq = synthetic.generate(seed=7, n_frames=130, n_azimuths=256, n_bins=256,
                             speed=4.0, dt=0.25, loop=True, n_walls=80)
    jres = jS.run_slam(_loop_cfg(j_cfg, jSCC),
                       jS.frames_from_arrays(seq.intensity, seq.azimuths,
                                             seq.ranges, seq.stamps))
    tframes = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                    seq.stamps, device="cpu")
    tres = tS.run_slam(_loop_cfg(t_cfg, tSCC), tframes, device="cpu")
    return seq, jres, tres


def _ates(seq, res):
    gt = seq.gt_poses[res.node_frame]
    return (formats.ate(res.odometry.node_pose, gt, align=True),
            formats.ate(res.node_pose_optimized, gt, align=True))


def test_port_closes_loops(runs):
    seq, jres, tres = runs
    loops = tres.loops
    assert loops.n_sc_candidates > 0 and loops.n_accepted > 0
    assert np.all(loops.edge_begin < loops.edge_end)
    assert set(loops.edge_begin) <= set(tres.odometry.submap_root.tolist())
    assert jres.loops.n_accepted > 0
    for k in ("features_s", "retrieval_s", "cand_features_s", "refine_gate_s"):
        assert loops.timings[k] >= 0.0, k
    assert all(tres.timings[k] >= 0.0 for k in ("odometry_s", "loop_closure_s",
                                                "pgo_s"))


def test_pgo_ate_against_odometry_and_reference(runs):
    seq, jres, tres = runs
    t_before, t_after = _ates(seq, tres)
    _, j_after = _ates(seq, jres)
    assert np.all(np.isfinite(tres.node_pose_optimized))
    assert t_after <= 1.05 * t_before, (t_before, t_after)
    assert abs(t_after - j_after) <= ATE_GAP, (t_after, j_after)


def test_submaps_reanchored(runs):
    _, _, tres = runs
    odo = tres.odometry
    n = odo.n_submaps
    np.testing.assert_array_equal(tres.submap_origin_optimized[:n],
                                  tres.node_pose_optimized[odo.submap_root[:n]])
    np.testing.assert_array_equal(tres.submap_origin_optimized[n:],
                                  odo.submap_origin[n:])


def test_pose_graph_route(runs):
    _, jres, tres = runs
    assert tres.timings["pgo_solver"] == jres.timings["pgo_solver"] == "dense"
    assert tres.timings["pgo_two_stage"]
    assert tres.pgo_iterations >= 1


def test_variant_b_with_recovered_covariances(runs):
    """``run_slam``'s position-association branch from the port's odometry:
    node covariances recovered from the odometry-only graph, then
    ``detect_loops_mahalanobis`` closes loops from a submap root to a later
    query node (the JAX package's variant-B test, with the covariances its
    ``run_slam`` passes)."""
    from randt_slam_torch.graph import pose_graph as tPG
    from randt_slam_torch.loops import detector as tdet

    seq, _, tres = runs
    odo = tres.odometry
    cfg = _loop_cfg(t_cfg, tSCC, use_scan_context_as_loop_closure=False,
                    max_data_association_mahalanobis_dist=8.0)
    g0 = tS.build_pose_graph(odo, None, "cpu")
    node_cov = tPG.recover_covariances(g0, g0.poses, cfg.global_fuser).numpy()
    assert node_cov.shape == (len(odo.node_id), 3, 3) and np.all(node_cov[0] == 0)
    frames = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                   seq.stamps, device="cpu")
    loops = tdet.detect_loops_mahalanobis(cfg, odo, frames, node_cov=node_cov,
                                          device="cpu")
    assert loops.n_sc_candidates > 0 and loops.n_accepted > 0
    assert np.all(loops.edge_begin < loops.edge_end)
