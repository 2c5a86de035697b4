"""Loop closure: the port against the JAX package from identical inputs.

* ``grid.allpairs_neighbors`` (the flat-table association), batched over
  candidates here and one candidate per call there: the same neighbors,
  valid flags and sanitized padding, exactly (the selection is a gather).
* ``matcher.estimate_loop`` and ``global_grid_search``, batched here and
  ``jax.vmap``-ped there, on a submap-like cell table and moving cells cut
  from it at known poses.  The refinement runs 10 GNC rounds of up to 25 LM
  iterations; the derivatives are exact on both sides (``jacfwd`` there,
  reverse mode here) and differ in float32 order only, but an LM exit that a
  few ulps of the cost decide can land one step apart (ROADMAP section 3).
  Poses agree within the one-step band of ``test_torch_registration.py``:
  5e-3 m / 1e-4 rad.  The CSM search scores the same candidate grid; its
  best pose agrees within 1e-4 m / 1e-5 rad, its cost within 1e-5.
* The batched solver's per-candidate freeze: a batch whose members exit at
  different LM iterations gives each member bitwise what it gives alone.
* ``detector.detect_loops`` (ScanContext, variant A) and
  ``detect_loops_mahalanobis`` (variant B) on the JAX package's own odometry
  result, carried across by ``state.odometry_from_numpy``, for the
  reference's loop sequence (``tests/test_slam_full.py``: seed 7, 130
  frames, CSM pre-alignment on).  Candidate counts, the per-query stages and
  matches, edge endpoints and accept counts are identical.  The refined
  edges agree within 2e-2 m / 2e-4 rad: the reference is not steadier than
  that against itself -- its own ``jax.vmap(estimate_loop)`` over these 11
  candidates lands up to 1.43e-2 m / 9.1e-5 rad from its detector's result
  for the same candidates padded to a batch of 64 (XLA vectorizes the two
  batch sizes differently, and 10 GNC rounds of LM carry the last-bit
  differences across ulp-decided exits); from identical inputs the port
  lands within 6.2e-3 m / 9.3e-5 rad of the former.  The CS divergences
  agree within 2e-3 relative: the JAX package's float32 sums of ~10^6
  overlaps are off a float64 evaluation of the same gate by up to 6.4e-4 of
  themselves on this sequence, and the edge band moves a divergence by up
  to ~3e-4.  The port's own divergences are held to 1e-4 of a float64
  evaluation of its gate, from its own refined poses and cells.
* Full offline SLAM (``pipeline/slam.run_slam``) on the same sequence,
  against the JAX package's ``run_slam``.  Both sides run odometry,
  ScanContext loop closure and the pose graph from the same frames.
  Free-running odometry differs by ulp-decided LM steps (ROADMAP section
  3), so the loop phase is judged from identical odometry above; here the
  whole run is held to what the reference's own test asks of it, and to
  the reference's result: at least one loop edge, each from a submap root
  to a later query node; the post-PGO node ATE no worse than 1.05 x the
  odometry node ATE, and within 1 cm of the JAX package's post-PGO ATE;
  the submap origins re-anchored on their root nodes' optimized poses; the
  dense pose-graph route with the two-stage DCS schedule, on both sides.

The sequence is rendered once, and the JAX package runs it once: the
detector tests take its odometry and its ScanContext loop result from its
``run_slam``, whose two phases are the very calls they would make
(``test_jax_slam_phases_are_the_detector_tests_calls`` holds the arguments
and the bits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randt_slam_tpu.config import ScanContextConfig as jSCC
from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.io import formats, synthetic
from randt_slam_tpu.loops import detector as jdet
from randt_slam_tpu.ndt import grid as jG
from randt_slam_tpu.pipeline import slam as jS
from randt_slam_tpu.registration import matcher as jM
from randt_slam_torch import state
from randt_slam_torch.config import ScanContextConfig as tSCC
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.loops import detector as tdet
from randt_slam_torch.ndt import grid as tG
from randt_slam_torch.pipeline import slam as tS
from randt_slam_torch.registration import matcher as tM
from randt_slam_torch.registration import solver as tsolver
from tests.torch_threads import one_thread  # noqa: F401

STEP_LIN, STEP_ANG = 5e-3, 1e-4       # one ulp-decided LM step
EDGE_LIN, EDGE_ANG = 2e-2, 2e-4       # the reference's own spread (below)
LIN, ANG = 1e-4, 1e-5                 # no LM decision in between
CS_REL = 2e-3                         # against the JAX package (below)
CS64_REL = 1e-4                       # against a float64 evaluation
ATE_GAP = 1e-2                        # post-PGO node ATE against the JAX package's
SC_KW = dict(num_ring=20, num_sector=60, max_radius=80.0, num_exclude_recent=20,
             num_candidates=5, dist_threshold=0.7, odom_weight=0.05, odom_eps=4.0,
             assumed_drift=0.05, intensity_factor=0.01)


def _loop_cfg(make, scc, **lf):
    cfg = make()
    return dataclasses.replace(
        cfg, scan_context=scc(**SC_KW),
        local_fuser=dataclasses.replace(cfg.local_fuser, csm_prealign_loops=True, **lf),
        matcher=dataclasses.replace(cfg.matcher, csm_window_linear=12.0,
                                    csm_window_angular=0.6, csm_n_iter=3))


def _cells(n, rng, spread=40.0):
    mean = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                           rng.uniform(60, 160, (n, 1))], 1)
    A = rng.normal(0, 0.6, (n, 3, 3)) * np.array([1.0, 1.0, 6.0])[:, None]
    cov = A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(3)
    return mean.astype(np.float32), cov.astype(np.float32)


def _rigid(pose, mean, cov):
    c, s = np.cos(pose[2]), np.sin(pose[2])
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    return ((mean @ R.T) + [pose[0], pose[1], 0.0]).astype(np.float32), \
        (R @ cov @ R.T).astype(np.float32)


@pytest.fixture(scope="module")
def refine_inputs():
    """A 400-cell fixed table and, per candidate, 160 moving cells cut from
    it at a known pose (noise added, some cells invalid); the guesses start
    0.1, 0.6 and 1.5 m / 0.02-0.08 rad off."""
    rng = np.random.default_rng(4)
    f_mean, f_cov = _cells(400, rng)
    f_valid = rng.random(400) < 0.95
    truth = np.array([[2.0, -1.0, 0.3], [-3.0, 2.5, -0.5], [0.5, 0.5, 1.2]])
    off = np.array([[0.1, -0.05, 0.02], [0.6, 0.3, -0.04], [-1.5, 0.9, 0.08]])
    mm, mc, mv = [], [], []
    for p in truth:
        pick = rng.choice(400, 160, replace=False)
        inv = np.array([-(np.cos(p[2]) * p[0] + np.sin(p[2]) * p[1]),
                        np.sin(p[2]) * p[0] - np.cos(p[2]) * p[1], -p[2]])
        m, c = _rigid(inv, f_mean[pick], f_cov[pick])
        mm.append(m + rng.normal(0, 0.05, m.shape).astype(np.float32))
        mc.append(c)
        mv.append(rng.random(160) < 0.9)
    B = len(truth)
    return dict(
        init=(truth + off).astype(np.float32),
        f=(np.broadcast_to(f_mean, (B,) + f_mean.shape).copy(),
           np.broadcast_to(f_cov, (B,) + f_cov.shape).copy(),
           np.broadcast_to(f_valid, (B, 400)).copy()),
        m=(np.stack(mm), np.stack(mc), np.stack(mv)),
        truth=truth)


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("k,metric", [(1, True), (4, True), (4, False), (6, True)])
def test_allpairs_neighbors_matches_jax(refine_inputs, k, metric):
    f, m = refine_inputs["f"], refine_inputs["m"]
    j = jax.vmap(lambda *a: jG.allpairs_neighbors(
        *a, k, 10.5, use_distribution_metric=metric))(
        *(jnp.asarray(x) for x in f + m))
    t = tG.allpairs_neighbors(*_t(f + m), k, 10.5, use_distribution_metric=metric)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert t.valid.any() and not t.valid.all()
    np.testing.assert_array_equal(t.mean.numpy(), np.asarray(j.mean))
    np.testing.assert_array_equal(t.cov.numpy(), np.asarray(j.cov))


def test_estimate_loop_matches_jax(refine_inputs):
    jcfg = _loop_cfg(j_cfg, jSCC)
    tcfg = _loop_cfg(t_cfg, tSCC)
    d = refine_inputs
    j = jax.vmap(lambda *a: jM.estimate_loop(jcfg, *a))(
        jnp.asarray(d["init"]), *(jnp.asarray(x) for x in d["f"] + d["m"]))
    t = tM.estimate_loop(tcfg, torch.from_numpy(d["init"]), *_t(d["f"] + d["m"]))
    jp = np.asarray(j.pose)
    dp = np.abs(t.pose.numpy() - jp)
    assert dp[:, :2].max() <= STEP_LIN and dp[:, 2].max() <= STEP_ANG, dp
    np.testing.assert_array_equal(t.n_pairs.numpy(), np.asarray(j.n_pairs))
    # both land on the cut poses
    assert np.abs(jp - d["truth"])[:, :2].max() < 0.1


def test_global_grid_search_matches_jax(refine_inputs):
    jcfg = _loop_cfg(j_cfg, jSCC)
    tcfg = _loop_cfg(t_cfg, tSCC)
    d = refine_inputs
    jp, jc = jax.vmap(lambda *a: jM.global_grid_search(jcfg, *a))(
        jnp.asarray(d["init"]), *(jnp.asarray(x) for x in d["f"] + d["m"]))
    tp, tc = tM.global_grid_search(tcfg, torch.from_numpy(d["init"]),
                                   *_t(d["f"] + d["m"]))
    dp = np.abs(tp.numpy() - np.asarray(jp))
    assert dp[:, :2].max() <= LIN and dp[:, 2].max() <= ANG, dp
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)


def test_batched_lm_freezes_each_member_alone():
    """Three toy problems that converge at different LM iterations: solved
    as one batch, each member is bitwise what it is alone."""
    targets = torch.tensor([[0.05, -0.02, 0.01], [1.0, 1.5, -1.0], [3.0, -4.0, 2.5]])

    def problem(tg):
        def residual_fn(p):
            r = torch.stack([torch.exp(p[:, 0:1]) - torch.exp(tg[:, 0:1]),
                             p[:, 1:2] - tg[:, 1:2],
                             torch.sin(p[:, 2:3]) - torch.sin(tg[:, 2:3])],
                            dim=-1).reshape(p.shape[0], -1)
            return r, p.new_zeros((p.shape[0], 1))

        def linearize_fn(p, mu):
            with torch.enable_grad():
                pr = p.detach()[:, None, :].expand(-1, 3, 3).clone().requires_grad_(True)
                r = torch.stack([residual_fn(pr[:, c])[0][:, c] for c in range(3)], 1)
                (J,) = torch.autograd.grad(r.sum(), pr)
            r = r.detach()
            return torch.einsum("bni,bnj->bij", J, J), torch.einsum("bn,bni->bi", r, J)
        return residual_fn, linearize_fn

    def solve(idx, iters):
        res, lin = problem(targets[idx])
        B = len(idx)
        p, _ = tsolver.lm_solve(
            res, lin, torch.zeros(B, 3), torch.ones(3, dtype=torch.bool),
            torch.tensor([False, False, True]), torch.ones(B, 3, dtype=torch.bool),
            torch.zeros(1, dtype=torch.bool), torch.ones(B), 1.0, 2.0,
            torch.ones(B), iters, 1e-7, ftol=1e-6)
        return p

    batch = solve([0, 1, 2], 40)
    exits = []
    for i in range(3):
        alone = solve([i], 40)
        assert torch.equal(batch[i], alone[0])
        exits.append(next(n for n in range(1, 41) if torch.equal(solve([i], n), alone)))
    assert len(set(exits)) == 3, exits


# ---- the detector on the reference's loop sequence ------------------------


@pytest.fixture(scope="module")
def loop_seq():
    """The reference's loop sequence, rendered once for the detector and the
    full-SLAM tests."""
    return synthetic.generate(seed=7, n_frames=130, n_azimuths=256, n_bins=256,
                              speed=4.0, dt=0.25, loop=True, n_walls=80)


def _leaves(result):
    """Every field of a result dataclass, as copies of its leaves."""
    return {f.name: [np.array(x) for x in jax.tree.leaves(getattr(result, f.name))]
            for f in dataclasses.fields(result)}


def jax_run_slam(cfg, jframes):
    """The JAX package's ``run_slam``, and each ``run_odometry`` and
    ``detect_loops`` call it made: its arguments and a copy of its result
    taken as it returned."""
    calls = {"odometry": [], "loops": []}

    def recording(phase, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[phase].append((args, kwargs, _leaves(out)))
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jS, "run_odometry", recording("odometry", jS.run_odometry))
        mp.setattr(jdet, "detect_loops", recording("loops", jdet.detect_loops))
        res = jS.run_slam(cfg, jframes)
    return res, calls


def assert_phase_is_the_plain_call(cfg, jframes, res, calls, phase):
    """``run_slam``'s odometry phase was one ``run_odometry(cfg, frames,
    use_scan=True)`` (``phase="odometry"``), or its loop phase one
    ``detect_loops(cfg, odo, frames)`` (``"loops"``), on these frames at
    this configuration, and its result holds what the call returned, bit
    for bit."""
    assert len(calls[phase]) == 1, calls[phase]
    args, kwargs, returned = calls[phase][0]
    assert args[0] == cfg and args[1 + (phase == "loops")] is jframes
    if phase == "odometry":
        assert kwargs == dict(sensor_to_base=None, initial_pose=None, use_scan=True,
                              chunk=0), kwargs
    else:
        assert args[1] is res.odometry and args[3:] == (None,) and not kwargs
    held = _leaves(getattr(res, phase))
    assert held.keys() == returned.keys()
    for k, leaves in returned.items():
        assert len(held[k]) == len(leaves), k
        for a, b in zip(held[k], leaves):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k


@pytest.fixture(scope="module")
def jax_slam(loop_seq):
    """The JAX package's ``run_slam`` on the loop sequence, its frames, and
    the calls of its two phases (``jax_run_slam``)."""
    seq = loop_seq
    jframes = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                    seq.stamps)
    res, calls = jax_run_slam(_loop_cfg(j_cfg, jSCC), jframes)
    return res, jframes, calls


@pytest.mark.parametrize("phase", ["odometry", "loops"])
def test_jax_slam_phases_are_the_detector_tests_calls(jax_slam, phase):
    """The detector tests take the JAX package's odometry and its ScanContext
    loop result from its ``run_slam``: each is what the plain call gives."""
    res, jframes, calls = jax_slam
    assert_phase_is_the_plain_call(_loop_cfg(j_cfg, jSCC), jframes, res, calls, phase)


@pytest.fixture(scope="module")
def loop_run(loop_seq, jax_slam):
    """The JAX package's odometry and ScanContext loop result of the loop
    sequence (its ``run_slam``'s phases, as the test above holds), both
    packages' frames, and the odometry carried across."""
    seq = loop_seq
    res, jframes, _ = jax_slam
    tframes = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                    seq.stamps, device="cpu")
    return (res.odometry, res.loops, jframes, tframes,
            state.odometry_from_numpy(res.odometry, "cpu"))


def _variant_b(make, scc):
    cfg = _loop_cfg(make, scc)
    return dataclasses.replace(cfg, local_fuser=dataclasses.replace(
        cfg.local_fuser, use_scan_context_as_loop_closure=False,
        max_data_association_mahalanobis_dist=8.0))


@pytest.mark.parametrize("variant", ["scancontext", "mahalanobis"])
def test_detect_loops_from_the_jax_odometry(loop_run, variant):
    odo, j_loops, jframes, tframes, t_odo = loop_run
    if variant == "scancontext":
        j = j_loops
        t = tdet.detect_loops(_loop_cfg(t_cfg, tSCC), t_odo, tframes, device="cpu")
        for k in ("query_node", "query_match", "query_stage"):
            np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
        fin = np.isfinite(j.query_sc_dist)
        np.testing.assert_allclose(t.query_sc_dist[fin], j.query_sc_dist[fin],
                                   rtol=0, atol=1e-5)
    else:
        j = jdet.detect_loops_mahalanobis(_variant_b(j_cfg, jSCC), odo, jframes)
        t = tdet.detect_loops_mahalanobis(_variant_b(t_cfg, tSCC), t_odo, tframes,
                                          device="cpu")
    assert j.n_accepted > 0
    for k in ("n_sc_candidates", "n_accepted", "n_odom_gate_rejected"):
        assert getattr(t, k) == getattr(j, k), k
    np.testing.assert_array_equal(t.edge_begin, j.edge_begin)
    np.testing.assert_array_equal(t.edge_end, j.edge_end)
    np.testing.assert_allclose(t.cs_divergences, j.cs_divergences, rtol=CS_REL)
    d = np.abs(t.edge_trans - j.edge_trans)
    assert d[:, :2].max() <= EDGE_LIN and d[:, 2].max() <= EDGE_ANG, d
    np.testing.assert_array_equal(t.edge_sqrt_information, j.edge_sqrt_information)
    if variant == "scancontext":
        np.testing.assert_allclose(t.cs_divergences, _cs_float64(t_odo, tframes, t),
                                   rtol=CS64_REL)


def _cs_float64(odo, frames, res):
    """The port's CS gate in float64 at its own refined poses (every
    candidate was accepted on this sequence, so the edges are the
    candidates)."""
    cfg = _loop_cfg(t_cfg, tSCC)
    dev = torch.device("cpu")
    sub = np.asarray(odo.node_submap)[res.edge_begin]
    fields = [x.double() if x.is_floating_point() else x
              for x in tdet._store_fields(cfg, odo, dev)]
    moving = [x.double() if x.is_floating_point() else x for x in
              tdet._candidate_features(cfg, frames,
                                       np.asarray(odo.node_frame)[res.edge_end],
                                       None, dev)]
    by_sub = tdet._self_terms(*fields, sub)
    s = torch.from_numpy(sub.astype(np.int64))
    cs = tdet._cs_gate(torch.from_numpy(res.edge_trans).double(), fields[0][s],
                       fields[1][s], fields[2][s], *moving,
                       torch.tensor([by_sub[int(x)] for x in sub], dtype=torch.float64))
    return cs.numpy()


# ---- full offline SLAM on the same sequence ----------------------------------


@pytest.fixture(scope="module")
def runs(loop_seq, jax_slam):
    seq = loop_seq
    tframes = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                    seq.stamps, device="cpu")
    tres = tS.run_slam(_loop_cfg(t_cfg, tSCC), tframes, device="cpu")
    return seq, jax_slam[0], tres


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
