"""Online mode (``pipeline/online.OnlineSlam``), its checkpoints and its CLI:
the port against the JAX package's ``OnlineSlam``.

* The tiny configuration of ``__graft_entry__._tiny_cfg``, built from the
  port's own classes, equals the JAX one field by field.
* Early database (``tests/test_online_cli.py``'s sequence: seed 5, 16
  frames, ``loop_every=2`` while the ScanContext database is shorter than
  ``num_candidates``): the free-running node and edge tables equal the JAX
  engine's.  Free-running poses are not a parity target on this sequence:
  the JAX package itself moves by up to 0.58 m when its azimuths move by one
  float32 ulp (64 azimuths, 3 m cells: a flat window cost), and the port's
  ``run_odometry`` lands as far from it.  What the online engine adds to
  odometry is held exactly instead: its odometry trace is bitwise the port's
  own ``run_odometry`` of the same frames (no loop edge, so no
  re-anchoring), whose parity with the reference
  ``tests/test_torch_odometry.py`` holds on a sequence where the reference
  is steady.
* Resume: the port resumes its own checkpoint bitwise (``atol=0`` on the
  trajectory, the odometry trace, the edges and the counting grids).
* A JAX checkpoint in the port, on the CPU loop tests' sequence (seed 7, 130
  frames, ``test_torch_loops``'s loop parameters, default cadences).  The
  JAX engine runs 114 frames and saves: it then holds 2 loop edges and two
  pending queries (after 119 frames the queue is empty).  From identical
  state, one ``detect_loops()`` + ``optimize_pose_graph()`` on both: the
  same refined candidates and accepted edges; CS within 1e-4 relative
  (measured 2.7e-5); refined edges within ``test_torch_loops``' one
  ulp-decided LM step, 5e-3 m / 1e-4 rad (measured 7.2e-4 m / 8.8e-6 rad);
  poses after the tick within 1e-4 m (measured 1.9e-6 m).  Both packages'
  float32 gates sit 1.5e-4-2.0e-4 off a float64 evaluation here, so the
  port's own CS is held to its float64 evaluation within ``test_torch_loops``'
  float32 band, 2e-3.  Then both run frames 114-129 and ``finalize``:
  identical tables, post-PGO node ATE within 1 cm.  The sequence is
  rendered with ``synthetic.render_scan_fast`` (the same world and drive,
  40 s less); its cadences accept the loop edges the slow rendering's do.
* The port's checkpoint in the JAX package: it loads in the JAX
  ``OnlineSlam.load_checkpoint`` and the JAX run resumed from it gives the
  port's tables; an offline carry saved by the port's CLI loads through
  both packages' ``load_carry``.
* Online OGM: replayed from the JAX engine's own raytrace calls (its node
  poses, beams and store state at each call), the port's counting grids
  equal the JAX engine's exactly; ``render_ogm`` from identical grids and
  (perturbed) node poses agrees within 1e-5 except on cells
  ``test_torch_ogm._boundary_cells`` proves to be within float32 rounding of
  a cell boundary.  The port's own online grids hold hits and free space.
* Schur routing (the JAX test's injected 2100-node graph): the Schur route
  is taken; both packages stop at the 100-iteration cap a few millimetres
  from the optimum along the slow directions of this long chain, so their
  poses agree within ``chip_smoke.SCHUR_BAND``, the repo's band for Schur
  solves at the cap against another solve of the same graph (measured:
  7.3e-3 m, 1.2e-4 rad), and both pull the noisy chain toward the ground
  truth.
* CLI: ``--online --checkpoint --checkpoint-every --resume`` writes the
  checkpoints and resumes to the uninterrupted run's trajectory;
  ``--online --viz-every --ogm`` writes ``live/``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from chip_smoke import SCHUR_BAND
from randt_slam_tpu.config import ScanContextConfig as jSCC
from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.io import formats, synthetic
from randt_slam_tpu.pipeline import frontend as jF
from randt_slam_tpu.pipeline import slam as jS
from randt_slam_tpu.pipeline.online import OnlineSlam as JOnline
from randt_slam_tpu.utils import checkpoint as jCK
from randt_slam_torch import run as trun
from randt_slam_torch import state
from randt_slam_torch.config import ScanContextConfig as tSCC
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.ndt import cells as tC
from randt_slam_torch.ndt import divergence as tD
from randt_slam_torch.pipeline import frontend as tF
from randt_slam_torch.pipeline import slam as tS
from randt_slam_torch.pipeline.online import OnlineSlam as TOnline
from randt_slam_torch.registration import matcher as tM
from randt_slam_torch.utils import checkpoint as tCK
from tests.test_torch_kernels_cuda import tiny_config
from tests.test_torch_loops import CS_REL, STEP_ANG, STEP_LIN, _loop_cfg
from tests.test_torch_ogm import OCC_TOL, _boundary_cells
from tests.torch_threads import one_thread  # noqa: F401

CS_ONE = 1e-4          # CS of one candidate against the JAX engine's
PGO_LIN = 1e-4         # poses after one pose-graph tick from identical state
ATE_GAP = 1e-2         # post-PGO node ATE after the free run to the end
SAVED_AT = 114


def _jframe(frames, t):
    return jax.tree.map(lambda x: x[t], frames)


def _tframe(frames, t):
    return tF.Frame(*(x[t] for x in frames))


def _tables(eng):
    return (eng.node_submap, eng.node_frame, eng.node_is_root,
            [(e[0], e[1]) for e in eng.edges], eng.n_loop_edges)


def _tiny_seq(seed=5, n=16):
    seq = synthetic.generate(seed=seed, n_frames=n, n_azimuths=64, n_bins=128,
                             max_range=40.0, speed=3.0, dt=0.25, n_walls=40)
    return (seq, jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                       seq.stamps),
            tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                  seq.stamps, device="cpu"))


@pytest.fixture(scope="module")
def tiny():
    return _tiny_seq()


def test_tiny_config_equals_jax():
    assert dataclasses.asdict(tiny_config()) == dataclasses.asdict(_tiny_cfg())


# ---- early database ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_runs(tiny):
    """Both engines over the 16 frames, raytracing on, loop search every 2
    frames; the JAX engine's raytrace calls recorded with the node poses,
    beams and store state each one saw."""
    _, jframes, tframes = tiny
    j = JOnline(dataclasses.replace(_tiny_cfg(), visualize_ogm=True),
                loop_every=2, pgo_every=6)
    t = TOnline(tiny_config(visualize_ogm=True), loop_every=2, pgo_every=6,
                device="cpu")
    calls = []
    trace = j._raytrace_node

    def spy(submap_id, node_pose, beams, beam_mask):
        calls.append((submap_id, np.array(node_pose), np.array(beams),
                      np.array(beam_mask), np.array(j.carry.store_root),
                      np.array(j.carry.store_origin), list(j.node_pose)))
        trace(submap_id, node_pose, beams, beam_mask)

    j._raytrace_node = spy
    poses = []
    for i in range(16):
        j.process_frame(_jframe(jframes, i))
        poses.append(t.process_frame(_tframe(tframes, i)))
    return dict(j=j, t=t, calls=calls, poses=poses)


def test_online_mode_runs_and_detects_early(tiny, tiny_runs):
    j, t = tiny_runs["j"], tiny_runs["t"]
    assert np.all(np.isfinite(tiny_runs["poses"]))
    assert len(t.node_pose) >= 3 and len(t.stage_walls["loops"]) == 8
    assert _tables(t) == _tables(j)
    traj = t.trajectory()
    assert traj.shape == (len(t.node_pose), 3) and np.all(np.isfinite(traj))
    assert np.linalg.norm(t.odom_trace[-1][:2]) > 1.0
    # no loop edge on this sequence: the online odometry is the offline one
    assert t.n_loop_edges == 0
    odo = tS.run_odometry(tiny_config(), tiny[2], device="cpu")
    np.testing.assert_array_equal(np.stack(t.odom_trace), odo.odom_poses)
    np.testing.assert_array_equal(traj, odo.node_pose)


# ---- resume -------------------------------------------------------------------


def _grids(eng):
    return eng.count_grids()


def test_online_checkpoint_resume_is_bitwise(tmp_path, tiny):
    seq, _, frames = tiny
    cfg = tiny_config(visualize_ogm=True)
    ref = TOnline(cfg, loop_every=3, pgo_every=7, device="cpu")
    for t in range(16):
        ref.process_frame(_tframe(frames, t))
    a = TOnline(cfg, loop_every=3, pgo_every=7, device="cpu")
    for t in range(8):
        a.process_frame(_tframe(frames, t))
    ck = str(tmp_path / "ck.npz")
    a.save_checkpoint(ck)
    b = TOnline(cfg, loop_every=3, pgo_every=7, device="cpu")
    b.load_checkpoint(ck)
    assert b._frame_count == 8
    for t in range(8, 16):
        b.process_frame(_tframe(frames, t))
    np.testing.assert_allclose(np.stack(b.odom_trace), np.stack(ref.odom_trace),
                               rtol=0, atol=0)
    np.testing.assert_allclose(b.trajectory(), ref.trajectory(), rtol=0, atol=0)
    assert _tables(b) == _tables(ref)
    for x, y in zip(b.edges, ref.edges):
        np.testing.assert_array_equal(x[2], y[2])
        np.testing.assert_array_equal(x[3], y[3])
    gb, gr = _grids(b), _grids(ref)
    assert gb.keys() == gr.keys() and len(gr) > 0
    for s in gr:
        np.testing.assert_array_equal(gb[s], gr[s])


def test_carry_npz_round_trip_is_bitwise(tiny):
    _, _, frames = tiny
    cfg = tiny_config()
    eng = TOnline(cfg, device="cpu")
    for t in range(7):
        eng.process_frame(_tframe(frames, t))
    flat = state.carry_to_npz_dict(eng.carry, "carry/")
    back = state.carry_from_npz(flat, tF.init_carry(cfg, device="cpu"), "carry/")
    assert flat.keys() == state.carry_to_npz_dict(back, "carry/").keys()
    for k, v in state.carry_to_npz_dict(back, "carry/").items():
        assert v.dtype == flat[k].dtype and np.array_equal(v, flat[k]), k
    for name in tF.HOST_FIELDS:
        assert type(getattr(back, name)) is type(getattr(eng.carry, name))
        assert getattr(back, name) == getattr(eng.carry, name)
    del flat["carry/submap_fmean"]
    state.carry_from_npz(flat, back, "carry/", optional={"submap_fmean"})
    del flat["carry/store_root"]
    with pytest.raises(KeyError):
        state.carry_from_npz(flat, back, "carry/", optional={"submap_fmean"})


def test_carry_dtypes_and_keys_equal_jax():
    """The port's checkpoint keys and dtypes are the JAX package's."""
    jflat = jCK._flatten(jF.init_carry(_tiny_cfg()))
    tflat = tCK._flatten(tF.init_carry(tiny_config(), device="cpu"))
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert (tflat[k].dtype, tflat[k].shape) == (jflat[k].dtype, jflat[k].shape), k


# ---- the JAX package's checkpoint in the port, and back -------------------------


def _cs_float64(eng, sub, pose, cells):
    """The port's CS gate in float64 at a refined pose, from the engine's
    store row and a node's cells."""
    cfg = eng.cfg
    cc = cfg.ndt_map.cell
    st = eng.carry.store_cells
    stats = tC.CellStats(st.n[sub].double(), st.s[sub].double(), st.ss[sub].double())
    f_mean, f_cov = tC.mean_cov(stats, cc.eig_floor_ratio, cc.intensity_var_jitter,
                                use_pndt=cc.use_pndt)
    f_valid = tC.valid_mask(stats, cfg.ndt_map.min_points_per_cell)
    m_mean, m_cov, m_valid = (x[None].double() if x.is_floating_point() else x[None]
                              for x in cells)
    mm, mc = tM.transform_mean_cov(torch.from_numpy(pose).double()[None], m_mean, m_cov)
    return float(tD.cs_divergence(f_mean[None], f_cov[None], f_valid[None], mm, mc,
                                  m_valid)[0])


@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    """The JAX engine's run to ``SAVED_AT`` frames on the loop sequence, its
    checkpoint in a port engine, one cadence on both with the JAX engine's
    retrievals and refinements recorded, then both to the end; and the
    port's checkpoint after the cadence resumed in a fresh JAX engine."""
    d = tmp_path_factory.mktemp("online")
    with pytest.MonkeyPatch.context() as mp:
        # the vectorised renderer: the same world and drive, rendered in a
        # second instead of 40 s (it draws its speckle in another order)
        mp.setattr(synthetic, "render_scan", synthetic.render_scan_fast)
        seq = synthetic.generate(seed=7, n_frames=130, n_azimuths=256, n_bins=256,
                                 speed=4.0, dt=0.25, loop=True, n_walls=80)
    jframes = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                    seq.stamps)
    tframes = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                    seq.stamps, device="cpu")
    jcfg, tcfg = _loop_cfg(j_cfg, jSCC), _loop_cfg(t_cfg, tSCC)
    j = JOnline(jcfg)
    for i in range(SAVED_AT):
        j.process_frame(_jframe(jframes, i))
    j_ck = str(d / "jax.npz")
    j.save_checkpoint(j_ck)
    t = TOnline(tcfg, device="cpu")
    t.load_checkpoint(j_ck)
    before = dict(loops=j.n_loop_edges, pending=list(j._pending_loop_queries),
                  origin=np.asarray(j.carry.submap_origin))

    seen = {"detect": [], "refine": []}
    detect, refine = j._detect, j._refine

    def spy_detect(q, *a):
        cand = detect(q, *a)
        seen["detect"].append((int(q), int(cand.match_id)))
        return cand

    def spy_refine(*a):
        out = refine(*a)
        seen["refine"].append(tuple(np.asarray(x) for x in out))
        return out

    j._detect, j._refine = spy_detect, spy_refine
    n_edges = len(j.edges)
    j.detect_loops()
    j.optimize_pose_graph()
    j._detect, j._refine = detect, refine
    t.detect_loops()
    t_cs64 = [_cs_float64(t, t.node_submap[m], pose, t._node_cells[q])
              for q, m, _, pose, _, _ in t.loop_trace]
    t.optimize_pose_graph()
    cadence = dict(t_cs64=t_cs64, j_edges=list(j.edges[n_edges:]), t_edges=list(t.edges[n_edges:]),
                   j_pose=j.trajectory(), t_pose=t.trajectory(),
                   t_origin=t.carry.submap_origin.numpy().copy())
    t_ck = str(d / "port.npz")
    t.save_checkpoint(t_ck)
    for i in range(SAVED_AT, 130):
        j.process_frame(_jframe(jframes, i))
        t.process_frame(_tframe(tframes, i))
    j.finalize()
    t.finalize()
    j2 = JOnline(jcfg)
    # the same jitted functions (same configuration), compiled once
    j2._step, j2._features, j2._refine, j2._detect = (
        j._step, j._features, j._refine, j._detect)
    j2.load_checkpoint(t_ck)
    for i in range(SAVED_AT, 130):
        j2.process_frame(_jframe(jframes, i))
    j2.finalize()
    return dict(seq=seq, j=j, t=t, j2=j2, seen=seen, before=before, **cadence)


def test_jax_checkpoint_holds_pending_queries(loop_run):
    b = loop_run["before"]
    assert b["loops"] == 2 and len(b["pending"]) == 2


def test_one_cadence_from_a_jax_checkpoint(loop_run):
    r = loop_run
    j, t = r["j"], r["t"]
    node_submap = j.node_submap
    refined = [(q, m) for q, m in r["seen"]["detect"]
               if m >= 0 and node_submap[m] != node_submap[q]]
    assert len(refined) == 2
    assert [x[:2] for x in t.loop_trace[:len(refined)]] == refined
    j_cs = np.asarray([float(x[1]) for x in r["seen"]["refine"]])
    t_cs = np.asarray([x[4] for x in t.loop_trace[:len(refined)]])
    cs_rel = np.abs(t_cs / j_cs - 1)
    je, te = r["j_edges"], r["t_edges"]
    assert [(e[0], e[1]) for e in te] == [(e[0], e[1]) for e in je] and je
    de = np.abs(np.stack([e[2] for e in te]) - np.stack([e[2] for e in je]))
    dp = np.abs(r["t_pose"] - r["j_pose"])
    print(f"one cadence from the JAX checkpoint: CS within {cs_rel.max():.2e} "
          f"relative, edges within {de[:, :2].max():.2e} m / {de[:, 2].max():.2e} "
          f"rad, poses within {dp[:, :2].max():.2e} m / {dp[:, 2].max():.2e} rad")
    assert cs_rel.max() <= CS_ONE
    # the port's gate against its own float64 evaluation: the float32 sums'
    # band of test_torch_loops (the JAX package's gate is as far off)
    np.testing.assert_allclose(t_cs, r["t_cs64"][:len(refined)], rtol=CS_REL)
    assert de[:, :2].max() <= STEP_LIN and de[:, 2].max() <= STEP_ANG
    assert dp[:, :2].max() <= PGO_LIN
    # the tick moved the active submap's origin (re-anchoring)
    assert not np.array_equal(r["t_origin"], r["before"]["origin"])


def test_jax_checkpoint_runs_to_the_end_in_the_port(loop_run):
    r = loop_run
    j, t, gt = r["j"], r["t"], r["seq"].gt_poses
    assert _tables(t) == _tables(j) and t.n_loop_edges > r["before"]["loops"]
    ate_j = formats.ate(j.trajectory(), gt[j.node_frame])
    ate_t = formats.ate(t.trajectory(), gt[t.node_frame])
    print(f"to the end: node ATE port {ate_t:.5f} m, JAX {ate_j:.5f} m")
    assert abs(ate_t - ate_j) <= ATE_GAP


def test_port_checkpoint_resumes_in_jax(loop_run):
    r = loop_run
    assert r["j2"]._frame_count == 130
    assert _tables(r["j2"]) == _tables(r["t"])


# ---- online OGM ---------------------------------------------------------------


def test_online_ogm_equals_jax_from_identical_inputs(tiny_runs):
    j, calls = tiny_runs["j"], tiny_runs["calls"]
    jcfg = j.cfg
    assert len(calls) == len(j.node_pose) and len(j._count_grids) >= 2

    t = TOnline(tiny_config(visualize_ogm=True), device="cpu")
    for s, pose, beams, mask, root, origin, poses in calls:
        t.node_pose = poses
        t.carry = t.carry._replace(store_root=torch.from_numpy(root),
                                   store_origin=torch.from_numpy(origin))
        t._raytrace_node(s, torch.from_numpy(pose), torch.from_numpy(beams),
                         torch.from_numpy(mask), root)
    grids = _grids(t)
    assert grids.keys() == j._count_grids.keys()
    for s, g in grids.items():
        np.testing.assert_array_equal(g, j._count_grids[s])

    # render from identical state at moved (post-pose-graph-like) poses
    rng = np.random.default_rng(0)
    moved = [p + rng.normal(0, [0.4, 0.4, 0.05]).astype(np.float32)
             for p in j.node_pose]
    kept = j.node_pose
    j.node_pose, t.node_pose = list(moved), list(moved)
    try:
        want = j.render_ogm()
    finally:
        j.node_pose = kept
    got = t.render_ogm()
    o = jcfg.ogm
    subs = sorted(grids)
    roots = np.asarray(j.carry.store_root)
    origins = np.stack([moved[roots[min(s, jcfg.capacity.max_submaps - 1)]]
                        for s in subs]).astype(np.float64)
    corner = np.array([-0.5 * o.submap_size_x * o.resolution,
                       -0.5 * o.submap_size_y * o.resolution])
    c, sn = np.cos(origins[:, 2]), np.sin(origins[:, 2])
    sub_corners = np.stack([origins[:, 0] + c * corner[0] - sn * corner[1],
                            origins[:, 1] + sn * corner[0] + c * corner[1],
                            origins[:, 2]], 1)
    g_corner = [-0.5 * o.size_x * o.resolution, -0.5 * o.size_y * o.resolution, 0.0]
    near = _boundary_cells(np.stack([grids[s] for s in subs]), sub_corners, g_corner,
                           o.resolution, o.size_y, o.size_x)
    off = np.abs(got - want) > OCC_TOL
    print(f"online render_ogm: {off.sum()} cells beyond {OCC_TOL}, all within the "
          f"{near.sum()} boundary cells")
    assert not (off & ~near).any()
    assert (got > 50).any() and ((got >= 0) & (got < 50)).any()


def test_online_ogm_cadence_holds_hits_and_free_space(tiny_runs):
    eng = tiny_runs["t"]
    cfg = eng.cfg
    assert eng._count_grids
    g = next(iter(eng._count_grids.values()))
    assert (g > 0).any() and (g < 0).any()
    ogm = eng.render_ogm()
    o = cfg.ogm
    assert ogm.shape == (o.size_y, o.size_x) and np.isfinite(ogm).all()
    assert (ogm > 50).any() and ((ogm >= 0) & (ogm < 50)).any()


# ---- the pose graph beyond the dense route's size --------------------------------


def _inject(eng):
    """The JAX test's graph: a noisy two-lap circle of 2100 nodes in submaps
    of 10, odometry edges and a few root-to-node loop edges, all exact."""
    rng = np.random.default_rng(3)
    N, per = 2100, 10
    t = np.linspace(0, 4 * np.pi, N)
    gt = np.stack([40 * np.cos(t), 40 * np.sin(t), t + np.pi / 2], 1)
    noisy = gt + np.concatenate(
        [np.zeros((1, 3)), np.cumsum(rng.normal(0, 0.01, (N - 1, 3)), 0)])
    eng.node_pose = [p.astype(np.float32) for p in noisy]
    eng.node_submap = (np.arange(N) // per).tolist()
    eng.node_is_root = (np.arange(N) % per == 0).tolist()

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b - a
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(d[2]), np.cos(d[2]))], np.float32)

    sqrtI = np.diag([10.0, 10.0, 20.0]).astype(np.float32)
    eng.edges = [(i, i + 1, rel(gt[i], gt[i + 1]), sqrtI) for i in range(N - 1)]
    for q in range(N // 2 + 5, N - 1, 400):
        r = (q - N // 2) // per * per
        eng.edges.append((r, q, rel(gt[r], gt[q]), sqrtI))
        eng.n_loop_edges += 1
    return gt, noisy


def test_online_pgo_routes_schur_beyond_dense_limit(monkeypatch):
    from randt_slam_torch.graph import schur

    j = JOnline(_tiny_cfg(), loop_every=10**9, pgo_every=10**9)
    gt, noisy = _inject(j)
    j.optimize_pose_graph()
    t = TOnline(tiny_config(), loop_every=10**9, pgo_every=10**9, device="cpu")
    _inject(t)
    routed = {}
    orig = schur.optimize_auto

    def spy(*a, **k):
        poses, info = orig(*a, **k)
        routed["solver"] = info["solver"]
        return poses, info

    monkeypatch.setattr(schur, "optimize_auto", spy)
    t.optimize_pose_graph()
    assert routed["solver"] == "schur"
    opt = t.trajectory()
    assert np.all(np.isfinite(opt))
    before = np.linalg.norm(noisy[:, :2] - gt[:, :2], axis=1).mean()
    after = np.linalg.norm(opt[:, :2] - gt[:, :2], axis=1).mean()
    assert after < 0.5 * before
    d = opt.astype(np.float64) - j.trajectory()
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    print(f"Schur route, 2100 nodes: port against JAX {np.abs(d[:, :2]).max():.2e} m "
          f"/ {np.abs(d[:, 2]).max():.2e} rad")
    assert np.abs(d[:, :2]).max() <= SCHUR_BAND[0]
    assert np.abs(d[:, 2]).max() <= SCHUR_BAND[1]


# ---- the CLI ---------------------------------------------------------------------


@pytest.fixture
def tiny_cli(monkeypatch):
    """The CLI on the tiny configuration and 64-azimuth frames (seed 6), as
    ``tests/test_online_cli.py`` drives the JAX CLI."""
    def frames(args, device):
        seq = synthetic.generate(seed=6, n_frames=args.frames, n_azimuths=64,
                                 n_bins=128, max_range=40.0, speed=3.0, dt=0.25,
                                 n_walls=40)
        return (tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                      seq.stamps, device=device),
                seq.gt_poses, seq.stamps)

    monkeypatch.setattr(trun, "load_config", lambda args: tiny_config())
    monkeypatch.setattr(trun, "load_frames", frames)

    def run(out, *extra, n=12):
        assert trun.main(["--input", "synthetic", "--frames", str(n), "--device",
                          "cpu", "--output", str(out), *extra]) == 0
        return json.loads((out / "metrics.json").read_text())
    return run


def test_cli_online_checkpoint_and_resume(tmp_path, tiny_cli, monkeypatch):
    saved = []
    save = TOnline.save_checkpoint

    def keep(self, path):
        save(self, path)
        saved.append(self._frame_count)
        save(self, str(tmp_path / f"at{self._frame_count}.npz"))

    monkeypatch.setattr(TOnline, "save_checkpoint", keep)
    ck = tmp_path / "ck.npz"
    m = tiny_cli(tmp_path / "a", "--online", "--checkpoint", str(ck),
                 "--checkpoint-every", "5")
    assert saved == [5, 10, 12] and ck.exists()
    assert m["frames"] == 12 and m["n_nodes"] >= 3
    assert {"online_total", "online_finalize"} <= set(m["profile"])
    for f in ("odom_tum.txt", "odom_kitti.txt", "slam_tum.txt", "slam_kitti.txt",
              "trajectory.json"):
        assert (tmp_path / "a" / f).exists(), f
    # from the mid-run checkpoint, and from the last one (taken before the
    # bag end), to the uninterrupted run's trajectory
    for name, path in (("b", tmp_path / "at10.npz"), ("c", ck)):
        m2 = tiny_cli(tmp_path / name, "--online", "--resume", str(path))
        assert m2["frames"] == 12 and m2["n_nodes"] == m["n_nodes"]
        for f in ("odom_tum.txt", "slam_tum.txt"):
            assert (tmp_path / name / f).read_text() == (tmp_path / "a" / f).read_text()


def test_cli_offline_checkpoint_loads_in_both_packages(tmp_path, tiny_cli):
    ck = str(tmp_path / "carry.npz")
    tiny_cli(tmp_path / "o", "--odometry-only", "--checkpoint", ck, n=6)
    t = tCK.load_carry(ck, tF.init_carry(tiny_config(), device="cpu"))
    j = jCK.load_carry(ck, jF.init_carry(_tiny_cfg()))
    assert t.node_count > 0 and int(j.node_count) == t.node_count
    tflat, jflat = tCK._flatten(t), jCK._flatten(j)
    assert tflat.keys() == jflat.keys()
    for k in tflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
        assert tflat[k].dtype == jflat[k].dtype, k


def test_cli_online_live_view(tmp_path, tiny_cli):
    pytest.importorskip("matplotlib")
    out = tmp_path / "v"
    tiny_cli(out, "--online", "--viz-every", "5", "--ogm", n=6)
    live = out / "live"
    for f in ("map.png", "ndt_submap.npz", "trajectory.json", "ogm.pgm"):
        assert (live / f).exists(), f
    assert (out / "ogm.pgm").exists()
    ndt = np.load(live / "ndt_submap.npz")
    assert ndt["mean_x"].size > 0 and np.isfinite(ndt["mean_x"]).all()
    traj = json.loads((live / "trajectory.json").read_text())
    assert len(traj) >= 1 and np.isfinite(traj[-1]["x"])


# ---- stage timing ---------------------------------------------------------------


def test_profiler_stages_and_device_trace(tmp_path):
    """``utils/profiling``: stages accumulate as the JAX package's do, the
    report aggregates every span recorded since the ``Profiler`` was made
    (stages and the program's spans alike), and under ``torch.profiler``
    each span is a range of its name in the profiler's own Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    from randt_slam_torch.utils import profiling

    prof = profiling.Profiler()
    for _ in range(3):
        with prof.stage("a", sync_value=torch.zeros(2)):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        with profiling.span("randt.test_range", chunk=1):
            torch.ones(4).sum()
    tp.export_chrome_trace(str(tmp_path / "trace.json"))
    rep = prof.report()
    assert rep["a"]["count"] == 3 and rep["a"]["min_s"] <= rep["a"]["max_s"]
    assert rep["randt.test_range"]["count"] == 1
    assert set(rep["a"]) == {"count", "total_s", "mean_s", "min_s", "max_s"}
    prof.dump(str(tmp_path / "p.json"))
    assert json.loads((tmp_path / "p.json").read_text()) == rep
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "randt.test_range" for e in trace["traceEvents"])
