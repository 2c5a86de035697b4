"""Offline odometry end to end: the port's ``run_odometry`` against the JAX
package's on the 46-frame synthetic sequence of ``tests/test_odometry_e2e.py``.

What must hold, and why:

* node, edge and submap tables (ids, source frames, submap ids, root flags,
  edge endpoints, submap count): identical -- the cadence decides them;
* odometry ATE against ground truth < 2.0 m on both sides (the JAX
  package's own bound) and within 5 mm of each other;
* per-frame headings within 1e-3 rad on every frame;
* per-frame positions within 1e-2 m on every frame but at most four, and
  each of those within 5e-2 m and tied to its cause below.

The cause.  The window solve is flat along some directions: in its last LM
iterations the cost falls by about 1e-6 of itself per step (a few float32
ulps) while the position still moves by millimetres.  There the LM
function-tolerance exit (``lm_function_tolerance``, Ceres' 1e-6) decides
the answer on the last bits of the cost, and the reference itself answers
differently to ulp-sized changes of its input (``test_reference_sensitivity``:
one ulp on every azimuth moves its positions by more than 1e-2 m).  The port
starts from scan cells that differ by such ulps (the frameworks' float32
sin/cos differ), so a few frames land on the other side of a decision.  On
this sequence those were frames 17, 34 and 41 (4.0e-2, 1.5e-2 and 1.2e-2 m):

* 17 and 34: the carries entering them differ by 1.3e-3 and 1.7e-3 m, and
  the reference stepped from the port's carry lands within 1e-5 m of the
  port -- the gap is the reference's own response to that carry difference
  (at 34 it moves the exit of the second GNC round by one iteration);
* 41: from one carry, the second GNC round's exit test reads 0.89 of its
  threshold after iteration 8 in the port and 1.16 in the reference, which
  runs one more iteration; the answers differ by 1.1e-2 m.

``test_over_band_frames_agree_without_exit_test`` checks each such frame:
stepped from the same carry with the function-tolerance exit taken out, the
two agree within the one-step tolerance of ``test_torch_frontend_step.py``
(1e-4 m, 1e-5 rad).

The port runs twice, with its kernel switches off and on
(``use_pallas_linearize`` and ``use_pallas_chol``: on the CPU the plain
versions of the fused linearize/cost kernels K3a/K3b and of the Cholesky
kernel K4); the JAX package runs once, on its CPU path (it honours the
switches on a TPU only).  With the switches on the port's solves differ
from the reference's in the last float32 bits everywhere (analytic
derivatives, a fused cost sum, a Cholesky instead of an LU solve).  Stepped
from the port's own carry, 42 of the 45 solved frames then agree within
1e-4 m / 1e-5 rad; 3 land across an ulp-decided LM step (up to 1.3e-3 m,
1.8e-5 rad), and the free run carries such steps on, as it carries the
reference's one-ulp azimuth change in ``test_reference_sensitivity``.  The
switches-on free run therefore misses the switches-off bands above (most
frames end up over 1e-2 m).  It keeps the tables rule; its guard is the
one-step rule on every solved frame, without the function-tolerance exit
(at most four frames beyond 1e-4 m / 1e-5 rad, each within 2e-3 m /
2e-5 rad); and it is held to looser free-running bands: ATE within
1e-2 m, headings within 3e-3 rad, positions within 0.1 m (measured:
7.6e-3 m, 1.4e-3 rad on frames and 2.0e-3 rad on nodes, 8.0e-2 m).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.io import formats, synthetic
from randt_slam_tpu.ndt import cells as jC, grid as jG
from randt_slam_tpu.pipeline import frontend as jF, slam as jS
from randt_slam_torch import state
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.pipeline import frontend as tF, slam as tS
from tests.torch_threads import one_thread  # noqa: F401

TABLES = ("node_id", "node_frame", "node_submap", "node_is_root",
          "edge_begin", "edge_end")
POS_TOL = 1e-2                        # free-running per-frame positions
STEP_POS_TOL, STEP_ANG_TOL = 1e-4, 1e-5   # one step from one carry
SWITCHES = {"off": {}, "on": {"matcher.use_pallas_linearize": True,
                              "matcher.use_pallas_chol": True}}
# per switch setting: ATE gap, heading band, frames over the position band
# (None: no count) and their cap, the frames the one-step rule steps (those
# over the band, or every solved frame), steps beyond it and their caps
LIMITS = {
    "off": dict(ate=5e-3, ang=1e-3, max_over=4, cap=5e-2, step_every_frame=False,
                max_steps=0, step_cap=(STEP_POS_TOL, STEP_ANG_TOL)),
    "on": dict(ate=1e-2, ang=3e-3, max_over=None, cap=1e-1, step_every_frame=True,
               max_steps=4, step_cap=(2e-3, 2e-5)),
}


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(seed=3, n_frames=46, n_azimuths=256, n_bins=256,
                              speed=4.0, dt=0.25)


@pytest.fixture(scope="module")
def jax_result(seq):
    frames = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps)
    return jS.run_odometry(j_cfg(), frames, use_scan=True)


@pytest.fixture(scope="module", params=list(SWITCHES))
def torch_run(seq, request):
    """The port's configuration, its result and a copy of the carry entering
    every frame, with the kernel switches off and on."""
    cfg = t_cfg(**SWITCHES[request.param])
    frames = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                   seq.stamps, device="cpu")
    carries = []

    def keep(t, carry):
        carries.append(jax.tree.map(np.array, state.carry_to_numpy(carry)))

    return (LIMITS[request.param],
            tS.run_odometry(cfg, frames, device="cpu", on_frame=keep), carries, cfg)


@pytest.fixture(scope="module")
def limits(torch_run):
    return torch_run[0]


@pytest.fixture(scope="module")
def torch_result(torch_run):
    return torch_run[1]


def _over_band(jax_result, torch_result):
    d = np.abs(torch_result.odom_poses - jax_result.odom_poses)[:, :2].max(axis=1)
    return d, np.flatnonzero(d > POS_TOL)


def _jax_carry(c):
    """The port's carry (numpy leaves) as the JAX package's FrontendCarry."""
    def conv(name, v):
        if name in ("kq_stats", "store_cells", "stats"):
            return jC.CellStats(**{k: jnp.asarray(x) for k, x in v._asdict().items()})
        if name in ("submap", "prev_submap"):
            return jG.SparseGrid(**{k: conv(k, x) for k, x in v._asdict().items()})
        return jnp.asarray(v)
    return jF.FrontendCarry(**{k: conv(k, v) for k, v in c._asdict().items()})


def _no_exit_test(cfg):
    return dataclasses.replace(
        cfg, matcher=dataclasses.replace(cfg.matcher, lm_function_tolerance=0.0))


def test_tables_identical(jax_result, torch_result):
    for k in TABLES:
        np.testing.assert_array_equal(getattr(torch_result, k),
                                      getattr(jax_result, k), err_msg=k)
    assert torch_result.n_submaps == jax_result.n_submaps == 3
    np.testing.assert_array_equal(torch_result.submap_root, jax_result.submap_root)
    np.testing.assert_array_equal(torch_result.rejected_frames,
                                  jax_result.rejected_frames)
    assert torch_result.saturation == jax_result.saturation


def test_ate_against_ground_truth(seq, jax_result, torch_result, limits):
    ate_t = formats.ate(torch_result.odom_poses, seq.gt_poses)
    ate_j = formats.ate(jax_result.odom_poses, seq.gt_poses)
    assert ate_t < 2.0 and ate_j < 2.0
    assert abs(ate_t - ate_j) < limits["ate"], (ate_t, ate_j)
    node_ate = formats.ate(torch_result.node_pose, seq.gt_poses[torch_result.node_frame])
    assert node_ate < 2.0


def test_per_frame_poses(jax_result, torch_result, limits):
    d = np.abs(torch_result.odom_poses - jax_result.odom_poses)
    assert d[:, 2].max() <= limits["ang"], d[:, 2].max()
    pos, over = _over_band(jax_result, torch_result)
    if limits["max_over"] is not None:
        assert len(over) <= limits["max_over"], {int(t): float(pos[t]) for t in over}
    assert pos.max() <= limits["cap"], pos.max()
    # node poses are window states as they leave the window, after up to W
    # more solves of the kind above: the same cap
    dn = np.abs(torch_result.node_pose - jax_result.node_pose)
    assert dn[:, :2].max() <= limits["cap"] and dn[:, 2].max() <= limits["ang"]
    np.testing.assert_allclose(torch_result.node_desc, jax_result.node_desc, atol=1e-3)


def test_over_band_frames_agree_without_exit_test(seq, jax_result, torch_run):
    """Every frame over the 1e-2 m band (with the switches on, every solved
    frame), stepped by both packages from the carry the port brought to it,
    with ``lm_function_tolerance = 0`` (no function-tolerance exit: both run
    ``lm_max_iterations``)."""
    limits, torch_result, carries, cfg = torch_run
    _, over = _over_band(jax_result, torch_result)
    if limits["step_every_frame"]:
        # frame 0 starts the trajectory; every later frame is solved
        over = np.arange(1, len(carries))
    if len(over) == 0:
        return
    fj = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps)
    ft = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps,
                               device="cpu")
    step = jax.jit(functools.partial(jF.frontend_step, _no_exit_test(j_cfg()),
                                     sensor_to_base=jnp.zeros(3)))
    beyond = {}
    for t in over:
        oj = np.asarray(step(_jax_carry(carries[t]),
                             jax.tree.map(lambda a: a[t], fj))[1].odom_pose)
        ot = tF.frontend_step(_no_exit_test(cfg),
                              state.carry_from_numpy(carries[t], "cpu"),
                              tF.Frame(*(x[t] for x in ft)),
                              torch.zeros(3))[1].odom_pose.numpy()
        dp, da = np.abs(ot[:2] - oj[:2]).max(), abs(ot[2] - oj[2])
        if dp > STEP_POS_TOL or da > STEP_ANG_TOL:
            beyond[int(t)] = (float(dp), float(da))
    assert len(beyond) <= limits["max_steps"], beyond
    cap_p, cap_a = limits["step_cap"]
    assert all(dp <= cap_p and da <= cap_a for dp, da in beyond.values()), beyond


def test_reference_sensitivity(seq, jax_result):
    """The JAX package against itself with every azimuth one ulp larger."""
    az = np.nextafter(seq.azimuths, np.float32(10.0))
    frames = jS.frames_from_arrays(seq.intensity, az, seq.ranges, seq.stamps)
    moved = jS.run_odometry(j_cfg(), frames, use_scan=True)
    d = np.abs(moved.odom_poses - jax_result.odom_poses)[:, :2].max()
    assert d > 1e-2, d


def test_reference_own_kernels_depart_from_its_cpu_path(seq, jax_result, monkeypatch):
    """The JAX package's own kernel switches on, run on the CPU: its matcher
    honours them only where the backend is a TPU, so inside this test its
    backend check sees one, and its K3a/K3b/K4 run in interpret mode.  The
    tables equal its switches-off run's; the poses depart from it by more
    than the 1e-2 m band on a few frames (4.0e-2 m at frame 17 of this
    sequence), as the port's switches-on run departs from that CPU path:
    the departure is the reference's own response to its kernels' last
    float32 bits."""
    import types

    from randt_slam_tpu.ops import ndt_linearize as jNL
    from randt_slam_tpu.ops import small_chol as jSC
    from randt_slam_tpu.registration import matcher as jM

    class TpuBackend(types.ModuleType):
        def __getattr__(self, name):
            return getattr(jax, name)

    on_tpu = TpuBackend("jax")
    on_tpu.default_backend = lambda: "tpu"
    traced = []

    def interpreted(fn):
        def run(*a, **k):
            traced.append(fn.__name__)
            return fn(*a, interpret=True, **k)
        return run

    monkeypatch.setattr(jM, "jax", on_tpu)
    for mod, name in ((jNL, "linearize"), (jNL, "robust_cost"), (jSC, "chol_solve")):
        monkeypatch.setattr(mod, name, interpreted(getattr(mod, name)))
    monkeypatch.setattr(jS, "_SCAN_CACHE", {})
    jax.clear_caches()  # no trace made without the switches may be reused
    try:
        frames = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                       seq.stamps)
        on = jS.run_odometry(j_cfg(**SWITCHES["on"]), frames, use_scan=True)
    finally:
        jax.clear_caches()  # nor a trace made with them, after the patches
    assert {"linearize", "robust_cost", "chol_solve"} <= set(traced), traced
    for k in TABLES:
        np.testing.assert_array_equal(getattr(on, k), getattr(jax_result, k), err_msg=k)
    d = np.abs(on.odom_poses - jax_result.odom_poses)
    pos = d[:, :2].max(axis=1)
    print("JAX switches on against off, per-frame position departure (m):",
          np.array2string(pos, precision=6, max_line_width=200),
          f"heading max {d[:, 2].max():.3e} rad")
    assert np.all(np.isfinite(on.odom_poses))
    assert pos.max() > 1e-2, pos.max()
