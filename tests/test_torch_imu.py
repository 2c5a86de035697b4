"""The IMU-aided path (``use_imu=True``): the port against the JAX package.

The reference adds a relative-yaw residual and a bias random walk to every
window transition (``imu_residual``, ``ceres_residuals.h:307-336``), frees
the bias column of the window states, and pairs each IMU reading's yaw
change with its own transition (``frontend._regular_scan``).  The carry
keeps ``last_imu_yaw`` and ``have_imu_prev`` across frames, submaps,
checkpoints, chunks and batches.

What must hold, and why:

* ``imu_residual`` and its Jacobian from seeded inputs, angle wrap-around
  included: within float32 rounding of the same formula (the residual
  scaled by its weights, 1e-6 of them).
* ``run_odometry`` on ``tests/test_imu.py``'s 40-frame straight sequence
  (true gyro bias 0.02 rad/s, that test's relaxed weights): node and edge
  tables identical; ``test_torch_odometry.py``'s switches-off free-running
  bands (ATE within 5e-3 m, headings within 1e-3 rad, at most four frames
  over 1e-2 m and none over 5e-2 m); every frame over 1e-2 m stepped by both
  packages from the port's carry without the function-tolerance exit within
  1e-4 m / 1e-5 rad; the newest bias state within 1e-4 rad/s of the JAX
  package's (measured 2e-6); and the port's own copies of ``test_imu.py``'s
  three assertions (the bias converges to the true rate, it stays exactly 0
  with the IMU off, and the IMU readings move the poses).
* ``estimate_window`` with the IMU on: ``test_torch_imu_window.py``; the
  chunked and batched runs, checkpoints and the CLI with IMU state:
  ``test_torch_imu_paths.py``; full SLAM at ``indoor_config()``:
  ``test_torch_imu_slam.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randt_slam_tpu.io import formats
from randt_slam_tpu.pipeline import frontend as jF, slam as jS
from randt_slam_tpu.registration import residuals as jR
from randt_slam_torch import state
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.pipeline import frontend as tF, slam as tS
from randt_slam_torch.registration import residuals as tR
from tests.test_imu import TRUE_BIAS, straight_seq  # noqa: F401
from tests.test_imu import _cfg as j_imu_cfg
from tests.test_torch_odometry import _jax_carry, _no_exit_test
from tests.torch_threads import one_thread  # noqa: F401

TABLES = ("node_id", "node_frame", "node_submap", "node_is_root",
          "edge_begin", "edge_end")
RES_TOL = 1e-6                      # imu_residual, relative to its weights
LIN_TOL, ANG_TOL = 1e-4, 1e-5       # one step from one carry
# switches-off free-running bands of test_torch_odometry.py
FREE_ATE, FREE_ANG, FREE_POS, MAX_OVER, FREE_CAP = 5e-3, 1e-3, 1e-2, 4, 5e-2
BIAS_TOL = 1e-4                     # newest bias state against the JAX run's
N_TOGGLE = 16                       # test_imu.py's toggle sub-sequence


def imu_cfg(use_imu: bool, **overrides):
    """The port's counterpart of ``tests/test_imu.py``'s configuration."""
    return t_cfg(use_imu=use_imu, **{"matcher.use_imu": use_imu,
                                     "matcher.weight_imu": 64.0,
                                     "matcher.weight_imu_bias": 50.0},
                 **overrides)


def _tframes(seq, with_imu=True, imu=None, start=0, n=None, host=False):
    scans, az, ranges, stamps, yaw, _ = seq
    end = len(stamps) if n is None else start + n
    yaw = yaw if imu is None else imu
    kw = dict(host=True) if host else dict(device="cpu")
    return tS.frames_from_arrays(scans[start:end], az, ranges, stamps[start:end],
                                 imu_yaw=yaw[start:end] if with_imu else None, **kw)


# ---- (1) the residual -------------------------------------------------------


def test_imu_residual_and_jacobian_match_jax():
    rng = np.random.default_rng(0)
    n = 64
    s0 = rng.normal(0, 1, (n, 9)).astype(np.float32)
    s1 = rng.normal(0, 1, (n, 9)).astype(np.float32)
    # headings on both sides of the wrap, measurements near +-pi
    s0[:8, 2] = np.float32(np.pi - 0.01)
    s1[:8, 2] = np.float32(-np.pi + 0.02)
    s0[8:16, 2] = np.float32(-3.1)
    s1[8:16, 2] = np.float32(3.1)
    s1[:, 8] = rng.normal(0, 0.05, n).astype(np.float32)
    dt = rng.uniform(0.05, 0.5, n).astype(np.float32)
    meas = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    meas[16:24] = np.float32(np.pi)
    w, wb = 64.0, 750000.1
    rj = np.asarray(jR.imu_residual(jnp.asarray(s0), jnp.asarray(s1), jnp.asarray(dt),
                                    jnp.asarray(meas), w, wb))
    t = torch.from_numpy
    rt = tR.imu_residual(t(s0), t(s1), t(dt), t(meas), w, wb).numpy()
    np.testing.assert_allclose(rt[:, 0], rj[:, 0], rtol=0, atol=RES_TOL * w * 2 * np.pi)
    np.testing.assert_allclose(rt[:, 1], rj[:, 1], rtol=0,
                               atol=RES_TOL * wb * np.abs(s1[:, 8] - s0[:, 8]).max())
    # the wrapped rotation change lies in (-pi, pi], the reading in [-pi, pi]
    assert np.all(np.abs(rt[:, 0]) <= w * 2 * np.pi * (1 + 1e-6))
    # Jacobians: JAX forward mode against torch reverse mode
    jj = jax.jacfwd(lambda a, b: jR.imu_residual(a, b, jnp.asarray(dt), jnp.asarray(meas),
                                                 w, wb), argnums=(0, 1))
    J0, J1 = (np.einsum("nkni->nki", np.asarray(x)) for x in jj(jnp.asarray(s0),
                                                                 jnp.asarray(s1)))
    a, b = t(s0).requires_grad_(True), t(s1).requires_grad_(True)
    r = tR.imu_residual(a, b, t(dt), t(meas), w, wb)
    for k in range(2):
        g0, g1 = torch.autograd.grad(r[:, k].sum(), (a, b), retain_graph=True)
        scale = w * (1 + dt.max()) if k == 0 else wb
        np.testing.assert_allclose(g0.numpy(), J0[:, k], rtol=0, atol=RES_TOL * scale)
        np.testing.assert_allclose(g1.numpy(), J1[:, k], rtol=0, atol=RES_TOL * scale)


# ---- (3) odometry on the straight sequence ----------------------------------


@pytest.fixture(scope="module")
def jax_straight(straight_seq):  # noqa: F811
    scans, az, ranges, stamps, imu, _ = straight_seq
    frames = jS.frames_from_arrays(scans, az, ranges, stamps, imu_yaw=imu)
    return jS.run_odometry(j_imu_cfg(True), frames, use_scan=True)


@pytest.fixture(scope="module")
def port_straight(straight_seq):  # noqa: F811
    """The port's IMU-on run (switches off) and a copy of the carry entering
    every frame."""
    carries = []

    def keep(t, carry):
        carries.append(jax.tree.map(np.array, state.carry_to_numpy(carry)))

    res = tS.run_odometry(imu_cfg(True), _tframes(straight_seq), device="cpu",
                          on_frame=keep)
    return res, carries


@pytest.fixture(scope="module")
def port_straight_off(straight_seq):  # noqa: F811
    return tS.run_odometry(imu_cfg(False), _tframes(straight_seq, with_imu=False),
                           device="cpu")


def test_straight_tables_identical(jax_straight, port_straight):
    res = port_straight[0]
    for k in TABLES:
        np.testing.assert_array_equal(getattr(res, k), getattr(jax_straight, k),
                                      err_msg=k)
    assert res.n_submaps == jax_straight.n_submaps
    np.testing.assert_array_equal(res.rejected_frames, jax_straight.rejected_frames)


def _over_band(a, b):
    d = np.abs(a.odom_poses - b.odom_poses)[:, :2].max(axis=1)
    return d, np.flatnonzero(d > FREE_POS)


def test_straight_free_running_bands(straight_seq, jax_straight, port_straight):  # noqa: F811
    res = port_straight[0]
    gt = straight_seq[5]
    ate_t, ate_j = formats.ate(res.odom_poses, gt), formats.ate(jax_straight.odom_poses, gt)
    assert abs(ate_t - ate_j) < FREE_ATE, (ate_t, ate_j)
    d = np.abs(res.odom_poses - jax_straight.odom_poses)
    assert d[:, 2].max() <= FREE_ANG, d[:, 2].max()
    pos, over = _over_band(res, jax_straight)
    assert len(over) <= MAX_OVER, {int(t): float(pos[t]) for t in over}
    assert pos.max() <= FREE_CAP, pos.max()
    dn = np.abs(res.node_pose - jax_straight.node_pose)
    assert dn[:, :2].max() <= FREE_CAP and dn[:, 2].max() <= FREE_ANG
    bias_t = float(res.final_carry.states[-1, tR.BIAS])
    bias_j = float(np.asarray(jax_straight.final_carry.states)[-1, jR.BIAS])
    assert abs(bias_t - bias_j) <= BIAS_TOL, (bias_t, bias_j)


def test_straight_over_band_frames_agree_without_exit_test(straight_seq, jax_straight,  # noqa: F811
                                                           port_straight):
    """Every frame over the 1e-2 m band, stepped by both packages from the
    carry the port brought to it, with ``lm_function_tolerance = 0``."""
    res, carries = port_straight
    _, over = _over_band(res, jax_straight)
    if len(over) == 0:
        return
    scans, az, ranges, stamps, imu, _ = straight_seq
    fj = jS.frames_from_arrays(scans, az, ranges, stamps, imu_yaw=imu)
    ft = _tframes(straight_seq)
    step = jax.jit(functools.partial(jF.frontend_step, _no_exit_test(j_imu_cfg(True)),
                                     sensor_to_base=jnp.zeros(3)))
    beyond = {}
    for t in over:
        oj = np.asarray(step(_jax_carry(carries[t]),
                             jax.tree.map(lambda a: a[t], fj))[1].odom_pose)
        ot = tF.frontend_step(_no_exit_test(imu_cfg(True)),
                              state.carry_from_numpy(carries[t], "cpu"),
                              tF.Frame(*(x[t] for x in ft)),
                              torch.zeros(3))[1].odom_pose.numpy()
        dp, da = np.abs(ot[:2] - oj[:2]).max(), abs(ot[2] - oj[2])
        if dp > LIN_TOL or da > ANG_TOL:
            beyond[int(t)] = (float(dp), float(da))
    assert not beyond, beyond


def test_imu_bias_converges_and_accuracy_holds(straight_seq, port_straight,  # noqa: F811
                                               port_straight_off):
    """``tests/test_imu.py``'s first test, on the port."""
    gt = straight_seq[5]
    res_on = port_straight[0]
    ate_off = formats.ate(port_straight_off.odom_poses, gt)
    ate_on = formats.ate(res_on.odom_poses, gt)
    assert np.isfinite(ate_on)
    assert ate_on <= ate_off * 1.10 + 0.05, (ate_on, ate_off)
    bias = float(res_on.final_carry.states[-1, tR.BIAS])
    assert 0.5 * TRUE_BIAS < bias < 1.6 * TRUE_BIAS, bias


def test_imu_off_never_touches_the_bias(port_straight_off):
    assert float(port_straight_off.final_carry.states[-1, tR.BIAS]) == 0.0
    assert float(port_straight_off.final_carry.states[:, tR.BIAS].abs().max()) == 0.0


def test_imu_measurements_reach_the_residual(straight_seq, port_straight):  # noqa: F811
    """Toggling the IMU channel changes the estimate: the first
    ``N_TOGGLE`` frames with their readings (the 40-frame run's first poses:
    odometry is causal) against the same frames with the readings zeroed."""
    zero = tS.run_odometry(imu_cfg(True), _tframes(straight_seq, with_imu=False,
                                                   n=N_TOGGLE), device="cpu")
    d = np.abs(port_straight[0].odom_poses[:N_TOGGLE] - zero.odom_poses).max()
    assert d > 1e-6, d
