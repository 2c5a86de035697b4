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

TABLES = ("node_id", "node_frame", "node_submap", "node_is_root",
          "edge_begin", "edge_end")
POS_TOL, ANG_TOL = 1e-2, 1e-3        # free-running per-frame poses
MAX_OVER_BAND, OVER_BAND_CAP = 4, 5e-2
STEP_POS_TOL, STEP_ANG_TOL = 1e-4, 1e-5   # one step from one carry


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate(seed=3, n_frames=46, n_azimuths=256, n_bins=256,
                              speed=4.0, dt=0.25)


@pytest.fixture(scope="module")
def jax_result(seq):
    frames = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps)
    return jS.run_odometry(j_cfg(), frames, use_scan=True)


@pytest.fixture(scope="module")
def torch_run(seq):
    """The port's result and a copy of the carry entering every frame."""
    frames = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                   seq.stamps, device="cpu")
    carries = []

    def keep(t, carry):
        carries.append(jax.tree.map(np.array, state.carry_to_numpy(carry)))

    return tS.run_odometry(t_cfg(), frames, device="cpu", on_frame=keep), carries


@pytest.fixture(scope="module")
def torch_result(torch_run):
    return torch_run[0]


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


def test_ate_against_ground_truth(seq, jax_result, torch_result):
    ate_t = formats.ate(torch_result.odom_poses, seq.gt_poses)
    ate_j = formats.ate(jax_result.odom_poses, seq.gt_poses)
    assert ate_t < 2.0 and ate_j < 2.0
    assert abs(ate_t - ate_j) < 5e-3, (ate_t, ate_j)
    node_ate = formats.ate(torch_result.node_pose, seq.gt_poses[torch_result.node_frame])
    assert node_ate < 2.0


def test_per_frame_poses(jax_result, torch_result):
    d = np.abs(torch_result.odom_poses - jax_result.odom_poses)
    assert d[:, 2].max() <= ANG_TOL, d[:, 2].max()
    pos, over = _over_band(jax_result, torch_result)
    assert len(over) <= MAX_OVER_BAND, {int(t): float(pos[t]) for t in over}
    assert pos.max() <= OVER_BAND_CAP, pos.max()
    # node poses are window states as they leave the window, after up to W
    # more solves of the kind above: the same cap
    dn = np.abs(torch_result.node_pose - jax_result.node_pose)
    assert dn[:, :2].max() <= OVER_BAND_CAP and dn[:, 2].max() <= ANG_TOL
    np.testing.assert_allclose(torch_result.node_desc, jax_result.node_desc, atol=1e-3)


def test_over_band_frames_agree_without_exit_test(seq, jax_result, torch_run):
    """Every frame over the 1e-2 m band, stepped by both packages from the
    carry the port brought to it, with ``lm_function_tolerance = 0`` (no
    function-tolerance exit: both run ``lm_max_iterations``)."""
    torch_result, carries = torch_run
    _, over = _over_band(jax_result, torch_result)
    if len(over) == 0:
        return
    fj = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps)
    ft = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps,
                               device="cpu")
    step = jax.jit(functools.partial(jF.frontend_step, _no_exit_test(j_cfg()),
                                     sensor_to_base=jnp.zeros(3)))
    for t in over:
        oj = np.asarray(step(_jax_carry(carries[t]),
                             jax.tree.map(lambda a: a[t], fj))[1].odom_pose)
        ot = tF.frontend_step(_no_exit_test(t_cfg()),
                              state.carry_from_numpy(carries[t], "cpu"),
                              tF.Frame(*(x[t] for x in ft)),
                              torch.zeros(3))[1].odom_pose.numpy()
        assert np.abs(ot[:2] - oj[:2]).max() <= STEP_POS_TOL, (int(t), ot, oj)
        assert abs(ot[2] - oj[2]) <= STEP_ANG_TOL, (int(t), ot, oj)


def test_reference_sensitivity(seq, jax_result):
    """The JAX package against itself with every azimuth one ulp larger."""
    az = np.nextafter(seq.azimuths, np.float32(10.0))
    frames = jS.frames_from_arrays(seq.intensity, az, seq.ranges, seq.stamps)
    moved = jS.run_odometry(j_cfg(), frames, use_scan=True)
    d = np.abs(moved.odom_poses - jax_result.odom_poses)[:, :2].max()
    assert d > 1e-2, d
