"""One front-end step of the port from the JAX package's carry.

The JAX package runs the 46-frame synthetic sequence of
``tests/test_odometry_e2e.py`` up to a frame; ``state.carry_from_numpy``
moves its carry across, and both packages step the next frame.  Cases: the
frame that completes the first submap (the same frame is then re-processed
as the root of the next one), the first keyframe exit, and an ordinary frame.

Tolerances:
* cadence counters, node/edge ids and flags, index grids, slot counts and
  valid masks: identical;
* poses and window states: 1e-4 (m, m/s) and 1e-5 rad -- the scan cells
  differ by float32 sin/cos ulps between the frameworks and the LM solve
  answers within that from one step;
* sufficient statistics: 1e-5 relative to the channel's largest entry;
* derived means 1e-3 absolute; derived covariances 2e-2 absolute + 1e-5
  relative: cells merged at the smoothed pose carry its 1e-4 m tolerance,
  and the position-intensity cross terms scale it by the intensity (<= 200).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.io import synthetic
from randt_slam_tpu.pipeline import frontend as jF, slam as jS
from randt_slam_torch import state
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.pipeline import frontend as tF, slam as tS
from tests.torch_threads import one_thread  # noqa: F401

POSE_TOL, ANG_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def run():
    seq = synthetic.generate(seed=3, n_frames=46, n_azimuths=256, n_bins=256,
                             speed=4.0, dt=0.25)
    fj = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps)
    ft = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps,
                               device="cpu")
    step = jax.jit(functools.partial(jF.frontend_step, j_cfg(),
                                     sensor_to_base=jnp.zeros(3)))
    carries = [jF.init_carry(j_cfg())]
    for t in range(20):
        carries.append(step(carries[-1], jax.tree.map(lambda a: a[t], fj))[0])
    return fj, ft, step, carries


def _stats_close(a, b):
    for x, y in zip(a, b):
        scale = max(float(np.abs(y).max()) if y.size else 0.0, 1.0)
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-5 * scale)


# frame 19 completes submap 0; frame 5 is the first keyframe exit
@pytest.mark.parametrize("t", [19, 5, 12])
def test_frontend_step_from_jax_carry(run, t):
    fj, ft, step, carries = run
    cj = carries[t]
    ct = state.carry_from_numpy(jax.tree.map(np.asarray, cj), "cpu")
    cj2, oj = step(cj, jax.tree.map(lambda a: a[t], fj))
    ct2, ot = tF.frontend_step(t_cfg(), ct, tF.Frame(*(x[t] for x in ft)),
                               torch.zeros(3))
    a = state.carry_to_numpy(ct2)
    b = jax.tree.map(np.asarray, cj2)

    for name in tF.HOST_FIELDS:
        assert int(getattr(a, name)) == int(getattr(b, name)), name
    for name in ("scan_valid", "kq_frame", "submap_fvalid", "prev_fvalid",
                 "store_root"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)
    for name in ("submap", "prev_submap"):
        sa, sb = getattr(a, name), getattr(b, name)
        np.testing.assert_array_equal(sa.index, sb.index)
        assert int(sa.count) == int(sb.count)
        _stats_close(sa.stats, sb.stats)
    _stats_close(a.kq_stats, b.kq_stats)
    _stats_close(a.store_cells, b.store_cells)
    for name in ("submap_fmean", "prev_fmean", "scan_mean"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                   rtol=0, atol=1e-3, err_msg=name)
    for name in ("submap_fcov", "prev_fcov", "scan_cov"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                   rtol=1e-5, atol=2e-2, err_msg=name)
    for name in ("states", "last_state", "cur_pose", "submap_origin",
                 "last_node_pose", "store_origin"):
        x, y = getattr(a, name), getattr(b, name)
        x2, y2 = x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1])
        ang = [2] if x.shape[-1] == 3 else [2, 5]  # theta (and omega)
        lin = [c for c in range(x2.shape[1]) if c not in ang]
        np.testing.assert_allclose(x2[:, lin], y2[:, lin], atol=POSE_TOL, err_msg=name)
        np.testing.assert_allclose(x2[:, ang], y2[:, ang], atol=ANG_TOL, err_msg=name)

    # outputs: the valid node/edge records and the per-frame pose
    np.testing.assert_allclose(ot.odom_pose.numpy()[:2], np.asarray(oj.odom_pose)[:2],
                               atol=POSE_TOL)
    assert abs(float(ot.odom_pose[2]) - float(oj.odom_pose[2])) <= ANG_TOL
    assert bool(ot.submap_finished) == bool(oj.submap_finished) == (t == 19)
    assert bool(np.asarray(ot.rejected)) == bool(oj.rejected)
    assert int(np.asarray(ot.n_residuals)) == int(oj.n_residuals)
    nv = np.asarray(oj.nodes.valid)
    np.testing.assert_array_equal(ot.nodes.valid, nv)
    for k in ("node_id", "submap_id", "is_root"):
        np.testing.assert_array_equal(np.asarray(getattr(ot.nodes, k))[nv],
                                      np.asarray(getattr(oj.nodes, k))[nv])
    np.testing.assert_array_equal(ot.nodes.frame_idx.numpy()[nv],
                                  np.asarray(oj.nodes.frame_idx)[nv])
    np.testing.assert_allclose(ot.nodes.pose.numpy()[nv], np.asarray(oj.nodes.pose)[nv],
                               atol=POSE_TOL)
    ev = np.asarray(oj.edges.valid)
    np.testing.assert_array_equal(ot.edges.valid, ev)
    for k in ("id_begin", "id_end"):
        np.testing.assert_array_equal(np.asarray(getattr(ot.edges, k))[ev],
                                      np.asarray(getattr(oj.edges, k))[ev])
    np.testing.assert_allclose(ot.edges.trans.numpy()[ev], np.asarray(oj.edges.trans)[ev],
                               atol=POSE_TOL)
    np.testing.assert_allclose(ot.sc_desc.numpy(), np.asarray(oj.sc_desc), atol=1e-3)
