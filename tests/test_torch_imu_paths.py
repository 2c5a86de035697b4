"""The IMU-aided path through the port's other entry points, against the
port's own single resident run and against the JAX package.

The sequence is ``tests/test_imu.py``'s straight drive (its world, drive
and gyro bias of 0.02 rad/s) rendered by ``synthetic.render_scan_fast`` (a
second instead of ~30 s; its speckle and the gyro's noise are other draws),
with that test's relaxed IMU weights (``test_torch_imu.py``).

What must hold, and why:

* The chunked host-resident run (``run_odometry(..., chunk=)``, chunks of
  8 over 21 frames: the first submap completes at frame 19) bitwise the
  resident run: poses, tables, node descriptors and the carry's IMU fields.
* The batch (``parallel/batch``) with distinct IMU streams, one member the
  drive under its gyro, the other the drive three frames late under another
  gyro (another drift and noise draw): each member bitwise its single run.
  ``have_imu_prev`` is one host value for the batch; every member's first
  frame is the batch's first frame, so it is every member's value.
* Checkpoints with IMU state: the JAX package's ``OnlineSlam`` checkpoint
  (after 13 frames, not a cadence multiple) resumes in the port and the
  port's in the JAX package, with the IMU carry fields read bitwise; from
  there both run to the next loop and pose-graph cadence (frame 20): the
  tables identical, poses within ``test_torch_odometry.py``'s free-running
  bands (1e-2 m, 1e-3 rad), the newest bias within 1e-4 rad/s.
* The CLI: ``--config indoor --odometry-only`` on an ``.npz`` carrying
  ``imu_yaw``, made through ``io/rosbag.convert_bag`` from a bag with an IMU
  topic: both packages' CLIs give the same node table, and odometry within
  1e-2 m of each other.
"""

import os

import jax
import numpy as np
import pytest
import torch

from randt_slam_tpu import run as jrun
from randt_slam_tpu.pipeline import slam as jS
from randt_slam_tpu.pipeline.online import OnlineSlam as JOnline
from randt_slam_torch import run as trun
from randt_slam_torch import state
from randt_slam_torch.io import rosbag as RB
from randt_slam_torch.parallel import batch as tB
from randt_slam_torch.pipeline import frontend as tF, slam as tS
from randt_slam_torch.pipeline.online import OnlineSlam as TOnline
from randt_slam_torch.registration import residuals as tR
from randt_slam_tpu.io import synthetic
from tests import test_imu
from tests.test_imu import _cfg as j_imu_cfg
from tests.test_torch_imu import (BIAS_TOL, FREE_ANG, FREE_POS, TABLES, _tframes,
                                  imu_cfg)
from tests.torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def straight_seq():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(synthetic, "render_scan", synthetic.render_scan_fast)
        return test_imu.straight_seq.__wrapped__()


# ---- (5) chunks and batches with IMU streams ----------------------------------


T_RUN = 21          # the first submap completes at frame 19
CHUNK = 8
DELAY = 3


@pytest.fixture(scope="module")
def single(straight_seq):
    """The port's resident IMU-on run of the drive's first T_RUN frames."""
    return tS.run_odometry(imu_cfg(True), _tframes(straight_seq, n=T_RUN), device="cpu")


def test_chunked_host_resident_run_is_the_resident_run(straight_seq, single):
    chunked = tS.run_odometry(imu_cfg(True), _tframes(straight_seq, n=T_RUN, host=True),
                              device="cpu", chunk=CHUNK)
    assert len(chunked.chunk_seconds) == -(-T_RUN // CHUNK)
    for k in TABLES + ("odom_poses", "node_pose", "edge_trans", "node_desc",
                       "rejected_frames"):
        np.testing.assert_array_equal(getattr(chunked, k), getattr(single, k), err_msg=k)
    a, b = chunked.final_carry, single.final_carry
    for k in ("states", "imu_meas", "last_imu_yaw"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.have_imu_prev is b.have_imu_prev is True
    # the carry holds the last reading, and the bias is free and has moved
    assert float(a.last_imu_yaw) == float(straight_seq[4][T_RUN - 1])
    assert float(a.states[-1, tR.BIAS]) != 0.0


def _other_gyro(seq):
    """A second gyro on the same drive: another drift and noise draw."""
    rng = np.random.default_rng(11)
    stamps, gt = seq[3], seq[5]
    return (gt[:, 2] - 0.01 * stamps + rng.normal(0, 0.001, len(stamps))).astype(np.float32)


def test_batched_members_with_distinct_imu_streams(straight_seq, single):
    """Member 0: the drive under its gyro; member 1: the drive three frames
    late under another gyro.  Each member bitwise its single run."""
    cfg = imu_cfg(True)
    lists = [_tframes(straight_seq, n=T_RUN),
             _tframes(straight_seq, n=T_RUN, imu=_other_gyro(straight_seq), start=DELAY)]
    frames = tF.Frame(*(torch.stack(x) for x in zip(*lists)))
    carries, outs = tB.make_batched_scan(cfg, np.zeros(3), device="cpu")(
        tB.init_batched_carry(cfg, len(lists), device="cpu"), frames)
    assert carries.have_imu_prev is True
    for b, fr in enumerate(lists):
        one = single if b == 0 else tS.run_odometry(cfg, fr, device="cpu")
        mine = jax.tree.map(lambda x: np.asarray(x)[b], outs)
        tab = tS._unstack_outputs(mine)
        for k in TABLES:
            np.testing.assert_array_equal(tab[k], getattr(one, k), err_msg=f"{b} {k}")
        np.testing.assert_array_equal(mine.odom_pose, one.odom_poses)
        np.testing.assert_array_equal(tab["node_pose"], one.node_pose)
        np.testing.assert_array_equal(tab["edge_trans"], one.edge_trans)
        for k in ("states", "imu_meas", "last_imu_yaw"):
            assert torch.equal(getattr(carries, k)[b], getattr(one.final_carry, k)), (b, k)
    # each member's gyro reached its own ring
    assert not torch.equal(carries.imu_meas[0], carries.imu_meas[1])


# ---- (6) checkpoints with IMU state -------------------------------------------


SAVED_AT = 13       # not a multiple of the loop (5) or pose-graph (20) cadence
RUN_TO = 20         # both cadences fire at frame 20
IMU_FIELDS = ("imu_meas", "last_imu_yaw", "have_imu_prev", "states")


def _engine_tables(eng):
    return (list(eng.node_submap), list(eng.node_frame), list(eng.node_is_root),
            [(int(e[0]), int(e[1])) for e in eng.edges], eng.n_loop_edges)


@pytest.fixture(scope="module")
def checkpoints(straight_seq, tmp_path_factory):
    d = tmp_path_factory.mktemp("imu_ck")
    scans, az, ranges, stamps, imu, _ = straight_seq
    fj = jS.frames_from_arrays(scans[:RUN_TO], az, ranges, stamps[:RUN_TO],
                               imu_yaw=imu[:RUN_TO])
    ft = _tframes(straight_seq, n=RUN_TO)
    jcfg, tcfg = j_imu_cfg(True), imu_cfg(True)
    j = JOnline(jcfg)
    t = TOnline(tcfg, device="cpu")
    for i in range(SAVED_AT):
        j.process_frame(jax.tree.map(lambda a: a[i], fj))
        t.process_frame(tF.Frame(*(x[i] for x in ft)))
    j_ck, t_ck = str(d / "jax.npz"), str(d / "port.npz")
    j.save_checkpoint(j_ck)
    t.save_checkpoint(t_ck)
    t_from_j = TOnline(tcfg, device="cpu")
    t_from_j.load_checkpoint(j_ck)
    j_from_t = JOnline(jcfg)
    j_from_t._step, j_from_t._features, j_from_t._refine, j_from_t._detect = (
        j._step, j._features, j._refine, j._detect)
    j_from_t.load_checkpoint(t_ck)
    loaded = dict(t_from_j=state.carry_to_numpy(t_from_j.carry),
                  j=jax.tree.map(np.asarray, j.carry),
                  j_from_t=jax.tree.map(np.asarray, j_from_t.carry),
                  t=state.carry_to_numpy(t.carry))
    for i in range(SAVED_AT, RUN_TO):
        j.process_frame(jax.tree.map(lambda a: a[i], fj))
        j_from_t.process_frame(jax.tree.map(lambda a: a[i], fj))
        fr = tF.Frame(*(x[i] for x in ft))
        t.process_frame(fr)
        t_from_j.process_frame(fr)
    return dict(j=j, t=t, t_from_j=t_from_j, j_from_t=j_from_t, loaded=loaded)


def test_checkpoint_imu_fields_cross_both_ways(checkpoints):
    ld = checkpoints["loaded"]
    for a, b in (("t_from_j", "j"), ("j_from_t", "t")):
        for k in IMU_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(ld[a], k)),
                                          np.asarray(getattr(ld[b], k)), err_msg=(a, k))
    assert bool(ld["t"].have_imu_prev) and float(ld["t"].last_imu_yaw) != 0.0
    # the bias is free and has moved by the checkpoint
    assert np.abs(np.asarray(ld["t"].states)[-1, tR.BIAS]) > 0.0


@pytest.mark.parametrize("pair", [("t_from_j", "j"), ("j_from_t", "t")])
def test_one_cadence_after_a_checkpoint_with_imu(checkpoints, pair):
    """From either package's checkpoint, the other package runs frames
    13-19 (the loop cadence at 15 and 20, the pose graph at 20) beside the
    engine that wrote it: identical tables, poses within the free-running
    bands, the bias within BIAS_TOL."""
    a, b = checkpoints[pair[0]], checkpoints[pair[1]]
    assert a._frame_count == b._frame_count == RUN_TO
    assert _engine_tables(a) == _engine_tables(b)
    oa, ob = np.stack(a.odom_trace[-(RUN_TO - SAVED_AT):]), np.stack(
        b.odom_trace[-(RUN_TO - SAVED_AT):])
    d = np.abs(oa - ob)
    assert d[:, :2].max() <= FREE_POS and d[:, 2].max() <= FREE_ANG, d
    np.testing.assert_allclose(a.trajectory(), b.trajectory(), atol=FREE_POS)
    ba = float(np.asarray(a.carry.states)[-1, tR.BIAS])
    bb = float(np.asarray(b.carry.states)[-1, tR.BIAS])
    assert abs(ba - bb) <= BIAS_TOL, (ba, bb)


# ---- (7) the CLI on an indoor .npz with imu_yaw ---------------------------------


N_CLI = 12


def test_cli_indoor_odometry_from_a_bag_with_imu(tmp_path):
    """Frames of ``chip_smoke.render_indoor`` (12 m, 3 cm bins, a drifting
    gyro) written as a bag of PointCloud2 and Imu messages, converted by the
    port's ``convert_bag`` with the IMU topic, then ``--config indoor
    --odometry-only`` through both packages' CLIs: the same node table, and
    odometry within the free-running bands."""
    from chip_smoke import IN_BIN_W, IN_MAX_RANGE, render_indoor

    scans, az, ranges, stamps, imu, _ = render_indoor(N_CLI, seed=2)
    msgs = []
    for t in range(N_CLI):
        a_idx, r_idx = np.nonzero(scans[t] > 6.0)
        pts = np.stack([ranges[r_idx] * np.cos(az[a_idx]),
                        ranges[r_idx] * np.sin(az[a_idx]), scans[t][a_idx, r_idx]], 1)
        st = 100.0 + float(stamps[t])
        msgs.append(("/radar/pcl2", "sensor_msgs/PointCloud2", st,
                     RB.serialize_pointcloud2(pts, st)))
        msgs.append(("/imu/data", "sensor_msgs/Imu", st, RB.serialize_imu(float(imu[t]), st)))
    bag, npz = str(tmp_path / "indoor.bag"), str(tmp_path / "indoor.npz")
    RB.write_bag(bag, msgs)
    info = RB.convert_bag(bag, npz, imu_topic="/imu/data", n_azimuths=len(az),
                          n_bins=len(ranges), max_range=IN_MAX_RANGE)
    assert info["imu_samples"] == N_CLI
    data = np.load(npz)
    np.testing.assert_allclose(data["imu_yaw"], np.unwrap(imu), atol=1e-6)
    assert abs(float(data["ranges"][1] - data["ranges"][0]) - IN_BIN_W) < 1e-6

    out_t, out_j = tmp_path / "t", tmp_path / "j"
    args = ["--input", npz, "--config", "indoor", "--odometry-only"]
    trun.main(args + ["--output", str(out_t), "--device", "cpu"])
    jrun.main(args + ["--output", str(out_j)])
    node_t = np.loadtxt(out_t / "slam_tum.txt", ndmin=2)
    node_j = np.loadtxt(out_j / "slam_tum.txt", ndmin=2)
    np.testing.assert_array_equal(node_t[:, 0], node_j[:, 0])   # node stamps
    odom_t = np.loadtxt(out_t / "odom_tum.txt", ndmin=2)
    odom_j = np.loadtxt(out_j / "odom_tum.txt", ndmin=2)
    np.testing.assert_array_equal(odom_t[:, 0], odom_j[:, 0])
    assert np.abs(odom_t[:, 1:3] - odom_j[:, 1:3]).max() <= FREE_POS
    assert os.path.getsize(out_t / "metrics.json") > 0
