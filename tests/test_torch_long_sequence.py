"""The long-sequence path of the port on the CPU: host-resident frames
(``frames_from_arrays(..., host=True)``), chunked odometry and SLAM
(``run_odometry``/``run_slam(..., chunk=)``), the OGM's node frames gathered
chunk by chunk (``render_ogm(..., chunk=)``), and ``OnlineSlam`` moving the
counting grids of finished submaps to host memory.

What must hold, and why:

* a chunked run is the device-resident run bit for bit (poses, node and
  edge tables, the submap store, the node descriptors), with chunks of 5
  and 8 frames over 10 (a node leaves the keyframe queue four frames after
  its source frame, so some nodes come from the chunk before) and with a
  chunk as long as the sequence, for float32, float16 and uint8 frames,
  each against its own resident run: the chunks change where the frames
  and outputs live, never what is computed;
* the chunked run's tables are the JAX package's ``run_odometry(chunk=8)``
  tables over the same host frames, and its poses lie within
  ``tests/test_torch_odometry.py``'s switches-off bands of it;
* ``chunk_seconds`` has one entry per chunk, none without chunks;
* ``run_slam(chunk=)`` gives the unchunked run's loop edges and optimized
  poses bit for bit (the loop pass uploads each candidate frame alone);
* ``render_ogm`` with chunks of 32 and of 4 frames (neither divides the
  node count) gives the counting grids and occupancy of one node per
  filter call, bit for bit (``tests/test_torch_ogm.py`` holds the grids to
  the JAX package's);
* ``OnlineSlam`` keeps on the device only the grids of submaps that can
  still receive nodes, re-uploads none, and its grids and occupancy are
  bit for bit those of the same run with the move taken out (patched here
  only; the package has no switch); a checkpoint taken after grids have
  moved resumes to the same end bit for bit.

The sequences are small: the seed-3 sequence of ``tests/test_odometry_e2e``
made 10 frames long, at its ``small_cfg()``, and for SLAM and online mode a
40- and a 20-frame drive at the tiny configuration of the online tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.io import synthetic
from randt_slam_tpu.pipeline import slam as jS
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.pipeline import frontend as tF
from randt_slam_torch.pipeline import slam as tS
from randt_slam_torch.pipeline.online import OnlineSlam
from tests.test_torch_kernels_cuda import tiny_config
from tests.test_torch_odometry import LIMITS, POS_TOL, TABLES
from tests.torch_threads import one_thread  # noqa: F401

T = 10
RESULT_FIELDS = ("odom_poses", "node_id", "node_pose", "node_stamp", "node_traversed",
                 "node_submap", "node_frame", "node_is_root", "edge_begin", "edge_end",
                 "edge_trans", "edge_sqrt_information", "submap_origin", "submap_root",
                 "rejected_frames", "node_desc")


@pytest.fixture(scope="module")
def seq():
    s = synthetic.generate(seed=3, n_frames=T, n_azimuths=256, n_bins=256,
                           speed=4.0, dt=0.25)
    return s.intensity, s.azimuths, s.ranges, s.stamps


def _intensity(seq, dtype):
    img = seq[0]
    return np.clip(img, 0, 255).astype(np.uint8) if dtype == "uint8" else img.astype(dtype)


@pytest.fixture(scope="module")
def resident(seq):
    """Device-resident runs (the CPU as the device), one per frame type."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            frames = tS.frames_from_arrays(_intensity(seq, dtype), *seq[1:], device="cpu")
            cache[dtype] = tS.run_odometry(t_cfg(), frames, device="cpu")
        return cache[dtype]
    return get


@pytest.fixture(scope="module")
def chunked(seq):
    """Runs from host memory in chunks, one per frame type and chunk size."""
    cache = {}

    def get(dtype, chunk):
        if (dtype, chunk) not in cache:
            frames = tS.frames_from_arrays(_intensity(seq, dtype), *seq[1:], host=True)
            assert frames.intensity.device.type == "cpu"
            assert frames.intensity.dtype == {"float32": torch.float32,
                                              "float16": torch.float16,
                                              "uint8": torch.uint8}[dtype]
            cache[dtype, chunk] = tS.run_odometry(t_cfg(), frames, device="cpu",
                                                  chunk=chunk)
        return cache[dtype, chunk]
    return get


def assert_same_odometry(a, b):
    for k in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert a.n_submaps == b.n_submaps and a.saturation == b.saturation
    for k in ("submap_cells_n", "submap_cells_s", "submap_cells_ss"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("dtype,chunk", [("float32", 5), ("float32", 8),
                                         ("float32", T), ("float16", 8),
                                         ("uint8", 8)])
def test_chunked_odometry_is_the_resident_run(resident, chunked, dtype, chunk):
    ref = resident(dtype)
    res = chunked(dtype, chunk)
    assert_same_odometry(res, ref)
    # a node whose source frame lies in an earlier chunk
    emitted = np.asarray(res.node_frame) + t_cfg().local_fuser.insertion_delay
    assert chunk >= T or np.any(res.node_frame // chunk < emitted // chunk)
    assert len(res.chunk_seconds) == (-(-T // chunk) if chunk < T else 0)
    assert len(ref.chunk_seconds) == 0 and np.all(res.chunk_seconds > 0)


def test_chunked_tables_are_the_jax_packages(seq, chunked):
    frames = jS.frames_from_arrays(*seq, host=True)
    jr = jS.run_odometry(j_cfg(), frames, use_scan=True, chunk=8)
    tr = chunked("float32", 8)
    for k in TABLES:
        np.testing.assert_array_equal(getattr(tr, k), getattr(jr, k), err_msg=k)
    assert len(tr.chunk_seconds) == len(jr.chunk_seconds) == 2
    lim = LIMITS["off"]
    d = np.abs(tr.odom_poses - jr.odom_poses)
    pos = d[:, :2].max(axis=1)
    assert d[:, 2].max() <= lim["ang"] and pos.max() <= lim["cap"], d.max(axis=0)
    assert np.count_nonzero(pos > POS_TOL) <= lim["max_over"], pos
    np.testing.assert_allclose(tr.node_desc, jr.node_desc, atol=1e-3)


# ---- full SLAM and the OGM ------------------------------------------------------


def _small_ogm(cfg):
    """A global grid of 150 m and submap grids of 80 m (the beams reach
    40 m) at 0.25 m."""
    return dataclasses.replace(cfg, ogm=dataclasses.replace(
        cfg.ogm, size_x=600, size_y=600, resolution=0.25, submap_size_x=320,
        submap_size_y=320))


def _loop_config():
    cfg = _small_ogm(tiny_config())
    return dataclasses.replace(
        cfg, capacity=dataclasses.replace(cfg.capacity, max_submaps=32),
        scan_context=dataclasses.replace(cfg.scan_context, num_exclude_recent=8,
                                         num_candidates=5, dist_threshold=0.7))


@pytest.fixture(scope="module")
def slam_runs():
    s = synthetic.generate(seed=7, n_frames=40, n_azimuths=64, n_bins=128,
                           max_range=40.0, speed=3.0, dt=0.25, loop=True, n_walls=40)
    arrays = (s.intensity, s.azimuths, s.ranges, s.stamps)
    cfg = _loop_config()
    resident = tS.run_slam(cfg, tS.frames_from_arrays(*arrays, device="cpu"),
                           device="cpu")
    host = tS.frames_from_arrays(*arrays, host=True)
    return cfg, resident, tS.run_slam(cfg, host, device="cpu", chunk=16), host


def test_chunked_slam_is_the_resident_run(slam_runs):
    _, ref, res, _ = slam_runs
    assert res.loops.n_accepted >= 1
    assert_same_odometry(res.odometry, ref.odometry)
    for k in ("query_node", "query_match", "query_stage", "edge_begin", "edge_end",
              "edge_trans", "cs_divergences"):
        np.testing.assert_array_equal(getattr(res.loops, k), getattr(ref.loops, k),
                                      err_msg=k)
    np.testing.assert_array_equal(res.node_pose_optimized, ref.node_pose_optimized)
    np.testing.assert_array_equal(res.submap_origin_optimized,
                                  ref.submap_origin_optimized)
    assert len(res.odometry.chunk_seconds) == 3


@pytest.fixture(scope="module")
def per_node_ogm(slam_runs):
    cfg, _, res, host = slam_runs
    return tS.render_ogm(cfg, res, host, device="cpu", chunk=1)


@pytest.mark.parametrize("chunk", [32, 4])
def test_render_ogm_chunks_are_the_per_node_grids(slam_runs, per_node_ogm, chunk):
    cfg, _, res, host = slam_runs
    assert len(res.odometry.node_id) % chunk
    occ1, grids1 = per_node_ogm
    occ, grids = tS.render_ogm(cfg, res, host, device="cpu", chunk=chunk)
    np.testing.assert_array_equal(grids, grids1)
    np.testing.assert_array_equal(occ, occ1)
    assert grids.min() < 0 and grids.max() >= 2


# ---- online mode: finished grids in host memory --------------------------------


N_ONLINE, SAVE_AT = 20, 13


@pytest.fixture(scope="module")
def online_frames():
    s = synthetic.generate(seed=5, n_frames=N_ONLINE, n_azimuths=64, n_bins=128,
                           max_range=40.0, speed=3.0, dt=0.25, n_walls=40)
    return tS.frames_from_arrays(s.intensity, s.azimuths, s.ranges, s.stamps,
                                 device="cpu")


def _online(frames, lo=0, eng=None, save=None):
    eng = eng or OnlineSlam(_small_ogm(tiny_config(visualize_ogm=True)),
                            loop_every=3, pgo_every=7, device="cpu")
    for t in range(lo, N_ONLINE):
        if t == SAVE_AT and save:
            eng.save_checkpoint(save)
        eng.process_frame(tF.Frame(*(x[t] for x in frames)))
    return eng


def _same_online(a, b):
    np.testing.assert_array_equal(np.stack(a.odom_trace), np.stack(b.odom_trace))
    np.testing.assert_array_equal(a.trajectory(), b.trajectory())
    ga, gb = a.count_grids(), b.count_grids()
    assert ga.keys() == gb.keys()
    for s in ga:
        assert ga[s].dtype == gb[s].dtype == np.int32
        np.testing.assert_array_equal(ga[s], gb[s])
    np.testing.assert_array_equal(a.render_ogm(), b.render_ogm())


@pytest.fixture(scope="module")
def online_runs(online_frames, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("online") / "ck.npz")
    moved = _online(online_frames, save=ck)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OnlineSlam, "_retire_grids", lambda self: None)
        kept = _online(online_frames)
    return moved, kept, ck


def test_online_moves_finished_grids_to_the_host(online_runs):
    moved, kept, _ = online_runs
    place = moved.grid_placement()
    done = moved.carry.n_finished
    assert place["host"] >= 2 and place["reuploads"] == 0, place
    for s, g in moved._count_grids.items():
        assert isinstance(g, np.ndarray) == (s < done), (s, done)
    assert kept.grid_placement()["host"] == 0
    _same_online(moved, kept)


def test_online_resume_across_moved_grids(online_runs, online_frames):
    moved, _, ck = online_runs
    eng = OnlineSlam(_small_ogm(tiny_config(visualize_ogm=True)), loop_every=3,
                     pgo_every=7, device="cpu")
    eng.load_checkpoint(ck)
    assert eng.grid_placement()["host"] >= 1
    _online(online_frames, lo=SAVE_AT, eng=eng)
    assert eng.grid_placement()["reuploads"] == 0
    _same_online(eng, moved)
