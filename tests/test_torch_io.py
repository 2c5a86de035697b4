"""The port's host-only io modules against the JAX package's: ``kitti_eval``,
``rosbag`` and the ``oxford`` converters.

The port keeps its own copies of these numpy and standard-library modules
(it imports nothing of the JAX package), so every case asserts exact
equality between the two packages on the same inputs:

* ``kitti_eval``: every function on seeded planar and 3-D trajectories of a
  few hundred metres (segments of 100-800 m, the 6-DoF alignment, ATE, RPE,
  the drift figures), on KITTI-format files and a ``result.txt`` (the
  parity test's reference files are not in the repository; its own
  round-trip input is included);
* ``rosbag``: bags written by each package and read by the other (both
  chunk compressions) give the same messages, and ``convert_bag`` the same
  ``.npz`` arrays (the port rasterizes with the numpy version of the JAX
  package's native ``pack_polar_image``), and the rasterizer alone against
  the native library on rounding ties and NaN intensities (it can still
  part from it where the C library's ``atan2f``, within an ulp of the
  rounded float64 ``arctan2``, puts a point that lies within an ulp of a
  row boundary across it; no point of these cases does);
* a hypothesis fuzz of corrupted bags (bytes replaced, cut, inserted): both
  readers raise the same exception type with the same message, or return
  the same messages and parsed clouds;
* the ``oxford`` converters on synthetic raw frames, a ground-truth CSV
  and a small PNG directory (that case alone needs PIL).
"""

import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from randt_slam_tpu.io import kitti_eval as jKE
from randt_slam_tpu.io import oxford as jOX
from randt_slam_tpu.io import rosbag as jRB
from randt_slam_torch.io import kitti_eval as tKE
from randt_slam_torch.io import oxford as tOX
from randt_slam_torch.io import rosbag as tRB
from tests.torch_threads import one_thread  # noqa: F401


def _equal(a, b):
    """Exact equality of nested results (dicts, tuples, arrays, floats;
    NaN equal to NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- kitti_eval --------------------------------------------------------------


def _trajectory(seed, n=420, step=1.2):
    """A planar drive of ``n`` poses ``step`` m apart with slow turns, and a
    drifting estimate of it."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(rng.normal(0, 0.03, n))
    xy = np.cumsum(step * np.stack([np.cos(yaw), np.sin(yaw)], 1), 0)
    gt = np.concatenate([xy, yaw[:, None]], 1)
    est = gt + np.cumsum(rng.normal(0, [0.02, 0.02, 0.001], (n, 3)), 0)
    return gt, est


def _lift(P, seed):
    """Planar poses tilted into 3-D by a small seeded roll/pitch per pose."""
    rng = np.random.default_rng(seed)
    out = P.copy()
    for k in range(len(P)):
        a, b = rng.normal(0, 0.01, 2)
        Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        out[k, :3, :3] = P[k, :3, :3] @ Rx @ Ry
        out[k, 2, 3] = rng.normal(0, 0.05)
    return out


@pytest.mark.parametrize("seed,lift", [(0, False), (1, True)])
def test_kitti_eval_functions_equal(seed, lift):
    gt_xyt, est_xyt = _trajectory(seed)
    _equal(tKE.poses_from_se2(gt_xyt), jKE.poses_from_se2(gt_xyt))
    gt, est = jKE.poses_from_se2(gt_xyt), jKE.poses_from_se2(est_xyt)
    if lift:
        gt, est = _lift(gt, seed), _lift(est, seed + 10)
    _equal(tKE.trajectory_distances(gt), jKE.trajectory_distances(gt))
    errs = tKE.segment_errors(gt, est)
    assert len(errs) > 0  # the drive is long enough for segments
    _equal(errs, jKE.segment_errors(gt, est))
    _equal(tKE.segment_errors(gt, est, lengths=(50.0,), step=3),
           jKE.segment_errors(gt, est, lengths=(50.0,), step=3))
    _equal(tKE.drift(gt, est), jKE.drift(gt, est))
    _equal(tKE.drift(gt[:40], est[:40]), jKE.drift(gt[:40], est[:40]))  # NaN
    x, y = est[:, :3, 3].T, gt[:, :3, 3].T
    for scale in (False, True):
        _equal(tKE.umeyama_alignment(x, y, scale), jKE.umeyama_alignment(x, y, scale))
    _equal(tKE.align_6dof(gt, est), jKE.align_6dof(gt, est))
    _equal(tKE.ate(gt, est), jKE.ate(gt, est))
    _equal(tKE.rpe(gt, est), jKE.rpe(gt, est))
    for align in ("6dof", None):
        _equal(tKE.evaluate(gt, est, align=align), jKE.evaluate(gt, est, align=align))
    assert (tKE.SEGMENT_LENGTHS, tKE.STEP_SIZE) == (jKE.SEGMENT_LENGTHS, jKE.STEP_SIZE)


def test_kitti_eval_files_equal(tmp_path):
    gt_xyt, est_xyt = _trajectory(2, n=300)
    paths = {}
    for name, xyt in (("gt", gt_xyt), ("est", est_xyt)):
        P = jKE.poses_from_se2(xyt)
        paths[name] = str(tmp_path / f"{name}.txt")
        np.savetxt(paths[name], P[:, :3, :4].reshape(len(P), 12), fmt="%.6f")
    one = str(tmp_path / "one.txt")  # a one-pose file (a row, not a table)
    np.savetxt(one, np.eye(4)[:3].reshape(1, 12), fmt="%.6f")
    _equal(tKE.load_kitti_poses(one), jKE.load_kitti_poses(one))
    _equal(tKE.load_kitti_poses(paths["gt"]), jKE.load_kitti_poses(paths["gt"]))
    _equal(tKE.evaluate_files(paths["gt"], paths["est"]),
           jKE.evaluate_files(paths["gt"], paths["est"]))
    res = tmp_path / "result.txt"
    res.write_text("Sequence, 01\nTrans.err.(%), 1.5873\nRot.err.(deg/100m), 0.4321\n"
                   "ATE(m), 3.21\nRPE(m), 0.0412\nRPE-dev(m), 0.0107\n"
                   "RPE(deg), 0.1488\nRPE-dev(deg), 0.1022\nnot, a, metric\n")
    _equal(tKE.parse_result_txt(str(res)), jKE.parse_result_txt(str(res)))
    # the parity test's own round-trip input
    xyt = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 0.3], [-4.0, 0.5, -2.9]])
    P = tKE.poses_from_se2(xyt)
    _equal(P, jKE.poses_from_se2(xyt))
    _equal(tKE.evaluate(P, P, align=None), jKE.evaluate(P, P, align=None))


# ---- rosbag --------------------------------------------------------------------


def _cloud(rng, n=50, rmax=20.0):
    ang = rng.uniform(-np.pi, np.pi, n)
    r = rng.uniform(2.0, rmax, n)
    return np.stack([r * np.cos(ang), r * np.sin(ang),
                     rng.uniform(60, 200, n)], axis=1).astype(np.float32)


def _messages(RB, seed=0, n=4):
    """Radar clouds and IMU samples (4 per frame), serialized by ``RB``."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(rng.uniform(-0.1, 0.1, n))
    msgs = []
    for t in range(n):
        st = 100.0 + t * 0.25
        msgs.append(("/radar_data", "sensor_msgs/PointCloud2", st,
                     RB.serialize_pointcloud2(_cloud(rng), st)))
        for k in range(4):
            s2 = st + k * 0.0625
            msgs.append(("/imu/data", "sensor_msgs/Imu", s2,
                         RB.serialize_imu(float(yaw[t]), s2)))
    return msgs


def _read(RB, path):
    """Every message of the bag, with its parsed cloud or IMU sample."""
    out = []
    for m in RB.read_messages(path):
        if m.msg_type.endswith("PointCloud2"):
            out.append((tuple(m[:3]), m.raw, tuple(RB.parse_pointcloud2(m.raw))))
        elif m.msg_type.endswith("Imu"):
            out.append((tuple(m[:3]), m.raw, tuple(RB.parse_imu(m.raw))))
        else:
            out.append((tuple(m[:3]), m.raw, None))
    return out


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bags_cross_read(tmp_path, compression):
    for writer, name in ((jRB, "jax"), (tRB, "torch")):
        msgs = _messages(writer)
        assert msgs == _messages(tRB if writer is jRB else jRB)  # serializers agree
        path = str(tmp_path / f"{name}.bag")
        writer.write_bag(path, msgs, compression=compression)
        other = tmp_path / f"{name}_other.bag"
        (tRB if writer is jRB else jRB).write_bag(str(other), msgs, compression=compression)
        assert open(path, "rb").read() == other.read_bytes()
        got_t, got_j = _read(tRB, path), _read(jRB, path)
        _equal(got_t, got_j)
        assert len(got_t) == len(msgs)
        for (head, raw, _), (topic, mtype, stamp, body) in zip(got_t, msgs):
            assert head[:2] == (topic, mtype) and raw == body


def test_convert_bag_equal(tmp_path):
    bag = str(tmp_path / "seq.bag")
    jRB.write_bag(bag, _messages(jRB, seed=2, n=6), compression="bz2")
    for kw in (dict(n_azimuths=64, n_bins=128), dict(n_azimuths=400, n_bins=512,
                                                     max_range=30.0, max_frames=4)):
        info_t = tRB.convert_bag(bag, str(tmp_path / "t.npz"), **kw)
        info_j = jRB.convert_bag(bag, str(tmp_path / "j.npz"), **kw)
        assert {k: v for k, v in info_t.items() if k != "out"} == \
            {k: v for k, v in info_j.items() if k != "out"}
        a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert a["intensity"].max() > 100


def test_converter_cli_equal(tmp_path, capsys):
    bag = str(tmp_path / "cut.bag")
    jRB.write_bag(bag, _messages(jRB, n=2))
    blob = open(bag, "rb").read()
    with open(bag, "wb") as f:
        f.write(blob[: len(blob) // 2])
    errs = []
    for RB in (tRB, jRB):
        with pytest.raises(SystemExit) as e:
            RB.main([bag, str(tmp_path / "out.npz")])
        assert e.value.code == 2
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1] and errs[0].startswith("error:")


@pytest.fixture(scope="module")
def fuzz_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fuzz")
    blobs = {}
    for compression in ("none", "bz2"):
        p = str(d / f"{compression}.bag")
        jRB.write_bag(p, _messages(jRB, seed=5, n=2), compression=compression)
        blobs[compression] = open(p, "rb").read()
    return d, blobs


def _outcome(RB, path):
    try:
        return ("ok", _read(RB, path))
    except Exception as e:  # the exception's type and message are the outcome
        return (type(e).__name__, str(e))


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(compression=st.sampled_from(["none", "bz2"]),
       edits=st.lists(st.tuples(st.floats(0, 1, exclude_max=True), st.integers(0, 255),
                                st.sampled_from(["set", "cut", "insert"])),
                      min_size=1, max_size=4))
def test_corrupted_bags_fail_alike(fuzz_dir, compression, edits):
    d, blobs = fuzz_dir
    blob = bytearray(blobs[compression])
    for where, value, op in edits:
        i = int(where * len(blob))
        if op == "set":
            blob[i] = value
        elif op == "cut":
            del blob[i:]
            if not blob:
                blob = bytearray(b"\0")
        else:
            blob[i:i] = bytes([value])
    path = str(d / "fuzz.bag")
    with open(path, "wb") as f:
        f.write(bytes(blob))
    got, want = _outcome(tRB, path), _outcome(jRB, path)
    assert got[0] == want[0]
    _equal(got[1], want[1])


# ---- oxford converters -----------------------------------------------------------


def _raw_frame(rng, stamp_us):
    A, R = jOX.OXFORD_N_AZIMUTHS, jOX.OXFORD_N_BINS
    raw = rng.integers(0, 256, (A, jOX.OXFORD_HEADER_BYTES + R)).astype(np.uint8)
    sweep = (np.arange(A) * (5600 // A)).astype(np.uint16)
    raw[:, :8] = np.frombuffer((stamp_us + np.arange(A, dtype=np.int64) * 625).tobytes(),
                               np.uint8).reshape(A, 8)
    raw[:, 8:10] = np.frombuffer(sweep.tobytes(), np.uint8).reshape(A, 2)
    return raw


def test_oxford_constants_and_decode_equal():
    for k in ("OXFORD_N_AZIMUTHS", "OXFORD_N_BINS", "OXFORD_BIN_WIDTH",
              "OXFORD_HEADER_BYTES"):
        assert getattr(tOX, k) == getattr(jOX, k), k
    raw = _raw_frame(np.random.default_rng(0), np.int64(1547120000123456))
    for down in (1, 2, 4, 7):
        _equal(tOX.decode_radar_png(raw, down), jOX.decode_radar_png(raw, down))


def _gt_csv(path, T=30):
    rng = np.random.default_rng(1)
    stamps = 1547120000000000 + np.arange(T - 1) * 250000
    with open(path, "w") as f:
        f.write("source_timestamp,destination_timestamp,x,y,z,roll,pitch,yaw,"
                "source_radar_timestamp,destination_radar_timestamp\n")
        for k in range(T - 1):
            x, y, yaw = rng.uniform(0.5, 1.5), rng.normal(0, 0.05), rng.normal(0, 0.05)
            f.write(f"{stamps[k]},{stamps[k] + 250000},{x},{y},0.0,0.0,0.0,{yaw},"
                    f"{stamps[k]},{stamps[k] + 250000}\n")


def test_load_gt_radar_odometry_equal(tmp_path):
    csv = str(tmp_path / "radar_odometry.csv")
    _gt_csv(csv)
    _equal(tOX.load_gt_radar_odometry(csv), jOX.load_gt_radar_odometry(csv))


def test_png_directory_converters_equal(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    radar = tmp_path / "radar"
    radar.mkdir()
    rng = np.random.default_rng(3)
    for t in range(3):
        stamp = np.int64(1547120000000000 + t * 250000)
        Image.fromarray(_raw_frame(rng, stamp)).save(radar / f"{int(stamp)}.png")
    for kw in (dict(), dict(max_frames=2, downsample_bins=4)):
        _equal(tuple(tOX.load_png_directory(str(radar), **kw)),
               tuple(jOX.load_png_directory(str(radar), **kw)))
    csv = str(tmp_path / "radar_odometry.csv")
    _gt_csv(csv, T=5)
    for gt in (None, csv):
        a = tOX.convert_png_directory(str(radar), str(tmp_path / "t.npz"), gt_csv=gt)
        b = jOX.convert_png_directory(str(radar), str(tmp_path / "j.npz"), gt_csv=gt)
        assert os.path.basename(a) == "t.npz" and os.path.basename(b) == "j.npz"
        x, y = np.load(a), np.load(b)
        assert sorted(x.files) == sorted(y.files) == sorted(
            ["intensity", "azimuths", "ranges", "stamps"] + (["gt_poses"] if gt else []))
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
        _equal(tuple(tOX.load_npz_sequence(a)), tuple(jOX.load_npz_sequence(b)))


def test_pack_polar_image_is_the_jax_packages():
    """The port's numpy rasterizer against the JAX package's native helper:
    a seeded cloud, rounding ties and NaN or non-positive intensities (the
    JAX package's numpy fallback rounds ties half to even and lets a NaN
    poison its bin, so the library must have built)."""
    from randt_slam_tpu.io import native

    assert native.have_native(), "the JAX package's native library did not build"
    rng = np.random.default_rng(4)
    pts = np.concatenate([_cloud(rng, n=500, rmax=40.0),
                          [[100.0, 0.0, 50.0]]]).astype(np.float32)
    for A, R, bw in ((64, 128, 0.3), (400, 512, 40.0 / 512)):
        _equal(tRB.pack_polar_image(pts, -np.pi, 2 * np.pi / A, A, 0.0, bw, R),
               native.pack_polar_image(pts, -np.pi, 2 * np.pi / A, A, 0.0, bw, R))
    # the serializers and parsers of one cloud
    raw = tRB.serialize_pointcloud2(pts, 3.5)
    assert raw == jRB.serialize_pointcloud2(pts, 3.5)
    _equal(tuple(tRB.parse_pointcloud2(raw)), tuple(jRB.parse_pointcloud2(raw)))

    def both(pts, a0, A, R=4, bw=1.0):
        pts = np.asarray(pts, np.float32)
        args = (a0, 2 * np.pi / A, A, 0.0, bw, R)
        return tRB.pack_polar_image(pts, *args), native.pack_polar_image(pts, *args)

    # the point (1, 1) lies half a step between rows 0 and 1: lround takes 1
    mine, ref = both([[1.0, 1.0, 7.0]], 0.0, 4)
    _equal(mine, ref)
    assert mine[1, 1] == 7.0 and mine[0].max() == 0.0
    # a NaN and a 20.0 in one bin give 20.0; a negative and a zero leave 0
    mine, ref = both([[2.5, 0.0, np.nan], [2.5, 0.0, 20.0], [0.0, 1.5, -3.0],
                      [0.0, -1.5, 0.0], [-1.5, 0.0, np.nan]], 0.0, 4)
    _equal(mine, ref)
    assert mine[0, 2] == 20.0 and not np.isnan(mine).any()
    # every half-step direction, on each side of the wrap, at three origins
    for A in (4, 8, 400):
        ang = (np.arange(2 * A) + 0.5) * np.pi / A
        pts = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang),
                        np.arange(1, 2 * A + 1)], axis=1)
        for a0 in (0.0, -np.pi, np.pi / 3):
            _equal(*both(pts, a0, A))
