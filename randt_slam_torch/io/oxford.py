"""Oxford Radar RobotCar ingestion.

Port of ``randt_slam_tpu/io/oxford.py`` (numpy; the port imports nothing of
the JAX package), held equal to it by ``tests/test_torch_io.py``.  The raw
dataset ships radar frames as polar intensity PNGs, the ``PolarScan`` format
the preprocessor consumes: one PNG per scan, 400 rows (azimuths) x (11 +
3768) columns of uint8; the first 11 bytes per row encode the UNIX
timestamp (8), sweep counter (2), and valid flag (1); the remaining 3768
bytes are power returns at 4.32 cm bins, exported as ``uint8 * 1.0``
(``min_intensity: 70`` of ``parameters_oxford.yaml`` implies raw power
units).  :func:`convert_png_directory` turns a ``radar/`` directory (and
the dataset's ``gt/radar_odometry.csv``) into the canonical ``.npz``
interchange format; :func:`load_npz_sequence` reads it (keys: intensity
(T, A, R) float16/32, azimuths (A,), ranges (R,), stamps (T,), optional
gt_poses (T, 3) and imu_yaw (T,)).  Only :func:`load_png_directory` needs
PIL, imported when it is called.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

OXFORD_N_AZIMUTHS = 400
OXFORD_N_BINS = 3768
OXFORD_BIN_WIDTH = 0.0432  # meters
OXFORD_HEADER_BYTES = 11


class RadarSequence(NamedTuple):
    intensity: np.ndarray  # (T, A, R) float32
    azimuths: np.ndarray   # (A,)
    ranges: np.ndarray     # (R,)
    stamps: np.ndarray     # (T,) seconds (re-based to 0)
    gt_poses: np.ndarray | None
    imu_yaw: np.ndarray | None = None  # (T,) absolute yaw readings [rad]


def decode_radar_png(data: np.ndarray, downsample_bins: int = 1):
    """Decode one raw Oxford radar frame already loaded as a (400, 3779)
    uint8 array (PNG decoding itself is the caller's concern; PIL/cv2 both
    work).  Returns (intensity (400, R), azimuths (400,), timestamps (400,))."""
    assert data.shape[0] == OXFORD_N_AZIMUTHS
    header = data[:, :OXFORD_HEADER_BYTES]
    power = data[:, OXFORD_HEADER_BYTES:].astype(np.float32)
    stamps = header[:, :8].copy().view(np.int64).reshape(-1) * 1e-6
    sweep = header[:, 8:10].copy().view(np.uint16).reshape(-1)
    azimuths = sweep.astype(np.float32) / 2800.0 * np.pi - np.pi
    if downsample_bins > 1:
        R = power.shape[1] // downsample_bins * downsample_bins
        power = power[:, :R].reshape(
            OXFORD_N_AZIMUTHS, -1, downsample_bins
        ).max(axis=2)
    return power, azimuths, stamps


def load_npz_sequence(path: str, max_frames: int | None = None) -> RadarSequence:
    """Load a converted sequence."""
    data = np.load(path)
    T = data["intensity"].shape[0]
    if max_frames is not None:
        T = min(T, max_frames)
    stamps = np.asarray(data["stamps"][:T], np.float64)
    stamps = (stamps - stamps[0]).astype(np.float32)
    return RadarSequence(
        intensity=np.asarray(data["intensity"][:T], np.float32),
        azimuths=np.asarray(data["azimuths"], np.float32),
        ranges=np.asarray(data["ranges"], np.float32),
        stamps=stamps,
        gt_poses=np.asarray(data["gt_poses"][:T], np.float32)
        if "gt_poses" in data else None,
        imu_yaw=np.asarray(data["imu_yaw"][:T], np.float32)
        if "imu_yaw" in data else None,
    )


def load_gt_radar_odometry(csv_path: str) -> tuple:
    """Parse the Oxford dataset's ``gt/radar_odometry.csv``.

    Each row holds the relative SE(3) motion between consecutive radar scans
    (columns include x, y, z, roll, pitch, yaw and the source/destination
    radar timestamps).  Returns (stamps (T,), gt_poses (T, 3)) with the
    relative planar motions composed into absolute SE(2) poses, first pose =
    identity at the first source timestamp.
    """
    data = np.genfromtxt(csv_path, delimiter=",", names=True)
    dx = np.asarray(data["x"], np.float64)
    dy = np.asarray(data["y"], np.float64)
    dyaw = np.asarray(data["yaw"], np.float64)
    # radar timestamps if present (the dataset ships both UNIX and radar
    # clock columns); fall back to the generic source timestamp
    for key in ("source_radar_timestamp", "source_timestamp"):
        if key in (data.dtype.names or ()):
            t0 = np.asarray(data[key], np.float64)
            break
    else:  # pragma: no cover - malformed file
        raise ValueError("no timestamp column in radar_odometry.csv")
    T = len(dx) + 1
    poses = np.zeros((T, 3), np.float64)
    for k in range(len(dx)):
        x, y, th = poses[k]
        c, s = np.cos(th), np.sin(th)
        poses[k + 1, 0] = x + c * dx[k] - s * dy[k]
        poses[k + 1, 1] = y + s * dx[k] + c * dy[k]
        poses[k + 1, 2] = np.arctan2(np.sin(th + dyaw[k]), np.cos(th + dyaw[k]))
    stamps = np.concatenate([t0, t0[-1:] + (t0[-1] - t0[-2])]) * 1e-6
    return stamps.astype(np.float64), poses.astype(np.float32)


def convert_png_directory(radar_dir: str, out_npz: str,
                          gt_csv: str | None = None,
                          max_frames: int | None = None,
                          downsample_bins: int = 2) -> str:
    """Convert a raw Oxford sequence (``radar/`` PNG directory + optional
    ``gt/radar_odometry.csv``) into the canonical ``.npz`` interchange format
    consumed by ``randt_slam_torch.run --input seq.npz``.

    Ground-truth poses are nearest-stamp-associated to the radar frames.
    """
    seq = load_png_directory(radar_dir, max_frames=max_frames,
                             downsample_bins=downsample_bins)
    payload = dict(intensity=seq.intensity.astype(np.float16),
                   azimuths=seq.azimuths, ranges=seq.ranges,
                   stamps=seq.stamps)
    if gt_csv is not None:
        gt_stamps, gt_poses = load_gt_radar_odometry(gt_csv)
        gt_stamps = gt_stamps - gt_stamps[0]
        idx = np.clip(np.searchsorted(gt_stamps, seq.stamps), 0,
                      len(gt_poses) - 1)
        payload["gt_poses"] = gt_poses[idx]
    np.savez_compressed(out_npz, **payload)
    return out_npz


def load_png_directory(radar_dir: str, max_frames: int | None = None,
                       downsample_bins: int = 2) -> RadarSequence:
    """Load a raw Oxford ``radar/`` directory of per-frame PNGs (requires
    PIL).  Range bins are max-pooled by ``downsample_bins``.

    The default is 2 (8.64 cm bins): the Oxford preprocessor config gates
    peak-run expansion at ``beam_distance_increment_threshold: 0.12`` m
    between adjacent returns (``parameters_oxford.yaml:102``), so bins wider
    than 0.12 m (e.g. the previous 4x = 17.3 cm default) would break every
    run at the peak and starve cells of points."""
    from PIL import Image  # noqa: deferred; optional dependency

    files = sorted(
        f for f in os.listdir(radar_dir) if f.endswith(".png")
    )
    if max_frames is not None:
        files = files[:max_frames]
    frames, stamps = [], []
    azimuths = None
    for f in files:
        arr = np.asarray(Image.open(os.path.join(radar_dir, f)))
        power, az, ts = decode_radar_png(arr, downsample_bins)
        frames.append(power)
        stamps.append(ts.mean())
        azimuths = az
    ranges = (
        (np.arange(frames[0].shape[1]) + 0.5)
        * OXFORD_BIN_WIDTH * downsample_bins
    ).astype(np.float32)
    stamps = np.asarray(stamps, np.float64)
    return RadarSequence(
        intensity=np.stack(frames),
        azimuths=azimuths.astype(np.float32),
        ranges=ranges,
        stamps=(stamps - stamps[0]).astype(np.float32),
        gt_poses=None,
    )
