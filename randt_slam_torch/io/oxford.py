"""Converted Oxford Radar RobotCar sequences (``.npz``).

Port of ``load_npz_sequence`` from ``randt_slam_tpu/io/oxford.py``: the
canonical interchange format with keys intensity (T, A, R) float16/32,
azimuths (A,), ranges (R,), stamps (T,), optional gt_poses (T, 3) and
imu_yaw (T,).  Converting raw PNG directories stays with the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RadarSequence(NamedTuple):
    intensity: np.ndarray  # (T, A, R) float32
    azimuths: np.ndarray   # (A,)
    ranges: np.ndarray     # (R,)
    stamps: np.ndarray     # (T,) seconds (re-based to 0)
    gt_poses: np.ndarray | None
    imu_yaw: np.ndarray | None = None  # (T,) absolute yaw readings [rad]


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
