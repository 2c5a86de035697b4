"""Trajectory export and error metrics (TUM / KITTI conventions).

The reference's published numbers come from the external
``radar_kitti_benchmark`` pipeline (``oxford-dataset.md:71-103``); this module
provides the same headline metrics in-repo so synthetic and real runs can be
scored without ROS: ATE after SE(2) alignment, relative pose error, and
KITTI-style translational/rotational drift over distance segments.
"""

from __future__ import annotations

import numpy as np


def umeyama_se2(est_xy, gt_xy):
    """Best rigid SE(2) alignment est -> gt (no scale)."""
    mu_e = est_xy.mean(axis=0)
    mu_g = gt_xy.mean(axis=0)
    E = est_xy - mu_e
    G = gt_xy - mu_g
    H = E.T @ G
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    Rm = Vt.T @ D @ U.T
    t = mu_g - Rm @ mu_e
    return Rm, t


def ate(est_poses, gt_poses, align=True):
    """RMS absolute trajectory error [m] after rigid alignment."""
    est_xy = np.asarray(est_poses)[:, :2]
    gt_xy = np.asarray(gt_poses)[:, :2]
    if align:
        Rm, t = umeyama_se2(est_xy, gt_xy)
        est_xy = est_xy @ Rm.T + t
    err = np.linalg.norm(est_xy - gt_xy, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def _rel(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    dth = np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))
    return np.array([c * dx + s * dy, -s * dx + c * dy, dth])


def rpe(est_poses, gt_poses, delta=1):
    """Mean relative pose error (translation [m], rotation [deg]) at frame
    offset ``delta``."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    terr, rerr = [], []
    for i in range(len(est) - delta):
        de = _rel(est[i], est[i + delta])
        dg = _rel(gt[i], gt[i + delta])
        terr.append(np.linalg.norm(de[:2] - dg[:2]))
        dth = np.arctan2(np.sin(de[2] - dg[2]), np.cos(de[2] - dg[2]))
        rerr.append(abs(dth))
    return float(np.mean(terr)), float(np.degrees(np.mean(rerr)))


def kitti_drift(est_poses, gt_poses, segment_lengths=(100, 200, 300, 400, 500, 600, 700, 800)):
    """KITTI odometry metric: mean translational drift [%] and rotational
    drift [deg/100m] over trajectory segments of the given lengths."""
    est = np.asarray(est_poses, dtype=np.float64)
    gt = np.asarray(gt_poses, dtype=np.float64)
    step = np.linalg.norm(np.diff(gt[:, :2], axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(step)])
    t_errs, r_errs = [], []
    for L in segment_lengths:
        starts = np.arange(0, len(gt), max(1, len(gt) // 200))
        for i in starts:
            target = cum[i] + L
            j = np.searchsorted(cum, target)
            if j >= len(gt):
                continue
            de = _rel(est[i], est[j])
            dg = _rel(gt[i], gt[j])
            t_errs.append(np.linalg.norm(de[:2] - dg[:2]) / L * 100.0)
            dth = np.arctan2(np.sin(de[2] - dg[2]), np.cos(de[2] - dg[2]))
            r_errs.append(np.degrees(abs(dth)) / L * 100.0)
    if not t_errs:
        return float("nan"), float("nan")
    return float(np.mean(t_errs)), float(np.mean(r_errs))


def write_tum(path, stamps, poses):
    """TUM format: stamp x y z qx qy qz qw (2-D: z=0, yaw-only quaternion)."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for t, p in zip(stamps, poses):
            qw, qz = np.cos(p[2] / 2.0), np.sin(p[2] / 2.0)
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} 0.0 0.0 0.0 {qz:.6f} {qw:.6f}\n")


def write_kitti(path, poses):
    """KITTI format: rows of the 3x4 world-from-body matrix."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for p in poses:
            c, s = np.cos(p[2]), np.sin(p[2])
            m = [c, -s, 0.0, p[0], s, c, 0.0, p[1], 0.0, 0.0, 1.0, 0.0]
            f.write(" ".join(f"{v:.9f}" for v in m) + "\n")
