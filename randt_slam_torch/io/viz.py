"""ROS-free visualization exports.

A copy of ``randt_slam_tpu/io/viz.py`` (numpy only; the port keeps its own).
Replaces the reference's visualization surface (``ndt_msgs`` wire format +
the RViz marker node, SURVEY.md §2.1 #19-20):

  * :func:`export_normal_distributions` — the ``ndt_msgs/NormalDistributions``
    equivalent (means, covariances, max intensity) as npz/JSON, built from a
    cell batch exactly like ``NDTSlam::createVisualizationMsg``
    (``ndt_slam.cpp:370-393``).
  * :func:`ellipse_parameters` — the covariance -> ellipse conversion the
    RViz visualizer performs (``rviz_visualization.cpp:21-80``): axis lengths
    = 3 * sqrt(eigenvalue), orientation from the eigenvectors, rainbow color
    by mean intensity.
  * :func:`write_pgm` — occupancy grids as portable graymaps.
"""

from __future__ import annotations

import json

import numpy as np


def export_normal_distributions(path, mean, cov, valid, max_intensity=None):
    """Save an NDT map snapshot: fields mirror ``ndt_msgs/NormalDistribution``
    (mean.{x,y,i}; covariance.{xx,xy,xi,yy,yi,ii}; mean_intensity)."""
    mean = np.asarray(mean)[np.asarray(valid)]
    cov = np.asarray(cov)[np.asarray(valid)]
    rec = {
        "mean_x": mean[:, 0], "mean_y": mean[:, 1], "mean_i": mean[:, 2],
        "cov_xx": cov[:, 0, 0], "cov_xy": cov[:, 0, 1], "cov_xi": cov[:, 0, 2],
        "cov_yy": cov[:, 1, 1], "cov_yi": cov[:, 1, 2], "cov_ii": cov[:, 2, 2],
    }
    if max_intensity is not None:
        rec["mean_intensity"] = (
            np.asarray(max_intensity)[np.asarray(valid)] / 100.0
        )
    np.savez_compressed(path, **rec)


def ellipse_parameters(cov2, n_sigma=3.0):
    """(..., 2, 2) covariances -> (half_axis_a, half_axis_b, angle_rad),
    matching the marker scaling of ``rviz_visualization.cpp:60-76``."""
    cov2 = np.asarray(cov2)
    a = cov2[..., 0, 0]
    b = cov2[..., 0, 1]
    d = cov2[..., 1, 1]
    tr, det = a + d, a * d - b * b
    root = np.sqrt(np.maximum(tr * tr / 4 - det, 0.0))
    lam1 = tr / 2 + root
    lam2 = tr / 2 - root
    angle = np.arctan2(lam1 - a, b + 1e-30)
    return n_sigma * np.sqrt(np.maximum(lam1, 0)), \
        n_sigma * np.sqrt(np.maximum(lam2, 0)), angle


def rainbow_color(intensity, lo=0.0, hi=1.0):
    """Rainbow colormap by normalized intensity
    (``rviz_visualization.cpp:145-171`` getRainbowColor)."""
    x = np.clip((np.asarray(intensity) - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    h = (1.0 - x) * 5.0 + 1.0
    i = np.floor(h).astype(int)
    f = h - i
    f = np.where(i % 2 == 0, 1.0 - f, f)
    n = 1.0 - f
    r = np.select([i <= 1, i == 2, i == 3, i == 4, i >= 5],
                  [n, 0.0, 0.0, n, 1.0])
    g = np.select([i <= 1, i == 2, i == 3, i == 4, i >= 5],
                  [0.0, n, 1.0, 1.0, n])
    b = np.select([i <= 1, i == 2, i == 3, i == 4, i >= 5],
                  [1.0, 1.0, n, 0.0, 0.0])
    return np.stack([r, g, b], axis=-1)


def write_pgm(path, grid, lo=-1.0, hi=100.0):
    """Occupancy grid (values in [lo, hi], -1 = unknown) -> 8-bit PGM."""
    g = np.asarray(grid, np.float32)
    img = np.where(
        g < 0, 127, (255 * (1.0 - np.clip(g, 0, hi) / hi)).astype(np.uint8)
    ).astype(np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img[::-1].tobytes())  # y-up


def render_map_png(path, node_pose=None, odom=None,
                   ndt_mean=None, ndt_cov=None, ndt_valid=None,
                   ogm=None, ogm_extent=None, n_sigma=3.0, dpi=150,
                   title=None):
    """Offline renderer of the RViz view (VERDICT r3 missing-3): global OGM
    as the backdrop, NDT covariance ellipses colored rainbow by mean
    intensity (``rviz_visualization.cpp:21-80,145-171``), odometry trace and
    optimized trajectory on top.  All inputs are optional; world frame.

    * ``ogm``: (H, W) occupancy in [0, 100], -1 unknown;
      ``ogm_extent`` = (xmin, xmax, ymin, ymax) meters.
    * ``ndt_mean``/``ndt_cov``/``ndt_valid``: derived cell fields (C, 3...)
      already transformed into the world frame.
    """
    try:
        import matplotlib
    except ImportError as e:  # the optional [viz] extra
        raise ImportError(
            "render_map_png needs matplotlib (install the [viz] extra); "
            "all other exports in io/viz.py are dependency-free") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Ellipse

    fig, ax = plt.subplots(figsize=(10, 10), dpi=dpi)
    if ogm is not None:
        g = np.asarray(ogm, np.float32)
        img = np.where(g < 0, 0.5, 1.0 - np.clip(g, 0, 100) / 100.0)
        ax.imshow(img, cmap="gray", vmin=0.0, vmax=1.0, origin="lower",
                  extent=ogm_extent, interpolation="nearest", zorder=0)
    if ndt_mean is not None:
        mean = np.asarray(ndt_mean)
        cov = np.asarray(ndt_cov)
        v = np.asarray(ndt_valid).astype(bool)
        mean, cov = mean[v], cov[v]
        if len(mean):
            a, b, ang = ellipse_parameters(cov[:, :2, :2], n_sigma=n_sigma)
            inten = mean[:, 2]
            lo, hi = (float(inten.min()), float(max(inten.max(), 1e-6))) \
                if len(inten) else (0.0, 1.0)
            colors = rainbow_color(inten, lo, hi)
            for k in range(len(mean)):
                ax.add_patch(Ellipse(
                    (mean[k, 0], mean[k, 1]), 2 * a[k], 2 * b[k],
                    angle=np.degrees(ang[k]), facecolor=colors[k],
                    edgecolor="none", alpha=0.55, zorder=2))
    if odom is not None and len(odom):
        o = np.asarray(odom)
        ax.plot(o[:, 0], o[:, 1], "-", color="#888888", lw=0.8,
                label="odometry", zorder=3)
    if node_pose is not None and len(node_pose):
        p = np.asarray(node_pose)
        ax.plot(p[:, 0], p[:, 1], "-", color="#d62728", lw=1.4,
                label="trajectory (optimized)", zorder=4)
        ax.plot(p[0, 0], p[0, 1], "o", color="#2ca02c", ms=6, zorder=5)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if title:
        ax.set_title(title)
    if (odom is not None and len(odom)) or (
            node_pose is not None and len(node_pose)):
        ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def export_trajectory_json(path, stamps, poses):
    with open(path, "w") as f:
        json.dump(
            [
                {"stamp": float(t), "x": float(p[0]), "y": float(p[1]),
                 "yaw": float(p[2])}
                for t, p in zip(np.asarray(stamps), np.asarray(poses))
            ],
            f,
        )
