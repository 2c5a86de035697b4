"""Command-line entry point of the PyTorch port (offline SLAM).

Offline replay over a synthetic world or a converted ``.npz`` sequence, with
the exports and metrics of ``randt_slam_tpu/run.py``: full SLAM (odometry,
loop closure, pose-graph optimization) by default, odometry alone with
``--odometry-only``; TUM + KITTI trajectories (per-frame odometry and the
nodes), ``trajectory.json`` and ``metrics.json`` (``n_loop_closures``,
odometry and SLAM ATE/RPE against ground truth, frames/s, per-phase wall
seconds).  ``--ogm`` writes the global occupancy grid (``ogm.pgm``, full
SLAM only), ``--export-ndt`` the last submap's NDT cells
(``ndt_submap.npz``), ``--render`` the map view (``map.png``; needs
matplotlib); ``--ref-yaml`` reads the reference's layered YAML files in
place of the preset.

Usage:
    python -m randt_slam_torch.run --input synthetic --config synthetic \\
        --loop --frames 130 --ogm --output /tmp/t [--device cpu]

Online mode (``--online``) and checkpoints (``--checkpoint``) arrive in a
later slice of the port; asking for them exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True,
                   help="'synthetic' or path to a converted .npz sequence")
    p.add_argument("--config", default="oxford",
                   choices=["oxford", "indoor", "synthetic"],
                   help="configuration preset")
    p.add_argument("--ref-yaml", nargs="*", default=None,
                   help="reference-style layered YAML files (override preset)")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--frames", type=int, default=None, help="frame cap")
    p.add_argument("--odometry-only", action="store_true",
                   help="skip loop closure and pose-graph optimization")
    p.add_argument("--loop", action="store_true",
                   help="synthetic: closed-loop trajectory")
    p.add_argument("--ogm", action="store_true", help="render the global OGM")
    p.add_argument("--online", action="store_true",
                   help="incremental mode (later slice)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file (later slice)")
    p.add_argument("--render", action="store_true",
                   help="write map.png: OGM backdrop (with --ogm), NDT covariance "
                        "ellipses, odometry and optimized trajectory")
    p.add_argument("--export-ndt", action="store_true",
                   help="export the final submap's NDT cells "
                        "(NormalDistributions-equivalent npz)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default cuda (which must exist)")
    return p


def load_config(args):
    from . import config as CFG

    if args.ref_yaml:
        return CFG.from_reference_yaml(*args.ref_yaml)
    if args.config == "oxford":
        return CFG.oxford_config()
    if args.config == "indoor":
        return CFG.indoor_config()
    return CFG.synthetic_config()


def load_frames(args, device):
    from .io import oxford, synthetic
    from .pipeline import slam

    if args.input == "synthetic":
        seq = synthetic.generate(seed=args.seed, n_frames=args.frames or 120,
                                 n_azimuths=256, n_bins=256, loop=args.loop)
    else:
        seq = oxford.load_npz_sequence(args.input, max_frames=args.frames)
    frames = slam.frames_from_arrays(
        seq.intensity, seq.azimuths, seq.ranges, seq.stamps,
        imu_yaw=seq.imu_yaw, device=device,
    )
    return frames, seq.gt_poses, seq.stamps


def main(argv=None):
    args = build_parser().parse_args(argv)
    later = [flag for flag, on in (("--online", args.online),
                                   ("--checkpoint", args.checkpoint)) if on]
    if later:
        print(f"randt_slam_torch.run: {', '.join(later)} arrives in a later "
              "slice of the port", file=sys.stderr)
        return 2

    import numpy as np

    from . import runtime
    from .io import formats, viz
    from .pipeline import slam

    device = runtime.resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    cfg = load_config(args)
    frames, gt_poses, stamps = load_frames(args, device)
    t0 = time.perf_counter()
    timings = {}
    ogm_grid = None
    if args.odometry_only:
        odo = slam.run_odometry(cfg, frames, device=device)
        node_pose, n_loops = odo.node_pose, 0
    else:
        res = slam.run_slam(cfg, frames, device=device)
        odo = res.odometry
        node_pose, n_loops = res.node_pose_optimized, res.loops.n_accepted
        timings = {k: v for k, v in res.timings.items()
                   if isinstance(v, float)}
        timings.update({f"loops.{k}": v for k, v in res.loops.timings.items()})
        if args.ogm:
            t1 = time.perf_counter()
            ogm_grid, _ = slam.render_ogm(cfg, res, frames, device=device)
            timings["ogm_s"] = round(time.perf_counter() - t1, 3)
            viz.write_pgm(os.path.join(args.output, "ogm.pgm"), ogm_grid)
    wall = time.perf_counter() - t0
    odom = odo.odom_poses
    T = len(odom)

    ndt = None
    if args.export_ndt or args.render:
        # the last submap's cells (the ``/aligned_normal_distribution``
        # topic, ndt_msgs wire format), in its frame for the export and in
        # the world frame for the render
        from .ndt import grid as G
        from .registration.matcher import transform_mean_cov

        carry = odo.final_carry
        mu, cov, valid = G.derive_sparse_fields(
            carry.submap, cfg.ndt_map.min_points_per_cell, cfg.ndt_map.cell)
        mu_w, cov_w = transform_mean_cov(carry.submap_origin, mu, cov)
        ndt = [x.cpu().numpy() for x in (mu, cov, valid, mu_w, cov_w)]
    if args.export_ndt:
        viz.export_normal_distributions(
            os.path.join(args.output, "ndt_submap.npz"), *ndt[:3])
    if args.render:
        o = cfg.ogm
        extent = None if ogm_grid is None else (
            -0.5 * o.size_x * o.resolution, 0.5 * o.size_x * o.resolution,
            -0.5 * o.size_y * o.resolution, 0.5 * o.size_y * o.resolution)
        viz.render_map_png(
            os.path.join(args.output, "map.png"), node_pose=node_pose,
            odom=odom, ndt_mean=ndt[3], ndt_cov=ndt[4], ndt_valid=ndt[2],
            ogm=ogm_grid, ogm_extent=extent,
            title=f"{args.input} — {T} frames, {int(n_loops)} loops")

    formats.write_tum(os.path.join(args.output, "odom_tum.txt"), stamps, odom)
    formats.write_kitti(os.path.join(args.output, "odom_kitti.txt"), odom)
    formats.write_tum(os.path.join(args.output, "slam_tum.txt"),
                      odo.node_stamp, node_pose)
    formats.write_kitti(os.path.join(args.output, "slam_kitti.txt"), node_pose)
    viz.export_trajectory_json(os.path.join(args.output, "trajectory.json"),
                               odo.node_stamp, node_pose)

    metrics = {
        "frames": T,
        "wall_s": round(wall, 3),
        "frames_per_second": round(T / wall, 2),
        "device": str(device),
        "n_nodes": int(len(node_pose)),
        "n_loop_closures": int(n_loops),
        "saturation": odo.saturation,
        "timings": timings,
    }
    if gt_poses is not None:
        metrics["odom_ate_m"] = round(formats.ate(odom, gt_poses[:T]), 4)
        metrics["slam_ate_m"] = round(
            formats.ate(node_pose, gt_poses[odo.node_frame]), 4)
        t_rpe, r_rpe = formats.rpe(odom, gt_poses[:T])
        metrics["odom_rpe_m"] = round(t_rpe, 4)
        metrics["odom_rpe_deg"] = round(r_rpe, 4)
        kt, kr = formats.kitti_drift(odom, gt_poses[:T])
        metrics["odom_kitti_trans_pct"] = round(kt, 4)
        metrics["odom_kitti_rot_degp100m"] = round(kr, 4)
    # NaN (e.g. KITTI drift on paths shorter than 100 m) is not valid JSON
    metrics = {k: (None if isinstance(v, float) and np.isnan(v) else v)
               for k, v in metrics.items()}
    with open(os.path.join(args.output, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
