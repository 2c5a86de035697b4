"""Command-line entry point of the PyTorch port.

Replay over a synthetic world or a converted ``.npz`` sequence, with the
exports and metrics of ``randt_slam_tpu/run.py``: full offline SLAM
(odometry, loop closure, pose-graph optimization) by default, odometry alone
with ``--odometry-only``, or online mode with ``--online`` (frames one at a
time, loop search and pose graph on their cadences, the pose graph
re-anchoring the active submap mid-run); TUM + KITTI trajectories
(per-frame odometry and the nodes), ``trajectory.json`` and
``metrics.json`` (``n_loop_closures``, odometry and SLAM ATE/RPE against
ground truth, frames/s, per-phase wall seconds, and ``profile``: the
wall of every span of the run aggregated by name, ``utils/profiling``).  ``--ogm`` writes the global occupancy grid (``ogm.pgm``),
``--export-ndt`` the last submap's NDT cells (``ndt_submap.npz``),
``--render`` the map view (``map.png``; needs matplotlib); ``--ref-yaml``
reads the reference's layered YAML files in place of the preset.
``--checkpoint`` saves the online state every ``--checkpoint-every`` frames
and after the last frame, before the bag-end ``finalize`` (offline: the
final carry); ``--resume`` continues an online run from such a file to the
trajectory the uninterrupted run gives; ``--viz-every`` overwrites
``live/`` with the current map view while an online run goes on.  With
``RANDT_COORDINATOR``, ``RANDT_NUM_PROCESSES`` and ``RANDT_PROCESS_ID`` set
(``parallel/mesh.py``), each process first joins the group as one rank and
prints ``distributed: process i/n, n devices``.

Usage:
    python -m randt_slam_torch.run --input synthetic --config synthetic \\
        --loop --frames 130 --ogm --output /tmp/t [--device cpu]
    python -m randt_slam_torch.run --input synthetic --config synthetic \\
        --loop --frames 130 --online --checkpoint ck.npz --output /tmp/t
"""

from __future__ import annotations

import argparse
import dataclasses
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
    p.add_argument("--ogm", action="store_true",
                   help="render the global OGM (online: also raytrace each "
                        "keyframe as it exits, visualize_ogm)")
    p.add_argument("--online", action="store_true",
                   help="incremental mode with mid-run pose-graph feedback")
    p.add_argument("--viz-every", type=int, default=0,
                   help="--online: every N frames overwrite live/ with the "
                        "current map view (0 = off)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; online: saved every "
                        "--checkpoint-every frames, offline: final carry")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", default=None,
                   help="resume an --online run from a checkpoint file")
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


def submap_cells(cfg, carry):
    """The active submap's derived cells, in its frame and in the world
    frame: numpy (mean, cov, valid, world mean, world cov)."""
    from .ndt import grid as G
    from .registration.matcher import transform_mean_cov

    mu, cov, valid = G.derive_sparse_fields(
        carry.submap, cfg.ndt_map.min_points_per_cell, cfg.ndt_map.cell)
    mu_w, cov_w = transform_mean_cov(carry.submap_origin, mu, cov)
    return [x.cpu().numpy() for x in (mu, cov, valid, mu_w, cov_w)]


def ogm_extent(cfg):
    o = cfg.ogm
    return (-0.5 * o.size_x * o.resolution, 0.5 * o.size_x * o.resolution,
            -0.5 * o.size_y * o.resolution, 0.5 * o.size_y * o.resolution)


def export_live_view(output: str, cfg, engine, with_ogm: bool = False):
    """Periodic online visualization export, the ROS-free stand-in for the
    reference's RViz publishers (``rviz_visualization.cpp:13-18``):
    overwrite ``live/{map.png, ndt_submap.npz, trajectory.json[, ogm.pgm]}``
    with the CURRENT engine state, so a viewer polling the directory watches
    the run as it goes.  ``map.png`` needs matplotlib."""
    import numpy as np

    from .io import viz

    live = os.path.join(output, "live")
    os.makedirs(live, exist_ok=True)
    _, _, valid, mu_w, cov_w = submap_cells(cfg, engine.carry)
    viz.export_normal_distributions(
        os.path.join(live, "ndt_submap.npz"), mu_w, cov_w, valid)
    ogm_grid = extent = None
    if with_ogm and cfg.visualize_ogm and engine._count_grids:
        ogm_grid = engine.render_ogm()
        viz.write_pgm(os.path.join(live, "ogm.pgm"), ogm_grid)
        extent = ogm_extent(cfg)
    node_pose = engine.trajectory()
    odom = (np.stack(engine.odom_trace) if engine.odom_trace
            else np.zeros((0, 3), np.float32))
    viz.export_trajectory_json(os.path.join(live, "trajectory.json"),
                               np.asarray(engine.node_stamp), node_pose)
    viz.render_map_png(
        os.path.join(live, "map.png"), node_pose=node_pose, odom=odom,
        ndt_mean=mu_w, ndt_cov=cov_w, ndt_valid=valid, ogm=ogm_grid,
        ogm_extent=extent,
        title=f"online frame {len(odom)} — {engine.n_loop_edges} loops")


def run_online(args, cfg, frames, device, prof):
    """The online branch of :func:`main`: (engine, OGM or None)."""
    from .io import viz
    from .pipeline import frontend as F
    from .pipeline.online import OnlineSlam

    engine = OnlineSlam(cfg, device=device)
    start = 0
    if args.resume:
        engine.load_checkpoint(args.resume)
        start = engine._frame_count
    T = int(frames.stamp.shape[0])
    with prof.stage("online_total"):
        for t in range(start, T):
            engine.process_frame(F.Frame(*(x[t] for x in frames)))
            if args.checkpoint and (t + 1) % args.checkpoint_every == 0:
                engine.save_checkpoint(args.checkpoint)
            if args.viz_every and (t + 1) % args.viz_every == 0:
                with prof.stage("online_viz"):
                    export_live_view(args.output, cfg, engine, with_ogm=args.ogm)
    # the live state before the bag end: a run resumed from it finalizes as
    # this one does (the JAX CLI saves after ``finalize``)
    if args.checkpoint:
        engine.save_checkpoint(args.checkpoint)
    # bag-end semantics (``ndt_slam.cpp:176-178``): drain the pending loop
    # queue, one final pose graph over every edge and the re-anchoring
    with prof.stage("online_finalize"):
        engine.finalize()
    ogm_grid = None
    if args.ogm:
        with prof.stage("ogm"):
            ogm_grid = engine.render_ogm()
        viz.write_pgm(os.path.join(args.output, "ogm.pgm"), ogm_grid)
    return engine, ogm_grid


def main(argv=None):
    args = build_parser().parse_args(argv)

    # multi-host entry (BASELINE config 5), first as in the JAX CLI: a no-op
    # unless the launcher set RANDT_COORDINATOR, RANDT_NUM_PROCESSES and
    # RANDT_PROCESS_ID; then this process is one rank of the default group,
    # bound to its own card (gloo ranks with --device cpu).  No CLI path
    # shards its work: the sharded paths are library calls with a group.
    import torch.distributed as dist

    from .parallel.mesh import init_distributed

    joined = init_distributed(device=args.device)
    if joined:
        print(f"distributed: process {dist.get_rank()}/{dist.get_world_size()}, "
              f"{dist.get_world_size()} devices")
    try:
        return _run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args):
    import numpy as np

    from . import runtime
    from .io import formats, viz
    from .pipeline import slam
    from .utils.profiling import Profiler

    device = runtime.resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    cfg = load_config(args)
    if args.online and args.ogm:
        cfg = dataclasses.replace(cfg, visualize_ogm=True)
    frames, gt_poses, stamps = load_frames(args, device)
    prof = Profiler()
    t0 = time.perf_counter()
    timings = {}
    ogm_grid = None
    saturation = None
    if args.online:
        engine, ogm_grid = run_online(args, cfg, frames, device, prof)
        carry = engine.carry
        odom = np.stack(engine.odom_trace)
        node_pose, n_loops = engine.trajectory(), engine.n_loop_edges
        node_stamp = np.asarray(engine.node_stamp)
        node_frame = np.asarray(engine.node_frame, np.int64)
    else:
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
        carry, odom, saturation = odo.final_carry, odo.odom_poses, odo.saturation
        node_stamp, node_frame = odo.node_stamp, odo.node_frame
        if args.checkpoint:
            from .utils import checkpoint as CK

            CK.save_carry(args.checkpoint, carry)
    wall = time.perf_counter() - t0
    T = len(odom)

    ndt = None
    if args.export_ndt or args.render:
        # the last submap's cells (the ``/aligned_normal_distribution``
        # topic, ndt_msgs wire format), in its frame for the export and in
        # the world frame for the render
        ndt = submap_cells(cfg, carry)
    if args.export_ndt:
        viz.export_normal_distributions(
            os.path.join(args.output, "ndt_submap.npz"), *ndt[:3])
    if args.render:
        extent = None if ogm_grid is None else ogm_extent(cfg)
        viz.render_map_png(
            os.path.join(args.output, "map.png"), node_pose=node_pose,
            odom=odom, ndt_mean=ndt[3], ndt_cov=ndt[4], ndt_valid=ndt[2],
            ogm=ogm_grid, ogm_extent=extent,
            title=f"{args.input} — {T} frames, {int(n_loops)} loops")

    formats.write_tum(os.path.join(args.output, "odom_tum.txt"), stamps, odom)
    formats.write_kitti(os.path.join(args.output, "odom_kitti.txt"), odom)
    formats.write_tum(os.path.join(args.output, "slam_tum.txt"),
                      node_stamp, node_pose)
    formats.write_kitti(os.path.join(args.output, "slam_kitti.txt"), node_pose)
    viz.export_trajectory_json(os.path.join(args.output, "trajectory.json"),
                               node_stamp, node_pose)

    metrics = {
        "frames": T,
        "wall_s": round(wall, 3),
        "frames_per_second": round(T / wall, 2),
        "device": str(device),
        "n_nodes": int(len(node_pose)),
        "n_loop_closures": int(n_loops),
        "timings": timings,
    }
    if saturation is not None:
        metrics["saturation"] = saturation
    metrics["profile"] = prof.report()
    if gt_poses is not None:
        metrics["odom_ate_m"] = round(formats.ate(odom, gt_poses[:T]), 4)
        metrics["slam_ate_m"] = round(
            formats.ate(node_pose, gt_poses[node_frame]), 4)
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
