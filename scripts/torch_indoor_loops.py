"""Loop edges of the indoor drive: the readings behind ``chip_smoke.IN_SEED``
and ``N_INDOOR``, and behind the indoor route's shape.

    python3 scripts/torch_indoor_loops.py [--seeds 0 1] [--threads N] [--jax]
        [--device cpu] [--half HX HY] [--lap FRAMES] [--frames N] [--no-port]

Renders ``chip_smoke.render_indoor``'s drive (400 x 400 bins of 3 cm,
136 frames, 1.2 laps of a 22.4 m rounded square, a gyro drifting at 0.02
rad/s) for each seed and runs full SLAM on it at ``indoor_config()`` with
phase 13's settings (the kernel switches on, weight_imu_bias 50), or
on another route (``--half``, ``--lap``, ``--frames``): the
port's ``run_slam`` (frames in host memory, chunks of 48), and with
``--jax`` the JAX package's ``run_slam`` on the CPU.  Prints per run the
accepted loop edges, each edge's error against the rendered ground truth
beside the odometry's error over the same two nodes, the odometry and
post-PGO node ATE and their ratio (phase 13 holds it to 1.05, and each
edge to 0.5 m), the largest heading error of the odometry, and the newest
bias state.  The port runs on ``--device`` (default cuda); ``--no-port``
runs the JAX package alone.  A run takes ~100 s of the port and ~30 s of
the JAX package on 4 CPU threads.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def report(label, odo, loops, node_opt, gt, wall):
    from chip_smoke import se2_relative
    from randt_slam_torch.io import formats

    node_frame = np.asarray(odo.node_frame)
    node_pose = np.asarray(odo.node_pose)
    ng = gt[node_frame]
    a0 = formats.ate(node_pose, ng)
    a1 = formats.ate(np.asarray(node_opt), ng)
    bias = float(np.asarray(odo.final_carry.states)[-1, 8])
    odom = np.asarray(odo.odom_poses)
    yaw = np.abs(np.angle(np.exp(1j * (odom[:, 2] - gt[:, 2]))))
    print(f"{label}: {wall:.1f} s; {int(loops.n_accepted)} loop edges; odometry ATE "
          f"{formats.ate(odom, gt):.4f} m, heading error at most {yaw.max():.4f} rad "
          f"(frame {int(yaw.argmax())}); node ATE {a0:.4f} m, "
          f"after the pose graph {a1:.4f} m ({a1 / a0:.3f} x); bias {bias:.5f} rad/s",
          flush=True)
    for b, e, t in zip(np.asarray(loops.edge_begin), np.asarray(loops.edge_end),
                       np.asarray(loops.edge_trans)):
        g = se2_relative(ng[b], ng[e])
        o = se2_relative(node_pose[b], node_pose[e])
        print(f"  edge {b}-{e}: loop {np.abs(t[:2] - g[:2]).max():.4f} m "
              f"{abs(float(np.angle(np.exp(1j * (t[2] - g[2]))))):.4f} rad; odometry "
              f"{np.abs(o[:2] - g[:2]).max():.4f} m "
              f"{abs(float(np.angle(np.exp(1j * (o[2] - g[2]))))):.4f} rad", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--half", type=float, nargs=2, default=None,
                    help="the route's straights over its corner radius "
                         "(scripts/indoor_sim.py's is 3 1)")
    ap.add_argument("--lap", type=int, default=None, help="frames a lap")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--no-port", action="store_true",
                    help="run the JAX package alone (with --jax)")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from randt_slam_torch.config import indoor_config
    from randt_slam_torch.pipeline import slam

    if args.threads:
        torch.set_num_threads(args.threads)
    settings = dict(cs.SWITCHES_ON, **cs.BIAS_WEIGHT)
    for seed in args.seeds:
        scans, az, ranges, stamps, imu, gt = cs.render_indoor(
            n_frames=args.frames or cs.N_INDOOR, lap_frames=args.lap or cs.INDOOR_LAP,
            seed=seed, half=tuple(args.half) if args.half else cs.ROUTE_HALF)
        if not args.no_port:
            t0 = time.perf_counter()
            frames = slam.frames_from_arrays(scans, az, ranges, stamps, imu_yaw=imu,
                                             host=True)
            res = slam.run_slam(indoor_config(**settings), frames, device=args.device,
                                chunk=cs.IN_CHUNK)
            report(f"seed {seed}, port ({args.device or 'cuda'})", res.odometry,
                   res.loops, res.node_pose_optimized, gt, time.perf_counter() - t0)
        if args.jax:
            from randt_slam_tpu.config import indoor_config as j_indoor
            from randt_slam_tpu.pipeline import slam as jS

            t0 = time.perf_counter()
            jres = jS.run_slam(j_indoor(**settings), jS.frames_from_arrays(
                scans, az, ranges, stamps, imu_yaw=imu))
            report(f"seed {seed}, JAX package (CPU)", jres.odometry, jres.loops,
                   jres.node_pose_optimized, gt, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
