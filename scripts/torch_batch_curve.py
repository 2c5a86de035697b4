"""Fleet throughput of the PyTorch port's batched odometry against the batch
size, on one CUDA card.

    python3 scripts/torch_batch_curve.py [--sizes 1,2,4,8,16] [--frames 30]

Renders one Oxford-geometry drive per member (``chip_smoke.render_frames``,
seeds 0, 1, 2, ...; seed 0's first frames are chip_smoke's phase 4 drive),
then runs ``parallel/batch.make_batched_scan`` with the kernel switches on
(``use_pallas_linearize``, ``use_pallas_chol``) over the first B drives for
every B of ``--sizes``, in that order and then in reverse, so that a drift
of the host's speed during the call shows as a gap between the two passes
of one B.  Per run it prints one JSON line: the steady ms per batched frame
and the fleet frames/s (frames 20 to the end, timed inside the run by
``chip_smoke.batch_run``, the device drained at frame 20), the peak device
memory, and the host's CPU clock and load beside them.  Then one line per B
with the two passes' mean, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1,2,4,8,16")
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()
    sizes = [int(x) for x in args.sizes.split(",")]

    import torch

    if not torch.cuda.is_available():
        print("torch_batch_curve: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.ops import build
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    build.build()
    cfg = oxford_config(**CS.SWITCHES_ON)
    t0 = time.perf_counter()
    frames = []
    for seed in range(max(sizes)):
        n = CS.N_RENDER if seed == 0 else args.frames  # seed 0: phase 4's drive
        scans, az, ranges, stamps, _ = CS.render_frames(n, seed=seed)
        frames.append(slam.frames_from_arrays(scans[:args.frames], az, ranges,
                                              stamps[:args.frames], device=dev))
    print(f"rendered {max(sizes)} drives of {args.frames} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def stacked(B):
        return F.Frame(*(torch.stack([fr[k] for fr in frames[:B]])
                         for k in range(len(F.Frame._fields))))

    CS.batch_run(cfg, stacked(1), CS.N_SHORT, dev)  # warm-up
    runs = {}
    for B in sizes + sizes[::-1]:
        _, _, _, ms, fps, peak = CS.batch_run(cfg, stacked(B), CS.N_SHORT, dev)
        runs.setdefault(B, []).append(fps)
        print(json.dumps({"B": B, "ms_per_batched_frame": ms, "fleet_fps": fps,
                          "peak_gib": peak / 2**30, "host": CS.host_cpu()}),
              flush=True)
    for B in sizes:
        mean = sum(runs[B]) / len(runs[B])
        print(f"B={B}: fleet frames/s {mean:.3f} (passes {runs[B][0]:.3f}, "
              f"{runs[B][1]:.3f}), {mean / B:.3f} per sequence, "
              f"{mean / (sum(runs[1]) / 2) if 1 in runs else float('nan'):.2f}x B = 1",
              flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
