"""Device time of the PyTorch port's switches-on LM solve, on one CUDA card.

    python3 scripts/torch_lm_profile.py [TREE ...]

For each TREE (a checkout of the repository; default: this one), in a fresh
process, render 12 Oxford-geometry frames with ``chip_smoke.render_frames``,
run the switches-on odometry (``use_pallas_linearize``, ``use_pallas_chol``)
once over 4 frames to build and warm up, then profile its first two frames
(one solved) twice with ``chip_smoke.profile_window`` and print, per
profile: the device busy time of the window, the ``randt.lm_solve`` and
``randt.scan_ndt`` layers' host and device time, and the device time and
launch count of the hand-written LM-loop kernels (K3a, K3b, K4) and of the
scan NDT's K2 by name.

Each tree runs its own ``randt_slam_torch`` under this checkout's
``chip_smoke`` (one instrument for all), so two commits compare in one call
on one card: unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists and pass the trees in the order parent, change,
change, parent.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RENDER = 12
KERNELS = ("chol_solve", "robust_cost", "linearize_kernel", "topi_moments")


def profile_tree(tree: str) -> None:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    sys.path.insert(0, tree)  # chip_smoke imports the port lazily: the tree's
    import randt_slam_torch
    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.pipeline import slam

    if not randt_slam_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {randt_slam_torch.__file__}, not {tree}'s")
    cfg = oxford_config(**CS.SWITCHES_ON)
    scans, az, ranges, stamps, _ = CS.render_frames(N_RENDER)
    frames = slam.frames_from_arrays(scans, az, ranges, stamps, device="cuda")
    slam.run_odometry(cfg, type(frames)(*(x[:4] for x in frames)), device="cuda")
    first_two = type(frames)(*(x[:2] for x in frames))
    for rep in range(2):
        _, wall, rows, total, layers = CS.profile_window(
            lambda: slam.run_odometry(cfg, first_two, device="cuda"))
        calls, host_us, dev_us = layers["randt.lm_solve"]
        _, scan_host_us, scan_dev_us = layers["randt.scan_ndt"]
        kernels = {name[:name.rfind("(")].removeprefix("void "): (round(us, 1), n)
                   for us, n, name in rows if any(k in name for k in KERNELS)}
        print(f"{tree} profile {rep}: wall {wall * 1e3:.1f} ms, device busy "
              f"{total / 1e3:.3f} ms; randt.lm_solve (one solved frame) host "
              f"{host_us / 1e3:.2f} ms, device {dev_us / 1e3:.3f} ms; randt.scan_ndt "
              f"(two frames) host {scan_host_us / 1e3:.2f} ms, device "
              f"{scan_dev_us:.1f} us; kernels (us, launches) {kernels}", flush=True)


def main() -> int:
    trees = [os.path.abspath(t) for t in sys.argv[1:]] or [ROOT]
    if len(trees) == 1:
        import torch

        if not torch.cuda.is_available():
            print("torch_lm_profile: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(), flush=True)
        profile_tree(trees[0])
        return 0
    for tree in trees:  # one process per tree: each imports its own package
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), tree]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
