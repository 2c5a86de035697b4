"""Online SLAM's frame time and device memory per tree, on one CUDA card.

    python3 scripts/torch_online_ab.py [TREE ...]

For each TREE (a checkout of the repository; default: this one), in a fresh
process, render ``chip_smoke.py``'s looping drive (phase 7's: 240 frames,
1.5 laps), put its first N_FRAMES frames on the card, and run the tree's
``OnlineSlam`` over them with chip_smoke phase 10's settings (switches on,
default cadences, the online OGM), after a warm-up run of WARM frames that
builds the kernels.  It prints the steady ms per frame (frames 20 to the
end, timed inside the run), the median of the engine's step stage, the
peak device memory over the run and, where the tree's engine reports it,
where its counting grids are.

Each tree runs its own ``randt_slam_torch`` under this checkout's
``chip_smoke`` (one instrument for all), so two commits compare in one call
on one card: unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists and pass the trees in the order parent, change,
change, parent.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 100
WARM = 3
STEADY_FROM = 20


def run_tree(tree: str) -> None:
    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    sys.path.insert(0, tree)  # chip_smoke imports the port lazily: the tree's
    import randt_slam_torch
    import torch
    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam
    from randt_slam_torch.pipeline.online import OnlineSlam

    if not randt_slam_torch.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {randt_slam_torch.__file__}, not {tree}'s")
    cfg = dataclasses.replace(oxford_config(**CS.SWITCHES_ON), visualize_ogm=True)
    scans, az, ranges, stamps, _ = CS.render_frames(CS.N_LOOP, seed=2, laps=CS.LOOP_LAPS)
    frames = slam.frames_from_arrays(scans[:N_FRAMES], az, ranges, stamps[:N_FRAMES],
                                     device="cuda")

    def run(n):
        eng = OnlineSlam(cfg, device="cuda")
        marks = []
        for t in range(n):
            marks.append(time.perf_counter())
            eng.process_frame(F.Frame(*(x[t] for x in frames)))
        torch.cuda.synchronize()
        return eng, marks, time.perf_counter()

    run(WARM)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng, marks, t_end = run(N_FRAMES)
    steady = (t_end - marks[STEADY_FROM]) / (N_FRAMES - STEADY_FROM) * 1e3
    step = float(np.median(eng.stage_walls["step"])) * 1e3
    place = eng.grid_placement() if hasattr(eng, "grid_placement") else (
        f"{len(eng._count_grids)} grids on the card")
    print(f"{tree}: online over {N_FRAMES} frames: steady (frames {STEADY_FROM}.."
          f"{N_FRAMES - 1}) {steady:.1f} ms/frame, step median {step:.1f} ms; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"counting grids {place}", flush=True)


def main() -> int:
    trees = [os.path.abspath(t) for t in sys.argv[1:]] or [ROOT]
    if len(trees) == 1:
        import torch

        if not torch.cuda.is_available():
            print("torch_online_ab: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(), flush=True)
        run_tree(trees[0])
        return 0
    for tree in trees:  # one process per tree: each imports its own package
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), tree]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
