"""CPU readings behind ``chip_smoke.SCHUR_BAND``.

    python3 scripts/torch_schur_band.py [--nodes 4077] [--threads N] [--jax]

Solves the JAX package's ``bench.py`` pose graph (``chip_smoke.bench_graph``)
with the shipped ``GlobalFuserConfig()`` (the two-stage DCS schedule) on the
CPU, through the port's ``schur.optimize_auto`` twice: with the submap
structure (the Schur route above 2048 nodes) and without it (the dense
route).  Prints each solve's route, iterations (second stage), wall seconds
and largest position / heading gap to the ground truth, and the gap between
the two solves.  ``--jax`` also runs the JAX package's ``optimize_auto``
with the submap structure (its Schur route) and prints its gap to the
ground truth and to the port's Schur solve.

The dense route at 4077 nodes factors a 12231 x 12231 float32 system per
iteration: minutes on a few CPU cores, about 3 GB of memory.  Readings move
with the thread count (LAPACK's blocking), so the band is twice the larger
of several runs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nodes", type=int, default=4077)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()

    import torch

    from chip_smoke import bench_graph, se2_gap
    from randt_slam_torch.config import GlobalFuserConfig
    from randt_slam_torch.graph import pose_graph as PG
    from randt_slam_torch.graph import schur

    if args.threads:
        torch.set_num_threads(args.threads)
    poses, eb, ee, trans, sqrt_i, node_submap, node_is_root, gt = bench_graph(args.nodes)
    g = PG.PoseGraph(*(torch.from_numpy(x) for x in (poses, eb, ee, trans, sqrt_i)),
                     torch.ones(len(eb), dtype=torch.bool))
    out = {}
    for name, kw in (("schur", dict(node_submap=node_submap, node_is_root=node_is_root)),
                     ("dense", {})):
        t0 = time.perf_counter()
        p, info = schur.optimize_auto(g, GlobalFuserConfig(), **kw)
        out[name] = p.numpy()
        gap = se2_gap(out[name], gt)
        print(f"{name}: route {info['solver']}, {info['iterations']} iterations in the "
              f"second stage, {time.perf_counter() - t0:.1f} s on {torch.get_num_threads()} "
              f"threads; from the ground truth {gap[0]:.3e} m / {gap[1]:.3e} rad",
              flush=True)
    gap = se2_gap(out["schur"], out["dense"])
    print(f"schur against dense: {gap[0]:.3e} m / {gap[1]:.3e} rad", flush=True)
    if args.jax:
        import jax.numpy as jnp

        from randt_slam_tpu.config import GlobalFuserConfig as jGFC
        from randt_slam_tpu.graph import pose_graph as jPG
        from randt_slam_tpu.graph import schur as jschur

        jg = jPG.PoseGraph(jnp.asarray(poses), jnp.asarray(eb, jnp.int32),
                           jnp.asarray(ee, jnp.int32), jnp.asarray(trans),
                           jnp.asarray(sqrt_i), jnp.ones(len(eb), bool))
        p, info = jschur.optimize_auto(jg, jGFC(), node_submap=node_submap,
                                       node_is_root=node_is_root)
        p = np.asarray(p)
        a, b = se2_gap(p, gt), se2_gap(p, out["schur"])
        print(f"JAX package: route {info['solver']}, {int(info['iterations'])} "
              f"iterations in the second stage; from the ground truth {a[0]:.3e} m / "
              f"{a[1]:.3e} rad; from the port's Schur solve {b[0]:.3e} m / {b[1]:.3e} rad",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
