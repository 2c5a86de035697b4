"""Where the submap-sharded Schur solve's bits depart from the one-process
solve, in one process: W ranks are emulated by building each rank's slice
of the layout (``graph/schur._prepare`` with the group's size and this
rank's range stood in for) on ``bench.py``'s 4077-node graph.

    python3 scripts/torch_schur_slices.py [cuda|cpu]

Prints, per W in 2, 4, 8 (W rank slices of the 510 submaps):

1. which of the submap pass's results (the blocks A, B, Csep, g_int, g_sep
   of ``_submap_blocks``; the compact Cblk and g_loc and the Cholesky
   factors of ``submap_pass``) are bitwise the full batch's, concatenated
   over the slices, and whether a batched ``cholesky_ex`` of slices is
   bitwise the full batch's;
2. the emulated sharded solve (``optimize_loop``'s steps over the slices,
   the reduced system scattered from the concatenated blocks) against the
   one-process solve, plain least squares at caps of 10 and 100
   iterations: iterations, bitwise or the gap, and both distances to the
   ground truth;
3. at W = 4, how far the gradient scatter ``g_int`` departs (largest
   absolute and relative difference, count of elements).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from randt_slam_torch.config import GlobalFuserConfig  # noqa: E402
from randt_slam_torch.graph import pose_graph as PG  # noqa: E402
from randt_slam_torch.graph import schur  # noqa: E402
from randt_slam_torch.parallel import mesh  # noqa: E402


def slices(g, ns, nr, W):
    """Every rank's layout of a group of W ranks."""
    size, shard = schur._group_size, mesh.shard_range
    schur._group_size = lambda grp: 1 if grp is None else W
    mesh.shard_range = lambda n, grp: (0, n) if grp is None else (
        grp * n // W, (grp + 1) * n // W)
    try:
        return [schur._prepare(g, ns, nr, group=r) for r in range(W)]
    finally:
        schur._group_size, mesh.shard_range = size, shard


def emulated_loop(g, poses, parts, cfg, dev):
    """``schur.optimize_loop`` with each rank's submap pass and
    back-substitution on its slice, the pieces concatenated in rank order
    where the collectives gather them."""
    robust, scale = PG.robust_spec(cfg), cfg.loss_function_scale
    lay = parts[0]
    lam = torch.tensor(1e-6, dtype=poses.dtype).to(dev)
    cost = schur.total_cost(poses, g, robust, scale)
    it = 0
    while it < cfg.max_iterations:
        outs = [schur.submap_pass(poses, g, part, lam, robust, scale) for part in parts]
        C_red, g_red = schur.scatter_reduced(torch.cat([o[0] for o in outs]),
                                             torch.cat([o[1] for o in outs]), lay)
        if lay.ss_idx.numel():
            Css, gss = schur._ss_blocks(poses, g, lay, robust, scale)
            C_red, g_red = C_red + Css, g_red + gss
        dsep = schur.solve_sep(C_red, g_red, lay.sep_free, lam)
        dint = torch.cat([schur.back_substitute(o[2], part, dsep)
                          for o, part in zip(outs, parts)])
        trial = schur.apply_delta(poses, dsep, dint, lay)
        cost_new = schur.total_cost(trial, g, robust, scale)
        accept = cost_new < cost
        step = torch.linalg.vector_norm(dsep) + torch.linalg.vector_norm(dint)
        small = step < cfg.tolerance * (1.0 + torch.linalg.vector_norm(poses))
        done = (accept & small) | ((~accept) & (lam >= 1e7))
        poses = torch.where(accept, trial, poses)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 4.0), 1e-12, 1e8)
        cost = torch.where(accept, cost_new, cost)
        it += 1
        if bool(done):
            break
    return poses, it


def main() -> int:
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    poses, eb, ee, trans, sqrt_i, ns, nr, gt = C.bench_graph(C.SCHUR_NODES)

    def put(x):
        return torch.from_numpy(x).to(dev)

    g = PG.PoseGraph(put(poses), put(eb), put(ee), put(trans), put(sqrt_i),
                     torch.ones(len(eb), dtype=torch.bool, device=dev))
    print(f"device {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
                             else ""), flush=True)
    lam = torch.tensor(1e-6, device=dev)
    full = schur._prepare(g, ns, nr)
    blocks = schur._submap_blocks(g.poses, g, full, None, 1.0)
    Cf, gf, (chf, _, _) = schur.submap_pass(g.poses, g, full, lam, None, 1.0)
    eye = torch.eye(3 * full.I, device=dev)
    A = blocks[0].reshape(full.S, 3 * full.I, 3 * full.I) + eye
    for W in (2, 4, 8):
        parts = slices(g, ns, nr, W)
        outs = [schur.submap_pass(g.poses, g, part, lam, None, 1.0) for part in parts]
        mine = [schur._submap_blocks(g.poses, g, part, None, 1.0) for part in parts]
        S = full.S
        same = {name: torch.equal(torch.cat([m[k] for m in mine])[:S], blocks[k])
                for k, name in enumerate(("A", "B", "Csep", "g_int", "g_sep"))}
        same.update(Cblk=torch.equal(torch.cat([o[0] for o in outs])[:S], Cf),
                    g_loc=torch.equal(torch.cat([o[1] for o in outs])[:S], gf),
                    chol=torch.equal(torch.cat([o[2][0] for o in outs])[:S], chf))
        n = -(-S // W)
        same["cholesky_ex of slices"] = torch.equal(
            torch.cat([torch.linalg.cholesky_ex(A[i:i + n])[0] for i in range(0, S, n)]),
            torch.linalg.cholesky_ex(A)[0])
        print(f"W={W}: {parts[0].S} submaps per rank; bitwise the full batch's: {same}",
              flush=True)
    for cap in (10, 100):
        cfg = dataclasses.replace(GlobalFuserConfig(max_iterations=cap),
                                  dcs_loop_defense=False, use_robust_loss=False)
        ref, _, its = schur.optimize_loop(g.poses, g, full, cfg)
        ref = ref.cpu().numpy()
        print(f"cap {cap}: one process {its} iterations, {C.se2_gap(ref, gt)[0]:.4g} m from "
              f"the ground truth", flush=True)
        for W in (2, 4, 8):
            p, it = emulated_loop(g, g.poses, slices(g, ns, nr, W), cfg, dev)
            p = p.cpu().numpy()
            gap = ("bitwise" if np.array_equal(p, ref)
                   else "{:.4g} m / {:.4g} rad".format(*C.se2_gap(p, ref)))
            print(f"  W={W}: {it} iterations, against one process {gap}, "
                  f"{C.se2_gap(p, gt)[0]:.4g} m from the ground truth", flush=True)
    parts = slices(g, ns, nr, 4)
    gi = torch.cat([schur._submap_blocks(g.poses, g, part, None, 1.0)[3]
                    for part in parts])[:full.S]
    d = (gi - blocks[3]).abs()
    print(f"g_int, W=4 against the full batch: largest difference {float(d.max()):.4g} "
          f"absolute, {float((d / blocks[3].abs().clamp(min=1e-30)).max()):.4g} relative; "
          f"{int((d > 0).sum())} of {d.numel()} elements differ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
