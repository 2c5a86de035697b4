"""Device time of the LM iteration's own kernels (``ops/lm_step``) alone, on
one CUDA card, against their plain versions and their byte bounds.

    python3 scripts/torch_lm_step_timing.py [--reps N] [--out FILE]

For B in (1, 8, 512) windows at ``oxford_config()``'s matcher (W = 3, P =
36; random iterations as ``tests/test_torch_kernels_cuda._lm_inputs`` makes
them), ``lm_assemble``, ``lm_trial`` and ``lm_accept`` are each launched
``--reps`` times in a row under ``torch.profiler``: the mean device time of
a launch (CUPTI), the wall per call of its plain version (CUDA events
around ``--reps`` calls), the bytes the kernel must move (its inputs read
once and its outputs written once) and what they take at the card's
3.35 TB/s.  Then one whole LM iteration at B = 512 with the Oxford
fleet's pair count (N = 2 x 512 x 2 pairs a slot): K3a, lm_assemble, K4,
lm_trial, K3b, lm_accept, their device times per launch in the same
profile.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12


def device_us(fn, reps, names):
    """Mean device time (us) of each kernel in ``names`` over ``reps``
    calls of ``fn``, from the profiler's kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in trace.device_work(trace.collect(prof)):
        for n in names:
            if n in e.name:
                out.setdefault(n, []).append((e.end - e.start) / 1e3)
    return {n: sum(v) / len(v) for n, v in out.items()}


def wall_us(fn, reps):
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def main() -> int:
    import numpy as np
    import torch

    from randt_slam_torch.ops import lm_step as L
    from randt_slam_torch.ops import ndt_linearize as NL
    from randt_slam_torch.ops import small_chol as K4
    from randt_slam_torch.registration import window as Wn
    # the card tests' input makers, by path: ``tests`` has no __init__.py,
    # and an installed package of that name would win the import
    spec = importlib.util.spec_from_file_location(
        "test_torch_kernels_cuda", os.path.join(ROOT, "tests", "test_torch_kernels_cuda.py"))
    T = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(T)
    _lm_inputs, _pairs = T._lm_inputs, T._pairs

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    out = {"card": torch.cuda.get_device_name(0), "kernels": {}}
    for B in (1, 8, 512):
        rng = np.random.default_rng(B)
        aux, Hj, gj, p, lam = _lm_inputs(rng, B, 4, dev)
        W, P = aux.W, p.shape[-1]
        win = aux.kern
        A, rhs, ds = L.assemble_cuda(win, Hj, gj, p, lam)
        x = K4.chol_solve_cuda(A, rhs)
        trial, _, dn, pn = L.trial_cuda(win, p, x, ds)
        rho = torch.rand(B, W, device=dev)
        ns = torch.full((B,), 0.01, device=dev)
        c = 0.5 * (ns * rho.sum(-1) + Wn.aux_cost(aux, trial))
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        live = torch.zeros(B, dtype=torch.int32, device=dev)
        state = [t.clone() for t in (p, c, lam)]
        f4 = 4
        consts = (64 + 10 * W + P) * f4
        calls = {
            "lm_assemble": (lambda: L.assemble_cuda(win, Hj, gj, p, lam),
                            lambda: Wn.assemble_plain(aux, Hj, gj, p, lam),
                            B * (W * 12 + P + 2 * W + 1) * f4 + consts
                            + B * (P * P + 2 * P) * f4),
            "lm_trial": (lambda: L.trial_cuda(win, p, x, ds),
                         lambda: Wn.trial_plain(aux, p, x, ds),
                         B * 3 * P * f4 + 2 * P * f4 + B * (P + 4 * W + 2) * f4),
            "lm_accept": (lambda: L.accept_cuda(win, rho, trial, dn, pn, ns, 1e-7, 1e-6,
                                                *state, done, live),
                          lambda: Wn.accept_plain(aux, rho, trial, dn, pn, ns, 1e-7, 1e-6,
                                                 p, c, lam, done, None),
                          B * (W + 2 * P + 5 + 2 * W) * f4 + consts + B * 2
                          + B * (P + 2 + 4 * W) * f4 + B * 5),
        }
        for name, (kernel, plain, nbytes) in calls.items():
            t = device_us(kernel, args.reps, [f"{name}_kernel"])[f"{name}_kernel"]
            out["kernels"].setdefault(name, {})[f"B={B}"] = dict(
                device_us=t, plain_us=wall_us(plain, max(args.reps // 10, 5)),
                bytes=nbytes, bound_us=nbytes / HBM_BYTES_PER_S * 1e6)
        print(json.dumps({k: v[f"B={B}"] for k, v in out["kernels"].items()}), flush=True)

    # one LM iteration at the fleet's B = 512 and pair count
    B, N = 512, 2 * 512 * 2
    rng = np.random.default_rng(0)
    aux, Hj, gj, p, lam = _lm_inputs(rng, B, 4, dev)
    W = aux.W
    pose4, packed = _pairs(rng, W * B, N, dev)
    packed = tuple(t.reshape((B, W) + t.shape[1:]) for t in packed)
    mu = torch.full((B,), 4.0, device=dev)
    ns = torch.full((B,), 0.01, device=dev)
    c = torch.full((B,), 1e9, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    live = torch.zeros(B, dtype=torch.int32, device=dev)
    pose4 = NL.pose_inputs(Wn.slot_poses(p))
    win = aux.kern

    def iteration():
        H, g, _ = NL.linearize_cuda(pose4, mu, ns, packed, 1.0, -2.0)
        A, rhs, ds = L.assemble_cuda(win, H, g, p, lam)
        tr, pose4_t, dn, pn = L.trial_cuda(win, p, K4.chol_solve_cuda(A, rhs), ds)
        rho, _ = NL.robust_cost_cuda(pose4_t, mu, packed, 1.0, -2.0)
        L.accept_cuda(win, rho, tr, dn, pn, ns, 1e-7, 1e-6, p.clone(), c.clone(),
                      lam.clone(), done.clone(), live)

    names = ["linearize_kernel", "lm_assemble_kernel", "chol_solve_kernel",
             "lm_trial_kernel", "robust_cost_kernel", "lm_accept_kernel"]
    per = device_us(iteration, max(args.reps // 4, 10), names)
    out["iteration_B512"] = dict(per_launch_us=per, sum_us=sum(per.values()), N=N)
    print(json.dumps(out["iteration_B512"]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
