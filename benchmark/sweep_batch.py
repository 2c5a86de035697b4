#!/usr/bin/env python3
"""The batch sweep that fixes each fleet cell's B: on the card, for each cell
and each B, the fleet rate, ms per batched step, peak device memory, the
device's idle share and the check.

    python3 benchmark/sweep_batch.py --cells oxford.fleet \\
        --batches 32 64 128 256 512 --seed 101 --out sweep.json

Each B warms up as its cell does, then times ``--chunks`` chunks; every B
runs in two passes, smallest first and then largest first, so that a drift
of the host's speed shows as a gap between a B's two passes.  The first
pass also profiles one chunk (the idle share) and runs the cell's check on
one window chunk, so a B that fits only without the check does not count
as fitting.  A B that runs out of device memory ends the pass at that B.
The rule: each cell takes the B with the highest fleet rate (the better of
its passes); where a smaller B lies within the larger one's gap between its
two passes, the smaller.
"""

import argparse
import copy
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(cell, laps, seed, B, chunks, first_pass):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace
    from benchmark.traffic import fleet

    c = copy.deepcopy(cell)
    c["workload"]["params"]["batch"] = B
    torch.cuda.reset_peak_memory_stats()
    run = fleet.make(c, seed, device="cuda")
    run.use_laps(laps)
    rec = dict(cell=cell["name"], B=B, first_pass=first_pass)
    try:
        t0 = time.perf_counter()
        run.setup()
        rec["setup_s"] = time.perf_counter() - t0
        run._sync()
        t0 = time.perf_counter()
        for _ in range(chunks):
            run._step_chunk()
        run._sync()
        wall = time.perf_counter() - t0
        steps = chunks * run.T
        rec.update(ms_per_step=wall / steps * 1e3, fleet_fps=B * steps / wall)
        if first_pass:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function("bench.traced"):
                    run._step_chunk()
                    run._sync()
            ev = trace.collect(prof)
            del prof
            sp = trace.span(ev, "bench.traced")
            rec["idle_pct"] = 100.0 * (1.0 - trace.busy_ns(ev, sp) / (sp[1] - sp[0]))
            rec["launches_per_step"] = len(trace.device_work(ev, sp)) / run.T
            del ev
            run.window(1e-9, trace=False)
            run.free_program()
            t0 = time.perf_counter()
            rec["check"] = {k: v for k, v, _ in run.check(c["workload"]["limits"])}
            rec["check_s"] = time.perf_counter() - t0
            rec["pair_gap_q"] = run.checked.get("pair_gap_q")
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    except torch.OutOfMemoryError as e:
        rec["oom"] = str(e).splitlines()[0][:200]
    finally:
        run.close()
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--batches", nargs="+", type=int, required=True)
    ap.add_argument("--seed", type=int, default=101)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--out", default="sweep.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import cellspec, device
    from benchmark.inputs import drives as D

    info = device.card(1)
    print(f"card: {device.label(info)}", flush=True)
    recs = []
    for name in args.cells:
        cell = cellspec.load_cell(name)
        p = cell["workload"]["params"]
        drive = cell["config"]["drive"]
        laps = D.LapRender(drive["kind"], drive, args.seed, int(p["drives"]),
                           int(p["drives"])).get()
        for first_pass, order in ((True, sorted(args.batches)),
                                  (False, sorted(args.batches, reverse=True))):
            for B in order:
                if not first_pass and any(r.get("oom") and r["B"] <= B and r["cell"] == name
                                          for r in recs):
                    continue
                rec = one(cell, laps, args.seed, B, args.chunks, first_pass)
                rec["card"] = device.label(info)
                recs.append(rec)
                print(json.dumps(rec), flush=True)
                if rec.get("oom") and first_pass:
                    break
        del laps
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(recs, indent=1))
    print("cell B pass fleet_fps ms/step peak_GiB idle% check_s")
    for r in recs:
        print(r["cell"], r["B"], 1 if r["first_pass"] else 2,
              r.get("fleet_fps", r.get("oom", "")), r.get("ms_per_step", ""),
              r.get("peak_bytes", 0) / 2**30, r.get("idle_pct", ""), r.get("check_s", ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
