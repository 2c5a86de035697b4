#!/usr/bin/env python3
"""Readings behind a cell's limits: the numbers its check compares, over
many seeds in one process, for the program or for the control.

    python3 benchmark/readings.py --workload oxford.fleet --program port \\
        --seeds 1 2 3 --seconds 10 --out readings.jsonl
    python3 benchmark/readings.py --workload oxford.fleet --program control \\
        --seeds 1 2 3 --seconds 10

``port`` runs the program as a benchmark run does (warm-up, a window of
``--seconds``, the check); its largest reading over a dozen seeds is a
limit's lower reading.  ``control`` puts the plain reference, its state
stored in bfloat16, in the program's place at the cell's own size and load
(``traffic/fleet.py``, ``_control``); its smallest reading is the upper
one.  The kernels build once and the card is set up once for all seeds;
each seed renders its own drives.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", default="port")
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import cellspec, device

    cell = cellspec.load_cell(args.workload)
    gen = cellspec.generator(cell["workload"]["generator"])
    info = device.card(int(cell["entry"]["chips"]))
    label = device.label(info)
    print(f"card: {label}", flush=True)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            run = gen.make(cell, seed, device="cuda", program=args.program)
            try:
                run.start()
                run.setup()
                e2e = run.window(args.seconds, trace=False)
                run.free_program()
                compared = run.check(cell["workload"]["limits"])
            finally:
                run.close()
            rec = dict(workload=args.workload, program=args.program, seed=seed,
                       readings={k: v for k, v, _ in compared},
                       not_compared=run.checked.get("not_compared", {}),
                       where=run.checked.get("where", {}),
                       pair_gap_q=run.checked.get("pair_gap_q"), e2e=e2e,
                       wall_s=time.perf_counter() - t0, card=label)
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            del run
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
