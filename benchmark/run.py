#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload oxford.fleet --seed 7 --seconds 30 --trace 0

From the root of a checkout, on a machine with the CUDA devices the cell
asks for.  Set-up (rendering the inputs from ``--seed``, building the
kernels on a checkout's first run, loading, warming up) is timed from the
start of this script to the first timed step (``setup_s``); then the
cell's traffic runs for ``--seconds``; then the plain reference checks a
sample of what the window produced.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of a few steady steps of the window.

The numbers compared by the check are printed beside their limits as the
last lines of standard error and, under ``compared``, last in the result.
Without a CUDA device, or with fewer than the cell asks for, or with
``jax``, ``jaxlib``, ``flax`` or ``randt_slam_tpu`` loaded once the window
has closed, the script prints no result and exits with a code other than 0.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "randt_slam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN (the whole
    name before the first dot: ``randt_slam_torch`` is not
    ``randt_slam_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _finite_le(v, limit) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v) and v <= limit


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import cellspec, device

    cell = cellspec.load_cell(args.workload)
    gen = cellspec.generator(cell["workload"]["generator"])
    try:
        info = device.card(int(cell["entry"]["chips"]))
    except device.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    card = device.label(info)
    print(f"card: {card}", file=sys.stderr, flush=True)

    import torch

    run = gen.make(cell, args.seed, device="cuda")
    try:
        run.start()
        run.setup()
        setup_s = time.perf_counter() - T0
        e2e = run.window(args.seconds, trace=bool(args.trace))
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(info["count"]))
        found = forbidden_modules()
        if found:
            print(f"no result: modules loaded after the window: {found}", file=sys.stderr)
            return 4
        ctx = run.trace_context() if args.trace else None
        run.free_program()
        compared = run.check(cell["workload"]["limits"])
    finally:
        run.close()

    metrics = {}
    if args.trace:
        for m in cell["per_layer"]:
            v = cellspec.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in cell["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    dev = {"platform": info["platform"], "kind": info["kind"], "count": info["count"],
           "memory_peak_bytes": int(peak), "power_limit_w": info["power_limit_w"]}
    result = {"correct": all(_finite_le(v, lim) for _, v, lim in compared),
              "attempted": int(run.attempted), "failed": 0, "metrics": metrics,
              "device": dev}
    if args.trace:
        from benchmark import trace
        lo, hi = ctx["span"]
        dev["busy_s"] = trace.busy_ns(ctx["events"], ctx["span"]) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = ctx["breakdown"]
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
    found = forbidden_modules()
    if found:
        print(f"no result: modules loaded: {found}", file=sys.stderr)
        return 4
    for name, v in getattr(run, "setup_phases", {}).items():
        print(f"setup phase {name} {v:.3f} s", file=sys.stderr)
    print(f"window allocator counts: {getattr(run, 'alloc_counts', {})}", file=sys.stderr)
    walls = getattr(run, "chunk_walls", [])
    print("window chunk walls (s): " + " ".join(f"{w:.3f}" for w in walls), file=sys.stderr)
    for name, m in metrics.items():
        print(f"{name} {m['value']!r} {m['unit']} ({card})", file=sys.stderr)
    for k, v in getattr(run, "checked", {}).get("where", {}).items():
        print(f"widest {k}: {v}", file=sys.stderr)
    for k, v in getattr(run, "checked", {}).get("not_compared", {}).items():
        print(f"not compared {k} {v!r}", file=sys.stderr)
    for k, v, lim in compared:
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
