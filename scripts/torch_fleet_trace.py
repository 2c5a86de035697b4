"""What the port's own spans and counters show of a fleet cell, on one CUDA card.

    python3 scripts/torch_fleet_trace.py [--workload oxford.fleet] [--seed N]
        [--rounds 2] [--out fleet_trace.json]

Sets the cell up as ``benchmark/run.py`` does (``--seed`` renders the
drives), then steps chunks in rounds of three modes, in this order each
round: tracing off; the registry's counters on (``profiling.tracing()``, no
profiler); and under ``torch.profiler`` in a ``bench.traced`` range (the
counters on, every span also a ``record_function`` range), as a
``--trace 1`` run traces its chunk.  It prints and writes:

* ``modes``: ms per batched step of each mode (the wall of each chunk's
  ``randt.batch_chunk`` span over its steps), their medians, and the
  per-step host wall of each span name in the untraced chunks;
* ``traced``: of each profiled chunk (the first holds its carries at every
  frame boundary, as a window's chunk kept for the check does), the ten
  longest idle gaps of the card, each with the innermost span open at its start, that span's ids, the
  allocator deltas of the step (``randt.frontend_step``) or the outputs'
  span holding it, and the ``cudaMalloc``/``cudaFree`` calls that overlap
  it; the device mallocs and frees in the chunk and the spans they fell
  in; the share of the idle time that lies inside no program span; the
  ``randt.batch_chunk`` record against ``bench.traced`` (the shared clock);
  the launches per step and the counters' own launches among them; per
  hand-written kernel of the LM loop and K2, the quantiles of its launches'
  device times and of the card's idle time just before each, and the mean
  device time of the launches that followed other work within 1 us against
  those the card waited for;
* ``lm``: the LM counters of the profiled chunks: per GNC round the
  distribution of the members' live iterations and the share of members that
  keep the round, and the per-layer readings ``lm_member_iters`` and
  ``lm_batch_iters``;
* ``lm_graph``: per chunk, how many window solves ran eagerly, were
  captured as CUDA graphs and were replayed (the registry's ``lm_graph.*``
  counters, ``registration/solve_graph``), and the launches of the LM
  iteration's kernels (``kernel.lm_assemble``, ``kernel.lm_trial``,
  ``kernel.lm_accept`` beside ``kernel.ndt_linearize``: on the switches-on
  card path all four are equal).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

GRAPH_COUNTERS = ("lm_graph.eager", "lm_graph.capture", "lm_graph.replay",
                  "kernel.ndt_linearize", "kernel.lm_assemble", "kernel.lm_trial",
                  "kernel.lm_accept")
KERNELS = ("linearize_kernel", "robust_cost_kernel", "chol_solve_kernel",
           "topi_moments_kernel", "lm_assemble_kernel", "lm_trial_kernel",
           "lm_accept_kernel")
QUANTILES = (0, 10, 50, 90, 100)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def innermost(records, t):
    best = None
    for r in records:
        if r.start <= t < r.end and (best is None or r.start >= best.start):
            best = r
    return best


def enclosing(records, t, names):
    for r in records:
        if r.name in names and r.start <= t < r.end:
            return r
    return None


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def outside_ns(gaps, intervals) -> int:
    """Length of the ``gaps`` that no interval covers."""
    import numpy as np

    if not gaps:
        return 0
    g = np.array(gaps, dtype=np.int64)
    covered = sum(np.clip(np.minimum(g[:, 1], e) - np.maximum(g[:, 0], s), 0, None).sum()
                  for s, e in merged(intervals))
    return int((g[:, 1] - g[:, 0]).sum() - covered)


def kernel_times(work) -> dict:
    """Per name of :data:`KERNELS`: its launches' device times (us) and the
    card's idle time before each (from the end of the device work before
    it), as quantiles, and the mean device time of the launches with under
    1 us of idle before them against the others."""
    import numpy as np

    work = sorted(work, key=lambda e: e.start)
    out = {}
    for name in KERNELS:
        dur, idle = [], []
        for i, e in enumerate(work):
            if name in e.name and i:
                dur.append((e.end - e.start) / 1e3)
                idle.append((e.start - max(p.end for p in work[max(0, i - 8):i])) / 1e3)
        if not dur:
            continue
        dur, idle = np.asarray(dur), np.asarray(idle)
        near = idle < 1.0
        out[name] = dict(
            launches=len(dur), us_quantiles=np.percentile(dur, QUANTILES).tolist(),
            us_mean=float(dur.mean()),
            idle_before_us_quantiles=np.percentile(idle, QUANTILES).tolist(),
            after_work_within_1us=[int(near.sum()),
                                   float(dur[near].mean()) if near.any() else None],
            after_idle=[int((~near).sum()),
                        float(dur[~near].mean()) if (~near).any() else None])
    return out


def traced_chunk(ev, span, c, recs, steps, rounds, iters) -> dict:
    """The gaps, clock and launches of one profiled chunk (module docstring)."""
    from benchmark import program, trace
    from randt_slam_torch.utils import profiling

    lo, hi = span
    gaps = trace.idle_gaps(ev, span)
    idle = sum(t - s for s, t in gaps)
    outside = outside_ns(gaps, [(r.start, r.end) for r in recs])
    mallocs = [e for e in ev if not e.device and e.name in ("cudaMalloc", "cudaFree")]
    top = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        r = innermost(recs, s)
        holder = enclosing(recs, s, profiling.ALLOC_SPANS)
        over = [e.name for e in mallocs if e.end > s and e.start < t]
        top.append(dict(ms=(t - s) / 1e6, at_ms=(s - lo) / 1e6,
                        span=r.name if r else None, ids=r.ids if r else None,
                        holder=holder.name if holder else None,
                        alloc=holder.attrs if holder else None,
                        mallocs_overlapping=over.count("cudaMalloc"),
                        frees_overlapping=over.count("cudaFree")))
    (chunk,) = [r for r in recs if r.name == program.CHUNK]
    solves = sum(1 for x in profiling.samples(program.LM) if lo <= x.time <= hi)
    in_span = [e for e in mallocs if lo <= e.start <= hi]
    return dict(
        chunk=c, span_s=(hi - lo) / 1e9, idle_share=idle / (hi - lo),
        idle_outside_spans_share=outside / idle if idle else None,
        chunk_record_vs_traced_us=[(chunk.start - lo) / 1e3, (hi - chunk.end) / 1e3],
        launches_per_step=len(trace.device_work(ev, span)) / steps, lm_solves=solves,
        counter_launches_per_step=solves * rounds * (iters + 1) / steps,
        mallocs_in_span=[(e.name, (e.start - lo) / 1e6, (e.end - e.start) / 1e6,
                          getattr(innermost(recs, e.start), "name", None)) for e in in_span],
        step_alloc=[(r.ids.get("t"), r.attrs) for r in recs
                    if r.name == "randt.frontend_step"],
        outputs_alloc=[r.attrs for r in recs if r.name == "randt.outputs_to_host"],
        kernels=kernel_times(trace.device_work(ev, span)),
        gaps=top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="oxford.fleet")
    ap.add_argument("--seed", type=int, default=2_900_000_001)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="fleet_trace.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import cellspec, program, trace
    from randt_slam_torch.utils import profiling

    cell = cellspec.load_cell(args.workload)
    run = cellspec.generator(cell["workload"]["generator"]).make(cell, args.seed,
                                                                 device=args.device)
    t0 = time.perf_counter()
    run.start()
    run.setup()
    run.close()
    print(f"setup {time.perf_counter() - t0:.1f} s", flush=True)
    steps = run.T
    cfg = run.prog_cfg.matcher
    iters = int(cfg.lm_max_iterations)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device == "cuda" else [])

    chunks = defaultdict(list)    # mode -> [(chunk record, the chunk's records)]
    profiled = []                 # (events, traced span, chunk index, records)
    lm = []                       # (live, kept) of the profiled chunks' solves
    graph_counts = []             # (chunk, mode, lm_graph.* counted in it)
    for _ in range(args.rounds):
        for mode in ("off", "counters", "profiled"):
            c = run.chunk
            n0 = profiling.REGISTRY.n
            g0 = {k: profiling.counter(k) for k in GRAPH_COUNTERS}
            if mode == "off":
                run._step_chunk()
            elif mode == "counters":
                with profiling.tracing():
                    run._step_chunk()
            else:
                # the first profiled chunk holds its carries at every frame
                # boundary, as the window's chunk kept for the check does
                snaps = [] if not profiled else None
                with profile(activities=acts) as prof:
                    with torch.profiler.record_function("bench.traced"):
                        run._step_chunk(None if snaps is None else
                                        (lambda t, carries: snaps.append(carries)))
                        run._sync()
                del snaps
            recs = profiling.records(n0)
            (chunk,) = [r for r in recs if r.name == program.CHUNK]
            chunks[mode].append((chunk, recs))
            if mode == "profiled":
                ev = trace.collect(prof)
                del prof
                profiled.append((ev, trace.span(ev, "bench.traced"), c, recs))
                lm.extend(program.lm_rounds(dict(span=(chunk.start, chunk.end))) or [])
            graph = {k: profiling.counter(k) - g0[k] for k in GRAPH_COUNTERS}
            graph_counts.append((c, mode, graph))
            print(f"chunk {c} {mode}: {(chunk.end - chunk.start) / 1e6 / steps:.1f} ms/step, "
                  f"{graph}", flush=True)

    # per-span host wall per step in the chunks stepped with tracing off
    by_name = defaultdict(list)
    for _, recs in chunks["off"]:
        for name in {r.name for r in recs}:
            by_name[name].append(program.union_ns(
                [(r.start, r.end) for r in recs if r.name == name]) / 1e6 / steps)
    ms = {k: [(ch.end - ch.start) / 1e6 / steps for ch, _ in v] for k, v in chunks.items()}
    out = {"workload": args.workload, "seed": args.seed, "steps_per_chunk": steps,
           "card": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
           "modes": {k: {"ms_per_step": v, "median": statistics.median(v)}
                     for k, v in ms.items()},
           "untraced_span_ms_per_step": {k: statistics.median(v)
                                         for k, v in sorted(by_name.items())},
           "lm_graph": graph_counts}

    # every profiled chunk: gaps, clock, launches
    out["traced"] = [traced_chunk(ev, span, c, recs, steps, int(cfg.gnc_steps), iters)
                     for ev, span, c, recs in profiled]

    # the LM counters of the profiled chunks
    if lm:
        R = lm[0][0].shape[0]
        rounds_out = []
        for r in range(R):
            live = np.concatenate([x[r] for x, _ in lm])
            kept = np.concatenate([k[r] for _, k in lm])
            rounds_out.append(dict(
                kept_share=float(kept.mean()),
                live_quantiles=np.percentile(live, [0, 10, 50, 90, 99, 100]).tolist(),
                live_kept_quantiles=(np.percentile(live[kept], [0, 10, 50, 90, 99, 100])
                                     .tolist() if kept.any() else None),
                batch_max_kept=[int(x[r][k[r]].max()) if k[r].any() else 0
                                for x, k in lm]))
        member = np.concatenate([(x * k).sum(0) for x, k in lm])
        need = [sum(int(x[r][k[r]].max()) if k[r].any() else 0 for r in range(R))
                for x, k in lm]
        out["lm"] = dict(solves=len(lm), members=int(lm[0][0].shape[1]), rounds=rounds_out,
                         lm_member_iters=float(member.mean()),
                         lm_batch_iters=float(np.mean(need)),
                         member_iters_quantiles=np.percentile(
                             member, [0, 10, 50, 90, 99, 100]).tolist())
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
