"""Reading the port's own span ring and counters
(``randt_slam_torch/utils/profiling``), for the ``program_span`` and
``program_counter`` readers of ``benchmark/metrics/``.

The ring's records carry ``time.time_ns()``, the clock of the profiler's
host events, so they are placed against the traced chunk's span
(``ctx["span"]``):

* span readers (:func:`span_ms`) take the window's untraced chunks, the
  ``randt.batch_chunk`` records that start after the traced span ends, and
  report host wall per batched step, the union of the named spans' intervals
  inside each chunk (nested or repeated spans count once);
* counter readers (:func:`lm_rounds`) take the LM solve's samples taken
  inside the traced span (the counters run only while a profiler records).

The span readers need the traced chunk's own ``randt.batch_chunk`` record
inside the traced span, so chunks of another run are never read.  A
program without the registry, or a window without those records or
samples, gives None.
"""

from __future__ import annotations

import numpy as np

CHUNK = "randt.batch_chunk"
LM = "randt.lm_solve"
SLACK_NS = 100_000      # the traced chunk's record against the traced span


def registry():
    """The port's registry module, or None where the program has none."""
    try:
        from randt_slam_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, a) for a in ("records", "samples")):
        return None
    return profiling


def _traced(ctx, records) -> bool:
    lo, hi = ctx["span"]
    return any(r.name == CHUNK and r.start >= lo - SLACK_NS and r.end <= hi + SLACK_NS
               for r in records)


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, at = 0, None
    for s, e in sorted(intervals):
        if at is None or s > at:
            total += e - s
            at = e
        elif e > at:
            total += e - at
            at = e
    return total


def span_ms(ctx, names) -> float | None:
    """Host wall (ms) per batched step inside the spans ``names`` over the
    window's untraced chunks."""
    prof = registry()
    if prof is None or not ctx or not ctx.get("steps"):
        return None
    recs = prof.records()
    if not _traced(ctx, recs):
        return None
    hi = ctx["span"][1]
    chunks = [(r.start, r.end) for r in recs if r.name == CHUNK and r.start > hi]
    if not chunks:
        return None
    names = set(names)
    total, found = 0, False
    for a, b in chunks:
        iv = [(r.start, r.end) for r in recs
              if r.name in names and a <= r.start and r.end <= b]
        found = found or bool(iv)
        total += union_ns(iv)
    if not found:
        return None
    return total / 1e6 / (len(chunks) * ctx["steps"])


def lm_rounds(ctx) -> list | None:
    """The LM solves sampled inside the traced span: per solve
    ``(live, kept)``, (rounds, members) arrays of the LM iterations that
    worked on each member in each GNC round and whether the member kept the
    round's result."""
    prof = registry()
    if prof is None or not ctx:
        return None
    lo, hi = ctx["span"]
    out = []
    for s in prof.samples(LM):
        if not lo <= s.time <= hi:
            continue
        live = np.stack([np.asarray(x.cpu()).reshape(-1) for x in s.values["live"]])
        kept = np.stack([np.ones(live.shape[1], bool) if k is None
                         else np.asarray(k.cpu()).reshape(-1) for k in s.values["kept"]])
        out.append((live, kept))
    return out or None
