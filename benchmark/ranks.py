"""Reading the span rings of a multi-rank run (``traffic/fleet_ranks.py``)
for the ``program_span`` readers of ``benchmark/metrics/``.

After the window every rank's ring is gathered on rank 0
(``randt_slam_torch/utils/profiling.gather_records``) into ``ctx["rings"]``,
each record with its rank among its ids; the ranks of one host share the
clock, so the records line up as they are.  The readers take the window's
untraced chunks: the chunks after the one rank 0 traced
(``ctx["traced_chunk"]``; the scan's ``chunk`` id counts one per call on
every rank alike), and of those only the chunks every rank's ring holds.
A context without rings, or rings without the spans a reader reads, gives
None.
"""

from __future__ import annotations

from .program import union_ns

CHUNK = "randt.batch_chunk"
GATHER = "randt.gather_outputs"
STEP = "randt.frontend_step"


def chunks(ctx) -> dict | None:
    """``{chunk: {rank: [records]}}`` of the untraced chunks that every
    rank's ring holds, or None."""
    if not ctx or not ctx.get("rings") or ctx.get("traced_chunk") is None \
            or not ctx.get("steps") or not ctx.get("ranks"):
        return None
    by = {}
    for r in ctx["rings"]:
        c, k = r.ids.get("chunk"), r.ids.get("rank")
        if c is None or k is None or c <= ctx["traced_chunk"]:
            continue
        by.setdefault(c, {}).setdefault(k, []).append(r)
    full = {c: v for c, v in by.items() if len(v) == ctx["ranks"]}
    return full or None


def _wall(records, name) -> int | None:
    """The union (ns) of the intervals of the records called ``name``, or
    None where there is none."""
    iv = [(r.start, r.end) for r in records if r.name == name]
    return union_ns(iv) if iv else None


def gather_ms(ctx) -> float | None:
    """Per chunk the longest rank's ``randt.gather_outputs`` wall, in ms per
    step, averaged over the chunks."""
    got = chunks(ctx)
    if got is None:
        return None
    per = []
    for ranks in got.values():
        walls = [_wall(recs, GATHER) for recs in ranks.values()]
        if all(w is not None for w in walls):
            per.append(max(walls))
    if not per:
        return None
    return sum(per) / len(per) / 1e6 / ctx["steps"]


def skew_ms(ctx) -> float | None:
    """Per chunk the last rank's end of ``randt.batch_chunk`` less the first
    rank's, in ms per step, averaged over the chunks: how long the ranks
    that finish their own work first wait in the exchange for the last."""
    got = chunks(ctx)
    if got is None:
        return None
    per = []
    for ranks in got.values():
        ends = [max((r.end for r in recs if r.name == CHUNK), default=None)
                for recs in ranks.values()]
        if all(e is not None for e in ends):
            per.append(max(ends) - min(ends))
    if not per:
        return None
    return sum(per) / len(per) / 1e6 / ctx["steps"]


def slowest_step_ms(ctx) -> float | None:
    """The slowest rank's host wall per batched step inside
    ``randt.frontend_step`` over the chunks (ms)."""
    got = chunks(ctx)
    if got is None:
        return None
    total = {}
    for ranks in got.values():
        for k, recs in ranks.items():
            w = _wall(recs, STEP)
            if w is not None:
                total[k] = total.get(k, 0) + w
    if len(total) != ctx["ranks"]:
        return None
    return max(total.values()) / 1e6 / (len(got) * ctx["steps"])
