"""Reading a ``torch.profiler`` trace in memory.

:func:`collect` turns the profiler's raw events into plain tuples once; the
per-layer readers (``benchmark/metrics/``) and the breakdown work on those.
Nothing is written to disk: one traced chunk of an Oxford fleet step is a
few hundred thousand device launches.

Device events are kernels, copies and sets; the device side of a
``record_function`` range (named ``randt.*`` or ``bench.*``) is not one.
A kernel's launch time is that of the host operator it was launched from,
or, for a kernel launched outside any operator (the port's own kernels,
through ctypes), that of its launch call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SPAN_PREFIXES = ("randt.", "bench.")


class Ev(NamedTuple):
    device: bool
    name: str
    start: int     # ns, the profiler's clock
    end: int
    corr: int      # correlation id
    linked: int    # linked correlation id (device events: the launching op)


def collect(prof) -> list:
    """The events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        dev = str(e.device_type()).endswith("CUDA")
        out.append(Ev(dev, e.name(), start, start + e.duration_ns(),
                      e.correlation_id(), e.linked_correlation_id() if dev else 0))
    return out


def is_work(e: Ev) -> bool:
    """A device event that is work on the card (not a range's device span)."""
    return e.device and not e.name.startswith(SPAN_PREFIXES)


def span(events, name: str):
    """(start, end) of the first host range called ``name``."""
    for e in events:
        if not e.device and e.name == name:
            return (e.start, e.end)
    raise ValueError(f"no host range {name!r} in the trace")


def device_work(events, span_=None):
    """The device work events, those that start inside ``span_`` if given."""
    if span_ is None:
        return [e for e in events if is_work(e)]
    lo, hi = span_
    return [e for e in events if is_work(e) and lo <= e.start <= hi]


def idle_gaps(events, span_):
    """Gaps inside ``span_`` in which no device work runs: [(start, end)]."""
    lo, hi = span_
    iv = sorted((max(e.start, lo), min(e.end, hi)) for e in device_work(events)
                if e.end > lo and e.start < hi)
    gaps, at = [], lo
    for s, t in iv:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def busy_ns(events, span_) -> int:
    """Length of the union of device work intervals, clipped to ``span_``."""
    lo, hi = span_
    return (hi - lo) - sum(t - s for s, t in idle_gaps(events, span_))


def launch_times(events):
    """For each device work event, its launch time (ns) or None."""
    op_start, api_start = {}, {}
    for e in events:
        if e.device:
            continue
        if e.name.startswith("cu"):
            api_start[e.corr] = e.start
        elif e.corr > 0 and not e.name.startswith(SPAN_PREFIXES):
            op_start[e.corr] = e.start
    out = []
    for e in device_work(events):
        t = op_start.get(e.linked) if e.linked in op_start else api_start.get(e.corr)
        out.append((e, t))
    return out


def ranges(events, name: str):
    """The host ranges called ``name`` as an (n, 2) int64 array, sorted."""
    r = sorted((e.start, e.end) for e in events if not e.device and e.name == name)
    return np.array(r, dtype=np.int64).reshape(-1, 2)


def inside(times, spans) -> np.ndarray:
    """Which of ``times`` fall inside one of the sorted, disjoint ``spans``."""
    t = np.asarray(times, dtype=np.int64)
    if not len(spans):
        return np.zeros(t.shape, bool)
    i = np.searchsorted(spans[:, 0], t, side="right") - 1
    return (i >= 0) & (t <= spans[np.maximum(i, 0), 1])


def breakdown(events, span_, top: int = 10) -> dict:
    """The device operations that took most time in ``span_`` and the
    longest idle gaps there, each gap named by the host range open at its
    start: ``{"device_ops": [[name, s], ...], "idle_gaps": [[name, s], ...]}``."""
    by = {}
    for e in device_work(events, span_):
        by[e.name] = by.get(e.name, 0) + (e.end - e.start)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(events, span_), key=lambda g: g[0] - g[1])[:top]
    host = [e for e in events if not e.device and e.name.startswith("randt.")]
    named = []
    for s, t in gaps:
        best = None
        for e in host:
            if e.start <= s < e.end and (best is None or e.start > best.start):
                best = e
        named.append([best.name if best is not None else "host", (t - s) / 1e9])
    return {"device_ops": [[k, v / 1e9] for k, v in ops], "idle_gaps": named}
