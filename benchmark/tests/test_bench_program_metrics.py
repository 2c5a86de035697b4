"""The readers of the port's own spans and LM counters
(``benchmark/program.py``) on a synthetic ring and a synthetic traced span."""

import numpy as np
import pytest
import torch

from benchmark import cellspec, program

MS = 1_000_000  # ns
T0 = 1_800_000_000 * 10 ** 9   # a time on the Unix-epoch clock, ns
STEPS = 2


@pytest.fixture
def prof(monkeypatch):
    from randt_slam_torch.utils import profiling

    monkeypatch.setattr(profiling, "REGISTRY", profiling.Registry(size=64))
    return profiling


def put(prof, name, start_ms, end_ms, **ids):
    prof.REGISTRY.write((name, T0 + int(start_ms * MS), T0 + int(end_ms * MS), ids, None))


def chunk(prof, at, c):
    """A chunk of two steps from ``at`` ms: 40 ms long, each step 15 ms with
    a filter of 2 ms, an association of 3 ms holding a submap merge of 1 ms,
    two LM solves of 4 and 3 ms, and outputs of 8 ms."""
    for t in range(STEPS):
        s = at + 1 + 15 * t
        put(prof, "randt.filter_scan", s, s + 2, chunk=c, t=t)
        put(prof, "randt.scan_ndt", s + 2, s + 3, chunk=c, t=t)
        put(prof, "randt.submap_merge", s + 4, s + 5, chunk=c, t=t)
        put(prof, "randt.association", s + 3, s + 6, chunk=c, t=t)   # holds the merge
        put(prof, "randt.lm_solve", s + 6, s + 10, chunk=c, t=t)
        put(prof, "randt.lm_solve", s + 10, s + 13, chunk=c, t=t)
        put(prof, "randt.frontend_step", s, s + 15, chunk=c, t=t)
    put(prof, "randt.outputs_to_host", at + 31, at + 39, chunk=c)
    put(prof, "randt.batch_chunk", at, at + 40, chunk=c)


def ctx_at(lo_ms=100, hi_ms=150):
    return dict(events=[], steps=STEPS, span=(T0 + lo_ms * MS, T0 + hi_ms * MS), shapes={})


def read(name, ctx):
    return cellspec.metric_reader(name)(ctx)


def window(prof):
    """A warm-up chunk, the traced chunk inside the traced span (100-150 ms)
    and two untraced chunks after it."""
    chunk(prof, 0, 0)
    chunk(prof, 105, 1)
    chunk(prof, 160, 2)
    chunk(prof, 210, 3)


@pytest.mark.parametrize("name, per_step_ms", [
    ("step_span_ms.fleet", 15.0),
    ("filter_span_ms.fleet", 2.0),
    ("scan_ndt_span_ms.fleet", 1.0),
    ("lm_span_ms.fleet", 7.0),
    ("grid_span_ms.fleet", 3.0),          # the merge inside the association counts once
    ("outputs_span_ms.fleet", 4.0),       # 8 ms a chunk over its 2 steps
])
def test_span_readers_take_the_untraced_chunks_after_the_traced_span(prof, name,
                                                                     per_step_ms):
    window(prof)
    assert read(name, ctx_at()) == pytest.approx(per_step_ms)
    # a longer span in the warm-up chunk or the traced chunk changes nothing
    put(prof, "randt.frontend_step", 1, 39)
    put(prof, "randt.lm_solve", 106, 130)
    assert read(name, ctx_at()) == pytest.approx(per_step_ms)


def test_span_readers_count_nested_and_repeated_spans_once(prof):
    window(prof)
    put(prof, "randt.lm_solve", 162, 173)     # overlaps both solves of chunk 2's step 0
    put(prof, "randt.lm_solve", 163, 165)     # inside it
    # chunk 2 step 0: its solves (167-171, 171-174) and these make one
    # interval, 162-174 ms; chunk 2 step 1 and chunk 3 as before
    assert read("lm_span_ms.fleet", ctx_at()) == pytest.approx((12 + 7 + 7 + 7) / 4)
    assert program.union_ns([(0, 5), (1, 2), (4, 9), (12, 13)]) == 10


def test_span_readers_return_none_without_an_untraced_chunk_or_the_traced_one(prof):
    chunk(prof, 0, 0)
    chunk(prof, 105, 1)
    for m in ("step_span_ms.fleet", "lm_span_ms.fleet", "outputs_span_ms.fleet"):
        assert read(m, ctx_at()) is None         # nothing after the traced span
    chunk(prof, 160, 2)
    assert read("step_span_ms.fleet", ctx_at()) == pytest.approx(15.0)
    # a traced span that holds no chunk of the ring: another run's records
    assert read("step_span_ms.fleet", ctx_at(400, 450)) is None


def test_the_traced_chunk_may_lie_within_100_us_of_the_traced_span(prof):
    window(prof)
    assert read("step_span_ms.fleet", ctx_at(105.09, 145)) == pytest.approx(15.0)
    assert read("step_span_ms.fleet", ctx_at(106, 150)) is None


def lm_sample(prof, at_ms, live, kept):
    from randt_slam_torch.utils.profiling import Sample

    values = dict(live=[torch.tensor(x, dtype=torch.int32) for x in live],
                  kept=[None if k is None else torch.tensor(k) for k in kept])
    prof.REGISTRY.samples.append(Sample("randt.lm_solve", T0 + at_ms * MS, {}, values))


def test_lm_counter_readers_take_the_solves_inside_the_traced_span(prof):
    window(prof)
    # two rounds of 25 and three members; member 2 drops round 1
    lm_sample(prof, 110, [[3, 25, 7], [25, 25, 1]], [None, [True, True, False]])
    lm_sample(prof, 120, [[5, 4, 4], [2, 9, 25]], [None, [False, False, False]])
    # outside the traced span: the warm-up's and an untraced chunk's
    lm_sample(prof, 10, [[1, 1, 1], [1, 1, 1]], [None, [True, True, True]])
    lm_sample(prof, 170, [[1, 1, 1], [1, 1, 1]], [None, [True, True, True]])
    ctx = ctx_at()
    member = [3 + 25, 25 + 25, 7, 5, 4, 4]
    assert read("lm_member_iters.fleet", ctx) == pytest.approx(np.mean(member))
    # solve 1: round 0 needs 25, round 1 the most of members 0 and 1 (25);
    # solve 2: round 0 needs 5, round 1 no member keeps it
    assert read("lm_batch_iters.fleet", ctx) == pytest.approx((50 + 5) / 2)
    assert read("lm_member_iters.fleet", ctx_at(300, 350)) is None
    assert read("lm_batch_iters.fleet", ctx_at(300, 350)) is None


def test_readers_of_a_program_without_the_registry_return_none(monkeypatch):
    monkeypatch.setattr(program, "registry", lambda: None)
    for m in ("step_span_ms.fleet", "grid_span_ms.fleet", "lm_member_iters.fleet",
              "lm_batch_iters.fleet"):
        assert read(m, ctx_at()) is None
