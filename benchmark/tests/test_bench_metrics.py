"""Each per-layer reader's arithmetic on a small synthetic trace, and the
kernels' work arithmetic."""

import pytest

from benchmark import cellspec, trace
from benchmark.roofline import k2, k4, peaks
from benchmark.trace import Ev

MS = 1_000_000  # ns


def _trace():
    """Two steps in a 10 ms span: an LM range on the host from 1 to 5 ms
    launching two kernels (through an operator and through a bare launch
    call), and three more kernels outside it, one a copy."""
    host = [
        Ev(False, "bench.traced", 0, 10 * MS, 0, 0),
        Ev(False, "randt.frontend_step", 0, 9 * MS, 0, 0),
        Ev(False, "randt.lm_solve", 1 * MS, 5 * MS, 0, 0),
        Ev(False, "aten::mul", 2 * MS, 2 * MS + 10, 11, 0),
        Ev(False, "cudaLaunchKernel", 2 * MS + 5, 2 * MS + 8, 21, 0),
        Ev(False, "cudaLaunchKernel", 3 * MS, 3 * MS + 8, 22, 0),       # ctypes launch
        Ev(False, "aten::add", 6 * MS, 6 * MS + 10, 12, 0),
        Ev(False, "cudaLaunchKernel", 6 * MS + 5, 6 * MS + 8, 23, 0),
    ]
    dev = [
        Ev(True, "randt.lm_solve", 1 * MS, 5 * MS, 0, 0),             # a range's device span
        Ev(True, "mul_kernel", 2 * MS, 3 * MS, 21, 11),                # 1 ms, in the LM range
        Ev(True, "chol_solve_kernel(float const*)", 3 * MS, 4 * MS, 22, 0),   # 1 ms, ctypes
        Ev(True, "topi_moments_kernel(float const*)", 6 * MS, 8 * MS, 23, 12),  # 2 ms
        Ev(True, "Memcpy DtoH (Device -> Pinned)", 7 * MS, 9 * MS, 24, 0),       # overlaps
        Ev(True, "late_kernel", 11 * MS, 12 * MS, 25, 0),                        # outside
    ]
    return host + dev


def _ctx(**shapes):
    ev = _trace()
    return dict(events=ev, steps=2, span=trace.span(ev, "bench.traced"), shapes=shapes)


def read(name, ctx):
    return cellspec.metric_reader(name)(ctx)


def test_launches_per_step_counts_device_work_in_the_span():
    assert read("launches_per_step.fleet", _ctx()) == 4 / 2


def test_lm_host_ms_sums_the_lm_ranges():
    assert read("lm_host_ms.fleet", _ctx()) == pytest.approx(4.0 / 2)


def test_lm_device_ms_counts_kernels_launched_inside_the_lm_ranges():
    # mul_kernel (through aten::mul at 2 ms) and the bare launch at 3 ms
    assert read("lm_device_ms.fleet", _ctx()) == pytest.approx(2.0 / 2)


def test_device_idle_is_the_share_outside_the_union_of_device_intervals():
    # busy: 2-4 ms and 6-9 ms -> 5 of 10 ms
    assert read("device_idle.fleet", _ctx()) == pytest.approx(50.0)
    ev = _trace()
    gaps = trace.idle_gaps(ev, (0, 10 * MS))
    assert gaps == [(0, 2 * MS), (4 * MS, 6 * MS), (9 * MS, 10 * MS)]
    b = trace.breakdown(ev, (0, 10 * MS))
    assert b["device_ops"][0] == ["topi_moments_kernel(float const*)", 0.002]
    # each gap named by the innermost range open at its start
    assert b["idle_gaps"] == [["randt.frontend_step", 0.002], ["randt.lm_solve", 0.002],
                              ["host", 0.001]]


def test_k2_roofline_is_the_least_time_over_the_mean_kernel_time():
    s = dict(B=4, P=100, CH=13, k=8, kept_rows=50.0)
    nbytes, flops = k2.work(**s)
    assert nbytes == 4 * (100 * 4 + 8 * 4 + 8 * 13 * 4) + 50 * 13 * 4
    assert flops == 50 * 13
    got = read("k2_roofline.fleet", _ctx(k2=[s, s]))
    assert got == pytest.approx(100 * max(nbytes / peaks.HBM_BYTES_PER_S,
                                          flops / peaks.FP32_FLOPS) / 2e-3)


def test_k4_roofline_counts_one_triangle_b_and_x():
    nbytes, flops = k4.work(B=2, P=36)
    assert nbytes == 2 * (36 * 37 // 2 + 72) * 4
    assert flops == 2 * (2 * 36 ** 3 // 3 + 2 * 36 * 36)
    got = read("k4_roofline.fleet", _ctx(k4=dict(B=2, P=36)))
    assert got == pytest.approx(100 * k4.least(2, 36) / 1e-3)


def test_a_reader_with_nothing_to_read_returns_none():
    ctx = _ctx()
    ctx["events"] = [e for e in ctx["events"] if not e.device
                     and not e.name.startswith("randt.")]
    for m in cellspec.manifest()["per_layer"]:
        assert read(m["name"], ctx) is None, m["name"]
