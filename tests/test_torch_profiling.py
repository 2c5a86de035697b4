"""The port's span and counter registry (``randt_slam_torch/utils/profiling``):
the spans' clock against ``torch.profiler``'s, what a span costs with
tracing off, the ring's bound, the LM solve's convergence counters against
a plain early-exit loop, the batched scan's spans and ids, and the ring
gather of a process without a group (the worlds of ranks are in
``test_torch_distributed.py``)."""

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from randt_slam_torch.config import synthetic_config
from randt_slam_torch.io import synthetic
from randt_slam_torch.ops import build
from randt_slam_torch.parallel import batch as tB
from randt_slam_torch.pipeline import frontend as tF
from randt_slam_torch.pipeline import slam as tS
from randt_slam_torch.registration import barron
from randt_slam_torch.registration import solver as S
from randt_slam_torch.utils import profiling as P
from tests.torch_threads import one_thread  # noqa: F401

RF_ENTER = "profiler._record_function_enter_new.default"


@pytest.fixture
def reg(monkeypatch):
    """A fresh registry in the module's place for the test."""
    r = P.Registry()
    monkeypatch.setattr(P, "REGISTRY", r)
    return r


class Ops(TorchDispatchMode):
    """Counts the aten (and profiler) ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.c = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.c[str(func)] += 1
        return func(*args, **(kwargs or {}))


# ---- spans ----------------------------------------------------------------------


def test_span_ring_record_and_profiler_range_share_a_clock(reg):
    def spans(n):
        for i in range(n):
            with P.span("randt.test_clock", i=i):
                time.sleep(1e-3)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans(4)       # the first calls pay the profiler's own start-up
        n0 = reg.n
        spans(20)
    recs = reg.records(n0)
    ev = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                if e.name() == "randt.test_clock")[-20:]
    assert len(recs) == len(ev) == 20
    gaps = np.array([(s - r.start, r.end - e) for r, (s, e) in zip(recs, ev)])
    # every record holds its range (the range opens and closes inside the
    # span), and the two agree to within 50 us at both ends: a host
    # scheduling hiccup can delay one range, so the median is held
    assert (gaps >= 0).all(), gaps
    assert (np.median(gaps, axis=0) < 50_000).all(), gaps


def test_span_without_a_profiler_enters_no_record_function(reg):
    @P.span("randt.test_fn")
    def f(x):
        return x + 1

    x = torch.ones(2)
    for on in (False, True):
        with Ops() as ops:
            if on:
                with P.tracing():
                    with P.span("randt.test_ctx", chunk=0):
                        f(x)
            else:
                with P.span("randt.test_ctx", chunk=0):
                    f(x)
        # counters on or off, no profiler records: no range is entered
        assert dict(ops.c) == {"aten.add.Tensor": 1}
    with profile(activities=[ProfilerActivity.CPU]):
        with Ops() as ops:
            with P.span("randt.test_ctx", chunk=0):
                f(x)
    assert ops.c[RF_ENTER] == 2
    names = [r.name for r in reg.records()]
    assert names == ["randt.test_fn", "randt.test_ctx"] * 3
    assert f.__name__ == "f"


def test_ids_nest_and_the_inner_span_carries_them(reg):
    with P.span("randt.outer", chunk=4):
        with P.ids(t=2):
            with P.span("randt.inner"):
                pass
        with P.span("randt.inner2", t=7):
            pass
    inner, inner2, outer = reg.records()
    assert (inner.name, inner.ids) == ("randt.inner", {"chunk": 4, "t": 2})
    assert inner2.ids == {"chunk": 4, "t": 7} and outer.ids == {"chunk": 4}
    assert outer.start <= inner.start <= inner.end <= inner2.start <= outer.end
    assert reg.stack == [{}]


def test_the_ring_is_bounded_and_keeps_the_newest(monkeypatch):
    r = P.Registry(size=8)
    monkeypatch.setattr(P, "REGISTRY", r)
    prof = P.Profiler()
    for i in range(21):
        with P.span(f"randt.s{i % 3}", i=i):
            pass
    assert len(r.ring) == 8 and r.n == 21
    kept = r.records()
    assert [x.ids["i"] for x in kept] == list(range(13, 21))
    # the profiler folded each lap before the ring overwrote it
    rep = prof.report()
    assert {k: v["count"] for k, v in rep.items()} == {"randt.s0": 7, "randt.s1": 7,
                                                       "randt.s2": 7}
    with P.span("randt.s0"):
        pass
    assert prof.report()["randt.s0"]["count"] == 8


def test_gather_records_without_a_group_gives_this_process_as_rank_0(reg):
    import torch.distributed as dist

    assert not dist.is_initialized()
    with P.span("randt.before", chunk=1):
        pass
    since = reg.n
    with P.span("randt.after", chunk=2, rank=5):
        pass
    got = P.gather_records(since=since)
    assert [(r.name, r.ids) for r in got] == [("randt.after", {"chunk": 2, "rank": 0})]
    assert got[0][1:3] == reg.records()[-1][1:3]


def test_kernel_counters_are_launches_view(reg):
    assert dict(build.LAUNCHES) == {k: 0 for k in P.KERNELS}
    P.count("kernel.chol_solve")
    P.count("kernel.chol_solve", 2)
    assert build.LAUNCHES["chol_solve"] == 3 and P.counter("kernel.chol_solve") == 3
    assert build.LAUNCHES == {k: 3 if k == "chol_solve" else 0 for k in P.KERNELS}
    build.reset_launches()
    assert P.counter("kernel.chol_solve") == 0
    with pytest.raises(KeyError):
        build.LAUNCHES["not_a_kernel"]


# ---- the LM solve's counters -----------------------------------------------------

ITERS = 25
GNC_STEPS, DIVISOR = 3, 4.0
# members whose first residuals put mu0 under 2 (one round kept), between 2
# and 8 (two) and above 8 (three), and whose LM loops stop after different
# numbers of iterations (a converged member's later rounds stop once the
# rejected steps have driven the damping to 1e7)
TARGETS = torch.tensor([[0.1, 0.5, 0.2], [0.8, 1.5, 0.6], [0.3, 2.5, 1.1],
                        [1.2, 0.2, 0.9]])
CONFLICT = 0.4
FTOL = 1e-2


def _problem(tg, conflict=None):
    """Residuals exp(p0), p1 and sin(p2) against the targets; with
    ``conflict``, a fourth, p1 against the target moved by ``conflict``, so
    the cost stays above 0 and each member's loop stops on a flat cost."""
    def residual_fn(p):
        r = [torch.exp(p[:, 0]) - torch.exp(tg[:, 0]), p[:, 1] - tg[:, 1],
             torch.sin(p[:, 2]) - torch.sin(tg[:, 2])]
        if conflict is not None:
            r.append(p[:, 1] - tg[:, 1] - conflict)
        return torch.stack(r, dim=-1), p.new_zeros((p.shape[0], 1))

    def linearize_fn(p, mu):
        r, _ = residual_fn(p)
        J = torch.diag_embed(torch.stack([torch.exp(p[:, 0]), torch.ones_like(p[:, 1]),
                                          torch.cos(p[:, 2])], dim=-1))
        if conflict is not None:
            J = torch.cat([J, J[:, 1:2]], dim=1)
        return J.transpose(1, 2) @ J, torch.einsum("bn,bni->bi", r, J)
    return residual_fn, linearize_fn


def _fixed(B, n=3):
    """(active_mask, angle_mask, ndt_valid, aux_valid, ndt_scale, scale, alpha)
    of ``n`` residuals a member."""
    return (torch.ones(3, dtype=torch.bool), torch.tensor([False, False, True]),
            torch.ones(B, n, dtype=torch.bool), torch.zeros(1, dtype=torch.bool),
            torch.ones(B), 1.0, 2.0)


def _plain_lm(res, lin, p, mu, fixed, tol=1e-7, ftol=1e-6):
    """One problem's LM loop that stops where ``lm_solve``'s ``done`` would
    freeze it: (params, iterations run)."""
    active, angle, ndt_valid, aux_valid, ndt_scale, scale, alpha = fixed
    active_f = active.to(p.dtype)

    def cost(q):
        rn, ra = res(q)
        return S._robust_cost(rn, ra, ndt_valid, aux_valid, ndt_scale, scale, alpha, mu)

    c = cost(p)
    lam = torch.full((1,), 1e-4)
    n = 0
    while n < ITERS:
        n += 1
        H, g = lin(p, mu)
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        dscale = torch.rsqrt(torch.clamp(diag, min=1e-10)) * active_f
        Hs = H * dscale[..., :, None] * dscale[..., None, :]
        A = Hs + torch.diag_embed(lam[..., None] * active_f + (1.0 - active_f))
        delta = -torch.linalg.solve_ex(A, g * dscale)[0] * dscale
        trial = p + delta
        trial = torch.where(angle, S.normalize_angle(trial), trial)
        c_new = cost(trial)
        accept = bool(c_new < c)
        small = bool(torch.linalg.vector_norm(delta, dim=-1)
                     <= tol * (torch.linalg.vector_norm(p * active_f, dim=-1) + tol))
        flat = bool((c - c_new) <= ftol * c)
        stop = (accept and (small or flat)) or (not accept and bool(lam >= 1e7))
        if accept:
            p, c = trial, c_new
        lam = torch.clamp(lam / 3.0 if accept else lam * 4.0, 1e-10, 1e8)
        if stop:
            break
    return p, n


def _plain_gnc(b):
    """Member ``b`` alone through the GNC rounds with early-exit LM loops:
    (iterations run per round, kept per round)."""
    res, lin = _problem(TARGETS[b:b + 1], CONFLICT)
    fixed = _fixed(1, 4)
    p = torch.zeros(1, 3)
    rn0, _ = res(p)
    mu = barron.gnc_mu_init(torch.amax(rn0 * rn0, dim=-1), 1.0, GNC_STEPS, DIVISOR)
    iters, kept = [], []
    for r in range(GNC_STEPS):
        p_new, n = _plain_lm(res, lin, p, torch.clamp(mu, min=1.0), fixed, ftol=FTOL)
        keep = r == 0 or bool(barron.gnc_continue(mu, DIVISOR))
        if keep:
            p, mu = p_new, mu / DIVISOR
        iters.append(n)
        kept.append(keep)
    return iters, kept, p


def _gnc(B=len(TARGETS)):
    res, lin = _problem(TARGETS[:B], CONFLICT)
    return S.gnc_solve(res, lin, torch.zeros(B, 3), *_fixed(B, 4), GNC_STEPS, DIVISOR,
                       ITERS, 1e-7, lm_ftol=FTOL)


def test_gnc_live_counts_and_kept_rounds_equal_a_plain_loop(reg):
    _gnc()
    assert not P.samples()                 # counters off: nothing kept
    with P.tracing():
        out = _gnc()
    (smp,) = P.samples("randt.lm_solve")
    live = np.stack([x.numpy() for x in smp.values["live"]])
    kept = np.stack([np.ones(len(TARGETS), bool) if k is None else k.numpy()
                     for k in smp.values["kept"]])
    assert live.dtype == np.int32 and live.shape == kept.shape == (GNC_STEPS, len(TARGETS))
    for b in range(len(TARGETS)):
        iters, kp, p = _plain_gnc(b)
        assert live[:, b].tolist() == iters, b
        assert kept[:, b].tolist() == kp, b
        assert torch.equal(out.params[b], p[0])
    # the problem exercises what the counters tell apart
    assert kept.sum(0).tolist() == [1, 2, 3, 3]
    assert len(set(live[0].tolist())) == 4 and live.max() < ITERS


# the ops the unchanged ``lm_solve`` dispatched on _problem(TARGETS) at 6
# iterations, counted under Ops
SEED_OPS = {
    "aten._linalg_solve_ex.default": 6, "aten._to_copy.default": 1,
    "aten._unsafe_view.default": 6, "aten.add.Tensor": 37, "aten.bitwise_and.Tensor": 12,
    "aten.bitwise_not.default": 6, "aten.bitwise_or.Tensor": 18, "aten.bmm.default": 12,
    "aten.clamp.default": 12, "aten.cos.default": 6, "aten.diag_embed.default": 12,
    "aten.diagonal.default": 6, "aten.div.Tensor": 12, "aten.exp.default": 32,
    "aten.expand.default": 12, "aten.floor.default": 6, "aten.full.default": 1,
    "aten.ge.Scalar": 6, "aten.le.Tensor": 12, "aten.linalg_vector_norm.default": 12,
    "aten.lt.Tensor": 6, "aten.mul.Tensor": 115, "aten.neg.default": 6,
    "aten.new_zeros.default": 13, "aten.ones_like.default": 6, "aten.permute.default": 30,
    "aten.reciprocal.default": 7, "aten.rsqrt.default": 6, "aten.rsub.Scalar": 6,
    "aten.scalar_tensor.default": 14, "aten.select.int": 96, "aten.sin.default": 26,
    "aten.stack.default": 19, "aten.sub.Tensor": 51, "aten.sum.dim_IntList": 14,
    "aten.transpose.int": 6, "aten.unsqueeze.default": 43, "aten.view.default": 36,
    "aten.where.self": 56, "aten.zeros.default": 1,
}


def test_lm_solve_ops_tracing_off_are_the_seeds_and_on_add_one_per_iteration(reg):
    res, lin = _problem(TARGETS)
    B = len(TARGETS)
    args = (res, lin, torch.zeros(B, 3), *_fixed(B)[:5], 1.0, 2.0, torch.ones(B), 6, 1e-7)
    with Ops() as ops:
        S.lm_solve(*args, ftol=1e-6)
    assert dict(ops.c) == SEED_OPS
    # the solve with its counters: per round one int32 fill and one in-place
    # add per iteration, nothing else
    with Ops() as off:
        _gnc()
    with P.tracing(), Ops() as on:
        _gnc()
    extra = on.c - off.c
    assert not (off.c - on.c)
    assert extra == {"aten.full.default": GNC_STEPS, "aten.add_.Tensor": GNC_STEPS * ITERS}
    assert sum(extra.values()) <= GNC_STEPS * (ITERS + 1)


# ---- the batched scan ------------------------------------------------------------


@pytest.fixture(scope="module")
def batch_frames():
    seqs = [synthetic.generate(seed=s, n_frames=3, n_azimuths=256, n_bins=256,
                               speed=4.0, dt=0.25) for s in (3, 4)]
    fr = [tS.frames_from_arrays(s.intensity, s.azimuths, s.ranges, s.stamps,
                                device="cpu") for s in seqs]
    return tF.Frame(*(torch.stack(x) for x in zip(*fr)))


def test_batched_scan_records_its_chunks_outputs_and_frame_ids(reg, batch_frames,
                                                               monkeypatch):
    stats = {"n": 0}

    def memory_stats(device=None):
        stats["n"] += 1
        return {"num_device_alloc": 2 * stats["n"], "num_device_free": stats["n"],
                "num_alloc_retries": 0}

    # a card's allocator as far as the registry reads it
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    cfg = synthetic_config()
    T = batch_frames.stamp.shape[1]
    scan = tB.make_batched_scan(cfg, np.zeros(3), device="cpu")
    carries = tB.init_batched_carry(cfg, 2, device="cpu")
    with Ops() as ops:
        carries, _ = scan(carries, batch_frames)
    # tracing off: no range entered, no allocator statistics read, no sample
    assert ops.c[RF_ENTER] == 0 and stats["n"] == 0 and not P.samples()
    assert all(r.attrs is None for r in reg.records())
    with P.tracing():
        carries, _ = scan(carries, batch_frames)
    recs = reg.records()
    for c in (0, 1):
        (chunk,) = [r for r in recs if r.name == "randt.batch_chunk" and r.ids["chunk"] == c]
        inside = [r for r in recs if chunk.start <= r.start and r.end <= chunk.end
                  and r is not chunk]
        outs = [r for r in inside if r.name == "randt.outputs_to_host"]
        steps = [r for r in inside if r.name == "randt.frontend_step"]
        assert len(outs) == 1 and outs[0].ids == {"chunk": c}
        assert [r.ids for r in steps] == [{"chunk": c, "t": t} for t in range(T)]
        assert all(r.ids["chunk"] == c for r in inside)
        assert {"randt.filter_scan", "randt.scan_ndt", "randt.association",
                "randt.lm_solve"} <= {r.name for r in inside}
        counted = c == 1
        assert all((r.attrs is not None) == counted for r in steps + outs)
    # counters on: two allocator reads per frame step and one pair for the
    # outputs, each span's deltas kept; one LM sample per solved frame
    assert stats["n"] == 2 * (T + 1)
    step = next(r for r in recs if r.name == "randt.frontend_step" and r.attrs)
    assert step.attrs == {"num_device_alloc": 2, "num_device_free": 1,
                          "num_alloc_retries": 0}
    lm = P.samples("randt.lm_solve")
    assert len(lm) >= T and all(s.ids["chunk"] == 1 for s in lm)
    assert {s.ids["t"] for s in lm} == set(range(T))
