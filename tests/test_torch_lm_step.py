"""The switches-on odometry window solve on the CPU
(``registration/matcher._window_solve``, ``registration/window``): the
tensor ops it dispatches are
the ones it dispatched before its LM iteration had kernels of its own, and
the six-stage loop the card runs gives, with its plain stages, the tensor
ops' bits.

The counts were taken on the window solves of :func:`graph_config`'s
switches on (W = 3, 2 GNC rounds of 6 LM iterations, the plain K3a/K3b/K4)
before the iteration had kernels of its own, one unbatched and one
batch of two, after a first solve had made the cached constants.  The
plain path that ``benchmark/reference/`` copies is held to them, so it
cannot drift while the card path changes.
"""

import collections
import dataclasses
from functools import partial

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from randt_slam_torch.ops import ndt_linearize as NL
from randt_slam_torch.ops import small_chol
from randt_slam_torch.pipeline import slam
from randt_slam_torch.registration import matcher, solver, window
from randt_slam_torch.utils import profiling
from tests.test_torch_kernels_cuda import graph_config, graph_frames
from tests.torch_threads import one_thread  # noqa: F401

# aten ops of one switches-on window solve (4 existing states) on the CPU
UNBATCHED_OPS = {
    "_to_copy.default": 16, "_unsafe_view.default": 24, "abs.default": 28,
    "add.Tensor": 1925, "amax.default": 32, "bitwise_and.Tensor": 24,
    "bitwise_not.default": 12, "bitwise_or.Tensor": 36, "bmm.default": 39,
    "cat.default": 39, "clamp.default": 515, "clone.default": 60, "copy_.default":
    1728, "cos.default": 67, "detach.default": 36, "diag_embed.default": 12,
    "diagonal.default": 24, "diagonal_backward.default": 12, "div.Tensor": 1211,
    "expand.default": 36, "floor.default": 120, "full.default": 2, "ge.Scalar": 12,
    "gt.Scalar": 29, "index.Tensor": 1, "index_put.default": 24,
    "index_put_.default": 24, "le.Tensor": 24, "linalg_vector_norm.default": 24,
    "lt.Scalar": 28, "lt.Tensor": 12, "mm.default": 12, "mul.Tensor": 5914,
    "mv.default": 12, "neg.default": 328, "new_zeros.default": 12,
    "ones_like.default": 12, "permute.default": 171, "pow.Tensor_Scalar": 40,
    "reciprocal.default": 52, "rsqrt.default": 444, "rsub.Scalar": 12,
    "scalar_tensor.default": 59, "select.int": 7198, "select_backward.default": 360,
    "sin.default": 67, "slice.Tensor": 5460, "sqrt.default": 28, "squeeze.dim": 12,
    "stack.default": 181, "sub.Tensor": 2004, "sub_.Tensor": 432, "sum.default": 12,
    "sum.dim_IntList": 936, "transpose.int": 36, "unbind.int": 124,
    "unsqueeze.default": 1611, "view.default": 231, "where.self": 145,
    "zeros.default": 2, "zeros_like.default": 72,
}

BATCH_OF_TWO_OPS = {
    "_to_copy.default": 16, "_unsafe_view.default": 48, "abs.default": 28,
    "add.Tensor": 1925, "amax.default": 32, "arange.default": 1,
    "bitwise_and.Tensor": 24, "bitwise_not.default": 12, "bitwise_or.Tensor": 36,
    "bmm.default": 63, "cat.default": 39, "clamp.default": 515, "clone.default": 60,
    "copy_.default": 1728, "cos.default": 67, "detach.default": 36,
    "diag_embed.default": 12, "diagonal.default": 24, "diagonal_backward.default":
    12, "div.Tensor": 1211, "expand.default": 84, "floor.default": 120,
    "full.default": 2, "ge.Scalar": 12, "gt.Scalar": 29, "index.Tensor": 1,
    "index_put.default": 24, "index_put_.default": 24, "le.Tensor": 24,
    "linalg_vector_norm.default": 24, "lt.Scalar": 28, "lt.Tensor": 12,
    "mul.Tensor": 5914, "neg.default": 328, "new_zeros.default": 12,
    "ones_like.default": 12, "permute.default": 171, "pow.Tensor_Scalar": 40,
    "reciprocal.default": 52, "rsqrt.default": 444, "rsub.Scalar": 12,
    "scalar_tensor.default": 59, "select.int": 7210, "select_backward.default": 360,
    "sin.default": 67, "slice.Tensor": 5460, "sqrt.default": 28, "squeeze.dim": 12,
    "stack.default": 181, "sub.Tensor": 2004, "sub_.Tensor": 432, "sum.default": 12,
    "sum.dim_IntList": 936, "transpose.int": 24, "unbind.int": 124,
    "unsqueeze.default": 1655, "view.default": 279, "where.self": 145,
    "zeros.default": 2, "zeros_like.default": 72,
}


class Ops(TorchDispatchMode):
    """Counts the aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.c = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.c[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def last_solves():
    """Per switch setting (``on``, ``imu``), the inputs of the last window
    solve (4 existing states) of a 6-frame CPU run, unbatched and as a
    batch of the same window twice."""
    out = {}
    solve = matcher._window_solve
    for name in ("on", "imu"):
        seen = []

        def spy(mcfg, n_exist, *args, seen=seen):
            seen.append((mcfg, n_exist, tuple(a.clone() for a in args)))
            return solve(mcfg, n_exist, *args)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(matcher, "_window_solve", spy)
            slam.run_odometry(graph_config(name), graph_frames(3, 6, "cpu"), device="cpu")
        mcfg, n_exist, args = seen[-1]
        assert n_exist == 4
        out[name] = {"unbatched": (mcfg, n_exist, args),
                     "batched": (mcfg, n_exist, tuple(torch.stack([a, a]) for a in args))}
    return out


CASES = [("on", "unbatched"), ("on", "batched"), ("imu", "batched")]


@pytest.mark.parametrize("name,lead", CASES)
def test_window_solve_on_the_cpu_dispatches_the_seeds_ops(last_solves, name, lead):
    mcfg, n_exist, args = last_solves[name][lead]
    matcher._window_solve(mcfg, n_exist, *args)  # the cached constants
    with Ops() as ops:
        matcher._window_solve(mcfg, n_exist, *args)
    want = UNBATCHED_OPS if lead == "unbatched" else BATCH_OF_TWO_OPS
    assert dict(ops.c) == {f"aten.{k}": v for k, v in want.items()}


@pytest.mark.parametrize("name,lead,ftol", [c + (None,) for c in CASES]
                         + [("imu", "batched", 1e-2)])
def test_fused_loop_with_plain_stages_is_the_tensor_ops_bitwise(last_solves, name, lead,
                                                               ftol, monkeypatch):
    """The card's six-stage LM iteration (``window.window_loop``) run on the
    CPU with the kernels' plain versions as its stages: the states, the
    cost and the LM counters' live iterations bitwise the tensor ops'
    solve.  At a function tolerance of 1e-2 the LM exits after its first
    iteration, so the freeze of what is done is taken too."""
    mcfg, n_exist, args = last_solves[name][lead]
    if ftol is not None:
        mcfg = dataclasses.replace(mcfg, lm_function_tolerance=ftol)
    params0, dts, imu_meas, ndt_scale, _, *pairs = args
    gnc_solve = solver.gnc_solve

    def with_plain_loop(*a, loop, **k):
        assert loop is None  # a CPU tensor runs the tensor ops
        aux = window.window_aux(mcfg, params0.shape[:-1], *matcher._window_masks(
            mcfg, mcfg.smoothing_steps, n_exist), dts, imu_meas)
        plain = window.Stages(NL.linearize_plain, partial(window.assemble_plain, aux),
                              small_chol.chol_solve_plain, partial(window.trial_plain, aux),
                              NL.robust_cost_plain, partial(window.accept_plain, aux))
        loop = window.window_loop(aux, tuple(pairs), ndt_scale,
                                  float(mcfg.loss_function_scale),
                                  float(mcfg.loss_function_convexity), mcfg.lm_tolerance,
                                  mcfg.lm_function_tolerance, plain)
        return gnc_solve(*a, loop=loop, **k)

    def solve():
        n = len(profiling.samples("randt.lm_solve"))
        with profiling.tracing():
            res = matcher._window_solve(mcfg, n_exist, *args)
        (sample,) = profiling.samples("randt.lm_solve")[n:]
        return res, sample.values["live"]

    ops, ops_live = solve()
    monkeypatch.setattr(solver, "gnc_solve", with_plain_loop)
    loop, loop_live = solve()
    assert torch.equal(loop.params, ops.params) and torch.equal(loop.cost, ops.cost)
    assert len(loop_live) == len(ops_live) == mcfg.gnc_steps
    assert all(torch.equal(a, b) for a, b in zip(loop_live, ops_live))
    if ftol is not None:
        assert int(loop_live[0].max()) < mcfg.lm_max_iterations
