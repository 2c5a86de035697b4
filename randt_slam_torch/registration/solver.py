"""Levenberg-Marquardt with Barron-loss graduated non-convexity, fixed trips.

Port of ``randt_slam_tpu/registration/solver.py`` (the reference's Ceres solve
loop, ``ndt_matcher.cpp:322-424``).  All residuals are one fixed-shape batch,
the robust loss enters as IRLS weights, and the small dense normal equations
are solved on the device.

The JAX package runs both loops as ``lax.while_loop``s that stop on
data-dependent conditions.  Here both loops have a fixed trip count, so the
host never waits on the device inside them:

* the LM loop always runs ``max_iters`` iterations; a ``done`` flag freezes
  ``(p, lam, c)`` from the iteration where the JAX loop would have stopped;
* the GNC loop runs ``gnc_steps`` rounds; a round after the schedule's
  ``gnc_continue`` turned false leaves ``p`` and ``mu`` untouched.  Because
  ``mu0 <= divisor^(gnc_steps-1)``, the JAX loop never runs more rounds.

The result equals the early-exit loops' up to the order of float operations.

Both loops take an optional leading batch dimension on the parameters,
(B, P): loop closure refines its candidates together, as the JAX package's
``jax.vmap(estimate_loop)`` does.  Every per-problem quantity (cost,
damping, the ``done`` freeze, mu and the GNC ``run`` flag) then has shape
(B,), so one candidate's exit never touches another's state.  Unbatched
parameters (P,) take the same operations with batch shape ().
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..geometry import normalize_angle
from ..utils import profiling
from . import barron


class SolveResult(NamedTuple):
    params: torch.Tensor
    cost: torch.Tensor          # final robust cost: 0.5*(a*sum rho + sum r_aux^2)
    n_ndt_valid: torch.Tensor   # number of active NDT residuals


def _robust_cost(r_ndt, r_aux, ndt_valid, aux_valid, ndt_scale, scale, alpha, mu):
    """Robust cost of residual stacks (..., N), mu and ndt_scale (...)."""
    s = r_ndt * r_ndt
    rho = barron.rho(s, scale, alpha, mu[..., None])
    c_ndt = torch.sum(torch.where(ndt_valid, rho, 0.0), dim=-1)
    c_aux = torch.sum(torch.where(aux_valid, r_aux * r_aux, 0.0), dim=-1)
    return 0.5 * (ndt_scale * c_ndt + c_aux)


def scaled_system(H, g, lam, active_f):
    """The damped system (A, rhs, dscale) of the normal equations H, g."""
    # Jacobi-scale the normal equations before solving (curvatures span
    # ~10 decades; an unscaled float32 solve leaks error into the weak
    # directions).  After scaling, active diagonals are 1 and the
    # Marquardt damping is lam * I.
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    dscale = torch.rsqrt(torch.clamp(diag, min=1e-10)) * active_f
    Hs = H * dscale[..., :, None] * dscale[..., None, :]
    damp = lam[..., None] * active_f + (1.0 - active_f)
    return Hs + torch.diag_embed(damp), g * dscale, dscale


def trial_step(p, x, dscale, angle_mask):
    """(delta, trial) of the scaled system's solution x."""
    delta = -x * dscale
    trial = p + delta
    return delta, torch.where(angle_mask, normalize_angle(trial), trial)


def step_norms(delta, p, active_f):
    """|delta| and |p * active| (...), the parameter tolerance's norms."""
    return (torch.linalg.vector_norm(delta, dim=-1),
            torch.linalg.vector_norm(p * active_f, dim=-1))


def accept_step(p, c, lam, done, trial, c_new, dnorm, pnorm, tol: float,
                ftol: float):
    """The next (p, c, lam, done): accept the trial where it lowers the
    cost, update the damping, and freeze what is done."""
    accept = c_new < c
    p_next = torch.where(accept[..., None], trial, p)
    c_next = torch.where(accept, c_new, c)
    lam_next = torch.clamp(torch.where(accept, lam / 3.0, lam * 4.0), 1e-10, 1e8)
    # Ceres parameter_tolerance (relative step) and function_tolerance.
    small = dnorm <= tol * (pnorm + tol)
    flat = (c - c_new) <= ftol * c
    done_next = (accept & (small | flat)) | ((~accept) & (lam >= 1e7))
    # Freeze once the early-exit loop would have stopped.
    return (torch.where(done[..., None], p, p_next), torch.where(done, c, c_next),
            torch.where(done, lam, lam_next), done | done_next)


def lm_solve(
    residual_fn: Callable,
    linearize_fn: Callable,
    params0,
    active_mask,
    angle_mask,
    ndt_valid,
    aux_valid,
    ndt_scale,
    scale: float,
    alpha: float,
    mu,
    max_iters: int,
    tol: float,
    ftol: float = 1e-6,
    cost_fn: Callable | None = None,
    solve_fn: Callable | None = None,
    live=None,
    loop: Callable | None = None,
):
    """Damped Gauss-Newton (LM) at a fixed GNC mu, ``max_iters`` iterations.

    residual_fn(params) -> (r_ndt (..., Nn), r_aux (..., Na));
    linearize_fn(params, mu) -> (H (..., P, P), g (..., P)), the
    IRLS-weighted normal equations; params (..., P), mu (...);
    cost_fn(params, mu) -> robust cost, if given, replaces the cost from
    ``residual_fn`` (the fused K3b pass); solve_fn(A, b) -> x, if given,
    replaces ``torch.linalg.solve_ex`` for the damped SPD system (K4).
    ``live``, if given, is an int32 tensor of the batch shape holding
    ``max_iters``: each iteration takes one from it, in place, for every
    problem already done, so it ends as the count of iterations that
    worked on each problem.  ``loop(params0, c, lam, done, mu, live,
    max_iters) -> (p, c)``, if given, runs the iterations from the same
    start in place of ``linearize_fn``, ``solve_fn`` and the trial's cost
    (``window.window_loop``: the odometry window solve's kernels).
    """
    active_f = active_mask.to(params0.dtype)

    def cost_at(p):
        if cost_fn is not None:
            return cost_fn(p, mu)
        rn, ra = residual_fn(p)
        return _robust_cost(rn, ra, ndt_valid, aux_valid, ndt_scale, scale,
                            alpha, mu)

    batch = params0.shape[:-1]
    p = params0
    c = cost_at(params0)
    lam = torch.full(batch, 1e-4, dtype=params0.dtype, device=params0.device)
    done = torch.zeros(batch, dtype=torch.bool, device=params0.device)
    if loop is not None:
        return loop(params0, c, lam, done, mu, live, max_iters)
    for _ in range(max_iters):
        if live is not None:
            live.add_(done, alpha=-1)
        H, g = linearize_fn(p, mu)
        A, rhs, dscale = scaled_system(H, g, lam, active_f)
        # solve_ex: no host-side check of the factorization's info flag.
        x = (torch.linalg.solve_ex(A, rhs)[0] if solve_fn is None
             else solve_fn(A, rhs))
        delta, trial = trial_step(p, x, dscale, angle_mask)
        c_new = cost_at(trial)
        p, c, lam, done = accept_step(
            p, c, lam, done, trial, c_new, *step_norms(delta, p, active_f),
            tol, ftol)
    return p, c


@profiling.span("randt.lm_solve")
def gnc_solve(
    residual_fn: Callable,
    linearize_fn: Callable,
    params0,
    active_mask,
    angle_mask,
    ndt_valid,
    aux_valid,
    ndt_scale,
    scale: float,
    alpha: float,
    gnc_steps: int,
    divisor: float,
    lm_max_iters: int,
    lm_tol: float,
    lm_ftol: float = 1e-6,
    cost_fn: Callable | None = None,
    r2max_fn: Callable | None = None,
    solve_fn: Callable | None = None,
    loop: Callable | None = None,
) -> SolveResult:
    """Graduated non-convexity: LM solves over the decreasing-mu schedule
    (do-while, ``ndt_matcher.cpp:390-397``), ``gnc_steps`` rounds.

    ``cost_fn(p, mu)`` / ``r2max_fn(p)`` / ``solve_fn(A, b)``, if given,
    replace the residual-stack cost (initial, trial and final), the largest
    squared residual of the mu initialisation, and the damped solve;
    ``loop``, if given, runs each round's LM iterations (:func:`lm_solve`).

    While the registry counts (``utils/profiling.counting``), the solve
    keeps a sample ``randt.lm_solve`` of two lists over its rounds:
    ``live``, each problem's count of the round's LM iterations that
    worked on it (the rest were frozen by ``done``), and ``kept``, whether
    the round's result was kept (None for round 0, always kept).  That
    costs one launch per round and one per LM iteration, and no host
    read."""
    if r2max_fn is not None:
        s0_max = r2max_fn(params0)
    else:
        rn0, _ = residual_fn(params0)
        s0_max = torch.amax(torch.where(ndt_valid, rn0 * rn0, 0.0), dim=-1)
    mu = barron.gnc_mu_init(s0_max, scale, gnc_steps, divisor)

    counting = profiling.counting()
    lives, kept = [], []
    p = params0
    for r in range(gnc_steps):
        mu_eff = torch.clamp(mu, min=1.0)
        live = (torch.full(params0.shape[:-1], lm_max_iters, dtype=torch.int32,
                           device=params0.device) if counting else None)
        p_new, _ = lm_solve(
            residual_fn, linearize_fn, p, active_mask, angle_mask, ndt_valid,
            aux_valid, ndt_scale, scale, alpha, mu_eff, lm_max_iters, lm_tol,
            ftol=lm_ftol, cost_fn=cost_fn, solve_fn=solve_fn, live=live,
            loop=loop,
        )
        if r == 0:  # the do-while's first round always runs
            p, mu = p_new, mu / divisor
            run = None
        else:
            run = barron.gnc_continue(mu, divisor)
            p = torch.where(run[..., None], p_new, p)
            mu = torch.where(run, mu / divisor, mu)
        lives.append(live)
        kept.append(run)
    if counting:
        profiling.record("randt.lm_solve", live=lives, kept=kept)
    mu_fin = torch.clamp(mu, min=1.0)
    if cost_fn is not None:
        final_cost = cost_fn(p, mu_fin)
    else:
        rn, ra = residual_fn(p)
        final_cost = _robust_cost(rn, ra, ndt_valid, aux_valid, ndt_scale,
                                  scale, alpha, mu_fin)
    return SolveResult(params=p, cost=final_cost,
                       n_ndt_valid=torch.sum(ndt_valid, dim=-1))
