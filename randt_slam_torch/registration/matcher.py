"""Sliding-window scan-to-submap registration (the reference ``Matcher``).

Port of the odometry part of ``randt_slam_tpu/registration/matcher.py``
(``ndt_matcher.cpp``): ``predictTransform`` (:22-59) ->
:func:`predict_next_state`, ``estimateTransformCeres`` (:322-424) ->
:func:`estimate_window`.  Data association runs once per frame and gathers
fixed-map neighbors for every (window slot, fixed map, moving cell); the GNC x
LM iteration then runs over one fixed-shape residual batch.

Window parameter layout: params (W+1, 9); row 0 is the anchor state (pose
constant, velocities free), rows 1..W are the active states, row W the
current frame.

What depends only on the cadence counters (which states exist, which fixed
maps are in use) is passed as host values, so that building the masks never
waits on the device.

:func:`estimate_window` takes an optional leading batch axis: B window
problems of the same cadence (states (B, W+1, 9), scans (B, W, C, ...),
fixed maps (B, F, ...)) solved in the same operations, each with its own
association, NDT scale, robust cost and GNC schedule (``solver.py`` keeps
every per-problem quantity per member) and its own pose-jump rejection.

The GNC-LM solve itself (:func:`_window_solve`) is a function of its
tensors and of host values alone.  On a CUDA tensor, given the run's
``solve_graph.SolveGraphs``, it is captured as a CUDA graph once per key
and replayed for every later frame of that key; on a CPU tensor it runs
eagerly.

``MatcherConfig.use_pallas_linearize`` (3-D residual only) and
``use_pallas_chol`` route the LM loop through the fused kernels K3a/K3b
(``ops/ndt_linearize``) and K4 (``ops/small_chol``): the CUDA kernels on a
CUDA tensor, their plain versions on a CPU tensor.  With both on, on a CUDA
tensor, the rest of each LM iteration is ``ops/lm_step``'s three kernels
(six launches an iteration in all, ``window.window_loop``); on a CPU
tensor it is the tensor ops of ``window`` and ``solver.lm_solve``.
Off, the NDT blocks come from reverse-mode autograd and the solve from
``torch.linalg.solve_ex``.

Loop closure: :func:`estimate_loop` (``estimateLoopConstraint``, :426-493)
refines a batch of candidate relative poses together, and
:func:`global_grid_search` (``estimateTransformGlobalBNB``, :495-608) is the
correlative pre-alignment, also batched over candidates.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import runtime
from ..config import SlamConfig
from ..geometry import compose, normalize_angle, rotmat
from ..ndt import grid as G
from ..ops import ndt_linearize as NL
from ..ops import small_chol
from ..utils import profiling
from . import barron
from . import residuals as R
from . import solver
from . import window


class ScanWindow(NamedTuple):
    """Derived NDT fields of the last W scans (moving maps), base frame.
    Slot W-1 is the current scan; slot j pairs with window state j+1."""

    mean: torch.Tensor   # (W, C, 3)
    cov: torch.Tensor    # (W, C, 3, 3)
    valid: torch.Tensor  # (W, C)


class FixedMaps(NamedTuple):
    """Derived fields of the fixed NDT maps (current submap + optional
    previous submap in the current frame, ``local_fuser.cpp:128-136``); a
    batch of problems adds a leading (B,) to every tensor, as to
    :class:`ScanWindow`'s."""

    index: tuple         # F-tuple of (H, W) int32 index grids (-1 = empty)
    mean: torch.Tensor   # (F, S, 3)
    cov: torch.Tensor    # (F, S, 3, 3)
    valid: torch.Tensor  # (F, S)
    use: tuple           # F-tuple of host bools: second map only in overlap


def transform_mean_cov(pose, mean, cov):
    """Rigid transform of cell distributions: mu' = R3 mu + t3,
    cov' = R3 cov R3^T (``ndt_cell.cpp:117-123``).  pose (..., 3) broadcast
    against mean (..., C, 3)."""
    R2 = rotmat(pose[..., 2])
    dt = mean.dtype
    z = torch.zeros(pose.shape[:-1] + (2, 1), dtype=dt, device=pose.device)
    bot = torch.zeros(pose.shape[:-1] + (1, 3), dtype=dt, device=pose.device)
    bot[..., 0, 2] = 1.0
    A = torch.cat([torch.cat([R2, z], dim=-1), bot], dim=-2)
    t3 = torch.cat([pose[..., :2], z[..., 0, :]], dim=-1)
    mu = torch.einsum("...ij,...cj->...ci", A, mean) + t3[..., None, :]
    cv = torch.einsum("...ij,...cjk,...lk->...cil", A, cov, A)
    return mu, cv


def predict_next_state(state, raw_dt):
    """``Matcher::predictTransform``: constant-velocity rollout of the newest
    state; the reference zeroes lin_acc before predicting (``:26``)."""
    acc = runtime.const(np.isin(np.arange(R.STATE_DIM), [R.AX, R.AY]),
                        torch.bool, state.device)
    return R.predict_state(torch.where(acc, 0.0, state), raw_dt)


@profiling.span("randt.ndt_autograd")
def ndt_blocks_autograd(pose_w, m_mean, m_cov, f_mean, f_cov, pair_valid,
                        ndt_scale, scale: float, alpha: float, mu,
                        use_intensity: bool = True):
    """Per-slot IRLS normal-equation blocks of the NDT residuals, H (..., W,
    3, 3) and g (..., W, 3), over pairs (..., W, F, C, K) at the slot poses
    (..., W, 3); ``ndt_scale`` and ``mu`` hold one value per problem (...).

    Each NDT residual depends only on the 3 pose params of its window slot,
    so its Jacobian row is 3 numbers.  The exact derivatives come from
    reverse-mode autograd on per-residual copies of the parameters (one
    backward pass gives every row: each residual reads only its own copy).
    The JAX package takes the same derivatives in forward mode
    (``jax.jacfwd``); under ``torch.func.jacfwd`` every elementwise op runs
    through Python decompositions, which would set the frame time."""
    with torch.enable_grad():
        pr = pose_w.detach()[..., :, None, None, None, :].expand(
            *f_mean.shape[:-1], 3).clone().requires_grad_(True)
        r = R.ndt_residual(pr, m_mean, m_cov, f_mean, f_cov,
                           use_intensity=use_intensity)
        (J,) = torch.autograd.grad(r.sum(), pr)
    r = r.detach()
    per_pair = (1,) * 4  # a problem's scalars against its (W, F, C, K) pairs
    w_ndt = (ndt_scale.reshape(ndt_scale.shape + per_pair)
             * barron.weight(r * r, scale, alpha, mu.reshape(mu.shape + per_pair)))
    w_ndt = torch.where(pair_valid, w_ndt, 0.0)
    Hj = torch.einsum("...wfck,...wfcki,...wfckj->...wij", w_ndt, J, J)
    gj = torch.einsum("...wfck,...wfcki->...wi", w_ndt * r, J)
    return Hj, gj


class WindowEstimate(NamedTuple):
    states: torch.Tensor      # (..., W+1, 9) updated window states
    rejected: torch.Tensor    # (...) bool -- pose-jump rejection fired
    cost: torch.Tensor        # (...)
    n_residuals: torch.Tensor  # (...)


def _window_masks(mcfg, W: int, n_exist: int):
    """Host-side parameter and slot masks for a window whose oldest
    ``W + 1 - n_exist`` rows do not exist yet (``ndt_matcher.cpp:343-356``)."""
    anchor_row = (W + 1) - n_exist
    rows = np.arange(W + 1)
    state_exists = rows >= anchor_row
    slot_active = rows[1:] > anchor_row
    # Anchor row: pose and bias constant, velocities free
    # (``addMotionParameterBlock(..., true)``, :290-313, :352); acceleration
    # frozen under the constant-velocity model; bias only with IMU.
    per_state = np.ones(9, bool)
    per_state[R.AX] = per_state[R.AY] = not mcfg.use_constant_velocity_model
    per_state[R.BIAS] = bool(mcfg.use_imu)
    static_mask = np.tile(per_state, (W + 1, 1))
    pose_cols = np.isin(np.arange(9), [R.X, R.Y, R.TH])
    anchor_frozen = (rows == anchor_row)[:, None] & (pose_cols | (np.arange(9) == R.BIAS))[None, :]
    active_mask = (static_mask & ~anchor_frozen & state_exists[:, None]).reshape(-1)
    angle_mask = np.tile(np.eye(1, 9, R.TH, dtype=bool)[0], W + 1)
    return slot_active, active_mask, angle_mask


def _moving_pairs(m_mean, m_cov, a_mean, a_cov):
    """Moving cells (..., W, C, ...) broadcast against their neighbours
    (..., W, F, C, K, ...)."""
    return (m_mean[..., :, None, :, None, :].expand(a_mean.shape),
            m_cov[..., :, None, :, None, :, :].expand(a_cov.shape))


def _window_solve(mcfg, n_exist: int, params0, dts, imu_meas, ndt_scale,
                  pair_valid, *pairs) -> solver.SolveResult:
    """The GNC-LM solve of a window, from the mu initialisation to the final
    cost: a function of its tensors and of host values alone, so that one
    CUDA graph of it serves every frame of a key: the matcher's
    configuration (its switches, ``use_imu``, ``use_intensity_as_dimension``,
    W, K and the solver's constants), ``n_exist``, and the layout of the
    tensors (the batch shape, C and F among them; ``solve_graph.key``).

    params0 (..., (W+1)*9) the window states, dts and imu_meas (..., W),
    ndt_scale (...), pair_valid (..., W, F, C, K); ``pairs``: with the
    fused kernels the pack of ``ops/ndt_linearize.pack_pairs``, else the
    benign moving cells (..., W, C, 3) and (..., W, C, 3, 3) and their
    neighbours' means and covariances (..., W, F, C, K, 3[, 3])."""
    W = mcfg.smoothing_steps
    dev = params0.device
    lead = params0.shape[:-1]
    use_int = bool(mcfg.use_intensity_as_dimension)
    fused = bool(mcfg.use_pallas_linearize) and use_int
    # with both switches on, the card runs the LM iteration as six kernels
    kernel_loop = fused and bool(mcfg.use_pallas_chol) and params0.is_cuda
    aux = window.window_aux(mcfg, lead, *_window_masks(mcfg, W, n_exist), dts,
                            imu_meas, kernels=kernel_loop)
    ndt_valid = pair_valid.reshape(lead + (-1,))
    scale_ = mcfg.loss_function_scale
    alpha_ = mcfg.loss_function_convexity

    cost_fn = r2max_fn = solve_fn = loop = None
    if mcfg.use_pallas_chol:
        solve_fn = small_chol.chol_solve
    if fused:
        # Per LM iteration K3a gives the NDT blocks, K3b the trial cost, K4
        # the damped solve; on the card the rest of the iteration is three
        # kernels more (window.window_loop).
        packed = pairs
        residual_fn = None  # cost_fn and r2max_fn stand in for it
        mu_one = runtime.const(np.ones(math.prod(lead), np.float32), params0.dtype,
                               dev).reshape(lead)

        def linearize_fn(p_flat, mu):
            p = p_flat.reshape(lead + (W + 1, 9))
            Hj, gj, _ = NL.linearize(p[..., 1:, :3], mu, ndt_scale, packed,
                                     float(scale_), float(alpha_))
            return window.assemble_normal(aux, p, Hj, gj)

        def cost_fn(p_flat, mu):
            p = p_flat.reshape(lead + (W + 1, 9))
            rho, _ = NL.robust_cost(p[..., 1:, :3], mu, packed, float(scale_),
                                    float(alpha_))
            return 0.5 * (ndt_scale * rho + window.aux_cost(aux, p_flat))

        def r2max_fn(p_flat):
            p = p_flat.reshape(lead + (W + 1, 9))
            return NL.robust_cost(p[..., 1:, :3], mu_one, packed, float(scale_),
                                  float(alpha_))[1]

        if kernel_loop:
            loop = window.window_loop(aux, packed, ndt_scale, float(scale_),
                                      float(alpha_), mcfg.lm_tolerance,
                                      mcfg.lm_function_tolerance)
    else:
        m_mean, m_cov, a_mean, a_cov = pairs
        m_mean_b, m_cov_b = _moving_pairs(m_mean, m_cov, a_mean, a_cov)

        def residual_fn(p_flat):
            p = p_flat.reshape(lead + (W + 1, 9))
            pose_w = p[..., 1:, :3]
            r_ndt = R.ndt_residual(
                pose_w[..., :, None, None, None, :], m_mean_b, m_cov_b,
                a_mean, a_cov, use_intensity=use_int,
            )  # (..., W, F, C, K)
            return r_ndt.reshape(lead + (-1,)), window.aux_residuals(aux, p_flat)

        def linearize_fn(p_flat, mu):
            p = p_flat.reshape(lead + (W + 1, 9))
            Hj, gj = ndt_blocks_autograd(p[..., 1:, :3], m_mean_b, m_cov_b, a_mean,
                                         a_cov, pair_valid, ndt_scale, scale_,
                                         alpha_, mu, use_intensity=use_int)
            return window.assemble_normal(aux, p, Hj, gj)

    return solver.gnc_solve(
        residual_fn,
        linearize_fn,
        params0,
        aux.active_mask,
        aux.angle_mask,
        ndt_valid,
        aux.aux_valid,
        ndt_scale,
        mcfg.loss_function_scale,
        mcfg.loss_function_convexity,
        mcfg.gnc_steps,
        mcfg.gnc_control_parameter_divisor,
        mcfg.lm_max_iterations,
        mcfg.lm_tolerance,
        lm_ftol=mcfg.lm_function_tolerance,
        cost_fn=cost_fn,
        r2max_fn=r2max_fn,
        solve_fn=solve_fn,
        loop=loop,
    )


def estimate_window(
    cfg: SlamConfig,
    states,        # (..., W+1, 9) anchor + active states (newest = predicted)
    stamps,        # (..., W+1)
    state_exists,  # (W+1,) host bools -- False for slots before trajectory start
    imu_meas,      # (..., W) relative yaw measurements per transition
    scans: ScanWindow,
    fixed: FixedMaps,
    prior_pose,    # (..., 3) pose-jump rejection reference (pre-prediction pose)
    graphs=None,   # the run's solve_graph.SolveGraphs, or None
):
    """One frame of the sliding-window smoother (``estimateTransformCeres``),
    for one problem or a batch of them (leading axis ``...`` = (B,)).  On a
    CUDA tensor the solve replays ``graphs``' CUDA graph of its key; without
    ``graphs`` it runs eagerly."""
    mcfg = cfg.matcher
    W = mcfg.smoothing_steps
    K = mcfg.n_results_nn_lookup
    geom = G.GridGeom.from_config(cfg.ndt_map)
    dtype = states.dtype
    dev = states.device
    lead = states.shape[:-2]
    nl = len(lead)
    use_int = bool(mcfg.use_intensity_as_dimension)
    lookup_dist = bool(mcfg.lookup_distribution) and use_int

    n_exist = int(np.sum(np.asarray(state_exists, bool)))
    slot_active = runtime.const(_window_masks(mcfg, W, n_exist)[0], torch.bool, dev)

    # ---- data association (once per frame, at current estimates) ----------
    poses = states[..., 1:, :3]  # (..., W, 3)
    q_mu, q_cov = transform_mean_cov(poses, scans.mean, scans.cov)  # (..., W, C, ...)
    C = scans.mean.shape[-2]
    Fm = fixed.mean.shape[nl]
    radius = cfg.ndt_map.nn_window_radius

    per_map = []
    for f in range(Fm):
        nb = G.window_neighbors_sparse(
            geom, fixed.index[f], fixed.mean.select(nl, f),
            fixed.cov.select(nl, f), fixed.valid.select(nl, f),
            q_mu.reshape(lead + (W * C, 3)), q_cov.reshape(lead + (W * C, 3, 3)),
            scans.valid.reshape(lead + (W * C,)), K, radius,
            use_distribution_metric=lookup_dist,
        )
        valid = nb.valid if fixed.use[f] else torch.zeros_like(nb.valid)
        per_map.append(G.NeighborSet(
            mean=nb.mean.reshape(lead + (W, C, K, 3)),
            cov=nb.cov.reshape(lead + (W, C, K, 3, 3)),
            valid=valid.reshape(lead + (W, C, K))))
    assoc = G.NeighborSet(*(torch.stack(a, dim=nl + 1) for a in zip(*per_map)))
    # assoc.*: (..., W, F, C, K, ...); rows <= anchor contribute no factors.
    pair_valid = assoc.valid & slot_active[:, None, None, None]

    # Benign values for invalid (padded) moving cells: keeps Jacobians finite.
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    safe_mean = torch.where(scans.valid[..., None], scans.mean, 0.0)
    safe_cov = torch.where(scans.valid[..., None, None], scans.cov, eye3)

    n_cells = torch.sum(
        torch.where(slot_active[:, None], scans.valid, False).to(dtype),
        dim=(-2, -1))
    ndt_scale = mcfg.ndt_weight / torch.clamp(n_cells * K, min=1.0)  # (...)

    # The fused kernels (K3a/K3b: 3-D residual only) read the pairs packed
    # once per frame.
    if mcfg.use_pallas_linearize and use_int:
        pairs = NL.pack_pairs(*_moving_pairs(safe_mean, safe_cov, assoc.mean, assoc.cov),
                              assoc.mean, assoc.cov, pair_valid, slot_dims=nl + 1)
    else:
        pairs = (safe_mean, safe_cov, assoc.mean, assoc.cov)
    args = (states.reshape(lead + (-1,)), stamps[..., 1:] - stamps[..., :-1],
            imu_meas, ndt_scale, pair_valid, *pairs)
    if dev.type == "cuda" and graphs is not None:
        res = graphs((mcfg, n_exist), functools.partial(_window_solve, mcfg, n_exist),
                     args)
    else:
        if dev.type == "cuda":
            profiling.count("lm_graph.eager")
        res = _window_solve(mcfg, n_exist, *args)
    new_states = res.params.reshape(lead + (W + 1, 9))

    # ---- pose-jump rejection (``ndt_matcher.cpp:411-422``) -----------------
    newest = new_states[..., -1, :]
    dx = torch.abs(newest[..., R.X] - prior_pose[..., 0])
    dy = torch.abs(newest[..., R.Y] - prior_pose[..., 1])
    dth = torch.abs(normalize_angle(newest[..., R.TH] - prior_pose[..., 2]))
    reject = (
        (dx > mcfg.pose_reject_translation)
        | (dy > mcfg.pose_reject_translation)
        | (dth > mcfg.pose_reject_rotation)
    )
    prev = new_states[..., -2, :]
    zero = torch.zeros_like(newest[..., R.X])
    fallback = torch.stack([
        prev[..., R.X], prev[..., R.Y], prev[..., R.TH], zero, zero, zero, zero,
        zero, prev[..., R.BIAS],
    ], dim=-1)
    new_states = torch.cat(
        [new_states[..., :-1, :],
         torch.where(reject[..., None], fallback, newest)[..., None, :]], dim=-2)

    return WindowEstimate(
        states=new_states,
        rejected=reject,
        cost=res.cost,
        n_residuals=res.n_ndt_valid,
    )


def _loop_pairs(m_mean, m_cov, m_valid, assoc: G.NeighborSet):
    """Moving cells broadcast against their (B, C, K) neighbors, with benign
    values for invalid (padded) moving cells."""
    eye3 = torch.eye(3, dtype=m_cov.dtype, device=m_cov.device)
    safe_mean = torch.where(m_valid[..., None], m_mean, 0.0)
    safe_cov = torch.where(m_valid[..., None, None], m_cov, eye3)
    return (safe_mean[..., :, None, :].expand(assoc.mean.shape),
            safe_cov[..., :, None, :, :].expand(assoc.cov.shape))


@profiling.span("randt.csm_search")
def global_grid_search(cfg: SlamConfig, init_pose, f_mean, f_cov, f_valid,
                       m_mean, m_cov, m_valid, search_window_linear=None,
                       search_window_angular=None, beam_width: int = 16,
                       use_intensity=None):
    """Correlative-scan-matching global search (``estimateTransformGlobalBNB``,
    ``ndt_matcher.cpp:495-608``) for a batch of candidates: init_pose (B, 3),
    f_* (B, F, ...), m_* (B, C, ...).  Returns (best pose (B, 3), best cost
    (B,)).

    As in the JAX package: the whole coarsest grid is scored as one batch,
    then ``csm_n_iter`` levels keep the ``beam_width`` best candidates and
    expand each into its 3x3x3 half-step neighbourhood.  Scoring is the
    Barron cost (no GNC, :517) averaged over the residual pairs, with the
    association made once at the centre pose (:520).  Only candidates below
    ``csm_cost_threshold`` are expanded or returned (:544-561); with none,
    the initial pose and cost inf come back (the JAX package's deviation from
    the reference's identity return)."""
    mcfg = cfg.matcher
    if use_intensity is None:
        use_intensity = bool(mcfg.use_intensity_as_dimension)
    win_l = mcfg.csm_window_linear if search_window_linear is None else min(
        search_window_linear, mcfg.csm_window_linear)
    win_a = mcfg.csm_window_angular if search_window_angular is None else min(
        search_window_angular, mcfg.csm_window_angular)
    lin_step = mcfg.csm_linear_step
    ang_step = float(np.arccos(
        1.0 - (lin_step * lin_step) / (2.0 * mcfg.csm_max_px_accurate_range ** 2)))
    n_iter = mcfg.csm_n_iter
    K = 4  # fixed neighbor count of the reference's CSM association (:520)
    dtype, dev = init_pose.dtype, init_pose.device

    q_mu, q_cov = transform_mean_cov(init_pose, m_mean, m_cov)
    # Association happens once at the window centre; the cutoff must cover
    # cells reachable anywhere inside the search window.
    cutoff = (cfg.ndt_map.nn_window_radius + 0.5) * cfg.ndt_map.resolution
    cutoff = max(cutoff, 0.5 * win_l + cfg.ndt_map.resolution)
    assoc = G.allpairs_neighbors(
        f_mean, f_cov, f_valid, q_mu, q_cov, m_valid, K, cutoff,
        use_distribution_metric=bool(mcfg.lookup_distribution) and use_intensity)
    pair_valid = assoc.valid                                    # (B, C, K)
    m_mu_b, m_cov_b = _loop_pairs(m_mean, m_cov, m_valid, assoc)
    n_pairs = torch.clamp(torch.sum(pair_valid, dim=(-2, -1)), min=1)

    def score(poses):  # (B, G, 3) -> (B, G) mean robust cost
        r = R.ndt_residual(
            poses[:, :, None, None, :], m_mu_b[:, None], m_cov_b[:, None],
            assoc.mean[:, None], assoc.cov[:, None], use_intensity=use_intensity)
        rho = barron.rho(r * r, mcfg.loss_function_scale,
                         mcfg.loss_function_convexity, 1.0)
        c = torch.sum(torch.where(pair_valid[:, None], rho, 0.0), dim=(-2, -1))
        return 0.5 * c / n_pairs[:, None]  # Ceres cost convention (0.5 sum rho)

    # coarsest level grid around init_pose
    step0 = (2.0 ** (n_iter - 1)) * lin_step
    nx = max(1, int(win_l / step0)) + 1
    na = max(1, int(win_a / ang_step))
    txs = torch.linspace(-win_l / 2.0, win_l / 2.0, nx, dtype=dtype, device=dev)
    angs = -win_a / 2.0 + torch.arange(na, dtype=dtype, device=dev) * ang_step
    TX, TY, AA = torch.meshgrid(txs, txs, angs, indexing="ij")
    local = torch.stack([TX.reshape(-1), TY.reshape(-1), AA.reshape(-1)], dim=-1)
    cands = compose(init_pose[:, None, :], local[None])        # (B, G, 3)
    costs = score(cands)
    thresh = mcfg.csm_cost_threshold

    def fold_best(best_pose, best_cost, cands, costs):
        """Running optimum over below-threshold candidates only."""
        masked = torch.where(costs < thresh, costs, float("inf"))
        i = torch.argmin(masked, dim=-1, keepdim=True)
        m = torch.gather(masked, -1, i)[:, 0]
        pick = torch.gather(cands, 1, i[..., None].expand(-1, 1, 3))[:, 0]
        return (torch.where((m < best_cost)[:, None], pick, best_pose),
                torch.minimum(m, best_cost))

    best_pose, best_cost = fold_best(
        init_pose, torch.full(init_pose.shape[:1], float("inf"), dtype=dtype,
                              device=dev), cands, costs)
    offs = runtime.const(
        np.array([[dx, dy, da] for dx in (-1.0, 0.0, 1.0) for dy in (-1.0, 0.0, 1.0)
                  for da in (-1.0, 0.0, 1.0)], np.float32), dtype, dev)
    for level in range(1, n_iter + 1):
        # Only below-threshold candidates may seed expansions (:544); the
        # beam is nearest first, lower index first among ties (lax.top_k).
        expandable = torch.where(costs < thresh, costs, float("inf"))
        top_i, top_c = G.smallest_k(expandable, min(beam_width, costs.shape[-1]))
        parent_ok = torch.isfinite(top_c)
        best = torch.gather(cands, 1, top_i[..., None].expand(-1, -1, 3))
        step = (2.0 ** max(n_iter - 1 - level, -1)) * lin_step
        local = offs * runtime.const(np.array([step, step, ang_step], np.float32),
                                     dtype, dev)
        cands = compose(best[:, :, None, :], local[None, None]).reshape(
            best.shape[0], -1, 3)
        costs = score(cands)
        costs = torch.where(
            torch.repeat_interleave(parent_ok, offs.shape[0], dim=-1),
            costs, float("inf"))
        best_pose, best_cost = fold_best(best_pose, best_cost, cands, costs)
    return best_pose, best_cost


class LoopEstimate(NamedTuple):
    pose: torch.Tensor       # (B, 3)
    mean_cost: torch.Tensor  # (B,) final robust cost / residual count
    n_pairs: torch.Tensor    # (B,)


@profiling.span("randt.loop_refine")
def estimate_loop(cfg: SlamConfig, init_pose, f_mean, f_cov, f_valid,
                  m_mean, m_cov, m_valid) -> LoopEstimate:
    """GNC refinement of a batch of loop-closure candidates
    (``Matcher::estimateLoopConstraint``, ``ndt_matcher.cpp:426-493``):
    init_pose (B, 3) relative transforms, f_* (B, F, ...) compacted fixed
    submap cells, m_* (B, C, ...) moving scan cells.

    The fixed submap is a flat cell list, so association is the masked
    all-pairs top-k with the search window's L-inf cutoff.
    ``use_intensity_in_loop_closure`` picks the 3-D or 2-D residual and the
    lookup metric (``local_fuser.cpp:335``).  The JAX package linearizes the
    3-parameter pose densely with ``jax.jacfwd``; here each residual's
    Jacobian row comes from reverse mode on per-residual copies of its
    candidate's pose (one backward pass per linearization), and the damped
    3x3 solves are one batched ``solve_ex``."""
    mcfg = cfg.matcher
    lcfg = cfg.local_fuser
    K = mcfg.n_results_nn_lookup
    use_int = bool(lcfg.use_intensity_in_loop_closure)
    B = init_pose.shape[0]
    dtype, dev = init_pose.dtype, init_pose.device

    q_mu, q_cov = transform_mean_cov(init_pose, m_mean, m_cov)
    cutoff = (cfg.ndt_map.nn_window_radius + 0.5) * cfg.ndt_map.resolution
    assoc = G.allpairs_neighbors(
        f_mean, f_cov, f_valid, q_mu, q_cov, m_valid, K, cutoff,
        use_distribution_metric=bool(mcfg.lookup_distribution) and use_int)
    pair_valid = assoc.valid                                    # (B, C, K)
    m_mu_b, m_cov_b = _loop_pairs(m_mean, m_cov, m_valid, assoc)
    scale = lcfg.loop_closure_scale
    alpha = mcfg.loss_function_convexity
    ndt_scale = torch.ones((B,), dtype=dtype, device=dev)  # ScaledLoss 1 (:479)
    no_aux = torch.zeros((1,), dtype=torch.bool, device=dev)

    def residual_fn(pose):
        r = R.ndt_residual(pose[:, None, None, :], m_mu_b, m_cov_b,
                           assoc.mean, assoc.cov, use_intensity=use_int)
        return r.reshape(B, -1), pose.new_zeros((B, 1))

    def linearize_fn(pose, mu):
        with torch.enable_grad():
            pr = pose.detach()[:, None, None, :].expand(
                *pair_valid.shape, 3).clone().requires_grad_(True)
            r = R.ndt_residual(pr, m_mu_b, m_cov_b, assoc.mean, assoc.cov,
                               use_intensity=use_int)
            (J,) = torch.autograd.grad(r.sum(), pr)
        r = r.detach()
        w = barron.weight(r * r, scale, alpha, mu[:, None, None])
        w = torch.where(pair_valid, w, 0.0)
        H = torch.einsum("bck,bcki,bckj->bij", w, J, J)
        g = torch.einsum("bck,bcki->bi", w * r, J)
        return H, g

    res = solver.gnc_solve(
        residual_fn,
        linearize_fn,
        init_pose,
        runtime.const(np.ones(3, bool), torch.bool, dev),
        runtime.const(np.array([False, False, True]), torch.bool, dev),
        pair_valid.reshape(B, -1),
        no_aux,
        ndt_scale,
        scale,
        alpha,
        lcfg.loop_closure_gnc_steps,
        mcfg.gnc_control_parameter_divisor,
        mcfg.lm_max_iterations,
        mcfg.lm_tolerance,
        lm_ftol=mcfg.lm_function_tolerance,
    )
    n = torch.clamp(res.n_ndt_valid, min=1)
    return LoopEstimate(pose=res.params, mean_cost=res.cost / n,
                        n_pairs=res.n_ndt_valid)
