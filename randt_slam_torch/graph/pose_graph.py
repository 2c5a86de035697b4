"""2-D pose-graph optimization: Gauss-Newton with LM damping on the device.

Port of ``randt_slam_tpu/graph/pose_graph.py`` (``GlobalFuser::
optimizePoseGraph``, ``global_fuser.cpp:13-105``): the normal equations of
all edges are assembled at once from closed-form 3x3 Jacobian blocks into a
dense (3N, 3N) system and solved with a damped Cholesky.  Radar pose graphs
are small (O(10^3) nodes); larger graphs take the Schur complement
(``graph/schur.py``).

Residual (``pose_graph_2d_error_term.h:63-105``):
    r = sqrtI @ [ R_a^T (p_b - p_a) - t_ab ; Normalize(yaw_b - yaw_a - yaw_ab) ]

Edge selection as ``global_fuser.cpp:30-47``: consecutive edges always, loop
edges only while ``id_end <= max_update_index``; node 0 is gauge-fixed
(:48-49).  Robust losses (Huber, DCS) enter as IRLS weights.

The block scatter into the (3N, 3N) system is one ``runtime.index_add`` on
flattened indices, reproducible on CUDA.  ``optimize`` reads the ``done``
flag on the host once per iteration (the pose graph runs once per run).
The JAX package's ``optimize_bucketed`` only pads shapes so the TPU reuses
compiled code, and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import runtime
from ..config import GlobalFuserConfig
from ..geometry import normalize_angle
from ..utils import profiling


class PoseGraph(NamedTuple):
    """Edge list (``valid`` masks padded or filtered edges)."""

    poses: torch.Tensor             # (N, 3) initial node poses
    id_begin: torch.Tensor          # (E,) int64
    id_end: torch.Tensor            # (E,) int64
    trans: torch.Tensor             # (E, 3) measured relative SE(2)
    sqrt_information: torch.Tensor  # (E, 3, 3)
    valid: torch.Tensor             # (E,) bool


def edge_residuals(poses, g: PoseGraph):
    """(E, 3) whitened residuals."""
    pa = poses[g.id_begin]
    pb = poses[g.id_end]
    ca, sa = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    ex = ca * dx + sa * dy - g.trans[:, 0]
    ey = -sa * dx + ca * dy - g.trans[:, 1]
    eth = normalize_angle(pb[:, 2] - pa[:, 2] - g.trans[:, 2])
    e = torch.stack([ex, ey, eth], dim=-1)
    return torch.einsum("eij,ej->ei", g.sqrt_information, e)


def _edge_jacobians(poses, g: PoseGraph):
    """Closed-form (E, 3, 3) Jacobian blocks w.r.t. pose_a and pose_b."""
    pa = poses[g.id_begin]
    pb = poses[g.id_end]
    ca, sa = torch.cos(pa[:, 2]), torch.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    zero = torch.zeros_like(ca)
    one = torch.ones_like(ca)
    # d e / d pose_a : [[-c, -s, -s*dx + c*dy], [s, -c, -c*dx - s*dy], [0,0,-1]]
    Ja = torch.stack([
        torch.stack([-ca, -sa, -sa * dx + ca * dy], dim=-1),
        torch.stack([sa, -ca, -ca * dx - sa * dy], dim=-1),
        torch.stack([zero, zero, -one], dim=-1),
    ], dim=-2)
    Jb = torch.stack([
        torch.stack([ca, sa, zero], dim=-1),
        torch.stack([-sa, ca, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    Ja = torch.einsum("eij,ejk->eik", g.sqrt_information, Ja)
    Jb = torch.einsum("eij,ejk->eik", g.sqrt_information, Jb)
    return Ja, Jb


def spd_solve(H, b):
    """Solve the damped, gauge-fixed SPD normal equations by Cholesky
    (``cholesky_ex``: no host-side check of the factorization's info)."""
    L = torch.linalg.cholesky_ex(H)[0]
    if b.dim() == H.dim() - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)


def _huber_weight(r, scale):
    """IRLS weight of Ceres' HuberLoss on s = ||r||^2."""
    s = torch.sum(r * r, dim=-1)
    b = scale * scale
    return torch.where(s <= b, 1.0, torch.sqrt(b / torch.clamp(s, min=1e-30)))


def _dcs_weight(r, scale):
    """IRLS weight of Dynamic Covariance Scaling (Agarwal et al., ICRA 2013):
    min(1, (2 phi / (phi + s))^2), s = ||r||^2, phi = scale^2; it redescends,
    driving gross outliers to ~zero."""
    s = torch.sum(r * r, dim=-1)
    phi = scale * scale
    return torch.clamp((2.0 * phi / (phi + s)) ** 2, max=1.0)


def robust_spec(cfg: GlobalFuserConfig):
    """``None`` when the robust loss is off, else ``(kernel,
    loop_edges_only)``.  The DCS loop defense (``cfg.dcs_loop_defense``) is
    not reflected here: it acts only in stage 2 of ``schur.optimize_auto``'s
    two-stage schedule (a redescending kernel from a drifted start would
    suppress genuine loop edges)."""
    if not cfg.use_robust_loss:
        return None
    return (cfg.robust_kernel, bool(cfg.robust_loop_edges_only))


def robust_two_stage(cfg: GlobalFuserConfig) -> bool:
    """Whether the solve runs the two-stage schedule: always for the DCS
    defense, opt-in for the reference-parity robust knob."""
    if cfg.dcs_loop_defense:
        return True
    return bool(cfg.use_robust_loss and cfg.robust_two_stage)


def robust_weight(r, id_begin, id_end, scale, spec):
    """Per-edge IRLS weight for a robust spec."""
    kernel, loop_only = spec
    if kernel == "dcs":
        w = _dcs_weight(r, scale)
    elif kernel == "huber":
        w = _huber_weight(r, scale)
    else:
        raise ValueError(f"unknown robust kernel {kernel!r}")
    if loop_only:
        w = torch.where(id_begin + 1 != id_end, w, 1.0)
    return w


def edge_blocks(poses, g: PoseGraph, robust, huber_scale: float):
    """Per-edge weighted normal-equation blocks (Haa, Hab, Hbb (E, 3, 3),
    ga, gb (E, 3)), the IRLS weights w (E,) and the residuals r (E, 3)."""
    r = edge_residuals(poses, g)
    Ja, Jb = _edge_jacobians(poses, g)
    w = g.valid.to(poses.dtype)
    if robust is not None:
        w = w * robust_weight(r, g.id_begin, g.id_end, huber_scale, robust)
    Wa = Ja * w[:, None, None]
    Wb = Jb * w[:, None, None]
    return (torch.einsum("eij,eik->ejk", Wa, Ja),
            torch.einsum("eij,eik->ejk", Wa, Jb),
            torch.einsum("eij,eik->ejk", Wb, Jb),
            torch.einsum("eij,ei->ej", Wa, r),
            torch.einsum("eij,ei->ej", Wb, r), w, r)


def _assemble(poses, g: PoseGraph, robust, huber_scale: float):
    """(H (3N, 3N), grad (3N,), cost) of the weighted edges.  The four 3x3
    blocks of every edge are scattered in the JAX package's order (all
    (a, a) blocks, then (a, b), (b, a), (b, b)) by one index_add."""
    N = poses.shape[0]
    Haa, Hab, Hbb, ga, gb, w, r = edge_blocks(poses, g, robust, huber_scale)

    ia, ib = g.id_begin.long(), g.id_end.long()
    k3 = torch.arange(3, device=poses.device)
    rows = torch.stack([ia, ia, ib, ib])[:, :, None] * 3 + k3      # (4, E, 3)
    cols = torch.stack([ia, ib, ia, ib])[:, :, None] * 3 + k3
    flat = rows[..., :, None] * (3 * N) + cols[..., None, :]          # (4, E, 3, 3)
    blocks = torch.stack([Haa, Hab, Hab.transpose(-1, -2), Hbb])
    H = runtime.index_add(poses.new_zeros(9 * N * N), flat.reshape(-1),
                          blocks.reshape(-1))
    gidx = torch.cat([ia, ib])[:, None] * 3 + k3
    grad = runtime.index_add(poses.new_zeros(3 * N), gidx.reshape(-1),
                             torch.cat([ga, gb]).reshape(-1))
    cost = 0.5 * torch.sum(w * torch.sum(r * r, dim=-1))
    return H.reshape(3 * N, 3 * N), grad, cost


def _filter_loops(g: PoseGraph, max_update_index):
    if max_update_index is None:
        return g
    consecutive = g.id_begin + 1 == g.id_end
    keep = consecutive | (g.id_end <= max_update_index)
    return g._replace(valid=g.valid & keep)


def _fixed_first(N: int, device):
    fixed = torch.zeros(N, dtype=torch.bool, device=device)
    fixed[0] = True
    return fixed


def lm_loop(poses, assemble, trial_cost, free_f, cfg: GlobalFuserConfig):
    """Gauss-Newton with LM damping: ``assemble(poses) -> (H, grad, cost)``
    of the normal equations, ``trial_cost(poses)`` the cost at a trial, the
    float mask ``free_f`` (3N,) of the free parameters.  Runs until the step
    is small or the damping gives up, at most ``cfg.max_iterations``
    iterations, reading ``done`` on the host once per iteration.  Returns
    (poses, {"cost", "iterations"})."""
    N = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    lam = torch.tensor(1e-6, dtype=dtype).to(dev)
    cost = torch.tensor(float("inf"), dtype=dtype).to(dev)
    it = 0
    while it < cfg.max_iterations:
        H, grad, cost_cur = assemble(poses)
        H = H * free_f[:, None] * free_f[None, :]
        grad = grad * free_f
        damp = lam * torch.clamp(torch.diagonal(H), min=1e-8) + (1.0 - free_f)
        delta = -spd_solve(H + torch.diag(damp), grad) * free_f
        trial = poses + delta.reshape(N, 3)
        trial = torch.cat([trial[:, :2], normalize_angle(trial[:, 2:])], dim=1)
        cost_new = trial_cost(trial)
        accept = cost_new < cost_cur
        small = torch.linalg.vector_norm(delta) < cfg.tolerance * (
            1.0 + torch.linalg.vector_norm(poses))
        done = (accept & small) | ((~accept) & (lam >= 1e7))
        poses = torch.where(accept, trial, poses)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 4.0), 1e-12, 1e8)
        cost = torch.where(accept, cost_new, cost_cur)
        it += 1
        if bool(done):
            break
    return poses, {"cost": float(cost), "iterations": it}


@profiling.span("randt.pgo")
def optimize(g: PoseGraph, cfg: GlobalFuserConfig, max_update_index=None,
             fixed_mask=None):
    """Gauss-Newton with LM damping over the whole graph (:func:`lm_loop`).

    max_update_index: loop edges with id_end above it are left out (odometry
    edges always kept, ``global_fuser.cpp:31``); fixed_mask (N,) bool marks
    gauge-fixed nodes (default: node 0 only).  Returns (poses, {"cost",
    "iterations"})."""
    N = g.poses.shape[0]
    if fixed_mask is None:
        fixed_mask = _fixed_first(N, g.poses.device)
    g = _filter_loops(g, max_update_index)
    free_f = (~torch.repeat_interleave(fixed_mask, 3)).to(g.poses.dtype)
    robust = robust_spec(cfg)

    def assemble(poses):
        return _assemble(poses, g, robust, cfg.loss_function_scale)

    return lm_loop(g.poses, assemble, lambda poses: assemble(poses)[2], free_f, cfg)


def recover_covariances(g: PoseGraph, poses, cfg: GlobalFuserConfig,
                        fixed_mask=None):
    """Marginal per-node covariances (N, 3, 3): the diagonal blocks of H^-1
    at the solution (``ceres::Covariance`` over (pos, rot) blocks, present
    but commented out in the reference, ``global_fuser.cpp:62-87``).
    Gauge-fixed nodes get zeros.  A dense inverse: radar pose graphs are
    O(10^3) nodes."""
    N = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    if fixed_mask is None:
        fixed_mask = _fixed_first(N, dev)
    H, _, _ = _assemble(poses, g, robust_spec(cfg), cfg.loss_function_scale)
    free = (~torch.repeat_interleave(fixed_mask, 3)).to(dtype)
    # gauge-fix: identity rows/cols on fixed params, a small ridge elsewhere
    Hf = H * free[:, None] * free[None, :] + torch.diag(1.0 - free + 1e-9)
    cov = spd_solve(Hf, torch.eye(3 * N, dtype=dtype, device=dev))
    diag = torch.diagonal(cov.reshape(N, 3, N, 3), dim1=0, dim2=2)  # (3, 3, N)
    diag = diag.permute(2, 0, 1)
    f3 = free.reshape(N, 3)
    return diag * f3[:, :, None] * f3[:, None, :]
