"""Pose-graph solve by size: dense, or the submap Schur complement.

Port of ``randt_slam_tpu/graph/schur.py``.  The SLAM graph's
nodes group into submaps whose ROOT nodes are the only ones loop edges
attach to (``local_fuser.cpp:341-347``), and odometry chains cross submap
boundaries only at roots.  Ordering the variables [interiors | roots] makes
the interior block A of the normal equations block-diagonal by submap:

    H = [[A, B], [B^T, C]],   A = diag(A_1 ... A_S)

so each Gauss-Newton step runs as

1. per-submap assembly of (A_s, B_s, g_s), B_s over the submap's LOCAL
   separator set (its own root, the next root and the loop roots its
   interiors touch: L slots), batched over submaps;
2. a batched damped Cholesky of the A_s and the local Schur contributions
   B_s^T A_s^-1 B_s, B_s^T A_s^-1 g_s;
3. their scatter into the (3R, 3R) reduced system over the R roots;
4. a dense solve for the root increment;
5. a batched back-substitution for the interiors.

:func:`optimize_auto` routes the solve the way the JAX package does
(:708-771), the counterpart of the reference handing every solve to Ceres'
``SPARSE_NORMAL_CHOLESKY`` + ``SCHUR_JACOBI`` (``global_fuser.cpp:52-59``):
graphs of at most ``dense_node_limit`` nodes, or without submap structure,
take the dense normal equations (:func:`pose_graph.optimize`); larger graphs
with submap structure take :func:`optimize_schur`.  The shipped DCS loop
defense runs as a two-stage schedule on either route: plain least squares to
convergence, then DCS on the loop edges only, from that optimum.

With a group of ranks (``parallel/mesh.py``, one process per card) two
sharded solves run, as the JAX package's mesh paths do: the submap Schur
route shards the submaps (steps 1, 2 and 5 run on each rank's slice; the
compact blocks are all-gathered in submap order, and every rank scatters
and solves the same reduced system), and :func:`optimize_distributed`
shards the edges of the dense normal equations, all-reduced every
iteration.  The JAX package's compile caches and its shape bucketing
(node and edge counts to 256, roots to 8) serve the TPU's compiler and are
not ported.  The index scatters go through ``runtime.index_add``, so the
solve repeats bitwise on CUDA; the loops read their ``done`` flag on the
host once per iteration, as :func:`pose_graph.optimize` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..config import GlobalFuserConfig
from ..geometry import normalize_angle
from ..parallel import mesh
from ..utils import profiling
from . import pose_graph as PG


# ---------------------------------------------------------------------------
# the edge-sharded dense solve
# ---------------------------------------------------------------------------


def _pad_edges(g: PG.PoseGraph, multiple: int) -> PG.PoseGraph:
    """``g`` with invalid edges (node 0 to node 0, zero weight) appended up
    to a multiple of ``multiple`` edges."""
    pad = (-g.id_begin.shape[0]) % multiple
    if pad == 0:
        return g
    return PG.PoseGraph(g.poses, *(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                                   for x in g[1:]))


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def optimize_distributed(g: PG.PoseGraph, cfg: GlobalFuserConfig, group):
    """Gauss-Newton with LM damping (:func:`pose_graph.lm_loop`, node 0
    fixed), the assembly sharded over the group's ranks by edges:
    the edges are padded to a multiple of the group's size, each rank
    assembles H, grad and cost over its contiguous share, and one
    all-reduce per iteration sums H (3N, 3N) and grad (3N,), packed.  The
    ranks' costs are all-gathered and summed in rank order, at the current
    poses and at the trial: the accept test compares the two, so a cost
    must have the same bits however it was reduced (an all-reduce may sum
    in another order from one call to the next).  Every rank runs the same
    step on the same sums.  ``group=None`` is one rank, no collective.
    Returns (poses, {"cost", "iterations"})."""
    with mesh.rank_ids(group), profiling.span("randt.pgo_distributed"):
        return _optimize_distributed(g, cfg, group)


def _optimize_distributed(g: PG.PoseGraph, cfg: GlobalFuserConfig, group):
    g = _pad_edges(g, _group_size(group))
    lo, hi = mesh.shard_range(g.id_begin.shape[0], group)
    shard = PG.PoseGraph(g.poses, *(x[lo:hi] for x in g[1:]))
    N = g.poses.shape[0]
    free_f = (~torch.repeat_interleave(PG._fixed_first(N, g.poses.device), 3)).to(
        g.poses.dtype)
    robust, scale = PG.robust_spec(cfg), cfg.loss_function_scale

    def summed(cost):
        return cost if group is None else mesh.all_gather_cat(cost[None], group).sum()

    def assemble(poses):
        H, grad, cost = PG._assemble(poses, shard, robust, scale)
        if group is None:
            return H, grad, cost
        flat = mesh.all_reduce_sum(torch.cat([H.reshape(-1), grad]), group)
        return flat[:H.numel()].reshape(H.shape), flat[H.numel():], summed(cost)

    return PG.lm_loop(g.poses, assemble,
                      lambda poses: summed(total_cost(poses, shard, robust, scale)),
                      free_f, cfg)


# ---------------------------------------------------------------------------
# the submap Schur complement
# ---------------------------------------------------------------------------


class SchurLayout(NamedTuple):
    """Host-built static partition of a SLAM pose graph for the Schur solve.

    S   = number of submaps (padded to a multiple of the group's size)
    I   = max interiors per submap
    Es  = max edges owned per submap (interior-interior + interior-root)
    R   = number of root (separator) nodes == number of real submaps
    """

    # node bookkeeping
    int_node: np.ndarray     # (S, I) global node id per interior slot, -1 pad
    int_valid: np.ndarray    # (S, I)
    root_node: np.ndarray    # (R,) global node id per separator index
    # per-submap owned edges; endpoints in LOCAL coordinates:
    #   kind 0: a = interior slot, b = interior slot
    #   kind 1: a = interior slot, b = LOCAL separator slot
    #   kind 2: a = LOCAL separator slot, b = interior slot
    edge_idx: np.ndarray     # (S, Es) global edge index, -1 pad
    edge_kind: np.ndarray    # (S, Es)
    edge_a: np.ndarray       # (S, Es) local slot of endpoint id_begin
    edge_b: np.ndarray       # (S, Es) local slot of endpoint id_end
    # separators each submap touches, local slot -> global separator index
    sep_ids: np.ndarray      # (S, L) global separator index, -1 pad
    # separator-separator edges (1-node submaps)
    ss_idx: np.ndarray       # (Ess,) global edge index
    ss_a: np.ndarray         # (Ess,) separator index of id_begin
    ss_b: np.ndarray         # (Ess,)
    n_submaps: int


def build_layout(node_submap, node_is_root, id_begin, id_end,
                 pad_submaps_to: int = 1) -> SchurLayout:
    """Host-side static partition (numpy; runs once per solve).  The
    submaps are padded to a multiple of ``pad_submaps_to`` (the group's
    size) with empty ones: no interior, no edge, every separator slot
    unused.  The JAX package's arguments that round I, Es and L up to
    compile buckets are left out: with their defaults the arrays are the
    same.  An edge that couples the interiors of two submaps fails the
    ``assert``: the Schur layout needs the interior block to be
    submap-diagonal."""
    node_submap = np.asarray(node_submap)
    node_is_root = np.asarray(node_is_root, bool)
    id_begin = np.asarray(id_begin)
    id_end = np.asarray(id_end)
    R = int(node_is_root.sum())
    root_ids = np.nonzero(node_is_root)[0]
    root_node = np.zeros(R, np.int32)
    sep_of_node = np.full(len(node_submap), -1, np.int32)
    for s, nid in enumerate(root_ids):
        root_node[s] = nid
        sep_of_node[nid] = s
    S = max(R, 1)
    S_pad = -(-S // pad_submaps_to) * pad_submaps_to

    # interior slots per submap
    int_lists = [[] for _ in range(S)]
    int_slot = np.full(len(node_submap), -1, np.int32)
    for nid in range(len(node_submap)):
        if node_is_root[nid]:
            continue
        s = int(node_submap[nid])
        int_slot[nid] = len(int_lists[s])
        int_lists[s].append(nid)
    I = max(1, max((len(l) for l in int_lists), default=1))
    int_node = np.full((S_pad, I), -1, np.int32)
    for s, l in enumerate(int_lists):
        int_node[s, :len(l)] = l

    # edge ownership; separator endpoints become LOCAL slots per submap
    owned = [[] for _ in range(S)]
    local_seps = [dict() for _ in range(S)]  # global sep -> local slot

    def local_sep(s, sep):
        d = local_seps[s]
        if sep not in d:
            d[sep] = len(d)
        return d[sep]

    ss = []
    for e in range(len(id_begin)):
        a, b = int(id_begin[e]), int(id_end[e])
        ra, rb = node_is_root[a], node_is_root[b]
        if ra and rb:
            ss.append((e, sep_of_node[a], sep_of_node[b]))
        elif ra:  # separator -> interior
            s = int(node_submap[b])
            owned[s].append((e, 2, local_sep(s, int(sep_of_node[a])),
                             int_slot[b]))
        elif rb:  # interior -> separator
            s = int(node_submap[a])
            owned[s].append((e, 1, int_slot[a],
                             local_sep(s, int(sep_of_node[b]))))
        else:
            sa, sb = int(node_submap[a]), int(node_submap[b])
            assert sa == sb, (
                f"edge {e} couples interiors of submaps {sa} and {sb}; "
                "the Schur layout requires interior blocks to be "
                "submap-diagonal")
            owned[sa].append((e, 0, int_slot[a], int_slot[b]))
    Es = max(1, max((len(l) for l in owned), default=1))
    L = max(1, max((len(d) for d in local_seps), default=1))
    edge_idx = np.full((S_pad, Es), -1, np.int32)
    edge_kind = np.zeros((S_pad, Es), np.int32)
    edge_a = np.zeros((S_pad, Es), np.int32)
    edge_b = np.zeros((S_pad, Es), np.int32)
    sep_ids = np.full((S_pad, L), -1, np.int32)
    for s, l in enumerate(owned):
        for j, (e, k, a, b) in enumerate(l):
            edge_idx[s, j] = e
            edge_kind[s, j] = k
            edge_a[s, j] = a
            edge_b[s, j] = b
    for s, d in enumerate(local_seps):
        for sep, slot in d.items():
            sep_ids[s, slot] = sep
    ss = np.asarray(ss, np.int64).reshape(-1, 3)
    return SchurLayout(
        int_node=int_node,
        int_valid=int_node >= 0,
        root_node=root_node,
        edge_idx=edge_idx, edge_kind=edge_kind,
        edge_a=edge_a, edge_b=edge_b,
        sep_ids=sep_ids,
        ss_idx=ss[:, 0].astype(np.int32),
        ss_a=ss[:, 1].astype(np.int32),
        ss_b=ss[:, 2].astype(np.int32),
        n_submaps=S,
    )


def _edge_terms(poses, g: PG.PoseGraph, idx, valid, robust, scale):
    """:func:`pose_graph.edge_blocks` of the edges ``idx``; ``valid`` masks
    padded entries (weight 0)."""
    sub = PG.PoseGraph(poses=poses, id_begin=g.id_begin[idx],
                       id_end=g.id_end[idx], trans=g.trans[idx],
                       sqrt_information=g.sqrt_information[idx],
                       valid=g.valid[idx] & valid)
    return PG.edge_blocks(poses, sub, robust, scale)[:5]


def _block_index(s, row, col, n_rows, n_cols):
    """Flat indices (numpy) of the 3x3 blocks at (row, col) of per-submap
    (n_rows, 3, n_cols, 3) matrices, (..., 3, 3)."""
    k3 = np.arange(3)
    r = (s * n_rows + row)[..., None] * 3 + k3             # (..., 3)
    c = col[..., None] * 3 + k3
    return r[..., :, None] * (3 * n_cols) + c[..., None, :]


def _vector_index(s, slot, n_slots):
    return (s * n_slots + slot)[..., None] * 3 + np.arange(3)


class _Layout(NamedTuple):
    """A :class:`SchurLayout` on the device: the owned edges of this rank's
    submaps (all of them without a group) and the flat indices they scatter
    to in the per-submap blocks (slot I, and L, is the dump of the
    endpoints an edge kind does not scatter to, as in the JAX package's
    ``_submap_blocks``), the separator DOF map and the gauge.  Built once
    per solve."""

    edge_idx: torch.Tensor    # (S * Es,) global edge index, 0 where padded
    edge_ok: torch.Tensor     # (S * Es,) bool
    is_ii: torch.Tensor       # (S, Es) bool: interior-interior
    is_is: torch.Tensor       # interior -> separator
    is_si: torch.Tensor       # separator -> interior
    a_index: torch.Tensor     # into (S, I+1, 3, I+1, 3): Haa, Hbb, Hab, Hba
    b_index: torch.Tensor     # into (S, I+1, 3, L+1, 3): Hab (IS), Hba (SI)
    c_index: torch.Tensor     # into (S, L+1, 3, 3): Haa (SI), Hbb (IS)
    gi_index: torch.Tensor    # into (S, I+1, 3): ga, gb
    gs_index: torch.Tensor    # into (S, L+1, 3): ga (SI), gb (IS)
    int_valid: torch.Tensor   # (S, I) bool
    dof_rows: torch.Tensor    # (S, 3L) reduced-system index; 3R = dump
    # every submap's, for the reduced system and the update
    int_valid_all: torch.Tensor  # (S_all, I) bool
    int_node_safe: torch.Tensor  # (S_all, I) int64, 0 where padded
    dof_all: torch.Tensor     # (S_all, 3L)
    root_node: torch.Tensor   # (R,) int64
    ss_idx: torch.Tensor      # (Ess,) separator-separator edges
    ss_c_index: torch.Tensor  # into (3R, 3R): Haa, Hbb, Hab, Hba
    ss_g_index: torch.Tensor  # into (3R,): ga, gb
    sep_free: torch.Tensor    # (3R,) float; the first root fixed (gauge)
    S: int
    Es: int
    I: int
    L: int
    R: int


def _prepare(g: PG.PoseGraph, node_submap, node_is_root, group=None) -> _Layout:
    """The layout of the whole graph, its submaps padded to the group's
    size, with this rank's slice of them."""
    full = build_layout(node_submap, node_is_root, g.id_begin.cpu().numpy(),
                        g.id_end.cpu().numpy(), pad_submaps_to=_group_size(group))
    dev, dtype = g.poses.device, g.poses.dtype
    R = len(full.root_node)
    (S_all, I), L = full.int_node.shape, full.sep_ids.shape[1]
    Es = full.edge_idx.shape[1]
    # padded separator slots scatter into the dump row/column 3R
    dof = np.where(full.sep_ids[:, :, None] >= 0,
                   full.sep_ids[:, :, None] * 3 + np.arange(3)[None, None, :],
                   3 * R).reshape(S_all, 3 * L)
    lo, hi = mesh.shard_range(S_all, group)
    S = hi - lo
    lay = full._replace(**{k: getattr(full, k)[lo:hi] for k in (
        "int_node", "int_valid", "edge_idx", "edge_kind", "edge_a", "edge_b",
        "sep_ids")})

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int64).reshape(-1)).to(dev)

    def mask(x):
        return torch.from_numpy(x).to(dev)

    kind, ea, eb = lay.edge_kind, lay.edge_a, lay.edge_b
    is_ii, is_is, is_si = kind == 0, kind == 1, kind == 2
    ia_int = np.where(is_ii | is_is, ea, I)    # interior slot of endpoint a
    ib_int = np.where(is_ii | is_si, eb, I)
    ia_sep = np.where(is_si, ea, L)            # separator slot of endpoint a
    ib_sep = np.where(is_is, eb, L)
    s = np.arange(S)[:, None]
    k9 = np.arange(9)
    sa, sb = lay.ss_a.astype(np.int64), lay.ss_b.astype(np.int64)
    # gauge: the first root is fixed (the dense path fixes node 0)
    sep_free = np.ones((R, 3), np.float32)
    sep_free[:1] = 0.0
    return _Layout(
        edge_idx=put(np.maximum(lay.edge_idx, 0)), edge_ok=mask(lay.edge_idx.reshape(-1) >= 0),
        is_ii=mask(is_ii), is_is=mask(is_is), is_si=mask(is_si),
        a_index=put([_block_index(s, ia_int, ia_int, I + 1, I + 1),
                     _block_index(s, ib_int, ib_int, I + 1, I + 1),
                     _block_index(s, ia_int, ib_int, I + 1, I + 1),
                     _block_index(s, ib_int, ia_int, I + 1, I + 1)]),
        b_index=put([_block_index(s, ia_int, ib_sep, I + 1, L + 1),
                     _block_index(s, ib_int, ia_sep, I + 1, L + 1)]),
        c_index=put([(s * (L + 1) + ia_sep)[..., None] * 9 + k9,
                     (s * (L + 1) + ib_sep)[..., None] * 9 + k9]),
        gi_index=put([_vector_index(s, ia_int, I + 1), _vector_index(s, ib_int, I + 1)]),
        gs_index=put([_vector_index(s, ia_sep, L + 1), _vector_index(s, ib_sep, L + 1)]),
        int_valid=mask(lay.int_valid), dof_rows=put(dof[lo:hi]).reshape(S, 3 * L),
        int_valid_all=mask(full.int_valid),
        int_node_safe=put(np.where(full.int_node >= 0, full.int_node, 0)).reshape(S_all, I),
        dof_all=put(dof).reshape(S_all, 3 * L), root_node=put(lay.root_node),
        ss_idx=put(lay.ss_idx),
        ss_c_index=put([_block_index(0, sa, sa, R, R), _block_index(0, sb, sb, R, R),
                        _block_index(0, sa, sb, R, R), _block_index(0, sb, sa, R, R)]),
        ss_g_index=put([_vector_index(0, sa, R), _vector_index(0, sb, R)]),
        sep_free=torch.from_numpy(sep_free.reshape(-1)).to(dtype).to(dev),
        S=S, Es=Es, I=I, L=L, R=R)


def _scatter(poses, index, parts, shape):
    """``parts`` stacked and added at the flat ``index`` into zeros of
    ``shape``."""
    return runtime.index_add(poses.new_zeros(math.prod(shape)), index,
                             torch.stack(parts).reshape(-1)).reshape(shape)


def _submap_blocks(poses, g: PG.PoseGraph, lay: _Layout, robust, scale):
    """Per-submap assembly, all submaps at once: A (S, I, 3, I, 3), B (S,
    I, 3, L, 3) over each submap's LOCAL separator slots, the root diagonal
    terms Csep (S, L, 3, 3), g_int (S, I, 3) and g_sep (S, L, 3)."""
    S, Es, I, L = lay.S, lay.Es, lay.I, lay.L
    Haa, Hab, Hbb, ga, gb = (x.reshape(S, Es, *x.shape[1:]) for x in
                             _edge_terms(poses, g, lay.edge_idx, lay.edge_ok,
                                         robust, scale))
    Hba = Hab.transpose(-1, -2)
    zero = poses.new_zeros(())

    def keep(m, x):
        return torch.where(m.reshape(m.shape + (1,) * (x.dim() - 2)), x, zero)

    ii, is_, si = lay.is_ii, lay.is_is, lay.is_si
    A = _scatter(poses, lay.a_index, [Haa, Hbb, keep(ii, Hab), keep(ii, Hba)],
                 (S, I + 1, 3, I + 1, 3))[:, :I, :, :I, :]
    B = _scatter(poses, lay.b_index, [keep(is_, Hab), keep(si, Hba)],
                 (S, I + 1, 3, L + 1, 3))[:, :I, :, :L, :]
    Csep = _scatter(poses, lay.c_index, [keep(si, Haa), keep(is_, Hbb)],
                    (S, L + 1, 3, 3))[:, :L]
    g_int = _scatter(poses, lay.gi_index, [keep(ii | is_, ga), keep(ii | si, gb)],
                     (S, I + 1, 3))[:, :I]
    g_sep = _scatter(poses, lay.gs_index, [keep(si, ga), keep(is_, gb)],
                     (S, L + 1, 3))[:, :L]
    return A, B, Csep, g_int, g_sep


def _ss_blocks(poses, g: PG.PoseGraph, lay: _Layout, robust, scale):
    """Separator-separator edge contributions, (3R, 3R) and (3R,)."""
    Haa, Hab, Hbb, ga, gb = _edge_terms(
        poses, g, lay.ss_idx, torch.ones_like(lay.ss_idx, dtype=torch.bool),
        robust, scale)
    R = lay.R
    C = _scatter(poses, lay.ss_c_index, [Haa, Hbb, Hab, Hab.transpose(-1, -2)],
                 (3 * R, 3 * R))
    return C, _scatter(poses, lay.ss_g_index, [ga, gb], (3 * R,))


def submap_pass(poses, g, lay: _Layout, lam, robust, scale):
    """Per-submap Schur contributions: the compact (S, 3L, 3L) blocks of
    C - B^T A^-1 B and (S, 3L) of g_sep - B^T A^-1 g_int over each submap's
    local separator slots, and the factorization the back-substitution
    reuses (chol, Bf, gf)."""
    A, B, Csep, g_int, g_sep = _submap_blocks(poses, g, lay, robust, scale)
    S, I, L = lay.S, lay.I, lay.L
    free = torch.repeat_interleave(lay.int_valid.to(poses.dtype), 3, dim=-1)  # (S, 3I)
    Af = A.reshape(S, 3 * I, 3 * I) * free[:, :, None] * free[:, None, :]
    damp = lam * torch.clamp(torch.diagonal(Af, dim1=1, dim2=2), min=1e-8) + (1.0 - free)
    Af = Af + torch.diag_embed(damp)
    Bf = B.reshape(S, 3 * I, 3 * L) * free[:, :, None]
    gf = g_int.reshape(S, 3 * I) * free
    chol = torch.linalg.cholesky_ex(Af)[0]
    AinvB = torch.cholesky_solve(Bf, chol)
    Ainvg = torch.cholesky_solve(gf[..., None], chol)[..., 0]
    # the root diagonal terms of the owned interior-root edges go on the
    # block diagonal of the local contribution
    eye = torch.eye(L, dtype=poses.dtype, device=poses.device)
    Cblk = (-torch.einsum("sab,sac->sbc", Bf, AinvB)
            + torch.einsum("slij,lm->slimj", Csep, eye).reshape(S, 3 * L, 3 * L))
    g_loc = g_sep.reshape(S, 3 * L) - torch.einsum("sab,sa->sb", Bf, Ainvg)
    return Cblk, g_loc, (chol, Bf, gf)


def scatter_reduced(Cblk, g_loc, lay: _Layout):
    """Every submap's compact blocks, in submap order, into the dense (3R,
    3R) reduced system; padded separator slots land in the dump row/column
    3R, sliced off."""
    n = 3 * lay.R + 1
    d = lay.dof_all
    C = runtime.index_add(Cblk.new_zeros(n * n),
                          (d[:, :, None] * n + d[:, None, :]).reshape(-1),
                          Cblk.reshape(-1)).reshape(n, n)
    gr = runtime.index_add(g_loc.new_zeros(n), d.reshape(-1), g_loc.reshape(-1))
    return C[:-1, :-1], gr[:-1]


def _gather_blocks(Cblk, g_loc, group):
    """Every rank's compact blocks and gradients in submap order, one
    all-gather of the pair: S (9 L^2 + 3 L) floats."""
    S, n = Cblk.shape[0], Cblk.shape[1]
    both = mesh.all_gather_cat(torch.cat([Cblk.reshape(S, n * n), g_loc], dim=1), group)
    return both[:, :n * n].reshape(-1, n, n), both[:, n * n:]


def reduced_system(poses, g, lay: _Layout, lam, robust, scale, group=None):
    """The reduced system over the roots, the same on every rank, and this
    rank's factorization for the back-substitution."""
    Cblk, g_loc, fact = submap_pass(poses, g, lay, lam, robust, scale)
    if group is not None:
        Cblk, g_loc = _gather_blocks(Cblk, g_loc, group)
    C_red, g_red = scatter_reduced(Cblk, g_loc, lay)
    if lay.ss_idx.numel():
        Css, gss = _ss_blocks(poses, g, lay, robust, scale)
        C_red, g_red = C_red + Css, g_red + gss
    return C_red, g_red, fact


def back_substitute(fact, lay: _Layout, dsep):
    """Interior increments (S, 3I) of this rank's submaps from the root
    increment."""
    chol, Bf, gf = fact
    dsep_loc = torch.cat([dsep, dsep.new_zeros(1)])[lay.dof_rows]   # (S, 3L)
    rhs = gf + torch.einsum("sab,sb->sa", Bf, dsep_loc)
    return -torch.cholesky_solve(rhs[..., None], chol)[..., 0]


def total_cost(poses, g: PG.PoseGraph, robust, scale):
    r = PG.edge_residuals(poses, g)
    w = g.valid.to(poses.dtype)
    if robust is not None:
        w = w * PG.robust_weight(r, g.id_begin, g.id_end, scale, robust)
    return 0.5 * torch.sum(w * torch.sum(r * r, dim=-1))


def solve_sep(C_red, g_red, sep_free, lam):
    Cf = C_red * sep_free[:, None] * sep_free[None, :]
    damp = lam * torch.clamp(torch.diagonal(Cf), min=1e-8) + (1.0 - sep_free)
    dsep = -PG.spd_solve(Cf + torch.diag(damp), g_red * sep_free)
    return dsep * sep_free


def apply_delta(poses, dsep, dint, lay: _Layout):
    """``poses`` moved by the root increment and every submap's interior
    increments (S_all, 3I)."""
    upd = (dint.reshape(-1, lay.I, 3) * lay.int_valid_all[..., None]).reshape(-1, 3)
    idx = torch.cat([lay.root_node, lay.int_node_safe.reshape(-1)])
    d = torch.cat([(dsep * lay.sep_free).reshape(lay.R, 3), upd])
    new = poses + runtime.index_add(torch.zeros_like(poses), idx, d)
    return torch.cat([new[:, :2], normalize_angle(new[:, 2:])], dim=1)


def optimize_loop(poses, g, lay: _Layout, cfg: GlobalFuserConfig, group=None):
    """Gauss-Newton with LM damping through the Schur complement, at most
    ``cfg.max_iterations`` iterations; the ``done`` flag is read on the host
    once per iteration.  With a group, the interior increments of every
    rank's submaps are all-gathered before the update.  Returns (poses,
    cost, iterations)."""
    robust = PG.robust_spec(cfg)
    scale = cfg.loss_function_scale
    dtype, dev = poses.dtype, poses.device
    lam = torch.tensor(1e-6, dtype=dtype).to(dev)
    cost = total_cost(poses, g, robust, scale)
    it = 0
    while it < cfg.max_iterations:
        C_red, g_red, fact = reduced_system(poses, g, lay, lam, robust, scale, group)
        dsep = solve_sep(C_red, g_red, lay.sep_free, lam)
        dint = back_substitute(fact, lay, dsep)
        if group is not None:
            dint = mesh.all_gather_cat(dint, group)
        trial = apply_delta(poses, dsep, dint, lay)
        cost_new = total_cost(trial, g, robust, scale)
        accept = cost_new < cost
        step = torch.linalg.vector_norm(dsep) + torch.linalg.vector_norm(dint)
        small = step < cfg.tolerance * (1.0 + torch.linalg.vector_norm(poses))
        done = (accept & small) | ((~accept) & (lam >= 1e7))
        poses = torch.where(accept, trial, poses)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 4.0), 1e-12, 1e8)
        cost = torch.where(accept, cost_new, cost)
        it += 1
        if bool(done):
            break
    return poses, cost, it


def optimize_schur(g: PG.PoseGraph, cfg: GlobalFuserConfig, node_submap,
                   node_is_root, group=None):
    """Gauss-Newton via the submap Schur complement.  Gauge: the first ROOT
    is fixed.  With a group, the submaps are sharded over its ranks (module
    docstring); every rank returns the same poses.  Returns (poses,
    {"cost", "iterations"})."""
    with mesh.rank_ids(group), profiling.span("randt.pgo_schur"):
        lay = _prepare(g, node_submap, node_is_root, group)
        poses, cost, iters = optimize_loop(g.poses, g, lay, cfg, group)
        return poses, {"cost": float(cost), "iterations": iters}


def optimize_auto(g: PG.PoseGraph, cfg: GlobalFuserConfig, node_submap=None,
                  node_is_root=None, group=None, max_update_index=None,
                  dense_node_limit: int = 2048):
    """Route the pose-graph solve by size; returns ``(poses, info)`` with
    ``info["solver"]`` the path taken (``"dense"`` or ``"schur"``) and
    ``info["two_stage"]`` set when the two-stage robust schedule ran.  A
    group shards the Schur route (the dense route runs whole on every rank,
    as in the JAX package)."""
    N = g.poses.shape[0]
    g = PG._filter_loops(g, max_update_index)
    schur = (N > dense_node_limit and node_submap is not None
             and node_is_root is not None)

    def solve(graph, c):
        if schur:
            poses, info = optimize_schur(graph, c, node_submap, node_is_root, group)
        else:
            poses, info = PG.optimize(graph, c)
        info["solver"] = "schur" if schur else "dense"
        return poses, info

    if not PG.robust_two_stage(cfg):
        return solve(g, cfg)
    # Stage 1: plain least squares.  Stage 2: robust IRLS from that optimum,
    # where an inconsistent loop edge's residual concentrates on itself.
    pre = dataclasses.replace(cfg, use_robust_loss=False, dcs_loop_defense=False)
    poses1, _ = solve(g, pre)
    if cfg.dcs_loop_defense:
        stage2 = dataclasses.replace(
            cfg, dcs_loop_defense=False, use_robust_loss=True,
            robust_kernel="dcs", robust_loop_edges_only=True,
            loss_function_scale=cfg.dcs_scale)
    else:
        stage2 = cfg
    poses, info = solve(g._replace(poses=poses1), stage2)
    info["two_stage"] = True
    return poses, info
