"""Sparse NDT submap grid: scatter-merge, rigid re-keying, neighbor lookup.

Port of the sparse path of ``randt_slam_tpu/ndt/grid.py``.  A submap is the
reference ``Map``'s storage (``ndt_map.h:155-162``): a dense int32 index grid
pointing into a compact table of cells in sufficient-statistic form.

 * insertion is a scatter-add of sufficient statistics keyed by cell mean
   (``Map::mergeMapCell``, ``ndt_map.cpp:191-207``);
 * neighbor lookup is a static window gather + masked top-k
   (``Map::getClosestCells``, ``ndt_map.cpp:101-151``);
 * rigid transforms re-key cells by their transformed means (a fix over the
   reference's stale spatial index).

Grid layout: row-major (iy, ix); ix = floor((x - offset_x)/res) with
offset = -size/2 * res (``ndt_map.cpp:19-20``).  The JAX package's dense-grid
functions are used by no pipeline path and are not ported.

Loop closure associates against a compacted (flat) submap cell table:
:func:`allpairs_neighbors`, batched over leading candidate dimensions.

The submap functions take an optional leading batch axis, B independent
submaps: index grids (B, H, W), tables (B, S), counts (B,).  Their scatters
and gathers run once over all members, each member's indices shifted into
its own stretch of one flat index (:func:`_flat`), so that what one member
writes or reads never reaches another's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import runtime
from ..config import MapConfig
from ..utils import profiling
from . import cells as C
from .cells import CellStats


class GridGeom(NamedTuple):
    size_x: int
    size_y: int
    resolution: float

    @property
    def offset_x(self) -> float:
        return -0.5 * self.size_x * self.resolution

    @property
    def offset_y(self) -> float:
        return -0.5 * self.size_y * self.resolution

    @classmethod
    def from_config(cls, m: MapConfig) -> "GridGeom":
        return cls(size_x=m.size_x, size_y=m.size_y, resolution=m.resolution)


def cell_index(geom: GridGeom, xy):
    """(ix, iy, in_bounds) for positions (..., 2); indices are int64."""
    ix = torch.floor((xy[..., 0] - geom.offset_x) / geom.resolution).long()
    iy = torch.floor((xy[..., 1] - geom.offset_y) / geom.resolution).long()
    ok = (ix >= 0) & (ix < geom.size_x) & (iy >= 0) & (iy < geom.size_y)
    return ix, iy, ok


class SparseGrid(NamedTuple):
    """NDT submap as a dense int32 index grid over a compact cell table
    (each field with a leading (B,) for a batch of submaps).

      index: (H, W) int32, -1 = empty, else slot into the stats table
      stats: CellStats with batch (S,) -- compact sufficient statistics
      count: () int32 -- allocated slots (monotone per submap lifetime)
    """

    index: torch.Tensor
    stats: CellStats
    count: torch.Tensor


def empty_sparse(geom: GridGeom, capacity: int, dtype=torch.float32,
                 device=None, batch: tuple = ()) -> SparseGrid:
    batch = tuple(batch)
    return SparseGrid(
        index=torch.full(batch + (geom.size_y, geom.size_x), -1,
                         dtype=torch.int32, device=device),
        stats=C.zeros(batch + (capacity,), dtype, device),
        count=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def _flat(idx, per_member: int):
    """Indices (B, ...) into each member's own table of ``per_member``
    entries, as indices into the B tables laid end to end."""
    shift = torch.arange(0, idx.shape[0] * per_member, per_member,
                         device=idx.device)
    return idx + shift.reshape((-1,) + (1,) * (idx.dim() - 1))


@profiling.span("randt.submap_merge")
def scatter_sparse(geom: GridGeom, sg: SparseGrid, new: CellStats, valid) -> SparseGrid:
    """Merge a batch of cells into the sparse grid, keyed by cell mean.

    Existing target cells merge by sufficient-statistic addition; new targets
    allocate table slots.  First-occurrence winners per target grid slot come
    from a scatter-min race, take consecutive slots by a prefix sum and are
    written into the index grid; every incoming cell then re-gathers its slot
    so in-batch duplicates merge into the winner's slot.  Table overflow
    drops cells.  Dropped writes go to one extra slot past the end, which is
    cut off (the JAX package's ``mode="drop"``).  Over a batch of submaps
    (``new`` (B, Cn)) the race, the prefix sum and the count are each
    member's own.
    """
    S = sg.stats.n.shape[-1]
    HW = geom.size_x * geom.size_y
    dev = sg.index.device
    batched = sg.count.dim() == 1
    nb = sg.count.shape[0] if batched else 1
    mu = C.mean(new)
    ix, iy, inb = cell_index(geom, mu[..., :2])
    ok = inb & valid & (new.n > 0)
    flat = torch.where(ok, iy * geom.size_x + ix, 0)
    if batched:
        flat = _flat(flat, HW)
    idx_flat = sg.index.reshape(-1)

    # dropped writes of every member go to one sentinel past all of them
    cur = idx_flat[flat]
    is_new = ok & (cur < 0)
    Cn = flat.shape[-1]
    pos = torch.arange(Cn, device=dev)
    race = torch.full((nb * HW + 1,), Cn, dtype=torch.long, device=dev)
    race.scatter_reduce_(0, torch.where(is_new, flat, nb * HW).reshape(-1),
                         pos.expand(flat.shape).reshape(-1), "amin",
                         include_self=True)
    winner = is_new & (race[flat] == pos)
    order = torch.cumsum(winner.to(torch.int32), dim=-1) - 1
    slot_w = sg.count[..., None] + order
    alloc = winner & (slot_w < S)
    idx_ext = torch.cat([idx_flat, idx_flat.new_full((1,), -1)])
    idx_ext[torch.where(alloc, flat, nb * HW)] = slot_w.to(torch.int32)
    idx_flat = idx_ext[:nb * HW]

    slot = idx_flat[flat]
    use = ok & (slot >= 0)
    tgt = torch.where(use, slot.long(), S)
    if batched:
        tgt = _flat(tgt, S + 1)
    tgt = tgt.reshape(-1)
    w = use.to(new.n.dtype)

    cd = w.dim() - 1  # the cell axis

    def add(table, rows):
        # one extra (dropped) slot per member; the members' tables end to end
        tail = rows.shape[cd + 1:]
        ext = torch.cat([table, table.new_zeros(table.shape[:cd] + (1,) + tail)],
                        dim=cd)
        out = runtime.index_add(ext.reshape((-1,) + tail), tgt,
                                rows.reshape((-1,) + tail))
        return out.reshape(ext.shape).narrow(cd, 0, S)

    stats = CellStats(
        n=add(sg.stats.n, new.n * w),
        s=add(sg.stats.s, new.s * w[..., None]),
        ss=add(sg.stats.ss, new.ss * w[..., None, None]),
    )
    count = torch.clamp(sg.count + torch.sum(winner.to(torch.int32), dim=-1),
                        max=S)
    return SparseGrid(
        index=idx_flat.reshape(sg.index.shape), stats=stats,
        count=count.to(torch.int32),
    )


def transform_sparse(geom: GridGeom, sg: SparseGrid, pose) -> SparseGrid:
    """Rigid-transform a sparse grid and re-key cells by transformed means
    (``Map::transformMap`` + submap re-anchoring, with a fresh index grid).
    Cells that land outside the grid are dropped."""
    moved = C.transform_set(sg.stats, pose)
    fresh = empty_sparse(geom, sg.stats.n.shape[-1], sg.stats.s.dtype,
                         sg.index.device, batch=sg.count.shape)
    return scatter_sparse(geom, fresh, moved, moved.n > 0)


def derive_sparse_fields(sg: SparseGrid, min_points: int, cell_cfg):
    """(mean, regularized cov, valid) of the compact cell table."""
    mu, cov = C.mean_cov(
        sg.stats, cell_cfg.eig_floor_ratio, cell_cfg.intensity_var_jitter,
        use_pndt=cell_cfg.use_pndt,
    )
    return mu, cov, C.valid_mask(sg.stats, min_points)


class NeighborSet(NamedTuple):
    """k fixed-map neighbors per query cell."""

    mean: torch.Tensor   # (..., k, 3)
    cov: torch.Tensor    # (..., k, 3, 3)
    valid: torch.Tensor  # (..., k) bool


@profiling.span("randt.association")
def window_neighbors_sparse(
    geom: GridGeom,
    index,        # (H, W) int32 index grid
    t_mean,       # (S, 3) derived table fields
    t_cov,        # (S, 3, 3)
    t_valid,      # (S,)
    q_mean,
    q_cov,
    q_valid,
    k: int,
    radius: int,
    use_distribution_metric: bool = True,
) -> NeighborSet:
    """Masked top-k neighbor lookup over a static (2r+1)^2 window: one index
    gather from the grid, then field gathers from the compact table.  Same
    cells as the reference ring search whenever they lie in the window.
    With a leading batch axis (index (B, H, W), tables (B, S, ...), queries
    (B, Q, ...)) each member's queries look up its own grid and table."""
    H, W = geom.size_y, geom.size_x
    dev = q_mean.device
    batched = index.dim() == 3
    ix, iy, inb = cell_index(geom, q_mean[..., :2])

    d = torch.arange(-radius, radius + 1, device=dev)
    dyy, dxx = torch.meshgrid(d, d, indexing="ij")
    dxx = dxx.reshape(-1)
    dyy = dyy.reshape(-1)
    nx = ix[..., None] + dxx  # (..., Q, W2)
    ny = iy[..., None] + dyy
    ok = inb[..., None] & (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
    flat = torch.where(ok, ny * W + nx, 0)

    slots = index.reshape(-1)[_flat(flat, H * W) if batched else flat]
    have = ok & (slots >= 0) & q_valid[..., None]   # (..., Q, W2)
    sl = torch.where(have, slots, 0).long()
    if batched:
        sl = _flat(sl, t_valid.shape[-1])
        t_mean, t_cov, t_valid = (t_mean.reshape(-1, 3), t_cov.reshape(-1, 3, 3),
                                  t_valid.reshape(-1))
    gm = t_mean[sl]                              # (..., Q, W2, 3)
    gc = t_cov[sl]                               # (..., Q, W2, 3, 3)
    gv = have & t_valid[sl]

    if use_distribution_metric:
        dist = C.mahalanobis_sq_intensity(q_mean[..., :, None, :],
                                          q_cov[..., :, None, :, :], gm, gc)
    else:
        diff = gm[..., :2] - q_mean[..., :, None, :2]
        dist = torch.sum(diff * diff, dim=-1)
    dist = torch.where(gv, dist, float("inf"))

    return _select_topk(dist, gm, gc, k)


def _select_topk(dist, gm, gc, k: int):
    """Pick the k nearest window cells per query (first index among ties, as
    ``argmin`` and ``lax.top_k`` both do)."""
    idx, sel = smallest_k(dist, k)
    return _sanitize(NeighborSet(
        mean=torch.stack([_take_row(gm, idx[..., j]) for j in range(k)], -2),
        cov=torch.stack([_take_row(gc, idx[..., j]) for j in range(k)], -3),
        valid=torch.isfinite(sel),
    ))


def _take_row(x, i):
    """x (..., Q, W2, ...) at window position i (..., Q) -> (..., Q, ...)."""
    n = i.dim()
    rows = x.reshape((-1,) + x.shape[n:])
    picked = rows[torch.arange(rows.shape[0], device=x.device), i.reshape(-1)]
    return picked.reshape(i.shape + x.shape[n + 1:])


def _sanitize(nb: NeighborSet) -> NeighborSet:
    """Benign values for invalid (padded) neighbors so residual Jacobians stay
    finite in float32 (their weights are zero)."""
    eye = torch.eye(3, dtype=nb.cov.dtype, device=nb.cov.device)
    v = nb.valid[..., None]
    return NeighborSet(
        mean=torch.where(v, nb.mean, 0.0),
        cov=torch.where(v[..., None], nb.cov, eye),
        valid=nb.valid,
    )


def _pair_mahalanobis(q_mean, q_cov, f_mean, f_cov):
    """:func:`cells.mahalanobis_sq_intensity` of every (query, fixed) pair:
    q_* (..., Q, ...) against f_* (..., F, ...) -> (..., Q, F), without a
    (..., Q, F, 3, 3) pooled-covariance tensor."""
    d = [f_mean[..., None, :, i] - q_mean[..., :, None, i] for i in range(3)]
    return C.pooled_quad_det(q_cov[..., :, None, :, :], f_cov[..., None, :, :, :],
                             d)[0]


def smallest_k(dist, k: int):
    """``(idx, val)``, each (..., k): the ``k`` smallest entries along the
    last dim, lower index first among equal values (the order of
    ``lax.top_k`` on the negated values).  Repeated ``argmin`` (first index
    among ties) for small ``k``, a stable sort otherwise.  An entry once
    taken is set to +inf, so a row with fewer than ``k`` finite entries may
    repeat an index with value inf there; callers mark inf picks invalid."""
    if k <= 4:
        idx, val = [], []
        for _ in range(k):
            i = torch.argmin(dist, dim=-1, keepdim=True)
            idx.append(i)
            val.append(torch.gather(dist, -1, i))
            dist = dist.scatter(-1, i, float("inf"))
        return torch.cat(idx, dim=-1), torch.cat(val, dim=-1)
    val, idx = torch.sort(dist, dim=-1, stable=True)
    return idx[..., :k], val[..., :k]


@profiling.span("randt.allpairs_neighbors")
def allpairs_neighbors(f_mean, f_cov, f_valid, q_mean, q_cov, q_valid, k: int,
                       linf_cutoff: float,
                       use_distribution_metric: bool = True) -> NeighborSet:
    """Top-k neighbors of every query cell in a compacted (flat) fixed-cell
    table: the reference ring search's spatial window becomes an L-inf
    cutoff on the mean positions.  f_* (..., F, ...), q_* (..., Q, ...),
    with the same leading (candidate) dimensions; returns (..., Q, k, ...)."""
    diff_xy = f_mean[..., None, :, :2] - q_mean[..., :, None, :2]  # (.., Q, F, 2)
    within = torch.amax(torch.abs(diff_xy), dim=-1) <= linf_cutoff
    ok = within & f_valid[..., None, :] & q_valid[..., :, None]
    if use_distribution_metric:
        dist = _pair_mahalanobis(q_mean, q_cov, f_mean, f_cov)
    else:
        dist = torch.sum(diff_xy * diff_xy, dim=-1)
    dist = torch.where(ok, dist, float("inf"))
    idx, sel = smallest_k(dist, k)                                  # (.., Q, k)
    lead = f_mean.shape[:-2]
    flat = idx.reshape(*lead, -1)                                   # (.., Q*k)
    mean = torch.gather(f_mean, -2, flat[..., None].expand(*flat.shape, 3))
    cov = torch.gather(f_cov.reshape(*lead, -1, 9), -2,
                       flat[..., None].expand(*flat.shape, 9))
    return _sanitize(NeighborSet(
        mean=mean.reshape(*idx.shape, 3),
        cov=cov.reshape(*idx.shape, 3, 3),
        valid=torch.isfinite(sel),
    ))
