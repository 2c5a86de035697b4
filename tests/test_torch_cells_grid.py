"""NDT cells and the sparse submap grid of the port against the JAX package.

The same seeded inputs go through both packages on the CPU.

* Counts and every integer or boolean output (valid masks, index grids,
  slot counts, kept segment ids) must be identical.
* Sufficient statistics agree within 1e-5 relative to the largest entry of
  their channel: both sides sum in point order, and the remaining difference
  is the rounding of float32 products formed in another order.
* Means and covariances derived from them agree within 1e-3 absolute plus
  1e-5 relative: ``ss / n - mean mean^T`` keeps the rounding of the raw
  float32 second moment, one ulp of which is 5e-4 for the cross terms here
  (|x| <= 26 m, intensity <= 200).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from randt_slam_tpu.config import synthetic_config as j_synthetic_config
from randt_slam_tpu.ndt import cells as jC
from randt_slam_tpu.ndt import grid as jG
from randt_slam_torch.config import synthetic_config as t_synthetic_config
from randt_slam_torch.ndt import cells as tC
from randt_slam_torch.ndt import grid as tG
from tests.torch_threads import one_thread  # noqa: F401

STAT_REL = 1e-5
FIELD_ATOL = 1e-3
FIELD_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_stats(a, b):
    for k in ("n", "s", "ss"):
        x = getattr(a, k)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = np.asarray(getattr(b, k))
        scale = np.abs(y).reshape(-1, *y.shape[-1:]).max() if y.size else 0.0
        np.testing.assert_allclose(x, y, rtol=0, atol=STAT_REL * max(scale, 1.0))


def _points(seed, P=3000):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 20, (P, 2))
    inten = rng.uniform(40, 200, (P, 1))
    pts = np.concatenate([xy, inten], 1).astype(np.float32)
    mask = rng.random(P) < 0.9
    polar = np.stack([np.arctan2(xy[:, 1], xy[:, 0]), np.hypot(xy[:, 0], xy[:, 1])],
                     1).astype(np.float32)
    return pts, mask, polar


def _cluster(pts, mask):
    cfg = j_synthetic_config().preprocessor
    rs, res = cfg.cluster_row_size, cfg.cluster_resolution
    ix = np.floor((pts[:, 0] + cfg.max_range) / res).astype(np.int64)
    iy = np.floor((pts[:, 1] + cfg.max_range) / res).astype(np.int64)
    ids = np.where(mask, ix + rs * iy, rs * rs).astype(np.int32)
    return ids, rs * rs


@pytest.mark.parametrize("pndt", [False, True])
def test_from_points_compact_and_fields_match_jax(pndt):
    pts, mask, polar = _points(0)
    ids, S = _cluster(pts, mask)
    beam_cov = np.asarray(j_synthetic_config().ndt_map.cell.beam_cov)
    kw_j = dict(polar=jnp.asarray(polar), beam_cov=beam_cov) if pndt else {}
    kw_t = dict(polar=_t(polar), beam_cov=beam_cov) if pndt else {}
    sj, topi_j = jC.from_points_compact(jnp.asarray(pts), jnp.asarray(mask),
                                        jnp.asarray(ids), S, 256, **kw_j)
    st, topi_t = tC.from_points_compact(_t(pts), _t(mask), _t(ids), S, 256, **kw_t)
    np.testing.assert_array_equal(topi_t.numpy(), np.asarray(topi_j))
    np.testing.assert_array_equal(st.n.numpy(), np.asarray(sj.n))
    _close_stats(st, sj)
    mj, cj = jC.mean_cov(sj, 0.001, 1e-6, use_pndt=pndt)
    mt, ct = tC.mean_cov(st, 0.001, 1e-6, use_pndt=pndt)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=FIELD_RTOL, atol=FIELD_ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=FIELD_RTOL, atol=FIELD_ATOL)
    np.testing.assert_array_equal(tC.valid_mask(st, 8).numpy(),
                                  np.asarray(jC.valid_mask(sj, 8)))
    # the plain full segment sum (the JAX package's oracle for the fused path)
    _close_stats(tC.from_points(_t(pts), _t(mask), _t(ids), S, **kw_t),
                 jC.from_points(jnp.asarray(pts), jnp.asarray(mask),
                                jnp.asarray(ids), S, **kw_j))


def _batches():
    """Three scans' compact cells in the submap frame, shifted by a drive."""
    out = []
    for i in range(3):
        pts, mask, _ = _points(10 + i)
        pts[:, 0] += 3.0 * i
        ids, S = _cluster(pts, mask)
        st, _ = tC.from_points_compact(_t(pts), _t(mask), _t(ids), S, 256)
        out.append(tuple(x.numpy() for x in st))
    return out


def test_scatter_sparse_three_merges_match_jax():
    jcfg = j_synthetic_config()
    gj = jG.GridGeom.from_config(jcfg.ndt_map)
    gt = tG.GridGeom.from_config(t_synthetic_config().ndt_map)
    sgj = jG.empty_sparse(gj, 1024)
    sgt = tG.empty_sparse(gt, 1024, device="cpu")
    for n, s, ss in _batches():
        valid = n > 8
        sgj = jG.scatter_sparse(gj, sgj, jC.CellStats(jnp.asarray(n), jnp.asarray(s),
                                                      jnp.asarray(ss)), jnp.asarray(valid))
        sgt = tG.scatter_sparse(gt, sgt, tC.CellStats(_t(n), _t(s), _t(ss)), _t(valid))
        np.testing.assert_array_equal(sgt.index.numpy(), np.asarray(sgj.index))
        assert int(sgt.count) == int(sgj.count)
        _close_stats(sgt.stats, sgj.stats)
    assert int(sgt.count) > 100

    pose = np.asarray([2.5, -1.0, 0.3], np.float32)
    tj = jG.transform_sparse(gj, sgj, jnp.asarray(pose))
    tt = tG.transform_sparse(gt, sgt, _t(pose))
    np.testing.assert_array_equal(tt.index.numpy(), np.asarray(tj.index))
    assert int(tt.count) == int(tj.count)
    _close_stats(tt.stats, tj.stats)

    fj = jG.derive_sparse_fields(tj, 8, jcfg.ndt_map.cell)
    ft = tG.derive_sparse_fields(tt, 8, jcfg.ndt_map.cell)
    np.testing.assert_allclose(ft[0].numpy(), np.asarray(fj[0]), rtol=FIELD_RTOL, atol=FIELD_ATOL)
    np.testing.assert_allclose(ft[1].numpy(), np.asarray(fj[1]), rtol=FIELD_RTOL, atol=FIELD_ATOL)
    np.testing.assert_array_equal(ft[2].numpy(), np.asarray(fj[2]))


@pytest.mark.parametrize("metric", [True, False])
def test_window_neighbors_sparse_matches_jax(metric):
    jcfg = j_synthetic_config()
    gj = jG.GridGeom.from_config(jcfg.ndt_map)
    gt = tG.GridGeom.from_config(t_synthetic_config().ndt_map)
    sgj = jG.empty_sparse(gj, 1024)
    for n, s, ss in _batches():
        sgj = jG.scatter_sparse(gj, sgj, jC.CellStats(jnp.asarray(n), jnp.asarray(s),
                                                      jnp.asarray(ss)), jnp.asarray(n > 8))
    fm, fc, fv = (np.asarray(x) for x in jG.derive_sparse_fields(sgj, 8, jcfg.ndt_map.cell))
    n, s, ss = _batches()[1]
    qm, qc = (np.array(x) for x in jC.mean_cov(
        jC.CellStats(jnp.asarray(n), jnp.asarray(s), jnp.asarray(ss))))
    qm[:, :2] += 0.7  # queries off the cell centres
    qv = n > 8
    radius = jcfg.ndt_map.nn_window_radius
    nj = jG.window_neighbors_sparse(gj, sgj.index, jnp.asarray(fm), jnp.asarray(fc),
                                    jnp.asarray(fv), jnp.asarray(qm), jnp.asarray(qc),
                                    jnp.asarray(qv), 2, radius,
                                    use_distribution_metric=metric)
    nt = tG.window_neighbors_sparse(gt, _t(np.asarray(sgj.index)), _t(fm), _t(fc),
                                    _t(fv), _t(qm), _t(qc), _t(qv), 2, radius,
                                    use_distribution_metric=metric)
    np.testing.assert_array_equal(nt.valid.numpy(), np.asarray(nj.valid))
    assert nt.valid.numpy().sum() > 50
    np.testing.assert_allclose(nt.mean.numpy(), np.asarray(nj.mean), atol=1e-5)
    np.testing.assert_allclose(nt.cov.numpy(), np.asarray(nj.cov), atol=1e-5)
