"""ScanContext retrieval and scoring (``loops/scancontext.py``): the port
against the JAX package on identical descriptors.

The database is a looping drive: the second half revisits the first, each
revisit's descriptor a column-rolled (heading change) and noisy copy of the
first visit's.  The port scores all queries in one batch; the JAX package
scores one query per call (``jax.vmap`` over queries, as its detector runs).

* ``pair_distance``: the best shift identical, the distance within 1e-5
  (float32 dot products and norms of ~20-row columns in another order);
* ``detect``: match ids, yaws (the shift times the float32 sector angle)
  and the accept decisions identical, distances within 1e-5.  Ties in the
  ring-key kNN and in the shift and candidate ``argmin`` go to the lower
  index on both sides; an exact copy in the database makes such ties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randt_slam_tpu.config import ScanContextConfig as jSCC
from randt_slam_tpu.loops import scancontext as jSC
from randt_slam_torch.config import ScanContextConfig as tSCC
from randt_slam_torch.loops import scancontext as tSC
from tests.torch_threads import one_thread  # noqa: F401

KW = dict(num_ring=20, num_sector=60, max_radius=80.0, num_exclude_recent=20,
          num_candidates=5, dist_threshold=0.7, odom_weight=0.05, odom_eps=4.0,
          assumed_drift=0.05, intensity_factor=0.01)
DIST_TOL = 1e-5


def _database(seed=0, n_first=36, n_second=34):
    rng = np.random.default_rng(seed)
    R, S = KW["num_ring"], KW["num_sector"]
    occ = rng.random((n_first, R, S)) < 0.3
    first = np.where(occ, -1000.0 + rng.uniform(0, 30, (n_first, R, S)), 0.0)
    src = np.arange(n_second) % n_first
    shifts = rng.integers(0, S, n_second)
    second = np.stack([np.roll(first[i], s, axis=1) for i, s in zip(src, shifts)])
    noise = rng.normal(0, 2.0, second.shape) * (second != 0)
    second = second + noise
    second[5] = np.roll(first[src[5]], shifts[5], axis=1)      # an exact copy
    desc = np.concatenate([first, second]).astype(np.float32)
    N = len(desc)
    ang = np.linspace(0, 2 * np.pi * N / n_first, N, endpoint=False)
    pos = (np.stack([np.cos(ang), np.sin(ang)], 1) * 30.0
           + rng.normal(0, 0.3, (N, 2))).astype(np.float32)
    dist = (np.arange(N) * 5.2).astype(np.float32)
    return desc, pos, dist


def test_pair_distance_matches_jax():
    desc, pos, dist = _database(1)
    a, b = np.arange(36, 70), np.arange(34) % 36
    jcfg, tcfg = jSCC(**KW), tSCC(**KW)
    jd, js = jax.vmap(lambda i, j: jSC.pair_distance(
        jnp.asarray(desc)[i], jnp.asarray(desc)[j], jnp.asarray(pos)[i],
        jnp.asarray(pos)[j], jnp.asarray(dist)[i], jnp.asarray(dist)[j], jcfg))(
        jnp.asarray(a), jnp.asarray(b))
    T = {k: torch.from_numpy(v) for k, v in (("d", desc), ("p", pos), ("t", dist))}
    td, ts = tSC.pair_distance(T["d"][a], T["d"][b], T["p"][a], T["p"][b],
                               T["t"][a], T["t"][b], tcfg)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=DIST_TOL)


@pytest.mark.parametrize("num_candidates", [5, 12])
def test_detect_matches_jax(num_candidates):
    desc, pos, dist = _database(2)
    kw = dict(KW, num_candidates=num_candidates)
    jcfg, tcfg = jSCC(**kw), tSCC(**kw)
    N = len(desc)
    rk = jax.vmap(jSC.ring_key)(jnp.asarray(desc))
    q = np.arange(N)
    j = jax.vmap(lambda qi: jSC.detect(qi, jnp.asarray(desc), rk, jnp.asarray(pos),
                                       jnp.asarray(dist), jnp.int32(N), jcfg))(
        jnp.asarray(q, jnp.int32))
    td = torch.from_numpy(desc)
    t = tSC.detect(torch.from_numpy(q), td, tSC.ring_key(td), torch.from_numpy(pos),
                   torch.from_numpy(dist), N, tcfg)
    match = np.asarray(j.match_id)
    assert (match >= 0).sum() >= 20, "the revisits must match"
    np.testing.assert_array_equal(t.match_id.numpy(), match)
    np.testing.assert_array_equal(t.yaw_rad.numpy(), np.asarray(j.yaw_rad))
    jd = np.asarray(j.distance)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(t.distance.numpy()), fin)
    np.testing.assert_allclose(t.distance.numpy()[fin], jd[fin], rtol=0,
                               atol=DIST_TOL)


def test_configs_equal():
    assert dataclasses.asdict(jSCC(**KW)) == dataclasses.asdict(tSCC(**KW))
