"""Occupancy grid (``mapping/raytrace.py``, ``mapping/ogm.py``,
``pipeline/slam.render_ogm``) and the map exports (``io/viz.py``): the port
against the JAX package.

* ``ray_cells`` and ``raytrace_beams`` give the JAX functions' cells and
  counting grids exactly (integers), on rays that leave the grid, of zero
  and sub-cell length, and along both major axes; the grids also equal the
  JAX package's native C++ walk, the reference-exact oracle.
* ``global_occupancy`` and ``submap_occupancy`` agree with the JAX
  functions within 1e-5; ``fuse_submaps`` does on seeded grids and origins
  except on boundary cells (below).
* ``render_ogm`` from one set of node tables (the JAX package's odometry of
  the loop sequence, carried across with ``state.odometry_from_numpy``, and
  one set of perturbed optimized origins): the counting grids are equal to
  the JAX ``render_ogm``'s, on both of its routes (native C++ and its device
  trace).  The global occupancy agrees within 1e-5 except on cells that a
  resampling sample may fall in from within float32 rounding of a cell
  boundary (``BOUNDARY_ROUNDOFFS``; evaluated in float64): there the cell a sample lands in turns on
  the last float32 bits of its position, and the JAX package's own two
  routes disagree with each other on such cells (the XLA dot rounds its
  multiply-adds once, the native loop contracts them differently, the port
  rounds each product).
* ``io/viz.py`` writes the JAX copy's bytes: ``ogm.pgm``,
  ``trajectory.json`` and the NDT export.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.io import native as jnative
from randt_slam_tpu.io import synthetic
from randt_slam_tpu.io import viz as jviz
from randt_slam_tpu.mapping import ogm as jOGM
from randt_slam_tpu.mapping import raytrace as jRT
from randt_slam_tpu.pipeline import slam as jS
from randt_slam_torch import state
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.io import viz as tviz
from randt_slam_torch.mapping import ogm as tOGM
from randt_slam_torch.mapping import raytrace as tRT
from randt_slam_torch.pipeline import slam as tS
from tests.torch_threads import one_thread  # noqa: F401

OCC_TOL = 1e-5
# a resampling sample's float32 position is a sum of products (the
# rotation, the corner, the sample offset) and a division: within 8 unit
# roundoffs of the sum of its terms' magnitudes
BOUNDARY_ROUNDOFFS = 8 * 2.0 ** -24


def _rays(kind, n=3000, seed=0):
    """Sensor poses (n, 3), beams (n, 3) and a validity mask."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((n, 3), np.float32)
    poses[:, :2] = rng.uniform(-25, 25, (n, 2))
    poses[:, 2] = rng.uniform(-np.pi, np.pi, n)
    ang = rng.uniform(-np.pi, np.pi, n)
    rng_m = rng.uniform(0.0, 40.0, n)      # up to 40 m: many rays leave the grid
    if kind == "zero_and_sub_cell":
        rng_m[: n // 2] = 0.0
        rng_m[n // 2:] = rng.uniform(0.0, 0.15, n - n // 2)
    elif kind == "x_major":
        poses[:, 2] = 0.0
        ang = rng.uniform(-0.7, 0.7, n) + np.pi * rng.integers(0, 2, n)
    elif kind == "y_major":
        poses[:, 2] = 0.0
        ang = rng.uniform(0.9, 2.2, n) * rng.choice([-1.0, 1.0], n)
    beams = np.stack([ang, rng_m, rng.uniform(0, 100, n)], 1).astype(np.float32)
    return poses, beams, rng.random(n) < 0.9


KINDS = ["random", "zero_and_sub_cell", "x_major", "y_major"]
H, W, RES, STEPS = 300, 400, 0.1, 600


@pytest.mark.parametrize("kind", KINDS)
def test_ray_cells_equal_jax(kind):
    import jax

    poses, beams, _ = _rays(kind, n=500)
    ang = poses[:, 2] + beams[:, 0]
    want = jax.vmap(lambda o, a, r: jRT.ray_cells(o, a, r, RES, W, H, STEPS))(
        jnp.asarray(poses[:, :2]), jnp.asarray(ang), jnp.asarray(beams[:, 1]))
    got = tRT.ray_cells(torch.from_numpy(poses[:, :2]), torch.from_numpy(ang),
                        torch.from_numpy(beams[:, 1]), RES, W, H, STEPS)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", KINDS)
def test_raytrace_beams_equal_jax_and_native(kind):
    poses, beams, valid = _rays(kind)
    want = np.asarray(jRT.raytrace_beams(
        jnp.zeros((H, W), jnp.int32), jnp.asarray(poses), jnp.asarray(beams),
        jnp.asarray(valid), RES, max_steps=STEPS))
    native = jnative.bresenham_raytrace(np.zeros((H, W), np.int32), poses,
                                        beams[:, 0], beams[:, 1], valid, RES)
    got = tRT.raytrace_beams(
        torch.zeros(H, W, dtype=torch.int32), torch.from_numpy(poses),
        torch.from_numpy(beams), torch.from_numpy(valid), RES,
        max_steps=STEPS).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(got, native)
    if kind != "zero_and_sub_cell":
        assert got.min() < 0 and got.max() >= 2


def test_raytrace_beams_chunks_agree(monkeypatch):
    """Tracing in chunks of a few beams gives the one-chunk grid."""
    poses, beams, valid = _rays("random", n=400)
    args = (torch.zeros(H, W, dtype=torch.int32), torch.from_numpy(poses),
            torch.from_numpy(beams), torch.from_numpy(valid), RES)
    whole = tRT.raytrace_beams(*args, max_steps=STEPS)
    monkeypatch.setattr(tRT, "CHUNK_ELEMENTS", 7 * STEPS)
    assert torch.equal(tRT.raytrace_beams(*args, max_steps=STEPS), whole)


def _boundary_cells(counts, sub_corners, g_corner, res, gh, gw):
    """(gh, gw) mask of the global cells a resampling sample may land in
    when its position, evaluated in float64, lies within the float32
    rounding bound (``BOUNDARY_ROUNDOFFS`` of its terms' magnitudes) of a
    cell boundary."""
    mask = np.zeros(gh * gw, bool)
    g = np.asarray(g_corner, np.float64)
    cg, sg = np.cos(g[2]), np.sin(g[2])
    for cnt, o in zip(counts, np.asarray(sub_corners, np.float64)):
        # the submap corner in the global OGM-origin frame
        dx, dy = o[0] - g[0], o[1] - g[1]
        ox, oy, th = cg * dx + sg * dy, -sg * dx + cg * dy, o[2] - g[2]
        iy, ix = np.nonzero(cnt)
        c, s = np.cos(th), np.sin(th)
        for fx, fy in tOGM._OFFSETS:
            px, py = ix * res + fx * res, iy * res + fy * res
            terms = np.abs(c * px) + np.abs(s * py)
            u = (c * px - s * py + ox) / res
            v = (s * px + c * py + oy) / res
            eu = BOUNDARY_ROUNDOFFS * ((terms + abs(ox)) / res + np.abs(u))
            ev = BOUNDARY_ROUNDOFFS * ((terms + abs(oy)) / res + np.abs(v))
            near = (np.abs(u - np.round(u)) < eu) | (np.abs(v - np.round(v)) < ev)
            for su in (-1, 1):
                for sv in (-1, 1):
                    gx = np.floor(u[near] + su * eu[near]).astype(np.int64)
                    gy = np.floor(v[near] + sv * ev[near]).astype(np.int64)
                    ok = (gx >= 0) & (gx < gw) & (gy >= 0) & (gy < gh)
                    mask[gy[ok] * gw + gx[ok]] = True
    return mask.reshape(gh, gw)


def test_fuse_and_occupancy_match_jax():
    rng = np.random.default_rng(3)
    counts = rng.integers(-30, 30, (3, 200, 260)).astype(np.int32)
    counts[rng.random(counts.shape) < 0.6] = 0
    origins = np.stack([rng.uniform(-5, 5, 3), rng.uniform(-5, 5, 3),
                        rng.uniform(-np.pi, np.pi, 3)], 1).astype(np.float32)
    g_origin = np.asarray([-20.0, -15.0, 0.3], np.float32)
    want = np.array(jOGM.fuse_submaps(
        jnp.asarray(counts, jnp.float32), jnp.asarray(origins), RES, RES,
        jnp.asarray(g_origin), 350, 420))
    got = tOGM.fuse_submaps(torch.from_numpy(counts), torch.from_numpy(origins),
                            RES, RES, torch.from_numpy(g_origin), 350, 420).numpy()
    near = _boundary_cells(counts, origins, g_origin, RES, 350, 420)
    off = np.abs(got - want) > OCC_TOL
    assert not (off & ~near).any()
    print(f"fuse: {off.sum()} cells beyond {OCC_TOL}, all within the "
          f"{near.sum()} boundary cells of {(want != 0).sum()} touched")
    assert near.sum() < 0.01 * (want != 0).sum() and np.abs(got).max() > 0
    occ = tOGM.global_occupancy(torch.from_numpy(want)).numpy()
    np.testing.assert_allclose(occ, np.asarray(jOGM.global_occupancy(jnp.asarray(want))),
                               rtol=0, atol=OCC_TOL)
    c = np.arange(-80, 81, dtype=np.int32)
    np.testing.assert_allclose(tOGM.submap_occupancy(torch.from_numpy(c)).numpy(),
                               np.asarray(jOGM.submap_occupancy(jnp.asarray(c))),
                               rtol=0, atol=OCC_TOL)


@pytest.fixture(scope="module")
def tables():
    """The JAX package's odometry of the loop sequence's first 24 frames
    and optimized submap origins perturbed from its odometry origins."""
    seq = synthetic.generate(seed=7, n_frames=24, n_azimuths=256, n_bins=256,
                             speed=4.0, dt=0.25, loop=True, n_walls=80)
    jframes = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                    seq.stamps)
    odo = jS.run_odometry(j_cfg(), jframes)
    n = odo.n_submaps
    rng = np.random.default_rng(0)
    opt = odo.submap_origin.copy()
    opt[:n] += np.concatenate([rng.normal(0, 0.3, (n, 2)),
                               rng.normal(0, 0.02, (n, 1))], 1).astype(np.float32)
    jres = jS.SlamResult(odometry=odo, loops=None, node_pose_optimized=odo.node_pose,
                         node_stamp=odo.node_stamp, node_frame=odo.node_frame,
                         submap_origin_optimized=opt, pgo_cost=0.0, pgo_iterations=0)
    tres = tS.SlamResult(odometry=state.odometry_from_numpy(odo, "cpu"), loops=None,
                         node_pose_optimized=odo.node_pose, node_stamp=odo.node_stamp,
                         node_frame=odo.node_frame, submap_origin_optimized=opt,
                         pgo_cost=0.0, pgo_iterations=0)
    tframes = tS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                    seq.stamps, device="cpu")
    port = tS.render_ogm(t_cfg(), tres, tframes, device="cpu")
    return jframes, jres, port


@pytest.mark.parametrize("route", ["native", "device"])
def test_render_ogm_matches_jax(tables, route, monkeypatch):
    jframes, jres, (occ, grids) = tables
    if route == "device":  # the JAX package's fallback: its device trace
        monkeypatch.setattr(jnative, "have_native", lambda: False)
    j_occ, j_grids = jS.render_ogm(j_cfg(), jres, jframes)
    o = t_cfg().ogm
    odo = jres.odometry
    assert grids.shape == (odo.n_submaps, o.submap_size_y, o.submap_size_x)
    assert grids.dtype == np.int32 and occ.dtype == np.float32
    assert np.array_equal(grids, j_grids)
    assert grids.min() < 0 and grids.max() >= 2
    corner = np.asarray([-0.5 * o.submap_size_x * o.resolution,
                         -0.5 * o.submap_size_y * o.resolution, 0.0], np.float32)
    sub_corners = tOGM.compose(
        torch.from_numpy(jres.submap_origin_optimized[:odo.n_submaps]),
        torch.from_numpy(corner).expand(odo.n_submaps, 3)).numpy()
    g_corner = [-0.5 * o.size_x * o.resolution, -0.5 * o.size_y * o.resolution, 0.0]
    near = _boundary_cells(grids, sub_corners, g_corner, o.resolution,
                           o.size_y, o.size_x)
    off = np.abs(occ - j_occ) > OCC_TOL
    known = occ >= 0
    print(f"{route}: {off.sum()} of {known.sum()} known cells beyond {OCC_TOL}, "
          f"all within the {near.sum()} boundary cells")
    assert not (off & ~near).any()
    assert near.sum() < 0.1 * known.sum()


def test_viz_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(2)
    grid = rng.uniform(-1, 100, (37, 53)).astype(np.float32)
    grid[rng.random(grid.shape) < 0.3] = -1.0
    stamps = np.arange(9) * 0.25
    poses = rng.normal(0, 10, (9, 3)).astype(np.float32)
    mean = rng.normal(0, 5, (20, 3)).astype(np.float32)
    a = rng.normal(0, 1, (20, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, 1, 2)
    valid = rng.random(20) < 0.7
    for mod, d in ((jviz, tmp_path / "j"), (tviz, tmp_path / "t")):
        d.mkdir()
        mod.write_pgm(d / "ogm.pgm", grid)
        mod.export_trajectory_json(d / "trajectory.json", stamps, poses)
        mod.export_normal_distributions(d / "ndt.npz", mean, cov, valid)
    for f in ("ogm.pgm", "trajectory.json"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    assert len(json.loads((tmp_path / "t" / "trajectory.json").read_text())) == 9
    jn, tn = np.load(tmp_path / "j" / "ndt.npz"), np.load(tmp_path / "t" / "ndt.npz")
    assert sorted(jn.files) == sorted(tn.files)
    for k in jn.files:
        assert np.array_equal(jn[k], tn[k]), k
    for x, y in zip(tviz.ellipse_parameters(cov[:, :2, :2]),
                    jviz.ellipse_parameters(cov[:, :2, :2])):
        assert np.array_equal(x, y)
