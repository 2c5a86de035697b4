"""The benchmark's frozen renderers against the originals, the closed laps,
and the threaded render against the serial one."""

import numpy as np
import pytest

from benchmark.inputs import drives as D
from benchmark.inputs import synthetic as BS

from .conftest import INDOOR_CONFIG


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_synthetic_copies_equal_the_port():
    from randt_slam_torch.io import synthetic as S

    for mod in (BS, S):
        rng = np.random.default_rng(3)
        gt = mod.make_trajectory(rng, 12, loop=True, laps=1)
        world = mod.make_world(rng, trajectory=gt, n_walls=20, n_clutter=30)
        az = np.linspace(-np.pi, np.pi, 64, endpoint=False).astype(np.float32)
        ranges = np.linspace(0.5, 60, 96).astype(np.float32)
        img = mod.render_scan_fast(gt[5], world, az, ranges, rng)
        if mod is BS:
            ours = (gt, world, img)
        else:
            _same(ours, (gt, world, img))


@pytest.mark.parametrize("which", ["render_frames", "render_indoor", "bench_graph"])
def test_drive_copies_equal_chip_smoke(which):
    import chip_smoke

    if which == "render_frames":
        _same(D.render_frames(6, seed=5, laps=1), chip_smoke.render_frames(6, seed=5, laps=1))
        _same(D.render_frames(5, seed=2), chip_smoke.render_frames(5, seed=2))
    elif which == "render_indoor":
        _same(D.render_indoor(8, 8, seed=5), chip_smoke.render_indoor(8, 8, seed=5))
    else:
        _same(D.bench_graph(400), chip_smoke.bench_graph(400))


def _steps(gt):
    closed = np.concatenate([gt, gt[:1]])
    d = np.diff(closed, axis=0)
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    return np.linalg.norm(d[:, :2], axis=1), d[:, 2]


@pytest.mark.parametrize("cfg", ["oxford", "indoor"])
def test_a_lap_wraps_without_a_jump(cfg):
    import json

    from benchmark.cellspec import BENCH

    if cfg == "oxford":
        drive = json.loads((BENCH / "configs" / "oxford.json").read_text())["drive"]
        gt = BS.make_trajectory(np.random.default_rng(1), drive["lap_frames"], dt=drive["dt"],
                             speed=drive["speed"], loop=True, laps=1)
    else:
        drive = INDOOR_CONFIG["drive"]
        gt = D.indoor_route(drive["lap_frames"], drive["lap_frames"],
                            tuple(drive["route_half"]), drive["speed"], drive["dt"])
    dist, dyaw = _steps(gt)
    step = drive["speed"] * drive["dt"]
    # the step from the lap's last frame back to its first is a step like
    # every other (a chord of at most one frame's arc): no jump in position
    # or heading
    np.testing.assert_allclose(dist, step, rtol=1e-3)
    assert dist[:-1].min() - 1e-6 <= dist[-1] <= dist[:-1].max() + 1e-6
    assert abs(dyaw[-1]) <= np.abs(dyaw[:-1]).max() + 1e-5


def test_pooled_render_equals_serial():
    params = dict(lap_frames=6, n_az=64, bin_w=0.5, max_range=40.0, dt=0.25, speed=4.0)
    render = D.LapRender("oxford_loop", params, seed=2**40 + 7, drives=3, workers=2)
    try:
        pooled = render.get()
    finally:
        render.close()
    for d in range(3):
        serial = D.render_lap("oxford_loop", params, D.drive_seed(2**40 + 7, d))
        for k in serial:
            np.testing.assert_array_equal(pooled[d][k], serial[k])
    assert not np.array_equal(pooled[0]["scans"], pooled[1]["scans"])


def test_drive_seed_takes_any_whole_number():
    seeds = [D.drive_seed(s, d) for s in (0, 1, -5, 2**31 + 3, 2**70) for d in (0, 1)]
    assert len(set(seeds)) == len(seeds)
    assert D.drive_seed(2**31 + 3, 1) == D.drive_seed(2**31 + 3, 1)


def test_the_sorted_scatter_equals_maximum_at():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 500, 5000)
    vals = rng.random(5000).astype(np.float32)
    a = rng.random(500).astype(np.float32)
    b = a.copy()
    BS._max_at(a, idx, vals, fast=True)
    BS._max_at(b, idx, vals, fast=False)
    np.testing.assert_array_equal(a, b)
