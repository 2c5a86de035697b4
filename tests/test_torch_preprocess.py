"""Scan filter and clustering of the port against the JAX package.

Masks, beams, beam masks, polar coordinates and cluster ids must be exact:
they come from comparisons, argmax, gathers and integer arithmetic on the
same float32 inputs.  Points agree within 1e-5 m absolute: x = cos(a) r and
y = sin(a) r go through each framework's float32 sin/cos, which may differ
by one ulp (<= 6e-8 r, below 1e-5 m for r <= 160 m).  Only kept points are
compared; dropped ones carry the -1e9 range sentinel.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from randt_slam_tpu import preprocess as jpp
from randt_slam_tpu.config import MapConfig, PreprocessorConfig, SlamConfig, derive
from randt_slam_tpu.io import synthetic
from randt_slam_torch import preprocess as tpp
from randt_slam_torch import config as tconfig
from tests.torch_threads import one_thread  # noqa: F401


def _cfg(thresh=1.5):
    cfg = SlamConfig(
        preprocessor=PreprocessorConfig(min_range=2.0, max_range=50.0,
                                        min_intensity=20.0,
                                        beam_distance_increment_threshold=thresh),
        ndt_map=MapConfig(size_x=100, size_y=100, resolution=2.0),
    )
    return derive(cfg).preprocessor


def _unit_scans():
    """The inputs of tests/test_preprocess.py (1 m range bins)."""
    R = 64
    ranges = (np.arange(R) + 0.5).astype(np.float32)
    a = np.zeros((8, R), np.float32)
    a[0, 17:24] = [30, 60, 90, 120, 80, 50, 25]
    a[1, 30] = 15.0
    b = np.zeros((4, R), np.float32)
    b[0, 0] = 200.0
    b[0, 60] = 90.0
    b[1, 10:13] = [50, 100, 40]
    c = np.zeros((4, 32), np.float32)
    c[0, 10] = 100.0
    az8 = np.linspace(-np.pi, np.pi, 8, endpoint=False).astype(np.float32)
    return [
        (a, az8, ranges, 1.5, 8, np.zeros(3, np.float32)),
        (a[:2], np.zeros(2, np.float32), ranges, 0.12, 8, np.zeros(3, np.float32)),
        (b, np.zeros(4, np.float32), ranges, 1.5, 4, np.zeros(3, np.float32)),
        (c, np.zeros(4, np.float32), ranges[:32], 1.5, 4,
         np.asarray([1.0, 0.0, np.pi / 2], np.float32)),
    ]


def _compare(img, az, ranges, pcfg_j, pcfg_t, run_window, s2b):
    A = img.shape[0]
    sj = jpp.PolarScan(jnp.asarray(img), jnp.asarray(az), jnp.asarray(ranges),
                       jnp.ones(A, bool))
    st = tpp.PolarScan(torch.from_numpy(img), torch.from_numpy(az),
                       torch.from_numpy(ranges), torch.ones(A, dtype=torch.bool))
    fj = jpp.filter_scan(sj, pcfg_j, jnp.asarray(s2b), run_window=run_window)
    ft = tpp.filter_scan(st, pcfg_t, torch.from_numpy(s2b), run_window=run_window)
    mask = np.asarray(fj.mask)
    np.testing.assert_array_equal(ft.mask.numpy(), mask)
    np.testing.assert_array_equal(ft.beam_mask.numpy(), np.asarray(fj.beam_mask))
    np.testing.assert_array_equal(ft.beams.numpy(), np.asarray(fj.beams))
    np.testing.assert_array_equal(ft.polar.numpy()[mask], np.asarray(fj.polar)[mask])
    np.testing.assert_allclose(ft.points.numpy()[mask], np.asarray(fj.points)[mask],
                               rtol=0, atol=1e-5)
    ids_j, n_j = jpp.cluster_ids(fj.points, fj.mask, pcfg_j)
    ids_t, n_t = tpp.cluster_ids(ft.points, ft.mask, pcfg_t)
    assert n_t == n_j
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    return int(mask.sum())


@pytest.mark.parametrize("case", range(4))
def test_filter_scan_matches_jax_on_unit_scans(case):
    img, az, ranges, thresh, rw, s2b = _unit_scans()[case]
    pj = _cfg(thresh)
    _compare(img, az, ranges, pj, tconfig.PreprocessorConfig(**pj.__dict__), rw, s2b)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_filter_scan_matches_jax_on_synthetic_frame(dtype):
    seq = synthetic.generate(seed=3, n_frames=2, n_azimuths=256, n_bins=256)
    # float16 frames are upcast before the filter, as the front end does
    img = seq.intensity[1].astype(dtype).astype(np.float32)
    pj = jpp_cfg = _synthetic_pcfg()
    kept = _compare(img, seq.azimuths, seq.ranges, jpp_cfg,
                    tconfig.synthetic_config().preprocessor, 32,
                    np.zeros(3, np.float32))
    assert kept > 500 and pj.cluster_row_size > 0


def _synthetic_pcfg():
    from randt_slam_tpu.config import synthetic_config

    return synthetic_config().preprocessor
