"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

* K1 ``row_windows``: bitwise equal to the plain version (a gather).
* K2 ``segment_topk_moments``: the same ``topi``; moments within 1e-5 of the
  sum of the absolute values of their terms; two launches bitwise equal.
* The wrappers refuse inputs the kernels do not take.
* A short odometry run launches each kernel once per frame and repeats
  bitwise.
"""

import numpy as np
import pytest
import torch

from randt_slam_torch.ops import build
from randt_slam_torch.ops import segment_moments as K2
from randt_slam_torch.ops import window_slice as K1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("win", [1, 65, 128])
def test_row_windows_kernel_matches_plain(dev, win):
    rng = np.random.default_rng(win)
    A, R = 400, 1221
    img = torch.from_numpy(rng.random((A, R), dtype=np.float32)).to(dev)
    rr = torch.from_numpy(rng.random(R, dtype=np.float32)).to(dev)
    starts = torch.from_numpy(rng.integers(-win - 3, R + 3, A)).to(dev)
    k = K1.row_windows(img, rr, starts, win)
    p = K1.row_windows_plain(img, rr, starts, win)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
def test_segment_topk_kernel_matches_plain(dev):
    rng = np.random.default_rng(3)
    P, S, k = 26000, 3249, 512
    vals = rng.normal(0, 30.0, (P, 13)).astype(np.float32)
    vals[:, 0] = (rng.random(P) < 0.5).astype(np.float32)
    vals = torch.from_numpy(vals).to(dev)
    ids = torch.from_numpy(rng.integers(-1, S + 2, P)).to(dev)
    out, topi = K2.segment_topk_moments(vals, ids, S, k)
    again, topi2 = K2.segment_topk_moments(vals, ids, S, k)
    plain = K2.topi_moments_plain(vals, ids, topi, S)
    scale = K2.topi_moments_plain(vals.abs(), ids, topi, S)
    cpu_out, cpu_topi = K2.segment_topk_moments(vals.cpu(), ids.cpu(), S, k)
    torch.cuda.synchronize()
    assert torch.equal(topi, topi2) and torch.equal(out, again)
    assert torch.equal(topi.cpu(), cpu_topi)
    assert bool(((out - plain).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    img = torch.zeros(4, 16, device=dev)
    with pytest.raises(TypeError):
        K1.row_windows(img.double(), torch.zeros(16, device=dev).double(),
                       torch.zeros(4, dtype=torch.long, device=dev), 5)
    with pytest.raises(ValueError):
        K1.row_windows(img, torch.zeros(16, device=dev),
                       torch.zeros(4, dtype=torch.long, device=dev), 2000)
    with pytest.raises(ValueError):
        K2.topi_moments_cuda(torch.zeros(8, 20, device=dev),
                             torch.zeros(8, dtype=torch.int32, device=dev),
                             torch.zeros(2, dtype=torch.int32, device=dev))


@pytest.mark.cuda
def test_odometry_launches_each_kernel_once_per_frame(dev):
    from randt_slam_torch.config import synthetic_config
    from randt_slam_torch.io import synthetic
    from randt_slam_torch.pipeline import slam

    seq = synthetic.generate(seed=3, n_frames=8, n_azimuths=256, n_bins=256)
    frames = slam.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                     seq.stamps, device=dev)
    build.reset_launches()
    a = slam.run_odometry(synthetic_config(), frames, device=dev)
    assert build.LAUNCHES == {"row_windows": 8, "segment_topk_moments": 8}
    b = slam.run_odometry(synthetic_config(), frames, device=dev)
    assert np.array_equal(a.odom_poses, b.odom_poses)
    assert np.all(np.isfinite(a.odom_poses))
