"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

* K1 ``row_windows``: bitwise equal to the plain version (a gather).
* K2 ``segment_topk_moments``: the same ``topi``; moments within 1e-5 of the
  sum of the absolute values of their terms; two launches bitwise equal.
* K3a ``ndt_linearize`` and K3b ``ndt_robust_cost``: within 1e-4 of each
  output's scale (the sum of the absolute values of its per-pair terms) of
  the plain versions (a few ulps of each term: the kernel contracts
  multiply-adds and its powf is not torch.pow's); the maximum within 1e-5
  of itself; two launches bitwise equal; a NaN pair passes on to its slot's
  cost and maximum, as in the plain version.
* K4 ``chol_solve``: within 4 P eps kappa |x| of the plain version and of a
  float64 solve, with the residual |A x - b| within 4 P eps |A| |x|, on
  damped Jacobi-scaled systems with identity rows, one system and a batch.
* The wrappers refuse inputs the kernels do not take.
* A short odometry run launches K1 and K2 once per frame; with the switches
  on, each ``estimate_window`` call launches K3a and K4 gnc_steps x
  lm_max_iterations times and K3b 2 + gnc_steps x (1 + lm_max_iterations)
  times, with them off none of the three; each run repeats bitwise.
"""

import numpy as np
import pytest
import torch

from randt_slam_torch.ops import build
from randt_slam_torch.ops import ndt_linearize as K3
from randt_slam_torch.ops import segment_moments as K2
from randt_slam_torch.ops import small_chol as K4
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


def _pairs(rng, W, N, dev):
    def spd(n):
        A = rng.normal(0, 0.3, (W, n, 3, 3))
        return A @ np.swapaxes(A, -1, -2) + 0.05 * np.eye(3)

    m_mean = rng.uniform(-20, 20, (W, N, 3))
    a_mean = m_mean + rng.normal(0, 1.0, (W, N, 3))
    valid = rng.random((W, N)) < 0.7
    t = [torch.from_numpy(np.asarray(x, np.float32)).to(dev)
         for x in (m_mean, spd(N), a_mean, spd(N))]
    packed = K3.pack_pairs(*t, torch.from_numpy(valid).to(dev))
    poses = torch.from_numpy(rng.normal(0, 0.5, (W, 3)).astype(np.float32)).to(dev)
    return K3.pose_inputs(poses), packed


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [-2.0, 0.0, 2.0])
def test_ndt_linearize_kernels_match_plain(dev, alpha):
    rng = np.random.default_rng(4)
    pose4, packed = _pairs(rng, 3, 2048, dev)
    mu = torch.tensor(4.0, device=dev)
    ns = torch.tensor(0.37, device=dev)
    H, g, rho = K3.linearize_cuda(pose4, mu, ns, packed, 1.0, alpha)
    H2, g2, rho2 = K3.linearize_cuda(pose4, mu, ns, packed, 1.0, alpha)
    Hp, gp, rhop = K3.linearize_plain(pose4, mu, ns, packed, 1.0, alpha)
    Hs, gs, rhos = K3.sums_to_blocks(
        K3.linearize_terms(pose4, mu, ns, packed, 1.0, alpha).abs().sum(-1))
    c, m = K3.robust_cost_cuda(pose4, mu, packed, 1.0, alpha)
    c2, m2 = K3.robust_cost_cuda(pose4, mu, packed, 1.0, alpha)
    cp, mp = K3.robust_cost_plain(pose4, mu, packed, 1.0, alpha)
    cs = K3.robust_cost_terms(pose4, mu, packed, 1.0, alpha)[0].abs().sum(-1)
    torch.cuda.synchronize()
    for a, b in ((H, H2), (g, g2), (rho, rho2), (c, c2), (m, m2)):
        assert torch.equal(a, b)
    for a, b, sc in ((H, Hp, Hs), (g, gp, gs), (rho, rhop, rhos), (c, cp, cs)):
        assert bool(((a - b).abs() <= 1e-4 * sc).all()), (a - b).abs().max()
    assert bool(((m - mp).abs() <= 1e-5 * mp).all())


def _system(rng, P, lam):
    Q = np.linalg.qr(rng.normal(0, 1, (P, P)))[0]
    J = rng.normal(0, 1, (3 * P, P)) @ (Q * np.logspace(-3, 0, P)) @ Q.T
    H = J.T @ J
    frozen = np.zeros(P, bool)
    frozen[[0, 1, 2, 8]] = True
    frozen[6::9] = frozen[7::9] = True
    H = H * ~frozen[:, None] * ~frozen[None, :]
    d = np.where(frozen, 0.0, 1.0 / np.sqrt(np.maximum(np.diag(H), 1e-10)))
    A = H * d[:, None] * d[None, :] + np.diag(np.where(frozen, 1.0, lam))
    return A, rng.normal(0, 1, P)


@pytest.mark.cuda
def test_chol_solve_kernel_matches_plain_and_float64(dev):
    rng = np.random.default_rng(9)
    P = 36
    systems = [_system(rng, P, lam) for lam in (1e-4, 1e-2, 1.0, 1e2)]
    A = torch.tensor(np.stack([s[0] for s in systems]), dtype=torch.float32, device=dev)
    b = torch.tensor(np.stack([s[1] for s in systems]), dtype=torch.float32, device=dev)
    x = K4.chol_solve_cuda(A, b)
    x2 = K4.chol_solve_cuda(A, b)
    x1 = K4.chol_solve_cuda(A[0].contiguous(), b[0].contiguous())
    xp = K4.chol_solve_plain(A, b)
    x64 = torch.linalg.solve(A.double(), b.double())
    kappa = torch.linalg.cond(A.double())
    torch.cuda.synchronize()
    assert torch.equal(x, x2) and torch.equal(x1, x[0])
    bound = (4 * P * float(np.finfo(np.float32).eps) * kappa
             * x64.abs().amax(-1))[:, None]
    assert bool(((x.double() - x64).abs() <= bound).all())
    assert bool(((x - xp).double().abs() <= bound).all())
    # the residual of a backward-stable solve, independent of kappa
    res = (A.double() @ x.double()[..., None])[..., 0] - b.double()
    res_bound = (4 * P * float(np.finfo(np.float32).eps) * A.abs().amax((-2, -1))
                 * x.abs().amax(-1)).double()
    assert bool((res.abs().amax(-1) <= res_bound).all())


@pytest.mark.cuda
def test_robust_cost_kernel_passes_nan_on(dev):
    rng = np.random.default_rng(6)
    pose4, packed = _pairs(rng, 3, 512, dev)
    first = int(torch.nonzero(packed[4][1, 0] > 0)[0])
    packed[2][1, 0, first] = float("nan")
    mu = torch.tensor(4.0, device=dev)
    c, m = K3.robust_cost_cuda(pose4, mu, packed, 1.0, -2.0)
    cp, mp = K3.robust_cost_plain(pose4, mu, packed, 1.0, -2.0)
    torch.cuda.synchronize()
    assert bool(m[1].isnan()) and bool(c[1].isnan())
    assert torch.equal(m.isnan(), mp.isnan()) and torch.equal(c.isnan(), cp.isnan())


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
    pose4, packed = _pairs(np.random.default_rng(0), 2, 64, dev)
    one = torch.ones((), device=dev)
    with pytest.raises(TypeError):
        K3.linearize_cuda(pose4.double(), one, one, packed, 1.0, -2.0)
    with pytest.raises(ValueError):
        K3.robust_cost_cuda(pose4[:1], one, packed, 1.0, -2.0)
    with pytest.raises(ValueError):
        K3.linearize_cuda(pose4, one, one, (packed[0].cpu(),) + packed[1:], 1.0, -2.0)
    with pytest.raises(ValueError):
        K4.chol_solve_cuda(torch.eye(65, device=dev), torch.ones(65, device=dev))
    with pytest.raises(ValueError):
        K4.chol_solve_cuda(torch.eye(4, device=dev), torch.ones(3, device=dev))
    with pytest.raises(TypeError):
        K4.chol_solve_cuda(torch.eye(4, device=dev).double(),
                           torch.ones(4, device=dev).double())


SWITCHES = {"off": {}, "on": {"matcher.use_pallas_linearize": True,
                              "matcher.use_pallas_chol": True}}


@pytest.mark.cuda
@pytest.mark.parametrize("switches", list(SWITCHES))
def test_odometry_launches_each_kernel_once_per_frame(dev, switches):
    from randt_slam_torch.config import synthetic_config
    from randt_slam_torch.io import synthetic
    from randt_slam_torch.pipeline import slam

    cfg = synthetic_config(**SWITCHES[switches])
    seq = synthetic.generate(seed=3, n_frames=8, n_azimuths=256, n_bins=256)
    frames = slam.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                     seq.stamps, device=dev)
    build.reset_launches()
    a = slam.run_odometry(cfg, frames, device=dev)
    # the first frame starts the trajectory; every later one is solved
    solves = 7 if switches == "on" else 0
    m = cfg.matcher
    assert build.LAUNCHES == {
        "row_windows": 8, "segment_topk_moments": 8,
        "ndt_linearize": solves * m.gnc_steps * m.lm_max_iterations,
        "ndt_robust_cost": solves * (2 + m.gnc_steps * (1 + m.lm_max_iterations)),
        "chol_solve": solves * m.gnc_steps * m.lm_max_iterations,
    }
    b = slam.run_odometry(cfg, frames, device=dev)
    assert np.array_equal(a.odom_poses, b.odom_poses)
    assert np.all(np.isfinite(a.odom_poses))
