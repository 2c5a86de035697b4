"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

* K1 ``row_windows``: bitwise equal to the plain version (a gather), with
  int64 starts, win in {1, 65, 128, 1024}, windows at both edges of the
  padded row and past them (the per-element clamp).
* K2 ``segment_topk_moments``, (P, S, k, CH) in {(26000, 3249, 512, 13),
  (5000, 700, 255, 13), (5000, 700, 3, 1), (4000, 900, 513, 16)}, every id
  -1, and kept segments without points: the same ``topi`` as on the CPU;
  moments within 1e-5 of the sum of the absolute values of their terms, an
  empty segment's row exactly 0; two launches bitwise equal.
* K5 ``segment_moments``: within 1e-5 of the sum of the absolute values of
  its terms of the plain version on dense random ids at (P, S) = (5000,
  700) and (26000, 3249), int32 and int64, dropped ids included; every id
  dropped; all rows in one segment; a sparse frame-like set (about 7 % of
  the rows kept, in runs along the beams); S and P at the kernel's limits;
  CH 1 and 16; two launches bitwise equal and segments without points
  exactly 0; one launch per ``cells.from_points`` call.
* K3a ``ndt_linearize`` and K3b ``ndt_robust_cost``, W in {1, 3, 4} slots
  of N in {1, 255, 256, 257, 2048, 2049, 4096} pairs (one to two pairs per
  thread of the kernels' 2048-thread clusters, and ragged ends): within
  1e-4 of each output's scale (the sum of the absolute values of its
  per-pair terms) of the plain versions (a few ulps of each term: the kernel
  contracts multiply-adds and its powf is not torch.pow's); the maximum
  within 1e-5 of itself; two launches bitwise equal; a NaN in a valid pair
  passes on to its slot's cost and maximum, a NaN in an invalid pair to its
  cost only, and a slot without a valid pair costs exactly 0, as in the
  plain version; a NaN in a valid or an invalid pair makes its slot's H, g
  and rho NaN where the plain version's are, and a slot without a valid
  pair gives exactly 0.
* K4 ``chol_solve``, P in {1, 9, 18, 31, 32, 36, 37, 63, 64} (each lane
  holds one, two or three rows of A and b) and B in {1, 3, 50} systems: within 4 P eps kappa |x|
  of the plain version and of a float64 solve, with the residual |A x - b|
  within 4 P eps |A| |x|, on damped Jacobi-scaled systems with identity
  rows; batch, repeat and one-by-one launches bitwise equal.
* The wrappers refuse inputs the kernels do not take.
* A short odometry run launches K1 and K2 once per frame; with the switches
  on, each ``estimate_window`` call launches K3a, K4, lm_assemble, lm_trial
  and lm_accept gnc_steps x lm_max_iterations times and K3b 2 + gnc_steps x
  (1 + lm_max_iterations) times, with them off none of them; each run
  repeats bitwise.
* Full SLAM on the CPU tests' loop sequence: loop closure and the pose
  graph on the CPU from the card's odometry give the card's tables, with
  the free-running edges and CS values inside ``chip_smoke.py``'s band.
* The Schur-complement pose graph on the card, on the CPU Schur tests'
  graphs (a numpy copy of ``tests/test_schur.py::_slam_graph``) and
  ``bench.py``'s at 77 nodes: the Schur route, within 1e-4 (m, rad) plus
  1e-5 of the pose's size of the CPU's solve (the CPU tests' tolerance
  against the JAX package: float order only), two card runs bitwise equal.
* ``render_ogm`` on the card from a short card odometry run: K1 once per
  chunk of 32 keyframe nodes and no other kernel; counting grids bitwise equal to the
  CPU's from the same tables, the occupancy within 1e-5; two card runs
  bitwise equal.
* ``OnlineSlam`` on the card: the CPU's tables, poses within 1e-2 m /
  1e-3 rad of the CPU's; resumed from its own checkpoint, bitwise the
  uninterrupted run.
* The long-sequence path: host-resident frames through chunked odometry
  bitwise the device-resident run (float32 and uint8 frames, both switch
  settings); ``render_ogm`` in chunks bitwise one node per launch; the
  online grids of finished submaps in host memory, none re-uploaded, the
  grids and occupancy bitwise those of the run that keeps them on the card.
* The batch axis of ``parallel/batch``: K1, K2 and K3a/K3b with B in
  {1, 3} (members with different range rows, segment populations,
  valid-pair counts, mu and NDT scale) against their batched plain
  versions, each member bitwise its unbatched launch; K4 on B in {1, 3, 16}
  window systems (P = 36); a batched odometry run of three sequences
  launches each kernel as one sequence does, and each member has its
  single card run's tables and poses within ``tests/test_torch_batch.py``'s
  free-running bands.
* The odometry window solve's CUDA graphs (``registration/solve_graph``),
  on 26 frames of three drives in chunks of 8 (switches off, on, and on
  with the IMU) and on one drive through ``run_odometry``: poses, records
  and the carries at every frame boundary bitwise the run with every solve
  eager; each replay bitwise the eager solve of that frame's own inputs,
  with frames of one key answering differently; one capture per key (2, 3
  and 4 existing window states), a replay for every later solve, and the
  kernel counters the eager run's launches.
* The LM iteration's own kernels ``lm_assemble``, ``lm_trial`` and
  ``lm_accept`` (``ops/lm_step``) against their plain versions, on random
  iterations at the Oxford configuration (B in {1, 8, 512}, W = 3, every
  number of existing states) and on every iteration of an IMU-on window
  solve at the indoor shapes: the damped system within 1e-5 of its
  scale, the trial bitwise, the acceptance's flags, damping and states
  exact wherever the cost and step tests are decided by more than 1e-5,
  the live counter exact; two launches bitwise.  Whole switches-on window
  solves on the card within 1e-4 (m, m/s) and 1e-5 (rad, rad/s) of the
  CPU's tensor ops; a member of a batch of 8 bitwise its own solve; the
  wrappers refuse W > 6 (P > 63), other dtypes, devices, shapes and
  strides.  Each launches once per LM iteration, as K3a does.
* The indoor shapes (``indoor_config()``, the IMU on): K1 and K2 on a
  rendered 400 x 400 frame of 3 cm bins (k = 256), bitwise and within
  1e-5 of their scale as above; K3a/K3b on every LM iteration's pairs of an
  IMU-on window solve (N = 1024 per slot) within 1e-4 of their scale;
  K4 on that solve's systems, whose bias columns are free at the
  reference's weight_imu_bias, within the bounds above.
"""

import dataclasses

import numpy as np
import pytest
import torch

from randt_slam_torch.ops import build
from randt_slam_torch.ops import ndt_linearize as K3
from randt_slam_torch.ops import segment_moments as K2
from randt_slam_torch.ops import small_chol as K4
from randt_slam_torch.ops import window_slice as K1


def tiny_config(**kw):
    """``__graft_entry__._tiny_cfg`` (a JAX package module) built from the
    port's own configuration classes."""
    from randt_slam_torch import config as C

    cfg = C.derive(C.SlamConfig(
        ndt_map=C.MapConfig(size_x=96, size_y=96, resolution=3.0,
                            min_points_per_cell=6, max_neighbour_linf_distance=9.0),
        preprocessor=C.PreprocessorConfig(min_range=2.0, max_range=40.0,
                                          min_intensity=40.0,
                                          beam_distance_increment_threshold=1.0),
        matcher=C.MatcherConfig(smoothing_steps=3, gnc_steps=2, lm_max_iterations=6),
        local_fuser=C.LocalFuserConfig(submap_size_poses=6, submap_overlap=3),
        scan_context=C.ScanContextConfig(num_ring=10, num_sector=24, max_radius=40.0),
        capacity=C.CapacityConfig(max_points=1024, max_scan_cells=64, max_azimuths=64,
                                  max_range_bins=128, max_submap_cells=128,
                                  max_submaps=4, max_nodes=64, max_edges=128,
                                  max_keyframes=64)))
    return dataclasses.replace(cfg, **kw)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("win", [1, 65, 128, 1024])
@pytest.mark.parametrize("where", ["random", "left", "right"])
def test_row_windows_kernel_matches_plain(dev, win, where):
    """int64 starts, as torch.argmax gives them: anywhere (past both ends
    too, where the per-element clamp decides), at the left edge of the
    padded row, and ending at its right edge."""
    rng = np.random.default_rng(win)
    A, R = 400, 1221
    img = torch.from_numpy(rng.random((A, R), dtype=np.float32)).to(dev)
    rr = torch.from_numpy(rng.random(R, dtype=np.float32)).to(dev)
    if where == "random":
        starts = rng.integers(-win - 3, R + 3, A)
    elif where == "left":
        starts = np.zeros(A, np.int64)
    else:
        starts = np.full(A, R - win, np.int64)
    starts = torch.from_numpy(starts).to(dev)
    assert starts.dtype == torch.int64
    k = K1.row_windows(img, rr, starts, win)
    p = K1.row_windows_plain(img, rr, starts, win)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("P,S,k,CH,ids_kind", [
    (26000, 3249, 512, 13, "random"),
    (5000, 700, 255, 13, "random"),
    (5000, 700, 3, 1, "random"),
    (4000, 900, 513, 16, "random"),
    (5000, 700, 255, 13, "all_dropped"),
    (5000, 700, 255, 13, "empty_segments"),
])
def test_segment_topk_kernel_matches_plain(dev, P, S, k, CH, ids_kind):
    """k not a multiple of the kernel's group of kept ranks, CH from 1 to
    16; every id -1; kept segments that no point falls in (their rows are
    exactly 0)."""
    rng = np.random.default_rng(3)
    vals = rng.normal(0, 30.0, (P, CH)).astype(np.float32)
    vals[:, 0] = (rng.random(P) < 0.5).astype(np.float32)
    vals = torch.from_numpy(vals).to(dev)
    if ids_kind == "all_dropped":
        ids = np.full(P, -1)
    elif ids_kind == "empty_segments":  # 100 segments hold points, k > 100
        ids = rng.integers(-1, 100, P)
    else:
        ids = rng.integers(-1, S + 2, P)
    ids = torch.from_numpy(ids).to(dev)
    out, topi = K2.segment_topk_moments(vals, ids, S, k)
    again, topi2 = K2.segment_topk_moments(vals, ids, S, k)
    plain = K2.topi_moments_plain(vals, ids, topi, S)
    scale = K2.topi_moments_plain(vals.abs(), ids, topi, S)
    cpu_out, cpu_topi = K2.segment_topk_moments(vals.cpu(), ids.cpu(), S, k)
    torch.cuda.synchronize()
    assert out.shape == (k, CH)
    assert torch.equal(topi, topi2) and torch.equal(out, again)
    assert torch.equal(topi.cpu(), cpu_topi)
    assert bool(((out - plain).abs() <= 1e-5 * scale).all())
    empty = ~torch.isin(topi, ids)
    if ids_kind != "random":
        assert bool(empty.any())
    assert bool((out[empty] == 0).all())


def _k5_ids(rng, P, S, kind):
    if kind == "all_dropped":
        return np.full(P, -1, np.int64)
    if kind == "one_run":  # every row in one segment
        return np.full(P, S // 2, np.int64)
    if kind == "frame_like":  # ~7 % kept, in runs of a beam; the rest S
        ids = np.full(P, S, np.int64)
        keep = rng.random(P) < 0.07
        ids[keep] = np.repeat(rng.integers(0, S, P // 65 + 1), 65)[:P][keep]
        return ids
    return rng.integers(-1, S + 2, P)


@pytest.mark.cuda
@pytest.mark.parametrize("P,S,CH,kind,dtype", [
    (5000, 700, 13, "random", torch.int32),
    (26000, 3249, 13, "random", torch.int32),
    (26000, 3249, 13, "random", torch.int64),
    (26000, 3249, 13, "all_dropped", torch.int64),
    (26000, 3249, 13, "one_run", torch.int64),
    (26000, 3249, 13, "frame_like", torch.int64),
    (26000, K2.MAX_SEGMENTS, 13, "random", torch.int64),
    (K2.MAX_POINTS, 3249, 13, "random", torch.int32),
    (3000, 100, 1, "random", torch.int64),
    (3000, 100, 16, "random", torch.int32),
    (0, 10, 13, "random", torch.int64),
])
def test_segment_moments_kernel_matches_plain(dev, P, S, CH, kind, dtype):
    rng = np.random.default_rng(P + S)
    vals = torch.from_numpy(rng.normal(0, 30.0, (P, CH)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(_k5_ids(rng, P, S, kind)).to(dtype).to(dev)
    build.reset_launches()
    out = K2.segment_moments(vals, ids, S)
    again = K2.segment_moments(vals, ids, S)
    assert build.LAUNCHES["segment_moments"] == 2
    plain = K2.segment_moments_plain(vals, ids, S)
    scale = K2.segment_moments_plain(vals.abs(), ids, S)
    torch.cuda.synchronize()
    assert out.shape == (S, CH) and torch.equal(out, again)
    assert bool(((out - plain).abs() <= 1e-5 * scale).all())
    empty = scale.sum(1) == 0
    assert bool((out[empty] == 0).all())
    if kind in ("all_dropped", "one_run", "frame_like"):
        assert bool(empty.any())


@pytest.mark.cuda
def test_from_points_launches_k5_once(dev):
    from randt_slam_torch.ndt import cells

    rng = np.random.default_rng(5)
    P, S = 4000, 600
    pts = torch.from_numpy(rng.normal(0, 30, (P, 3)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random(P) < 0.7).to(dev)
    ids = torch.from_numpy(rng.integers(0, S, P)).to(dev)
    build.reset_launches()
    c = cells.from_points(pts, mask, ids, S)
    torch.cuda.synchronize()
    assert build.LAUNCHES["segment_moments"] == 1
    ref = cells.from_points(pts.cpu(), mask.cpu(), ids.cpu(), S)
    for a, b in zip(c, ref):
        assert torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-2)


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
@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("N", [1, 255, 256, 257, 2048, 2049, 4096])
def test_ndt_linearize_kernels_match_plain(dev, alpha, W, N):
    rng = np.random.default_rng(4)
    pose4, packed = _pairs(rng, W, N, dev)
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
    frozen[[k for k in (0, 1, 2, 8) if k < P]] = True
    frozen[6::9] = frozen[7::9] = True
    H = H * ~frozen[:, None] * ~frozen[None, :]
    d = np.where(frozen, 0.0, 1.0 / np.sqrt(np.maximum(np.diag(H), 1e-10)))
    A = H * d[:, None] * d[None, :] + np.diag(np.where(frozen, 1.0, lam))
    return A, rng.normal(0, 1, P)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 9, 18, 31, 32, 36, 37, 63, 64])
@pytest.mark.parametrize("B", [1, 3, 50])
def test_chol_solve_kernel_matches_plain_and_float64(dev, P, B):
    rng = np.random.default_rng(9)
    lams = (1e-4, 1e-2, 1.0, 1e2)
    systems = [_system(rng, P, lams[i % len(lams)]) for i in range(B)]
    A = torch.tensor(np.stack([s[0] for s in systems]), dtype=torch.float32, device=dev)
    b = torch.tensor(np.stack([s[1] for s in systems]), dtype=torch.float32, device=dev)
    x = K4.chol_solve_cuda(A, b)
    x2 = K4.chol_solve_cuda(A, b)
    one = torch.stack([K4.chol_solve_cuda(A[i].contiguous(), b[i].contiguous())
                       for i in range(B)])
    xp = K4.chol_solve_plain(A, b)
    x64 = torch.linalg.solve(A.double(), b.double())
    kappa = torch.linalg.cond(A.double())
    torch.cuda.synchronize()
    assert torch.equal(x, x2) and torch.equal(one, x)
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
@pytest.mark.parametrize("case", ["valid_nan", "invalid_nan", "all_invalid"])
def test_robust_cost_kernel_passes_nan_on(dev, case):
    """Slot 1: a NaN in a valid pair makes its cost and maximum NaN; a NaN in
    an invalid pair makes its cost NaN (the cost is multiplied by the valid
    weight) and leaves its maximum finite; a slot without a valid pair
    costs exactly 0, with maximum 0.  As in the plain version."""
    rng = np.random.default_rng(6)
    pose4, packed = _pairs(rng, 3, 2048, dev)
    mu = torch.tensor(4.0, device=dev)
    if case == "all_invalid":
        packed[4][1] = 0.0
    else:
        pick = packed[4][1, 0] > 0 if case == "valid_nan" else packed[4][1, 0] == 0
        packed[2][1, 0, int(torch.nonzero(pick)[0])] = float("nan")
    c, m = K3.robust_cost_cuda(pose4, mu, packed, 1.0, -2.0)
    c2, m2 = K3.robust_cost_cuda(pose4, mu, packed, 1.0, -2.0)
    cp, mp = K3.robust_cost_plain(pose4, mu, packed, 1.0, -2.0)
    torch.cuda.synchronize()
    for a, b in ((c, c2), (m, m2)):
        assert torch.allclose(a, b, rtol=0.0, atol=0.0, equal_nan=True)
    assert torch.equal(m.isnan(), mp.isnan()) and torch.equal(c.isnan(), cp.isnan())
    if case == "all_invalid":
        assert float(c[1]) == 0.0 and float(m[1]) == 0.0
    else:
        assert bool(c[1].isnan())
        assert bool(m[1].isnan()) == (case == "valid_nan")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["valid_nan", "invalid_nan", "all_invalid"])
def test_linearize_kernel_passes_nan_on(dev, case):
    """Slot 1: a NaN in a valid or in an invalid pair makes its H, g and rho
    NaN where the plain version's are (every term is multiplied by the valid
    weight), the other slots stay finite; a slot without a valid pair gives
    exactly 0."""
    rng = np.random.default_rng(6)
    pose4, packed = _pairs(rng, 3, 2048, dev)
    mu = torch.tensor(4.0, device=dev)
    ns = torch.tensor(0.37, device=dev)
    if case == "all_invalid":
        packed[4][1] = 0.0
    else:
        pick = packed[4][1, 0] > 0 if case == "valid_nan" else packed[4][1, 0] == 0
        packed[2][1, 0, int(torch.nonzero(pick)[0])] = float("nan")
    out = K3.linearize_cuda(pose4, mu, ns, packed, 1.0, -2.0)
    again = K3.linearize_cuda(pose4, mu, ns, packed, 1.0, -2.0)
    plain = K3.linearize_plain(pose4, mu, ns, packed, 1.0, -2.0)
    torch.cuda.synchronize()
    for a, b, p in zip(out, again, plain):
        assert torch.allclose(a, b, rtol=0.0, atol=0.0, equal_nan=True)
        assert torch.equal(a.isnan(), p.isnan())
        assert bool(a[[0, 2]].isfinite().all())
        if case == "all_invalid":
            assert bool((a[1] == 0).all())
        else:
            assert bool(a[1].isnan().all())


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
    with pytest.raises(TypeError):
        K1.row_windows(img, torch.zeros(16, device=dev),
                       torch.zeros(4, dtype=torch.int32, device=dev), 5)
    with pytest.raises(ValueError):
        K1.row_windows(img, torch.zeros(16, device=dev),
                       torch.zeros(8, dtype=torch.long, device=dev)[::2], 5)
    vals = torch.zeros(8, 13, device=dev)
    ids = torch.zeros(8, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        K2.segment_moments_cuda(vals.double(), ids, 3)
    with pytest.raises(TypeError):
        K2.segment_moments_cuda(vals, ids.float(), 3)
    with pytest.raises(ValueError):
        K2.segment_moments_cuda(vals, ids.cpu(), 3)
    with pytest.raises(ValueError):
        K2.segment_moments_cuda(torch.zeros(8, 17, device=dev), ids, 3)
    with pytest.raises(ValueError):
        K2.segment_moments_cuda(vals, ids[:4], 3)
    with pytest.raises(ValueError):
        K2.segment_moments_cuda(vals, ids, K2.MAX_SEGMENTS + 1)
    with pytest.raises(ValueError):
        K2.segment_moments_cuda(vals, ids, -1)
    with pytest.raises(ValueError):
        K2.segment_moments(torch.zeros(K2.MAX_POINTS + 1, 1, device=dev),
                           torch.zeros(K2.MAX_POINTS + 1, dtype=torch.int64, device=dev), 3)
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
# the LM iteration's own kernels: as often as K3a with both switches on
LM_STEP = ("lm_assemble", "lm_trial", "lm_accept")


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
        "row_windows": 8, "segment_topk_moments": 8, "segment_moments": 0,
        "ndt_linearize": solves * m.gnc_steps * m.lm_max_iterations,
        "ndt_robust_cost": solves * (2 + m.gnc_steps * (1 + m.lm_max_iterations)),
        "chol_solve": solves * m.gnc_steps * m.lm_max_iterations,
        **{k: solves * m.gnc_steps * m.lm_max_iterations for k in LM_STEP},
    }
    b = slam.run_odometry(cfg, frames, device=dev)
    assert np.array_equal(a.odom_poses, b.odom_poses)
    assert np.all(np.isfinite(a.odom_poses))


# the CPU tests' loop sequence and loop parameters (tests/test_torch_loops.py)
LOOP_KW = {**{f"scan_context.{k}": v for k, v in dict(
    num_ring=20, num_sector=60, max_radius=80.0, num_exclude_recent=20,
    num_candidates=5, dist_threshold=0.7, odom_weight=0.05, odom_eps=4.0,
    assumed_drift=0.05, intensity_factor=0.01).items()},
    "local_fuser.csm_prealign_loops": True, "matcher.csm_window_linear": 12.0,
    "matcher.csm_window_angular": 0.6, "matcher.csm_n_iter": 3}
# optimized poses from the CPU's own free-running loop edges against the
# card's: twice the reading on an H100 (2.25e-3 m, 1.09e-4 rad), which the
# refined edges' one-step gap sets
FREE_POSE_BAND = (4.5e-3, 2.2e-4)


@pytest.mark.cuda
def test_loop_closure_card_against_cpu(dev):
    """Full SLAM on the card over the CPU tests' loop sequence (seed 7, 130
    frames, 1.25 laps), then loop closure and the pose graph again on the
    CPU from the card's odometry: identical candidate and edge tables;
    refined edges and CS divergences within ``chip_smoke.py``'s band, and
    the poses optimized from them within the band above; the pose graph of
    the card's own loop edges, solved on the CPU, within 1e-3 m / 1e-4 rad
    of the card's.  A second drive beside chip_smoke's; its readings are
    printed (``-s``)."""
    from chip_smoke import LOOP_CS_BAND, LOOP_EDGE_BAND
    from randt_slam_torch.config import synthetic_config
    from randt_slam_torch.graph import schur
    from randt_slam_torch.io import synthetic
    from randt_slam_torch.loops import detector
    from randt_slam_torch.pipeline import slam

    cfg = synthetic_config(**LOOP_KW)
    seq = synthetic.generate(seed=7, n_frames=130, n_azimuths=256, n_bins=256,
                             speed=4.0, dt=0.25, loop=True, n_walls=80)
    frames = slam.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                     seq.stamps, device=dev)
    res = slam.run_slam(cfg, frames, device=dev)
    odo, card = res.odometry, res.loops
    assert card.n_accepted > 0

    def pgo_on_cpu(loops):
        opt, _ = schur.optimize_auto(slam.build_pose_graph(odo, loops, "cpu"),
                                     cfg.global_fuser, node_submap=odo.node_submap,
                                     node_is_root=odo.node_is_root)
        return np.abs(opt.numpy() - res.node_pose_optimized)

    cpu = detector.detect_loops(cfg, odo, frames, device="cpu")
    for k in ("query_node", "query_match", "query_stage", "edge_begin", "edge_end"):
        assert np.array_equal(getattr(cpu, k), getattr(card, k)), k
    assert (cpu.n_sc_candidates, cpu.n_accepted) == (card.n_sc_candidates,
                                                      card.n_accepted)
    cs_rel = float(np.max(np.abs(cpu.cs_divergences / card.cs_divergences - 1)))
    de = np.abs(cpu.edge_trans - card.edge_trans)
    dp, dq = pgo_on_cpu(cpu), pgo_on_cpu(card)
    print(f"loop sequence, {card.n_sc_candidates} candidates, {card.n_accepted} "
          f"accepted: CPU against card CS within {cs_rel:.2e} relative, edges "
          f"within {de[:, :2].max():.2e} m / {de[:, 2].max():.2e} rad, optimized "
          f"poses within {dp[:, :2].max():.2e} m / {dp[:, 2].max():.2e} rad (from "
          f"the card's edges {dq[:, :2].max():.2e} m / {dq[:, 2].max():.2e} rad)")
    assert cs_rel <= LOOP_CS_BAND
    assert de[:, :2].max() <= LOOP_EDGE_BAND[0] and de[:, 2].max() <= LOOP_EDGE_BAND[1]
    assert dp[:, :2].max() <= FREE_POSE_BAND[0] and dp[:, 2].max() <= FREE_POSE_BAND[1]
    assert dq[:, :2].max() <= 1e-3 and dq[:, 2].max() <= 1e-4


def _slam_graph(seed=0, n_submaps=6, nodes_per=10, n_loops=4):
    """numpy copy of ``tests/test_schur.py::_slam_graph`` (that module
    imports JAX): a noisy circular drive split into submaps, loop edges from
    roots to interior nodes of other submaps."""
    rng = np.random.default_rng(seed)
    N = n_submaps * nodes_per
    t = np.linspace(0, 2 * np.pi, N, endpoint=False)
    gt = np.stack([30 * np.cos(t), 30 * np.sin(t), t + np.pi / 2], 1)
    noisy = gt + np.concatenate(
        [np.zeros((1, 3)), np.cumsum(rng.normal(0, 0.02, (N - 1, 3)), 0)])
    node_submap = np.repeat(np.arange(n_submaps), nodes_per)
    node_is_root = np.zeros(N, bool)
    node_is_root[::nodes_per] = True

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b - a
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(d[2]), np.cos(d[2]))])

    eb, ee = list(range(N - 1)), list(range(1, N))
    trans = [rel(gt[i], gt[i + 1]) for i in range(N - 1)]
    roots = np.nonzero(node_is_root)[0]
    for k in range(n_loops):
        m = roots[k % n_submaps]
        q = int(rng.integers(0, N))
        if node_is_root[q] or node_submap[q] == node_submap[m]:
            q = (m + nodes_per + 3) % N
            if node_is_root[q]:
                q += 1
        eb.append(int(m))
        ee.append(int(q))
        trans.append(rel(gt[m], gt[q]))
    sqrt_i = np.tile(np.diag([10.0, 10.0, 20.0]), (len(eb), 1, 1))
    return (noisy.astype(np.float32), np.asarray(eb), np.asarray(ee),
            np.stack(trans).astype(np.float32), sqrt_i.astype(np.float32),
            node_submap, node_is_root)


SCHUR_GRAPHS = {
    "slam": {},
    "sharded": dict(n_submaps=8, nodes_per=12, n_loops=6),
    "single_node_submaps": dict(n_submaps=4, nodes_per=1, n_loops=0),
    "many_loops": dict(seed=1, n_submaps=3, nodes_per=25, n_loops=8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCHUR_GRAPHS) + ["bench_77"])
def test_schur_card_against_cpu(dev, name):
    from chip_smoke import bench_graph, se2_gap
    from randt_slam_torch.config import GlobalFuserConfig
    from randt_slam_torch.graph import pose_graph as PG
    from randt_slam_torch.graph import schur

    if name == "bench_77":
        graph = bench_graph(77)[:7]
    else:
        graph = _slam_graph(**SCHUR_GRAPHS[name])
    poses, eb, ee, trans, sqrt_i, node_submap, node_is_root = graph

    def solve(device):
        g = PG.PoseGraph(*(torch.from_numpy(x).to(device) for x in
                           (poses, eb, ee, trans, sqrt_i)),
                         torch.ones(len(eb), dtype=torch.bool, device=device))
        p, info = schur.optimize_auto(g, GlobalFuserConfig(), node_submap=node_submap,
                                      node_is_root=node_is_root, dense_node_limit=1)
        assert info["solver"] == "schur" and info["two_stage"]
        return p.cpu().numpy()

    card, again, cpu = solve(dev), solve(dev), solve("cpu")
    assert np.array_equal(card, again)
    d = np.abs(card.astype(np.float64) - cpu)
    d[:, 2] = np.abs(np.arctan2(np.sin(card[:, 2] - cpu[:, 2]),
                                np.cos(card[:, 2] - cpu[:, 2])))
    print(f"{name}: Schur card against CPU {se2_gap(card, cpu)}")
    assert np.all(d <= 1e-4 + 1e-5 * np.abs(cpu))


@pytest.mark.cuda
def test_render_ogm_card_against_cpu(dev):
    from randt_slam_torch.config import synthetic_config
    from randt_slam_torch.io import synthetic
    from randt_slam_torch.pipeline import slam

    cfg = synthetic_config()
    seq = synthetic.generate(seed=7, n_frames=40, n_azimuths=256, n_bins=256,
                             speed=4.0, dt=0.25, loop=True, n_walls=80)
    frames = slam.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                     seq.stamps, device=dev)
    odo = slam.run_odometry(cfg, frames, device=dev)
    n = odo.n_submaps
    opt = odo.submap_origin.copy()
    opt[:n] += np.random.default_rng(0).normal(0, 0.3, (n, 3)).astype(np.float32)
    res = slam.SlamResult(odometry=odo, loops=None, node_pose_optimized=odo.node_pose,
                          node_stamp=odo.node_stamp, node_frame=odo.node_frame,
                          submap_origin_optimized=opt, pgo_cost=0.0, pgo_iterations=0)
    build.reset_launches()
    occ, grids = slam.render_ogm(cfg, res, frames, device=dev)
    launches = dict(build.LAUNCHES)
    # one batched K1 per chunk of 32 node frames
    assert launches == {k: (-(-len(odo.node_id) // 32) if k == "row_windows" else 0)
                        for k in launches}
    occ2, grids2 = slam.render_ogm(cfg, res, frames, device=dev)
    occ_c, grids_c = slam.render_ogm(cfg, res, frames, device="cpu")
    assert np.array_equal(grids, grids2) and np.array_equal(occ, occ2)
    assert np.array_equal(grids, grids_c)
    assert np.abs(occ - occ_c).max() <= 1e-5
    assert grids.min() < 0 and grids.max() >= 2


@pytest.mark.cuda
def test_ogm_scatters_under_deterministic_algorithms(dev):
    """The OGM's scatters, the integer ``index_add_`` of ``raytrace_beams``
    and the ``scatter_reduce_`` max pair of ``fuse_submaps``, are allowed
    under ``torch.use_deterministic_algorithms(True)`` on CUDA and give the
    grids they give without it (integers, and maxima: exact in any order)."""
    from randt_slam_torch.mapping import ogm, raytrace

    rng = np.random.default_rng(5)
    n = 4000
    poses = np.zeros((n, 3), np.float32)
    poses[:, :2] = rng.uniform(-20, 20, (n, 2))
    poses[:, 2] = rng.uniform(-np.pi, np.pi, n)
    beams = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(0, 30, n),
                      np.zeros(n)], 1).astype(np.float32)
    args = (torch.zeros(300, 400, dtype=torch.int32, device=dev),
            torch.from_numpy(poses).to(dev), torch.from_numpy(beams).to(dev),
            torch.ones(n, dtype=torch.bool, device=dev), 0.1)
    origins = torch.tensor([[1.0, -2.0, 0.3], [-3.0, 0.5, -1.2]], device=dev)

    def run():
        grid = raytrace.raytrace_beams(*args, max_steps=600)
        total = ogm.fuse_submaps(torch.stack([grid, grid.flip(0)]), origins, 0.1, 0.1,
                                 torch.tensor([-25.0, -20.0, 0.1], device=dev), 450, 500)
        torch.cuda.synchronize()
        return grid, total

    grid, total = run()
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        grid_d, total_d = run()
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(grid, grid_d) and torch.equal(total, total_d)
    assert int(grid.min()) < 0 and float(total.abs().max()) > 0


@pytest.mark.cuda
def test_online_card_against_cpu_and_resume(dev, tmp_path):
    """``OnlineSlam`` over 16 frames of ``chip_smoke.py``'s Oxford-geometry
    drive (kernel switches on, loop search every 2 frames, pose graph every
    6, online raytracing on): the card's node and edge tables equal the
    CPU's and its poses lie within 1e-2 m / 1e-3 rad of them, the band of
    chip_smoke's odometry comparison; the card's run resumed from its own
    checkpoint after 9 frames is bitwise the uninterrupted run (odometry,
    trajectory, edges, counting grids)."""
    from chip_smoke import SWITCHES_ON, render_frames
    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam
    from randt_slam_torch.pipeline.online import OnlineSlam

    cfg = dataclasses.replace(oxford_config(**SWITCHES_ON), visualize_ogm=True)
    scans, az, ranges, stamps, _ = render_frames(16)
    ck = str(tmp_path / "ck.npz")

    def run(device, save_at=None, resume=False):
        frames = slam.frames_from_arrays(scans, az, ranges, stamps, device=device)
        eng = OnlineSlam(cfg, loop_every=2, pgo_every=6, device=device)
        if resume:
            eng.load_checkpoint(ck)
        for t in range(eng._frame_count, 16):
            if t == save_at:
                eng.save_checkpoint(ck)
            eng.process_frame(F.Frame(*(x[t] for x in frames)))
        eng.finalize()
        return eng

    def tables(e):
        return (e.node_submap, e.node_frame, e.node_is_root,
                [x[:2] for x in e.edges], e.n_loop_edges)

    card, cpu = run(dev, save_at=9), run("cpu")
    assert tables(card) == tables(cpu)
    for a, b in ((card.trajectory(), cpu.trajectory()),
                 (np.stack(card.odom_trace), np.stack(cpu.odom_trace))):
        d = np.abs(a - b)
        print(f"online card against CPU: {d[:, :2].max():.2e} m / {d[:, 2].max():.2e} rad")
        assert d[:, :2].max() <= 1e-2 and d[:, 2].max() <= 1e-3
    again = run(dev, resume=True)
    assert np.array_equal(np.stack(again.odom_trace), np.stack(card.odom_trace))
    assert np.array_equal(again.trajectory(), card.trajectory())
    assert tables(again) == tables(card)
    for a, b in zip(again.edges, card.edges):
        assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
    grids, grids_again = card.count_grids(), again.count_grids()
    assert grids_again.keys() == grids.keys()
    for k, g in grids.items():
        assert np.array_equal(grids_again[k], g)


@pytest.mark.cuda
def test_long_sequence_path_on_the_card(dev):
    """The long-sequence path on the card: host-resident frames through
    ``run_odometry(chunk=8)`` (the chunks 8, 8 and 4; some nodes leave the
    keyframe queue in the chunk after their source frame's) bitwise the
    device-resident run, float32 and uint8 frames, switches off and on;
    ``render_ogm`` with chunks of 32 and 5 node frames bitwise one node per
    launch, one K1 launch per chunk; ``OnlineSlam`` with the online OGM
    keeps on the card only the grids of submaps that can still receive
    nodes, re-uploads none, and gives the grids and occupancy of the same
    run with the move taken out, bit for bit."""
    from randt_slam_torch.config import synthetic_config
    from randt_slam_torch.io import synthetic
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam
    from randt_slam_torch.pipeline.online import OnlineSlam

    seq = synthetic.generate(seed=3, n_frames=20, n_azimuths=256, n_bins=256)
    fields = ("odom_poses", "node_id", "node_frame", "node_submap", "node_is_root",
              "node_pose", "edge_begin", "edge_end", "edge_trans", "node_desc")
    for switches in SWITCHES:
        cfg = synthetic_config(**SWITCHES[switches])
        for img in (seq.intensity, np.clip(seq.intensity, 0, 255).astype(np.uint8)):
            arrays = (img, seq.azimuths, seq.ranges, seq.stamps)
            ref = slam.run_odometry(cfg, slam.frames_from_arrays(*arrays, device=dev),
                                    device=dev)
            res = slam.run_odometry(cfg, slam.frames_from_arrays(*arrays, host=True),
                                    device=dev, chunk=8)
            for k in fields:
                assert np.array_equal(getattr(res, k), getattr(ref, k)), (switches, k)
            assert len(res.chunk_seconds) == 3

    host = slam.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps,
                                   host=True)
    res = slam.SlamResult(odometry=ref, loops=None, node_pose_optimized=ref.node_pose,
                          node_stamp=ref.node_stamp, node_frame=ref.node_frame,
                          submap_origin_optimized=ref.submap_origin, pgo_cost=0.0,
                          pgo_iterations=0)
    one = slam.render_ogm(cfg, res, host, device=dev, chunk=1)
    for chunk in (32, 5):
        build.reset_launches()
        occ, grids = slam.render_ogm(cfg, res, host, device=dev, chunk=chunk)
        assert build.LAUNCHES["row_windows"] == -(-len(ref.node_id) // chunk)
        assert np.array_equal(grids, one[1]) and np.array_equal(occ, one[0])

    ocfg = dataclasses.replace(tiny_config(), visualize_ogm=True)
    small = synthetic.generate(seed=5, n_frames=20, n_azimuths=64, n_bins=128,
                               max_range=40.0, speed=3.0, dt=0.25, n_walls=40)
    frames = slam.frames_from_arrays(small.intensity, small.azimuths, small.ranges,
                                     small.stamps, device=dev)

    def online():
        eng = OnlineSlam(ocfg, loop_every=3, pgo_every=7, device=dev)
        for t in range(20):
            eng.process_frame(F.Frame(*(x[t] for x in frames)))
        return eng

    moved = online()
    retire = OnlineSlam._retire_grids
    OnlineSlam._retire_grids = lambda self: None
    try:
        kept = online()
    finally:
        OnlineSlam._retire_grids = retire
    place = moved.grid_placement()
    print(f"online grids on the card and the host: {place}")
    assert place["host"] >= 2 and place["reuploads"] == 0
    assert all(isinstance(g, np.ndarray) == (s < moved.carry.n_finished)
               for s, g in moved._count_grids.items())
    a, b = moved.count_grids(), kept.count_grids()
    assert a.keys() == b.keys() and all(np.array_equal(a[s], b[s]) for s in a)
    assert np.array_equal(moved.render_ogm(), kept.render_ogm())


# ---- the batch axis (parallel/batch: B sequences in one launch) -------------


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
def test_batched_row_windows(dev, B):
    """Each row reads its own scan's range row: bitwise the plain version
    and each member's unbatched launch."""
    rng = np.random.default_rng(20 + B)
    A, R, win = 400, 1221, 65
    img = torch.from_numpy(rng.random((B, A, R), dtype=np.float32)).to(dev)
    rr = torch.from_numpy(rng.random((B, R), dtype=np.float32)).to(dev)
    starts = torch.from_numpy(rng.integers(-win - 3, R + 3, (B, A))).to(dev)
    k = K1.row_windows(img, rr, starts, win)
    p = K1.row_windows_plain(img, rr, starts, win)
    one = [K1.row_windows(img[b], rr[b], starts[b], win) for b in range(B)]
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    for b in range(B):
        assert torch.equal(k[0][b], one[b][0]) and torch.equal(k[1][b], one[b][1])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
def test_batched_segment_topk(dev, B):
    """Members with different segment populations (dense, few segments,
    every point dropped): the CPU path's top-k per member, moments within
    1e-5 of their scale, each member bitwise its unbatched launch."""
    rng = np.random.default_rng(30 + B)
    P, S, k = 26000, 3249, 512
    vals = rng.normal(0, 30, (B, P, 13)).astype(np.float32)
    vals[..., 0] = (rng.random((B, P)) < 0.3).astype(np.float32)
    ids = np.stack([rng.integers(-1, S + 1, P), rng.integers(0, 40, P),
                    np.full(P, S)][:B])
    values = torch.from_numpy(vals).to(dev)
    ids_t = torch.from_numpy(ids).to(dev)
    out, topi = K2.segment_topk_moments(values, ids_t, S, k)
    plain = K2.topi_moments_plain(values, ids_t, topi, S)
    scale = K2.topi_moments_plain(values.abs(), ids_t, topi, S)
    _, topi_cpu = K2.segment_topk_moments(values.cpu(), ids_t.cpu(), S, k)
    one = [K2.segment_topk_moments(values[b], ids_t[b], S, k) for b in range(B)]
    torch.cuda.synchronize()
    assert torch.equal(topi.cpu(), topi_cpu)
    assert bool(((out - plain).abs() <= 1e-5 * scale).all())
    for b in range(B):
        assert torch.equal(out[b], one[b][0]) and torch.equal(topi[b], one[b][1])


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [-2.0, 0.0])
@pytest.mark.parametrize("B", [1, 3])
def test_batched_ndt_linearize(dev, alpha, B):
    """Per-member mu and NDT scale, members with different valid-pair
    counts: within 1e-4 of each output's scale of the batched plain
    version; each member's slots bitwise its unbatched launch; the wrappers'
    rho, cost and max per member."""
    rng = np.random.default_rng(40 + B)
    W, N = 3, 2048
    sets = [_pairs(rng, W, N, dev) for _ in range(B)]
    for b, (_, packed) in enumerate(sets):  # member b keeps a share of its pairs
        packed[4].mul_((torch.rand(packed[4].shape, device=dev) < (b + 1) / B).float())
    pose4 = torch.stack([s[0] for s in sets])
    packed = tuple(torch.stack([s[1][i] for s in sets]) for i in range(5))
    mu = torch.tensor([1.0, 4.0, 30.0][:B], device=dev)
    ns = torch.tensor([0.1, 0.37, 2.0][:B], device=dev)
    H, g, rho = K3.linearize_cuda(pose4, mu, ns, packed, 1.0, alpha)
    Hp, gp, rhop = K3.linearize_plain(pose4, mu, ns, packed, 1.0, alpha)
    Hs, gs, rhos = K3.sums_to_blocks(
        K3.linearize_terms(pose4, mu, ns, packed, 1.0, alpha).abs().sum(-1))
    c, m = K3.robust_cost_cuda(pose4, mu, packed, 1.0, alpha)
    cp, mp = K3.robust_cost_plain(pose4, mu, packed, 1.0, alpha)
    cs = K3.robust_cost_terms(pose4, mu, packed, 1.0, alpha)[0].abs().sum(-1)
    one = [(K3.linearize_cuda(pose4[b], mu[b], ns[b], sets[b][1], 1.0, alpha),
            K3.robust_cost_cuda(pose4[b], mu[b], sets[b][1], 1.0, alpha))
           for b in range(B)]
    poses = torch.stack([pose4[..., 0], pose4[..., 1],
                         torch.atan2(pose4[..., 3], pose4[..., 2])], -1)
    wrapped = (K3.linearize(poses, mu, ns, packed, 1.0, alpha),
               K3.robust_cost(poses, mu, packed, 1.0, alpha))
    torch.cuda.synchronize()
    assert H.shape == (B, W, 3, 3) and c.shape == (B, W)
    for a, b_, sc in ((H, Hp, Hs), (g, gp, gs), (rho, rhop, rhos), (c, cp, cs)):
        assert bool(((a - b_).abs() <= 1e-4 * sc).all()), (a - b_).abs().max()
    assert bool(((m - mp).abs() <= 1e-5 * mp).all())
    for b, ((Hb, gb, rb), (cb, mb)) in enumerate(one):
        assert torch.equal(H[b], Hb) and torch.equal(g[b], gb) and torch.equal(rho[b], rb)
        assert torch.equal(c[b], cb) and torch.equal(m[b], mb)
    assert wrapped[0][2].shape == wrapped[1][0].shape == wrapped[1][1].shape == (B,)
    assert bool(((wrapped[1][0] - cp.sum(-1)).abs() <= 1e-4 * cs.sum(-1)).all())
    assert bool(((wrapped[1][1] - mp.amax(-1)).abs() <= 1e-5 * mp.amax(-1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 16])
def test_batched_chol_solve_window_systems(dev, B):
    """The batched LM loop's systems (P = 36, up to 16 members): one launch
    bitwise each member's unbatched launch, within the float32 Cholesky
    bound of a float64 solve."""
    rng = np.random.default_rng(50 + B)
    lams = (1e-4, 1e-2, 1.0, 1e2)
    systems = [_system(rng, 36, lams[i % len(lams)]) for i in range(B)]
    A = torch.tensor(np.stack([s[0] for s in systems]), dtype=torch.float32, device=dev)
    b = torch.tensor(np.stack([s[1] for s in systems]), dtype=torch.float32, device=dev)
    x = K4.chol_solve(A, b)
    one = [K4.chol_solve(A[i].contiguous(), b[i].contiguous()) for i in range(B)]
    x64 = torch.linalg.solve(A.double(), b.double())
    kappa = torch.linalg.cond(A.double())
    torch.cuda.synchronize()
    assert all(torch.equal(x[i], one[i]) for i in range(B))
    bound = (4 * 36 * float(np.finfo(np.float32).eps) * kappa
             * x64.abs().amax(-1))[:, None]
    assert bool(((x.double() - x64).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("switches", list(SWITCHES))
def test_batched_odometry_launches_once_per_batched_frame(dev, switches):
    """Three sequences in one batched run launch what one sequence does;
    each member has its single card run's tables and poses within the CPU
    tests' free-running bands (``tests/test_torch_batch.py``)."""
    from randt_slam_torch.config import synthetic_config
    from randt_slam_torch.io import synthetic
    from randt_slam_torch.parallel import batch
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam

    cfg = synthetic_config(**SWITCHES[switches])
    T = 8
    lists = []
    for seed in (3, 4, 5):
        seq = synthetic.generate(seed=seed, n_frames=T, n_azimuths=256, n_bins=256)
        lists.append(slam.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges,
                                             seq.stamps, device=dev))
    frames = F.Frame(*(torch.stack(x) for x in zip(*lists)))
    build.reset_launches()
    _, outs = batch.make_batched_scan(cfg, np.zeros(3), device=dev)(
        batch.init_batched_carry(cfg, 3, device=dev), frames)
    solves = T - 1 if switches == "on" else 0
    m = cfg.matcher
    assert build.LAUNCHES == {
        "row_windows": T, "segment_topk_moments": T, "segment_moments": 0,
        "ndt_linearize": solves * m.gnc_steps * m.lm_max_iterations,
        "ndt_robust_cost": solves * (2 + m.gnc_steps * (1 + m.lm_max_iterations)),
        "chol_solve": solves * m.gnc_steps * m.lm_max_iterations,
        **{k: solves * m.gnc_steps * m.lm_max_iterations for k in LM_STEP},
    }
    for b, fr in enumerate(lists):
        single = slam.run_odometry(cfg, fr, device=dev)
        mine = F.FrameOutput(*(None if x is None else
                               (type(x)(*(y[b] for y in x)) if isinstance(x, tuple)
                                else x[b]) for x in outs))
        tab = slam._unstack_outputs(mine)
        for k in ("node_id", "node_frame", "node_submap", "node_is_root",
                  "edge_begin", "edge_end"):
            assert np.array_equal(tab[k], getattr(single, k)), k
        d = np.abs(mine.odom_pose - single.odom_poses)
        assert d[:, :2].max() <= 0.1 and d[:, 2].max() <= 5e-3, d.max(0)
        print(f"switches {switches}, member {b}: within {d[:, :2].max():.2e} m, "
              f"{d[:, 2].max():.2e} rad of its single card run")


# ---- the indoor shapes (indoor_config(), the IMU on) --------------------------


@pytest.fixture(scope="module")
def indoor_inputs():
    """K1 and K2 inputs of a rendered indoor frame (400 x 400 bins of 3 cm,
    k = 256 kept cells) and the K3a/K3b inputs and K4 systems of frame 10's
    window solve in a 12-frame IMU-on run with the switches on, at the
    reference's weight_imu_bias (the bias column free)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from chip_smoke import (CAPTURE_FRAME, SWITCHES_ON, capture_solve_inputs,
                            frame_inputs, render_indoor)
    from randt_slam_torch.config import indoor_config
    from randt_slam_torch.pipeline import slam

    dev = torch.device("cuda", 0)
    cfg = indoor_config(**SWITCHES_ON)
    scans, az, ranges, stamps, imu, _ = render_indoor(12)
    k1, k2, _ = frame_inputs(cfg, scans[CAPTURE_FRAME], az, ranges, dev)
    frames = slam.frames_from_arrays(scans, az, ranges, stamps, imu_yaw=imu, device=dev)
    _, lin, chol, _ = capture_solve_inputs(cfg, frames, dev, CAPTURE_FRAME)
    return dict(cfg=cfg, k1=k1, k2=k2, lin=lin, chol=chol)


@pytest.mark.cuda
def test_row_windows_and_segment_topk_at_the_indoor_shapes(dev, indoor_inputs):
    img, rr, starts, win = indoor_inputs["k1"]
    assert img.shape == (400, 400 + win - 1)
    k = K1.row_windows(img, rr, starts, win)
    p = K1.row_windows_plain(img, rr, starts, win)
    values, ids, num, kk = indoor_inputs["k2"]
    assert kk == 256
    out, topi = K2.segment_topk_moments(values, ids, num, kk)
    again, topi2 = K2.segment_topk_moments(values, ids, num, kk)
    plain = K2.topi_moments_plain(values, ids, topi, num)
    scale = K2.topi_moments_plain(values.abs(), ids, topi, num)
    _, cpu_topi = K2.segment_topk_moments(values.cpu(), ids.cpu(), num, kk)
    torch.cuda.synchronize()
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(out, again) and torch.equal(topi, topi2)
    assert torch.equal(topi.cpu(), cpu_topi)
    assert bool(((out - plain).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
def test_ndt_linearize_at_the_indoor_shapes(dev, indoor_inputs):
    """Every LM iteration's pair packs of the captured window solve (N = 2 x
    256 x K = 1024 pairs per slot, half the Oxford shape's): within 1e-4 of each output's scale of the plain
    versions, the maximum within 1e-5 of itself, two launches bitwise."""
    m = indoor_inputs["cfg"].matcher
    sc, al = m.loss_function_scale, m.loss_function_convexity
    for poses, mu, ns, packed in indoor_inputs["lin"]:
        # two fixed maps x 256 scan cells x K neighbours per slot
        assert packed[0].shape[-1] == 2 * 256 * m.n_results_nn_lookup
        pose4 = K3.pose_inputs(poses)
        H, g, rho = K3.linearize_cuda(pose4, mu, ns, packed, sc, al)
        H2, g2, rho2 = K3.linearize_cuda(pose4, mu, ns, packed, sc, al)
        Hp, gp, rhop = K3.linearize_plain(pose4, mu, ns, packed, sc, al)
        Hs, gs, rhos = K3.sums_to_blocks(
            K3.linearize_terms(pose4, mu, ns, packed, sc, al).abs().sum(-1))
        c, mx = K3.robust_cost_cuda(pose4, mu, packed, sc, al)
        cp, mp = K3.robust_cost_plain(pose4, mu, packed, sc, al)
        cs = K3.robust_cost_terms(pose4, mu, packed, sc, al)[0].abs().sum(-1)
        torch.cuda.synchronize()
        assert torch.equal(H, H2) and torch.equal(g, g2) and torch.equal(rho, rho2)
        for a, b, s in ((H, Hp, Hs), (g, gp, gs), (rho, rhop, rhos), (c, cp, cs)):
            assert bool(((a - b).abs() <= 1e-4 * s).all()), (a - b).abs().max()
        assert bool(((mx - mp).abs() <= 1e-5 * mp).all())


@pytest.mark.cuda
def test_chol_solve_on_imu_window_systems(dev, indoor_inputs):
    """K4 on the damped, Jacobi-scaled systems of the captured IMU-on solve,
    whose bias columns are free at weight_imu_bias 750000.1 (a bias-walk
    curvature of 5.6e11 beside pose curvatures near 1 before the scaling):
    within 4 P eps kappa |x| of the plain version and of a float64 solve,
    the residual within 4 P eps |A| |x|, batch and one-by-one bitwise."""
    from randt_slam_torch.registration import residuals as R

    chol = indoor_inputs["chol"]
    A = torch.stack([a for a, _ in chol]).contiguous()
    b = torch.stack([x for _, x in chol]).contiguous()
    P = A.shape[-1]
    bias = [9 * j + R.BIAS for j in range(P // 9)]
    # a free bias column couples to its neighbours' (the walk), a frozen one
    # is an identity row
    assert any(float(A[0, c].abs().sum()) > 1.0 for c in bias)
    x = K4.chol_solve_cuda(A, b)
    one = torch.stack([K4.chol_solve_cuda(A[i].contiguous(), b[i].contiguous())
                       for i in range(A.shape[0])])
    xp = K4.chol_solve_plain(A, b)
    x64 = torch.linalg.solve(A.double(), b.double())
    kappa = torch.linalg.cond(A.double())
    torch.cuda.synchronize()
    assert torch.equal(x, one)
    eps = float(np.finfo(np.float32).eps)
    bound = (4 * P * eps * kappa * x64.abs().amax(-1))[:, None]
    assert bool(((x.double() - x64).abs() <= bound).all())
    assert bool(((x - xp).double().abs() <= bound).all())
    res = (A.double() @ x.double()[..., None])[..., 0] - b.double()
    res_bound = (4 * P * eps * A.abs().amax((-2, -1)) * x.abs().amax(-1)).double()
    assert bool((res.abs().amax(-1) <= res_bound).all())
    print(f"K4 on {A.shape[0]} IMU-on window systems: kappa "
          f"{float(kappa.min()):.3g}..{float(kappa.max()):.3g}, within "
          f"{float(((x.double() - x64).abs() / bound).max()):.3f} of the bound")


# ---- the LM solve's CUDA graphs (registration/solve_graph) ---------------------

GRAPH_COUNTERS = ("lm_graph.eager", "lm_graph.capture", "lm_graph.replay")
GRAPH_MATCHER = {"off": {}, "on": dict(use_pallas_linearize=True, use_pallas_chol=True),
                 "imu": dict(use_imu=True, use_pallas_linearize=True,
                             use_pallas_chol=True)}


def graph_config(name):
    """:func:`tiny_config` (a submap every 6 frames) with the matcher
    switches of ``GRAPH_MATCHER[name]``."""
    cfg = tiny_config()
    kw = GRAPH_MATCHER[name]
    if kw.get("use_imu"):
        cfg = dataclasses.replace(cfg, use_imu=True)
    return dataclasses.replace(cfg, matcher=dataclasses.replace(cfg.matcher, **kw))


def graph_frames(seed, n_frames, device):
    """A straight synthetic drive at :func:`tiny_config`'s sizes, with its
    gyro readings."""
    from randt_slam_torch.io import synthetic
    from randt_slam_torch.pipeline import slam

    seq = synthetic.generate(seed=seed, n_frames=n_frames, n_azimuths=64, n_bins=128,
                             max_range=40.0, speed=3.0, dt=0.25, n_walls=40)
    return slam.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps,
                                   imu_yaw=seq.imu_yaw, device=device)


def graph_counts():
    from randt_slam_torch.utils import profiling

    return {k: profiling.counter(k) for k in GRAPH_COUNTERS}


def _graph_caches():
    """A graph cache class that keeps each call's key, inputs and answer,
    and the list of the caches it made."""
    from randt_slam_torch.registration import solve_graph

    made = []

    class Recording(solve_graph.SolveGraphs):
        def __init__(self):
            super().__init__()
            self.calls = []
            made.append(self)

        def __call__(self, part, fn, args):
            out = super().__call__(part, fn, args)
            self.calls.append((solve_graph.key(part, args), fn,
                               tuple(a.clone() for a in args),
                               type(out)(*(o.clone() for o in out))))
            return out

    return Recording, made


class _EagerSolves:
    """A graph cache that solves every window eagerly."""

    def __call__(self, part, fn, args):
        return fn(*args)


def _batched_chunks(cfg, frames, dev, chunk=8):
    """Carries at every frame boundary and each chunk's outputs."""
    from randt_slam_torch.parallel import batch
    from randt_slam_torch.pipeline import frontend as F

    B, T = frames.stamp.shape[:2]
    scan = batch.make_batched_scan(cfg, np.zeros(3), device=dev)
    carries = batch.init_batched_carry(cfg, B, device=dev)
    snaps, outs = [], []
    for lo in range(0, T, chunk):
        fr = F.Frame(*(x[:, lo:lo + chunk] for x in frames))
        carries, o = scan(carries, fr, on_frame=lambda t, c: snaps.append(c))
        outs.append(o)
    snaps.append(carries)
    return snaps, outs


def _tree_leaves(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _tree_leaves(v)
    else:
        yield x


def _bitwise(a, b):
    for x, y in zip(_tree_leaves(a), _tree_leaves(b), strict=True):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y)
        else:
            assert x == y


def _graphed_then_eager(monkeypatch, run):
    """``run()``, which makes its own graph cache, then ``run()`` with every
    solve eager: (graph run, its cache, the graph counters' change, its
    launches; eager run, its launches)."""
    from randt_slam_torch.registration import solve_graph

    recording, made = _graph_caches()
    monkeypatch.setattr(solve_graph, "SolveGraphs", recording)
    build.reset_launches()
    before = graph_counts()
    graphed = run()
    torch.cuda.synchronize()
    counted = {k: v - before[k] for k, v in graph_counts().items()}
    launches = dict(build.LAUNCHES)
    assert len(made) == 1
    monkeypatch.setattr(solve_graph, "SolveGraphs", _EagerSolves)
    build.reset_launches()
    eager = run()
    return graphed, made[0], counted, launches, eager, dict(build.LAUNCHES)


def _check_graph_cache(rec, counted):
    keys = [k for k, *_ in rec.calls]
    first = {}
    for i, k in enumerate(keys):
        first.setdefault(k, i)
    # one capture per key, after its first solve ran eagerly; a replay for
    # every later solve
    assert len(rec.graphs) == len(first)
    assert counted == {"lm_graph.eager": len(first), "lm_graph.capture": len(first),
                       "lm_graph.replay": len(keys) - len(first)}
    assert sorted(k[1] for k in first) == [2, 3, 4]
    # each replay answers, bitwise, as the eager solve does on that frame's
    # own inputs; frames of one key answer differently (no stale buffer)
    answers = {}
    for i, (k, fn, args, out) in enumerate(rec.calls):
        if i != first[k]:
            _bitwise(out, fn(*args))
            answers.setdefault(k, set()).add(out.params.cpu().numpy().tobytes())
    assert max(len(v) for v in answers.values()) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRAPH_MATCHER))
def test_batched_graph_path_is_the_eager_path(dev, name, monkeypatch):
    """26 frames of three drives in chunks of 8 (five submaps): poses,
    records and the carries at every frame boundary bitwise the eager run's;
    the outputs held over a chunk are the eager run's, so no replay
    overwrote them; the kernels count the eager run's launches."""
    from randt_slam_torch.pipeline import frontend as F

    cfg = graph_config(name)
    T = 26
    frames = F.Frame(*(torch.stack(x) for x in zip(
        *[graph_frames(s, T, dev) for s in (3, 4, 5)])))
    (g_snaps, g_outs), rec, counted, launches, (e_snaps, e_outs), e_launches = \
        _graphed_then_eager(monkeypatch, lambda: _batched_chunks(cfg, frames, dev))
    assert sum(int(np.sum(o.submap_finished)) for o in e_outs) >= 3 * 3
    _bitwise(g_outs, e_outs)
    assert len(g_snaps) == len(e_snaps) == T + 1
    for a, b in zip(g_snaps, e_snaps):
        _bitwise(a, b)
    _check_graph_cache(rec, counted)
    assert launches == e_launches
    if GRAPH_MATCHER[name]:
        m = cfg.matcher
        assert launches["chol_solve"] == len(rec.calls) * m.gnc_steps * m.lm_max_iterations
        assert all(launches[k] == launches["ndt_linearize"] == launches["chol_solve"]
                   for k in LM_STEP)
    else:
        assert not any(launches[k] for k in LM_STEP)


@pytest.mark.cuda
def test_single_sequence_graph_path_is_the_eager_path(dev, monkeypatch):
    from randt_slam_torch.pipeline import slam

    cfg = graph_config("on")
    fr = graph_frames(3, 26, dev)
    graphed, rec, counted, launches, eager, e_launches = _graphed_then_eager(
        monkeypatch, lambda: slam.run_odometry(cfg, fr, device=dev))
    for f in dataclasses.fields(eager):
        _bitwise(getattr(graphed, f.name), getattr(eager, f.name))
    _check_graph_cache(rec, counted)
    assert launches == e_launches


# ---- one LM iteration's own kernels (ops/lm_step) -----------------------------


def _lm_inputs(rng, B, n_exist, dev):
    """A random LM iteration of ``B`` windows at ``oxford_config()``'s
    matcher (W = 3): the window's aux context, K3a's blocks, the states and
    the damping.  States about a 4 m/s drive, headings anywhere, dt on both
    sides of the 0.2 s clamp."""
    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.registration import matcher
    from randt_slam_torch.registration import window as Wn

    mcfg = oxford_config().matcher
    W = mcfg.smoothing_steps

    def f(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    aux = Wn.window_aux(mcfg, (B,), *matcher._window_masks(mcfg, W, n_exist),
                        f(rng.uniform(0.1, 0.35, (B, W))), f(rng.normal(0, 0.05, (B, W))),
                        kernels=True)
    s = np.zeros((B, W + 1, 9))
    s[..., :2] = rng.normal(0, 50, (B, W + 1, 2))
    s[..., 2] = rng.uniform(-np.pi, np.pi, (B, W + 1))
    s[..., 3] = rng.normal(4.0, 1.0, (B, W + 1))
    s[..., 4:6] = rng.normal(0, 0.3, (B, W + 1, 2))
    s[..., 6:8] = rng.normal(0, 0.1, (B, W + 1, 2))
    s[..., 8] = rng.normal(0, 1e-3, (B, W + 1))
    G = rng.normal(0, 3.0, (B, W, 3, 3))
    Hj = f(G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(3))
    return (aux, Hj, f(rng.normal(0, 3.0, (B, W, 3))), f(s.reshape(B, -1)),
            f(10.0 ** rng.uniform(-6, 8.5, B)))


@pytest.mark.cuda
@pytest.mark.parametrize("n_exist", [1, 2, 3, 4])
@pytest.mark.parametrize("B", [1, 8, 512])
def test_lm_step_kernels_match_plain(dev, B, n_exist):
    """The three kernels on random iterations at the Oxford configuration
    (W = 3, P = 36), every number of existing states: each against its plain
    version on the same inputs (``chip_smoke``'s ``check_lm_assemble``,
    ``check_lm_trial`` and ``check_lm_accept``).  The acceptance's inputs
    are set so that every flag is decided: trial costs 0.5 to 2 times the
    current cost, the function tolerance at 1e-2 (between the two costs'
    gaps), the step tolerance between the two middle members' |delta| / |p|,
    damping up to 3e8 (the >= 1e7 exit), a third of the members done
    before."""
    from chip_smoke import check_lm_accept, check_lm_assemble, check_lm_trial
    from randt_slam_torch.registration import window as Wn

    rng = np.random.default_rng(1000 * B + n_exist)
    aux, Hj, gj, p, lam = _lm_inputs(rng, B, n_exist, dev)
    (A, rhs, ds), _ = check_lm_assemble(aux, Hj, gj, p, lam)
    x = K4.chol_solve_cuda(A, rhs)
    (trial, _, dnorm, pnorm), _ = check_lm_trial(aux, p, x, ds)
    rho = torch.tensor(rng.uniform(0, 50, (B, aux.W)), dtype=torch.float32, device=dev)
    ns = torch.tensor(rng.uniform(1e-3, 0.1, B), dtype=torch.float32, device=dev)
    c_new = 0.5 * (ns * rho.sum(-1) + Wn.aux_cost(aux, trial))
    factor = torch.tensor(rng.choice([0.5, 0.995, 1.005, 1.05, 2.0], B),
                          dtype=torch.float32, device=dev)
    # the step tolerance halfway (in log) between the two middle members'
    # |delta| / |p|, so that no member sits on it
    ratio = torch.sort(dnorm / pnorm).values
    tol = float(torch.sqrt(ratio[(B - 1) // 2] * ratio[B // 2]) * (0.5 if B == 1 else 1.0))
    done = torch.tensor(rng.random(B) < 1 / 3, device=dev)
    live = torch.tensor(rng.integers(0, 50, B), dtype=torch.int32, device=dev)
    decided, _ = check_lm_accept(aux, rho, trial, dnorm, pnorm, ns, tol, 1e-2, p,
                                 c_new * factor, lam, done, live)
    assert decided >= (0.9 if B > 1 else 0.0), decided


@pytest.fixture(scope="module")
def indoor_lm_steps():
    """Every call of the three kernels' wrappers in frame CAPTURE_FRAME's
    window solve of a 12-frame IMU-on run at ``indoor_config()`` with the
    switches on (unbatched, the bias columns free at the reference's
    weight_imu_bias), that solve eager (``chip_smoke.spying_solves``): (LM
    iterations a solve, [(wrapper name, the solve's WindowAux, the other
    inputs)] in call order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from chip_smoke import CAPTURE_FRAME, SWITCHES_ON, capture_solve_inputs, render_indoor
    from randt_slam_torch.config import indoor_config
    from randt_slam_torch.pipeline import slam

    dev = torch.device("cuda", 0)
    scans, az, ranges, stamps, imu, _ = render_indoor(12)
    frames = slam.frames_from_arrays(scans, az, ranges, stamps, imu_yaw=imu, device=dev)
    cfg = indoor_config(**SWITCHES_ON)
    _, _, _, calls = capture_solve_inputs(cfg, frames, dev, CAPTURE_FRAME)
    return cfg.matcher.gnc_steps * cfg.matcher.lm_max_iterations, calls


@pytest.mark.cuda
def test_lm_step_kernels_at_the_indoor_shapes(dev, indoor_lm_steps):
    """Each LM iteration of an IMU-on window solve (bias rows active,
    residuals up to w_bias = 750000.1 times the walk): the three kernels
    against their plain versions on the iteration's own inputs, as in
    :func:`test_lm_step_kernels_match_plain`; the acceptance's flags exact
    wherever decided.  The late iterations of a converging solve take
    trial costs within 1e-5 of the current one, which no margin decides, so
    a quarter of the iterations is asked to be decided (the early ones)."""
    from chip_smoke import check_lm_accept, check_lm_assemble, check_lm_trial

    iters, calls = indoor_lm_steps
    assert [n for n, _, _ in calls] == ["assemble_cuda", "trial_cuda", "accept_cuda"] * iters
    checks = {"assemble_cuda": check_lm_assemble, "trial_cuda": check_lm_trial,
              "accept_cuda": check_lm_accept}
    decided = []
    for name, aux, a in calls:
        assert aux.lead == () and bool(aux.kern.valid[-2:].bool().all())
        share, _ = checks[name](aux, *a)
        if name == "accept_cuda":
            decided.append(share)
    assert np.mean(decided) >= 0.25, decided


def _cpu_window_solves(name, B):
    """The window solves of a CPU run on :func:`graph_frames` at
    :func:`graph_config`'s switches ``name``: B = None, one drive through
    ``run_odometry`` (every solve); else B drives through the batched scan
    (its solves with 4 existing states).  [(mcfg, n_exist, args)]."""
    from randt_slam_torch.parallel import batch
    from randt_slam_torch.pipeline import frontend as F
    from randt_slam_torch.pipeline import slam
    from randt_slam_torch.registration import matcher

    cfg = graph_config(name)
    seen = []
    solve = matcher._window_solve

    def spy(mcfg, n_exist, *args):
        seen.append((mcfg, n_exist, tuple(a.clone() for a in args)))
        return solve(mcfg, n_exist, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(matcher, "_window_solve", spy)
        if B is None:
            slam.run_odometry(cfg, graph_frames(3, 8, "cpu"), device="cpu")
        else:
            frames = F.Frame(*(torch.stack(x) for x in zip(
                *[graph_frames(s, 6, "cpu") for s in range(3, 3 + B)])))
            batch.make_batched_scan(cfg, np.zeros(3), device="cpu")(
                batch.init_batched_carry(cfg, B, device="cpu"), frames)
    return seen if B is None else [s for s in seen if s[1] == 4]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["on", "imu"])
def test_window_solve_through_the_kernels_against_the_cpu(dev, name):
    """Every window solve of an 8-frame drive (2, 3 and 4 existing states),
    switches on with and without the IMU: the card's solve through the six
    kernels against the CPU's tensor ops on the same inputs, within
    ``tests/test_torch_registration.py``'s 1e-4 (m, m/s) and 1e-5 (rad,
    rad/s), the costs within 1e-4 of each other, the same residual count;
    the kernels launched once each per LM iteration.

    One exception, tied to its cause, as in that test: the card's float32
    sums part from the CPU's, and on an IMU-on window (the bias walk
    weighted 750000.1) the two fixed-trip solves drift apart by one LM
    step's size (1.4e-3 m on an H100).  A solve over the tolerance must
    show that the three kernels did not part it: the card's own tensor ops
    (the iteration without them, K3a/K3b/K4 kept) land within 1e-5 (m,
    m/s) and 1e-6 (rad, rad/s) of the kernels' answer and are over the
    tolerance themselves, and both stay within that test's one-step band,
    5e-3 m / 1e-4 rad, of the CPU's."""
    from randt_slam_torch.registration import matcher
    from randt_slam_torch.registration import residuals as R
    from randt_slam_torch.registration import solver

    ang = [R.TH, R.OM]
    gnc_solve = solver.gnc_solve

    def tensor_ops(*a, loop, **k):  # the iteration without the three kernels
        assert loop is not None
        return gnc_solve(*a, loop=None, **k)

    lin = [c for c in range(9) if c not in ang]

    def gap(a, b):
        d = np.abs(a.params.cpu().numpy() - b.params.cpu().numpy()).reshape(-1, 9)
        return d[:, lin].max(), d[:, ang].max()

    worst, drifted = np.zeros(2), 0
    for mcfg, n_exist, args in _cpu_window_solves(name, None):
        cpu = matcher._window_solve(mcfg, n_exist, *args)
        build.reset_launches()
        card_args = tuple(a.to(dev) for a in args)
        card = matcher._window_solve(mcfg, n_exist, *card_args)
        torch.cuda.synchronize()
        iters = mcfg.gnc_steps * mcfg.lm_max_iterations
        assert all(build.LAUNCHES[k] == iters for k in LM_STEP + ("ndt_linearize",))
        d = gap(card, cpu)
        worst = np.maximum(worst, d)
        if d[0] > 1e-4 or d[1] > 1e-5:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(solver, "gnc_solve", tensor_ops)
                ops = matcher._window_solve(mcfg, n_exist, *card_args)
            e, o = gap(card, ops), gap(ops, cpu)
            assert e[0] <= 1e-5 and e[1] <= 1e-6, (n_exist, e)
            assert o[0] > 1e-4 or o[1] > 1e-5, (n_exist, o)
            assert d[0] <= 5e-3 and d[1] <= 1e-4, (n_exist, d)
            drifted += 1
        assert int(card.n_ndt_valid) == int(cpu.n_ndt_valid)
        np.testing.assert_allclose(float(card.cost), float(cpu.cost), rtol=1e-4)
    print(f"switches {name}: the card's window solves within {worst[0]:.2e} (m, m/s) "
          f"and {worst[1]:.2e} (rad, rad/s) of the CPU's; {drifted} over the "
          f"tolerance, as the card's tensor ops are")


@pytest.mark.cuda
def test_window_solve_member_of_a_batch_is_its_own_solve(dev):
    """A batch of 8 windows (8 drives, 4 existing states) solved through the
    kernels on the card: each member's states and cost bitwise its solve
    as a batch of one."""
    from randt_slam_torch.registration import matcher

    solves = _cpu_window_solves("on", 8)
    assert solves
    for mcfg, n_exist, args in solves[-2:]:
        a = tuple(x.to(dev) for x in args)
        whole = matcher._window_solve(mcfg, n_exist, *a)
        for b in range(8):
            one = matcher._window_solve(mcfg, n_exist, *(x[b:b + 1] for x in a))
            assert torch.equal(whole.params[b:b + 1], one.params), b
            assert torch.equal(whole.cost[b:b + 1], one.cost), b


@pytest.mark.cuda
def test_lm_step_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.ops import lm_step as L
    from randt_slam_torch.registration import matcher
    from randt_slam_torch.registration import window as Wn

    rng = np.random.default_rng(7)
    aux, Hj, gj, p, lam = _lm_inputs(rng, 4, 4, dev)
    win = aux.kern
    x, ds = torch.ones_like(p), torch.ones_like(p)
    with pytest.raises(TypeError):
        L.assemble_cuda(win, Hj.double(), gj, p, lam)
    with pytest.raises(ValueError):
        L.assemble_cuda(win, Hj, gj.cpu(), p, lam)
    with pytest.raises(ValueError):
        L.assemble_cuda(win, Hj[:, :2], gj, p, lam)
    with pytest.raises(ValueError):
        L.trial_cuda(win, p, x.t().contiguous().t(), ds)
    with pytest.raises(ValueError):
        L.trial_cuda(win, p[..., :-9], x[..., :-9], ds[..., :-9])
    with pytest.raises(ValueError):
        L.trial_cuda(win, p[None], x[None], ds[None])
    c, done = torch.ones(4, device=dev), torch.zeros(4, dtype=torch.bool, device=dev)
    rho, n = torch.ones(4, aux.W, device=dev), torch.ones(4, device=dev)
    with pytest.raises(TypeError):
        L.accept_cuda(win, rho, p, n, n, n, 1e-7, 1e-6, p, c, lam, done.float())
    with pytest.raises(TypeError):
        L.accept_cuda(win, rho, p, n, n, n, 1e-7, 1e-6, p, c, lam, done,
                      torch.zeros(4, dtype=torch.int64, device=dev))
    # W = 7: P = 72, past K4's 64
    mcfg = dataclasses.replace(oxford_config().matcher, smoothing_steps=7)
    wide = Wn.window_aux(mcfg, (4,), *matcher._window_masks(mcfg, 7, 8),
                         torch.ones(4, 7, device=dev), torch.zeros(4, 7, device=dev),
                         kernels=True)
    with pytest.raises(ValueError):
        L.trial_cuda(wide.kern, torch.zeros(4, 72, device=dev), torch.zeros(4, 72, device=dev),
                     torch.zeros(4, 72, device=dev))
    with pytest.raises(ValueError):
        K4.chol_solve_cuda(torch.eye(72, device=dev), torch.ones(72, device=dev))
