"""Batched multi-sequence odometry: the port's ``parallel/batch`` against the
JAX package's ``make_batched_scan`` and against its own single-sequence runs.

B = 3 synthetic sequences of one length (seeds 3, 4 and 5; seed 3's is the
sequence of ``tests/test_torch_odometry.py``), 26 frames: the first submap
completes at frame 19 and keyframes leave the window in both submaps.

What must hold, and why:

* against the JAX package's own batch (``jax.vmap`` of its front end under
  ``lax.scan``, on its CPU path): every member's node and edge tables,
  rejections and submap completions identical -- the cadence decides them;
  every solved frame, stepped by both packages' batched steps from the
  carry the port brought to it without the LM exit tests
  (``lm_function_tolerance = lm_tolerance = 0``), within the one-step
  tolerance of ``test_torch_odometry.py`` (1e-4 m, 1e-5 rad), but for at
  most 8 of the 75 member-frames, each within 1e-2 m / 1e-4 rad; and the
  free-running poses within 1e-2 m of the JAX batch's ATE, 5e-3 rad on
  headings and 0.1 m on positions, with either switch setting.

  Why those bands.  ``test_torch_odometry.py``'s switches-off free-running
  bands (ATE within 5e-3 m, headings within 1e-3 rad, at most four frames
  over 1e-2 m) are tuned to seed 3's sequence; on seeds 4 and 5 the port's
  single step lands across an ulp-decided LM step from the JAX package's
  on a few frames, from the same carry and with the exit tests off
  (measured: 6 of 75 member-frames beyond 1e-4 m / 1e-5 rad switches off,
  5 switches on; the largest 5.96e-3 m, 5.46e-5 rad), and the free run
  carries such steps on (measured: 6.4e-2 m, 3.35e-3 rad, ATE gap
  4.3e-3 m), as it carries the reference's one-ulp azimuth change in
  ``test_reference_sensitivity``.  These steps are the single-sequence
  port's, not the batch's: the port's members are its single runs bit for
  bit (below), and the JAX package's own batched step departs from its
  own single step by as much on one member-frame (4.10e-3 m, switches-on
  run, member 0, frame 20);
* against the port's single-sequence ``run_odometry`` of each member's
  frames: tables identical and poses bit for bit, with the kernel switches
  off and on.  On the CPU every batched operation gives each member the
  bits of its unbatched call (the plain kernel versions included), so any
  difference is a member reading another's data: a reduction over the
  whole batch (the NDT scale, the robust cost, the GNC mu) would move every
  pose;
* members that differ: member 1 runs member 0's frames three frames late,
  each against its own single run, bit for bit;
* the batched carry is ``init_carry`` broadcast, and the plain versions of
  K1, K2, K3a/K3b and K4 with a batch equal a loop of their unbatched calls
  on the same data, bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.io import formats, synthetic
from randt_slam_tpu.ndt import cells as jC, grid as jG
from randt_slam_tpu.parallel import batch as jB
from randt_slam_tpu.pipeline import frontend as jF, slam as jS
from randt_slam_torch import state
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.ops import ndt_linearize as K3
from randt_slam_torch.ops import segment_moments as K2
from randt_slam_torch.ops import small_chol as K4
from randt_slam_torch.ops import window_slice as K1
from randt_slam_torch.parallel import batch as tB
from randt_slam_torch.pipeline import frontend as tF, slam as tS
from tests.torch_threads import one_thread  # noqa: F401

SEEDS = (3, 4, 5)
T = 26
DELAY = 3   # member 1's lag in the members-differ case
TABLES = ("node_id", "node_frame", "node_submap", "node_is_root",
          "edge_begin", "edge_end")
SWITCHES = {"off": {}, "on": {"matcher.use_pallas_linearize": True,
                              "matcher.use_pallas_chol": True}}
# against the JAX batch (module docstring): free-running ATE gap, heading
# and position bands; the one-step tolerance, the member-frames allowed
# beyond it and their caps
FREE_ATE, FREE_ANG, FREE_POS = 1e-2, 5e-3, 1e-1
STEP_POS_TOL, STEP_ANG_TOL = 1e-4, 1e-5
MAX_STEPS, STEP_CAP = 8, (1e-2, 1e-4)


@pytest.fixture(scope="module")
def seqs():
    # 46 frames rendered, as test_torch_odometry renders seed 3, the first
    # T + DELAY used
    return [synthetic.generate(seed=s, n_frames=46, n_azimuths=256, n_bins=256,
                               speed=4.0, dt=0.25) for s in SEEDS]


def _frames(seq, start=0, n=T):
    return tS.frames_from_arrays(seq.intensity[start:start + n], seq.azimuths,
                                 seq.ranges, seq.stamps[start:start + n],
                                 device="cpu")


def _stack(frame_list):
    return tF.Frame(*(torch.stack(x) for x in zip(*frame_list)))


def _member(outs, b):
    """Member ``b`` of a (B, T, ...) FrameOutput tree (either package's)."""
    return jax.tree.map(lambda x: np.asarray(x)[b], outs)


@pytest.fixture(scope="module")
def single(seqs):
    """``single(label, b, start=0)``: the port's single-sequence run of
    sequence ``b``'s T frames from ``start`` (kept: the members-differ case
    reuses member 0's)."""
    runs = {}

    def run(label, b, start=0):
        if (label, b, start) not in runs:
            runs[label, b, start] = tS.run_odometry(
                t_cfg(**SWITCHES[label]), _frames(seqs[b], start), device="cpu")
        return runs[label, b, start]
    return run


@pytest.fixture(scope="module")
def jax_batch(seqs):
    fr = [jS.frames_from_arrays(s.intensity[:T], s.azimuths, s.ranges,
                                s.stamps[:T]) for s in seqs]
    frames = jax.tree.map(lambda *x: jnp.stack(x), *fr)
    cfg = j_cfg()
    _, outs = jB.make_batched_scan(cfg, jnp.zeros(3))(
        jB.init_batched_carry(cfg, len(seqs)), frames)
    return jax.tree.map(np.asarray, outs)


@pytest.fixture(scope="module", params=list(SWITCHES))
def torch_batch(seqs, request):
    """Switch setting, config, the port's batched outputs and a copy of the
    batched carry entering every frame."""
    cfg = t_cfg(**SWITCHES[request.param])
    frames = _stack([_frames(s) for s in seqs])
    kept = []
    carries, outs = tB.make_batched_scan(cfg, np.zeros(3), device="cpu")(
        tB.init_batched_carry(cfg, len(seqs), device="cpu"), frames,
        on_frame=lambda t, c: kept.append(state.carry_to_numpy(c)))
    assert carries.cur_pose.shape == (len(seqs), 3)
    return request.param, cfg, outs, kept, frames


def test_output_shapes(torch_batch, jax_batch):
    """(B, T, ...) leaves, no descriptor, as the JAX package's batch."""
    outs = torch_batch[2]
    assert outs.sc_desc is None and jax_batch.sc_desc is None
    for name in ("odom_pose", "finished_origin", "rejected", "n_residuals",
                 "submap_finished", "scan_saturated"):
        assert getattr(outs, name).shape == getattr(jax_batch, name).shape, name
    for rec in ("nodes", "edges"):
        for a, b in zip(getattr(outs, rec), getattr(jax_batch, rec)):
            assert a.shape == b.shape, rec


def test_members_match_jax_batch(seqs, torch_batch, jax_batch):
    outs = torch_batch[2]
    for b, seq in enumerate(seqs):
        mine, ref = _member(outs, b), _member(jax_batch, b)
        t_tab, j_tab = tS._unstack_outputs(mine), tS._unstack_outputs(ref)
        for k in TABLES:
            np.testing.assert_array_equal(t_tab[k], j_tab[k], err_msg=f"{b} {k}")
        np.testing.assert_array_equal(mine.rejected, ref.rejected)
        np.testing.assert_array_equal(mine.submap_finished, ref.submap_finished)
        gt = seq.gt_poses[:T]
        ate_t, ate_j = formats.ate(mine.odom_pose, gt), formats.ate(ref.odom_pose, gt)
        assert abs(ate_t - ate_j) < FREE_ATE, (b, ate_t, ate_j)
        d = np.abs(mine.odom_pose - ref.odom_pose)
        assert d[:, 2].max() <= FREE_ANG, (b, d[:, 2].max())
        assert d[:, :2].max() <= FREE_POS, (b, d[:, :2].max())


def _assert_member_is_single(outs, b, single):
    mine = _member(outs, b)
    tab = tS._unstack_outputs(mine)
    for k in TABLES:
        np.testing.assert_array_equal(tab[k], getattr(single, k), err_msg=k)
    np.testing.assert_array_equal(mine.odom_pose, single.odom_poses)
    np.testing.assert_array_equal(tab["node_pose"], single.node_pose)
    np.testing.assert_array_equal(tab["edge_trans"], single.edge_trans)
    np.testing.assert_array_equal(mine.rejected, single.rejected_frames)


def test_members_match_single_runs(seqs, torch_batch, single):
    label, _, outs = torch_batch[:3]
    for b in range(len(seqs)):
        _assert_member_is_single(outs, b, single(label, b))


def _jax_batched_carry(c, batch):
    """The port's batched carry (numpy leaves) as the JAX package's, with
    the shared cadence counters spread over the batch as ``vmap`` takes
    them."""
    def conv(name, v):
        if name in ("kq_stats", "store_cells", "stats"):
            return jC.CellStats(**{k: jnp.asarray(x) for k, x in v._asdict().items()})
        if name in ("submap", "prev_submap"):
            return jG.SparseGrid(**{k: conv(k, x) for k, x in v._asdict().items()})
        if name in tF.HOST_FIELDS:
            return jnp.full((batch,), v)
        return jnp.asarray(v)
    return jF.FrontendCarry(**{k: conv(k, v) for k, v in c._asdict().items()})


def _no_exit_test(cfg):
    return dataclasses.replace(cfg, matcher=dataclasses.replace(
        cfg.matcher, lm_function_tolerance=0.0, lm_tolerance=0.0))


def test_one_step_against_jax_batch_step(seqs, torch_batch):
    """Every solved frame, stepped by both packages' batched steps from the
    batched carry the port brought to it, with the function-tolerance exit
    taken out (module docstring)."""
    _, cfg, _, kept, frames = torch_batch
    B_ = len(seqs)
    jframes = jax.tree.map(
        lambda *x: jnp.stack(x),
        *[jS.frames_from_arrays(s.intensity[:T], s.azimuths, s.ranges, s.stamps[:T])
          for s in seqs])
    step = jax.jit(jax.vmap(functools.partial(
        jF.frontend_step, _no_exit_test(j_cfg()), sensor_to_base=jnp.zeros(3),
        with_descriptor=False)))
    beyond = {}
    for t in range(1, T):
        oj = np.asarray(step(_jax_batched_carry(kept[t], B_),
                             jax.tree.map(lambda a: a[:, t], jframes))[1].odom_pose)
        ot = tF.frontend_step(_no_exit_test(cfg), state.carry_from_numpy(kept[t], "cpu"),
                              tF.Frame(*(x[:, t] for x in frames)), torch.zeros(3),
                              with_descriptor=False)[1].odom_pose.numpy()
        for b in range(B_):
            dp, da = np.abs(ot[b, :2] - oj[b, :2]).max(), abs(ot[b, 2] - oj[b, 2])
            if dp > STEP_POS_TOL or da > STEP_ANG_TOL:
                beyond[(b, t)] = (float(dp), float(da))
    assert len(beyond) <= MAX_STEPS, beyond
    assert all(dp <= STEP_CAP[0] and da <= STEP_CAP[1]
               for dp, da in beyond.values()), beyond


@pytest.mark.parametrize("label", list(SWITCHES))
def test_members_that_differ(seqs, single, label):
    """Member 1 is member 0's sequence three frames late: each member against
    its own single run."""
    cfg = t_cfg(**SWITCHES[label])
    lists = [_frames(seqs[0]), _frames(seqs[0], start=DELAY)]
    _, outs = tB.make_batched_scan(cfg, np.zeros(3), device="cpu")(
        tB.init_batched_carry(cfg, 2, device="cpu"), _stack(lists))
    _assert_member_is_single(outs, 0, single(label, 0))
    _assert_member_is_single(outs, 1, single(label, 0, DELAY))


def test_init_batched_carry_is_init_carry_broadcast():
    cfg = t_cfg()
    one = tF.init_carry(cfg, device="cpu")
    many = tB.init_batched_carry(cfg, 3, device="cpu")
    flat_one, flat_many = jax.tree.leaves(one), jax.tree.leaves(many)
    assert len(flat_one) == len(flat_many)
    for a, b in zip(flat_one, flat_many):
        if isinstance(a, torch.Tensor):
            assert b.shape == (3,) + a.shape and b.is_contiguous()
            assert all(torch.equal(b[i], a) for i in range(3))
        else:
            assert a == b
    # every member owns its memory (the store is written in place)
    many.store_cells.n[0].fill_(1.0)
    assert float(many.store_cells.n[1].abs().sum()) == 0.0


def test_batched_step_takes_no_descriptor(seqs):
    cfg = t_cfg()
    frames = _stack([_frames(s, n=1) for s in seqs[:2]])
    with pytest.raises(ValueError):
        tF.frontend_step(cfg, tB.init_batched_carry(cfg, 2, device="cpu"),
                         tF.Frame(*(x[:, 0] for x in frames)), torch.zeros(3))


# ---- the kernels' plain versions: a batch against a loop of single calls ---

B = 3


def test_k1_plain_batched_equals_loop():
    rng = np.random.default_rng(0)
    A, R, win = 40, 300, 65
    img = torch.from_numpy(rng.random((B, A, R), dtype=np.float32))
    rng_row = torch.from_numpy(rng.random((B, R), dtype=np.float32))
    starts = torch.from_numpy(rng.integers(-8, R - win + 8, (B, A)))
    out = K1.row_windows(img, rng_row, starts, win)
    for b in range(B):
        one = K1.row_windows(img[b], rng_row[b], starts[b], win)
        assert torch.equal(out[0][b], one[0]) and torch.equal(out[1][b], one[1])


def test_k2_plain_batched_equals_loop():
    """Members with different populations: counts, the top-k order (lower
    id first among equal counts) and sums are each member's own."""
    rng = np.random.default_rng(1)
    P, S, k = 3000, 400, 64
    vals = rng.normal(0, 30, (B, P, 13)).astype(np.float32)
    vals[..., 0] = (rng.random((B, P)) < 0.8).astype(np.float32)
    ids = np.stack([rng.integers(-1, S + 1, P), rng.integers(0, S // 8, P),
                    np.full(P, S)])  # member 2: every point dropped
    values, ids = torch.from_numpy(vals), torch.from_numpy(ids)
    out, topi = K2.segment_topk_moments(values, ids, S, k)
    assert out.shape == (B, k, 13) and topi.shape == (B, k)
    for b in range(B):
        o, t = K2.segment_topk_moments(values[b], ids[b], S, k)
        assert torch.equal(topi[b], t) and torch.equal(out[b], o)
        assert torch.equal(K2.topi_moments_plain(values, ids, topi, S)[b],
                           K2.topi_moments_plain(values[b], ids[b], t, S))


def _pairs(rng, W, N):
    """Random window-slot pairs: poses (B, W, 3) and their packs."""
    mm = rng.uniform(-50, 50, (B, W, N, 3))
    c = rng.normal(0, 0.5, (2, B, W, N, 3, 3))
    c = c @ np.swapaxes(c, -1, -2) + 0.05 * np.eye(3)
    t = [torch.tensor(x, dtype=torch.float32)
         for x in (mm, c[0], mm + rng.normal(0, 1.0, mm.shape), c[1])]
    valid = torch.from_numpy(rng.random((B, W, N)) < np.array([0.2, 0.7, 1.0])[:, None, None])
    packed = K3.pack_pairs(*t, valid, slot_dims=2)
    return torch.tensor(rng.normal(0, 0.3, (B, W, 3)), dtype=torch.float32), packed


@pytest.mark.parametrize("alpha", [-2.0, 0.0])
def test_k3_plain_batched_equals_loop(alpha):
    """Per-member mu and NDT scale; the rho sum, cost sum and max over each
    member's own W slots."""
    rng = np.random.default_rng(2)
    W, N = 3, 500
    poses, packed = _pairs(rng, W, N)
    mu = torch.tensor([1.0, 4.0, 30.0])
    ns = torch.tensor([0.1, 0.37, 2.0])
    H, g, rho = K3.linearize(poses, mu, ns, packed, 1.5, alpha)
    cost, r2max = K3.robust_cost(poses, mu, packed, 1.5, alpha)
    assert H.shape == (B, W, 3, 3) and rho.shape == cost.shape == r2max.shape == (B,)
    for b in range(B):
        one = tuple(x[b] for x in packed)
        Hb, gb, rb = K3.linearize(poses[b], mu[b], ns[b], one, 1.5, alpha)
        cb, mb = K3.robust_cost(poses[b], mu[b], one, 1.5, alpha)
        assert torch.equal(H[b], Hb) and torch.equal(g[b], gb)
        assert torch.equal(rho[b], rb) and torch.equal(cost[b], cb)
        assert torch.equal(r2max[b], mb)


def test_k4_plain_batched_equals_loop():
    rng = np.random.default_rng(3)
    P = 36
    M = rng.normal(0, 1, (B, P, P))
    A = torch.tensor(M @ np.swapaxes(M, -1, -2) + P * np.eye(P), dtype=torch.float32)
    rhs = torch.tensor(rng.normal(0, 1, (B, P)), dtype=torch.float32)
    x = K4.chol_solve(A, rhs)
    for b in range(B):
        assert torch.equal(x[b], K4.chol_solve(A[b], rhs[b]))
