"""Sliding-window estimator of the port against the JAX package.

``estimate_window`` gets identical inputs on both sides: scan cells of
frames 1..W and a submap built from frame 0 by the JAX package, states
perturbed off the ground truth.  Both run the Barron-GNC LM solve on the
CPU.  ``rejected`` and ``n_residuals`` must be identical; the window states
agree within 1e-4 (m, m/s) and 1e-5 (rad, rad/s): the derivatives are exact
on both sides (forward mode there, reverse mode here) and differ only in the
order of float32 operations, which the damped solve does not amplify from
identical inputs.

The port runs each combination of its kernel switches (``use_pallas_*``):
on the CPU the fused K3a/K3b linearization and cost and the K4 Cholesky
solve take their plain versions, whose analytic derivatives and unpivoted
solve differ from the JAX package's ``jacfwd`` and LU solve (the JAX package
ignores the switches off a TPU) only in the order of float32 operations:
the same tolerances hold.

One exception, tied to its cause.  With the K4 switch and the second fixed
map in use, the LM's 9th iteration of the first GNC round proposes a step
of ~1.5e-3 m whose trial cost lies one float32 ulp (4.9e-4 of 5587.7) below
the current cost with K4 and equals it with the LU solve: the port takes
it, the reference does not (the flat-solve fault of ROADMAP section 3; the
final costs agree).  So a K4 case over the tolerance must show that K4
solved exactly: the port with a float64 solve in K4's place lands within
1e-6 of K4's answer; it must also stay within 5e-3 m / 1e-4 rad of the
reference.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from randt_slam_tpu.config import synthetic_config as j_cfg
from randt_slam_tpu.io import synthetic
from randt_slam_tpu.ndt import grid as jG
from randt_slam_tpu.pipeline import frontend as jF, slam as jS
from randt_slam_tpu.registration import matcher as jM
from randt_slam_torch.config import synthetic_config as t_cfg
from randt_slam_torch.ops import small_chol
from randt_slam_torch.registration import matcher as tM
from randt_slam_torch.registration import residuals as tR
from tests.torch_threads import one_thread  # noqa: F401

LIN_TOL = 1e-4
ANG_TOL = 1e-5
EXACT_TOL = 1e-6                       # K4 against a float64 solve
EDGE_LIN_TOL, EDGE_ANG_TOL = 5e-3, 1e-4  # one ulp-decided LM step


@pytest.fixture(scope="module")
def window():
    cfg = j_cfg()
    seq = synthetic.generate(seed=3, n_frames=6, n_azimuths=256, n_bins=256)
    frames = jS.frames_from_arrays(seq.intensity, seq.azimuths, seq.ranges, seq.stamps)
    W = cfg.matcher.smoothing_steps
    geom = jG.GridGeom.from_config(cfg.ndt_map)
    scans = [jF.build_scan_cells(cfg, jax.tree.map(lambda a: a[i], frames),
                                 jnp.zeros(3))[0] for i in range(W + 1)]
    S = cfg.capacity.max_submap_cells
    sub = jG.scatter_sparse(geom, jG.empty_sparse(geom, S), scans[0].stats, scans[0].valid)
    # a second fixed map: the same submap seen from a shifted origin
    prev = jG.transform_sparse(geom, sub, jnp.asarray([0.4, -0.3, 0.02]))
    fields = [jG.derive_sparse_fields(m, cfg.ndt_map.min_points_per_cell,
                                      cfg.ndt_map.cell) for m in (sub, prev)]
    states = np.zeros((W + 1, 9), np.float32)
    states[:, :3] = seq.gt_poses[:W + 1] + np.asarray([0.3, -0.2, 0.02], np.float32)
    states[:, 3] = 4.0
    return dict(
        W=W, index=(np.asarray(sub.index), np.asarray(prev.index)),
        mean=np.stack([np.asarray(f[0]) for f in fields]),
        cov=np.stack([np.asarray(f[1]) for f in fields]),
        valid=np.stack([np.asarray(f[2]) for f in fields]),
        sw=[np.stack([np.asarray(getattr(s, k)) for s in scans[1:]])
            for k in ("mean", "cov", "valid")],
        states=states, stamps=(np.arange(W + 1) * 0.25).astype(np.float32),
        imu=np.asarray([0.01, -0.02, 0.015], np.float32)[:W],
    )


SWITCHES = {
    "off": {},
    "linearize": {"matcher.use_pallas_linearize": True},
    "chol": {"matcher.use_pallas_chol": True},
    "both": {"matcher.use_pallas_linearize": True, "matcher.use_pallas_chol": True},
}


@pytest.fixture(scope="module")
def jax_windows():
    """The JAX package's solves of the window, by (n_exist, use_prev): one
    for every switch setting of the port (the JAX package's CPU path takes
    none of them)."""
    return {}


def _jax_window(d, exist, use_prev):
    fj = jM.FixedMaps(index=tuple(jnp.asarray(i) for i in d["index"]),
                      mean=jnp.asarray(d["mean"]), cov=jnp.asarray(d["cov"]),
                      valid=jnp.asarray(d["valid"]),
                      use=jnp.asarray([True, use_prev]))
    return jM.estimate_window(j_cfg(), jnp.asarray(d["states"]), jnp.asarray(d["stamps"]),
                              jnp.asarray(exist), jnp.asarray(d["imu"]),
                              jM.ScanWindow(*(jnp.asarray(x) for x in d["sw"])), fj,
                              jnp.asarray(d["states"][-2, :3]))


@pytest.mark.parametrize("switches", list(SWITCHES))
@pytest.mark.parametrize("n_exist,use_prev", [(4, False), (2, False), (4, True)])
def test_estimate_window_matches_jax(window, jax_windows, n_exist, use_prev, switches,
                                     monkeypatch):
    d = window
    W = d["W"]
    exist = np.arange(W + 1) >= (W + 1 - n_exist)
    if (n_exist, use_prev) not in jax_windows:
        jax_windows[n_exist, use_prev] = _jax_window(d, exist, use_prev)
    ej = jax_windows[n_exist, use_prev]
    t = torch.from_numpy
    ft = tM.FixedMaps(index=tuple(t(i) for i in d["index"]), mean=t(d["mean"]),
                      cov=t(d["cov"]), valid=t(d["valid"]), use=(True, use_prev))

    def port():
        return tM.estimate_window(t_cfg(**SWITCHES[switches]), t(d["states"]),
                                  t(d["stamps"]), exist, t(d["imu"]),
                                  tM.ScanWindow(*(t(x) for x in d["sw"])), ft,
                                  t(d["states"][-2, :3]))

    et = port()
    assert bool(et.rejected) == bool(ej.rejected)
    assert int(et.n_residuals) == int(ej.n_residuals) > 0
    diff = np.abs(et.states.numpy() - np.asarray(ej.states))
    ang = [tR.TH, tR.OM]
    lin = [c for c in range(9) if c not in ang]
    within = diff[:, lin].max() <= LIN_TOL and diff[:, ang].max() <= ANG_TOL
    if not within and SWITCHES[switches].get("matcher.use_pallas_chol"):
        monkeypatch.setattr(small_chol, "chol_solve", lambda A, b: torch.linalg.solve(
            A.double(), b.double()).float())
        exact = port()
        assert np.abs(exact.states.numpy() - et.states.numpy()).max() <= EXACT_TOL
        assert diff[:, lin].max() <= EDGE_LIN_TOL, diff
        assert diff[:, ang].max() <= EDGE_ANG_TOL, diff
    else:
        assert diff[:, lin].max() <= LIN_TOL, diff
        assert diff[:, ang].max() <= ANG_TOL, diff
    np.testing.assert_allclose(float(et.cost), float(ej.cost), rtol=1e-4)

