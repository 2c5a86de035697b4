"""The plain reference against the port's plain path on the CPU: the same
configuration, and bit for bit the same steps of a small batched drive."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import cellspec
from benchmark.cellspec import BENCH
from benchmark.inputs import drives as D

from .conftest import INDOOR_CONFIG

# every configuration file, and the IMU-aided one that no cell runs yet
CONFIGS = sorted(p.stem for p in (BENCH / "configs").glob("*.json")) + ["indoor_small"]


def _conf(name):
    if name == "indoor_small":
        return INDOOR_CONFIG
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_config_is_the_programs(name):
    conf = _conf(name)
    prog = dataclasses.asdict(cellspec.program_config(conf))
    ref = dataclasses.asdict(cellspec.reference_config(conf))
    assert prog == ref


def _leaves(x, path="out"):
    if isinstance(x, tuple):
        for f, v in zip(getattr(x, "_fields", range(len(x))), x):
            yield from _leaves(v, f"{path}.{f}")
    else:
        yield path, x


def _as_np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_steps_equal_the_ports_plain_path(name):
    from randt_slam_torch.pipeline import frontend as F

    from benchmark.reference.pipeline import frontend as RF

    conf = _conf(name)
    drive = dict(conf["drive"], lap_frames=8)
    laps = [D.render_lap(drive["kind"], drive, D.drive_seed(5, d)) for d in range(2)]
    pcfg, rcfg = cellspec.program_config(conf), cellspec.reference_config(conf)
    s2b = torch.zeros(3)
    pc = F.init_batched_carry(pcfg, 2, device="cpu")
    rc = RF.init_batched_carry(rcfg, 2, device="cpu")
    for t in range(24):   # three laps: keyframe exits and a submap switch
        f = t % 8
        scans = torch.from_numpy(np.stack([lap["scans"][f] for lap in laps]))
        A, R = scans.shape[1:]
        yaw = torch.tensor([lap["gt"][f, 2] + lap["imu_noise"][f] for lap in laps]) \
            + drive.get("imu_bias", 0.0) * t * drive["dt"]
        fields = (scans, torch.from_numpy(np.tile(laps[0]["az"], (2, 1))),
                  torch.from_numpy(np.tile(laps[0]["ranges"], (2, 1))),
                  torch.ones((2, A), dtype=torch.bool),
                  torch.full((2,), t * drive["dt"], dtype=torch.float32),
                  yaw.to(torch.float32), torch.full((2,), t, dtype=torch.int32))
        pc, pout = F.frontend_step(pcfg, pc, F.Frame(*fields), s2b, with_descriptor=False)
        rc, rout = RF.frontend_step(rcfg, rc, RF.Frame(*fields), s2b)
        for (path, a), (_, b) in zip(_leaves(pout), _leaves(rout)):
            if a is None:
                assert b is None, path
                continue
            np.testing.assert_array_equal(_as_np(a), _as_np(b), err_msg=f"frame {t} {path}")
        for (path, a), (_, b) in zip(_leaves(pc, "carry"), _leaves(rc, "carry")):
            np.testing.assert_array_equal(_as_np(a), _as_np(b), err_msg=f"frame {t} {path}")
    assert pc.n_finished >= 1 and pc.node_count >= 3
