"""Fixtures of the benchmark's own tests (CPU unless marked ``cuda``)."""

import pytest

# A configuration that a later change could add as a file alone, which no
# cell runs yet: the IMU-aided preset on the indoor drive
# (``inputs/drives.py``, ``render_indoor``; the gyro of
# ``scripts/indoor_sim.py``).
INDOOR_CONFIG = {
    "preset": "indoor_config",
    "overrides": {"matcher.use_pallas_linearize": True, "matcher.use_pallas_chol": True},
    "reduced": [],
    "drive": {"kind": "indoor_route", "lap_frames": 112, "route_half": [0.5, 0.5],
              "n_az": 400, "bin_w": 0.03, "max_range": 12.0, "dt": 0.25, "speed": 0.8,
              "imu_bias": 0.002, "imu_noise": 0.004},
}


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present (decided when the test
    runs, never when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_cell(name, **params):
    """Cell ``name`` as the files define it, at a size the CPU runs in
    seconds: two drives, two members, chunks of two frames."""
    import copy

    from benchmark import cellspec

    cell = copy.deepcopy(cellspec.load_cell(name))
    p = dict(batch=2, drives=2, chunk=2, warmup_frames=2, check_frames=3,
             check_members=2)
    p.update(params)
    cell["workload"]["params"].update(p)
    cell["config"]["drive"]["lap_frames"] = 12
    return cell
