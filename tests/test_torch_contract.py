"""Contract of the PyTorch port.

* It imports nothing of JAX or of the JAX package (checked in a fresh
  interpreter that imports every submodule, and in the sources).
* Entry points run on CUDA unless asked for the CPU: with no device and no
  CUDA they raise instead of dropping to the CPU.
* Its configuration presets equal the JAX package's field by field.
* The CLI runs full SLAM and odometry, writes the OGM, the NDT export, the
  map view and ``trajectory.json`` and reads a reference YAML (its online
  mode and checkpoints: ``tests/test_torch_online.py``).
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from randt_slam_tpu import config as jcfg
from randt_slam_torch import config as tcfg
from tests.torch_threads import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "randt_slam_torch"


def _py_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_graph_has_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import randt_slam_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'randt_slam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'randt_slam_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('randt_slam_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "randt_slam_tpu"), (path, n)


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from randt_slam_torch.pipeline import frontend, slam

    cfg = tcfg.synthetic_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frontend.init_carry(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slam.frames_from_arrays(np.zeros((1, 4, 8), np.float32), np.zeros(4),
                                np.arange(8.0), np.zeros(1))
    frames = slam.frames_from_arrays(np.zeros((1, 4, 8), np.float32), np.zeros(4),
                                     np.arange(8.0), np.zeros(1), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slam.run_odometry(cfg, frames)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slam.run_slam(cfg, frames)
    from randt_slam_torch import state
    from randt_slam_torch.loops import detector

    for fn in (detector.detect_loops, detector.detect_loops_mahalanobis):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(cfg, None, frames)  # the device is resolved first
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state.odometry_from_numpy(None, None)
    from randt_slam_torch.pipeline.online import OnlineSlam

    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineSlam(cfg)
    from randt_slam_torch.parallel import batch

    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.init_batched_carry(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.make_batched_scan(cfg, np.zeros(3))


@pytest.mark.parametrize("preset", ["synthetic_config", "oxford_config",
                                    "indoor_config"])
def test_config_presets_equal_the_jax_package(preset):
    a = dataclasses.asdict(getattr(tcfg, preset)())
    b = dataclasses.asdict(getattr(jcfg, preset)())
    assert a == b


@pytest.mark.parametrize("source", ["synthetic", "npz"])
def test_cli_odometry_only(tmp_path, source):
    out = tmp_path / "run"
    inp = "synthetic"
    if source == "npz":  # a converted sequence: float16 scans, ground truth
        from randt_slam_torch.io import synthetic

        seq = synthetic.generate(seed=1, n_frames=8, n_azimuths=256, n_bins=256)
        inp = str(tmp_path / "seq.npz")
        np.savez(inp, intensity=seq.intensity.astype(np.float16),
                 azimuths=seq.azimuths, ranges=seq.ranges, stamps=seq.stamps + 100.0,
                 gt_poses=seq.gt_poses)
    cmd = [sys.executable, "-m", "randt_slam_torch.run", "--input", inp,
           "--config", "synthetic", "--odometry-only", "--frames", "8",
           "--device", "cpu", "--output", str(out)]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    for f in ("odom_tum.txt", "odom_kitti.txt", "slam_tum.txt", "slam_kitti.txt",
              "metrics.json"):
        assert (out / f).exists(), f
    m = json.loads((out / "metrics.json").read_text())
    assert m["frames"] == 8 and m["device"] == "cpu"
    assert np.isfinite(m["odom_ate_m"]) and m["odom_ate_m"] < 2.0
    assert len((out / "odom_tum.txt").read_text().splitlines()) == 8


def test_cli_full_slam(tmp_path):
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "randt_slam_torch.run", "--input", "synthetic",
           "--config", "synthetic", "--loop", "--frames", "20", "--device", "cpu",
           "--output", str(out)]
    env = dict(os.environ, OMP_NUM_THREADS="1")  # small eager ops: one thread
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    for f in ("odom_tum.txt", "odom_kitti.txt", "slam_tum.txt", "slam_kitti.txt",
              "metrics.json"):
        assert (out / f).exists(), f
    m = json.loads((out / "metrics.json").read_text())
    assert m["frames"] == 20 and m["n_loop_closures"] >= 0
    assert np.isfinite(m["odom_ate_m"]) and np.isfinite(m["slam_ate_m"])
    for k in ("odometry_s", "loop_closure_s", "pgo_s"):
        assert m["timings"][k] >= 0.0, k


def _cli(tmp_path, *extra, frames=12):
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "randt_slam_torch.run", "--input", "synthetic",
           "--config", "synthetic", "--frames", str(frames), "--device", "cpu",
           "--output", str(out), *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1")  # small eager ops: one thread
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return out, json.loads((out / "metrics.json").read_text())


def test_cli_ogm_and_ndt_export(tmp_path):
    out, m = _cli(tmp_path, "--loop", "--ogm", "--export-ndt")
    cfg = tcfg.synthetic_config().ogm
    pgm = (out / "ogm.pgm").read_bytes()
    header = f"P5\n{cfg.size_x} {cfg.size_y}\n255\n".encode()
    assert pgm.startswith(header) and len(pgm) == len(header) + cfg.size_x * cfg.size_y
    img = np.frombuffer(pgm[len(header):], np.uint8)
    assert (img == 127).any() and (img != 127).any()  # unknown and mapped cells
    ndt = np.load(out / "ndt_submap.npz")
    assert len(ndt["mean_x"]) > 0 and np.isfinite(ndt["cov_xx"]).all()
    traj = json.loads((out / "trajectory.json").read_text())
    assert len(traj) == m["n_nodes"] and set(traj[0]) == {"stamp", "x", "y", "yaw"}
    assert m["timings"]["ogm_s"] >= 0.0


def test_cli_render(tmp_path):
    pytest.importorskip("matplotlib")
    out, _ = _cli(tmp_path, "--odometry-only", "--render", frames=6)
    assert (out / "map.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (out / "trajectory.json").exists()


def test_cli_ref_yaml(tmp_path):
    """``--ref-yaml`` takes the reference's layered YAML in place of the
    preset, as the JAX CLI does (the YAML of
    ``tests/test_reference_yaml.py``'s cascade test)."""
    from randt_slam_tpu import run as jrun
    from randt_slam_torch import run as trun

    p = tmp_path / "min.yaml"
    p.write_text(
        "ndt_matcher:\n"
        "  gnc_steps: 7\n"
        "  loss_function_scale: 2.5\n"
        "  use_intensity_as_dimension: false\n"
        "ndt_map:\n"
        "  size_x: 70\n  size_y: 70\n  resolution: 2.0\n"
    )
    argv = ["--input", "synthetic", "--output", str(tmp_path), "--ref-yaml", str(p)]
    cfg = trun.load_config(trun.build_parser().parse_args(argv))
    assert cfg == tcfg.from_reference_yaml(str(p))
    assert cfg.ndt_map.size_x == 35 and cfg.matcher.gnc_steps == 7
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jrun.load_config(jrun.build_parser().parse_args(argv)))
    out, m = _cli(tmp_path, "--odometry-only", "--ref-yaml", str(p), frames=6)
    assert m["frames"] == 6 and np.isfinite(m["odom_ate_m"])
