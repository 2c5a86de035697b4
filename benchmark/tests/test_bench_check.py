"""The check that decides ``correct``: the program passes it, and a run
with the timed path broken underneath fails it, one fault at a time; the
control (the plain reference with its state stored in bfloat16, in the
program's place) fails it on the card.  Each drives the rest of a run (inputs, warm-up, window,
check) without the harness's look for a card."""

import subprocess
import sys

import pytest

from benchmark import cellspec
from benchmark.cellspec import ROOT

from .conftest import tiny_cell

CELLS = [w["name"] for w in cellspec.manifest()["workloads"]]
FAULTS = ["state_unchanged", "half_batch", "answer_altered"]


def _run(cell, program, device="cpu", seconds=0.01):
    gen = cellspec.generator(cell["workload"]["generator"])
    run = gen.make(cell, 2**31 + 99, device=device, program=program, workers=2)
    try:
        run.start()
        run.setup()
        run.window(seconds, trace=False)
        run.free_program()
        compared = run.check(cell["workload"]["limits"])
    finally:
        run.close()
    return {k: (v, lim) for k, v, lim in compared}


def _correct(compared):
    return all(v <= lim for v, lim in compared.values())


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes(name):
    compared = _run(tiny_cell(name), "port")
    assert _correct(compared), compared


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_fails(name, fault):
    compared = _run(tiny_cell(name, check_frames=4), f"fault:{fault}", seconds=0.5)
    assert not _correct(compared), compared


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(name, card):
    compared = _run(tiny_cell(name, batch=8, drives=8, chunk=4, warmup_frames=24,
                              check_frames=8, check_members=8),
                    "control", device="cuda", seconds=1.0)
    assert not _correct(compared), compared


def test_without_a_card_the_harness_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
