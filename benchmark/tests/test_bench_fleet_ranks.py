"""The multi-rank fleet traffic (``traffic/fleet_ranks.py``) on four tiny gloo
ranks on the CPU: the faults that only a cell of several ranks can have
each turn ``correct`` false or end the run, and the readers of the gathered
rings (``benchmark/ranks.py``) on a synthetic ring of four ranks.  The
program's pass, the single-rank faults and the control are
``test_bench_check.py``'s, which runs every cell."""

import json
import subprocess
import sys
import time

import pytest

from benchmark import cellspec
from benchmark.cellspec import ROOT
from benchmark.traffic import fleet_ranks

from .conftest import tiny_cell

CELL = "oxford.fleet4"
MS = 1_000_000  # ns
T0 = 1_800_000_000 * 10 ** 9   # a time on the Unix-epoch clock, ns


def _run(program, seconds=0.5):
    cell = tiny_cell(CELL, check_frames=4)
    run = fleet_ranks.make(cell, 2**31 + 99, device="cpu", program=program, workers=2)
    try:
        run.start()
        run.setup()
        run.window(seconds, trace=False)
        run.free_program()
        compared = run.check(cell["workload"]["limits"])
    finally:
        run.close()
    return {k: (v, lim) for k, v, lim in compared}


@pytest.mark.parametrize("fault", ["shares_swapped", "rank_stalled"])
def test_a_multi_rank_fault_fails(fault):
    """Rank 1's share of the gathered outputs replaced by rank 0's; the last
    rank keeping its carries unchanged while the others step."""
    compared = _run(f"fault:{fault}")
    assert not all(v <= lim for v, lim in compared.values()), compared


KILLED = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests.conftest import tiny_cell
from benchmark.traffic import fleet_ranks
cell = tiny_cell({cell!r}, check_frames=4)
run = fleet_ranks.make(cell, 2**31 + 7, device="cpu", program="fault:rank_killed", workers=2)
try:
    run.start()
    run.setup()
    print("window", flush=True)
    run.window(5.0, trace=False)
    run.free_program()
    print(json.dumps(run.check(cell["workload"]["limits"])), flush=True)
finally:
    run.close()
"""


def test_a_killed_rank_ends_the_run_without_a_hang():
    """Rank 1 killed (SIGKILL) after the window's first chunk: rank 0 exits
    non-zero within the deadline and prints no result, and no rank is left
    running."""
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", KILLED.format(root=str(ROOT), cell=CELL)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0, out.stdout
    lines = out.stdout.strip().splitlines()
    assert lines and lines[-1] == "window", out.stdout     # died in the window, no result
    assert "rank 1" in out.stderr, out.stderr[-3000:]
    assert time.monotonic() - t0 < 240
    left = subprocess.run(["pgrep", "-f", f"fleet_ranks.*{2**31 + 7}"],
                          capture_output=True, text=True)
    assert left.stdout.strip() == ""


# ---- the readers of the gathered rings --------------------------------------------


def rec(name, start_ms, end_ms, **ids):
    from randt_slam_torch.utils.profiling import Record
    return Record(name, T0 + int(start_ms * MS), T0 + int(end_ms * MS), ids, None)


def rings(drop=()):
    """Four ranks, chunks 0-3 of two steps each, chunk 1 traced.  In chunk c
    (from 100 c ms) rank k steps 10 + k ms a step and ends its own work at
    20 + 2k ms, then gathers until 40 ms (rank k's gather: 20 - 2k ms);
    ``drop`` leaves out the named spans."""
    out = []
    for c in range(4):
        at = 100 * c
        for k in range(4):
            for t in range(2):
                out.append(rec("randt.frontend_step", at + t * (10 + k),
                               at + (t + 1) * (10 + k), chunk=c, rank=k, t=t))
            out.append(rec("randt.batch_chunk", at, at + 20 + 2 * k, chunk=c, rank=k))
            out.append(rec("randt.gather_outputs", at + 20 + 2 * k, at + 40, chunk=c, rank=k))
    return [r for r in out if r.name not in drop]


def ctx_of(rs, **kw):
    return dict(dict(events=[], steps=2, span=(T0, T0), shapes={}, rings=rs,
                     traced_chunk=1, ranks=4), **kw)


def read(name, ctx):
    return cellspec.metric_reader(name)(ctx)


def test_readers_of_the_gathered_rings():
    ctx = ctx_of(rings())
    # chunks 2 and 3: the longest gather is rank 0's 20 ms, over 2 steps
    assert read("gather_span_ms.fleet4", ctx) == pytest.approx(10.0)
    # the last rank ends its own work 6 ms after the first: 3 ms a step
    assert read("rank_skew_ms.fleet4", ctx) == pytest.approx(3.0)
    # the slowest rank, rank 3, steps 13 ms
    assert read("rank_step_ms.fleet4", ctx) == pytest.approx(13.0)


def test_readers_skip_the_traced_chunk_and_chunks_a_rank_lacks():
    rs = rings()
    # a slow traced chunk and a chunk 4 that only three ranks ran change nothing
    rs.append(rec("randt.gather_outputs", 100, 190, chunk=1, rank=2))
    rs += [rec("randt.gather_outputs", 400, 490, chunk=4, rank=k) for k in range(3)]
    ctx = ctx_of(rs)
    assert read("gather_span_ms.fleet4", ctx) == pytest.approx(10.0)
    assert read("rank_step_ms.fleet4", ctx) == pytest.approx(13.0)


def test_readers_return_none_where_nothing_is_there_to_read():
    names = ("gather_span_ms.fleet4", "rank_skew_ms.fleet4", "rank_step_ms.fleet4")
    for ctx in (None, ctx_of([]), ctx_of(rings(), traced_chunk=3),
                {k: v for k, v in ctx_of(rings()).items() if k != "rings"}):
        for m in names:
            assert read(m, ctx) is None, m
    # a program without the exchange's span: that reader alone finds nothing
    ctx = ctx_of(rings(drop=("randt.gather_outputs",)))
    assert read("gather_span_ms.fleet4", ctx) is None
    assert read("rank_skew_ms.fleet4", ctx) == pytest.approx(3.0)
    ctx = ctx_of(rings(drop=("randt.frontend_step", "randt.batch_chunk")))
    assert read("rank_step_ms.fleet4", ctx) is None
    assert read("rank_skew_ms.fleet4", ctx) is None


def test_each_rank_renders_its_own_drives():
    seeds = {fleet_ranks.rank_seed(2**40 + 5, r) for r in range(4)}
    assert len(seeds) == 4
    assert fleet_ranks.rank_seed(-3, 1) != fleet_ranks.rank_seed(3, 1)
    cell = cellspec.load_cell(CELL)
    p = cell["workload"]["params"]
    assert (p["ranks"], p["batch"], cell["entry"]["chips"]) == (4, 512, 4)
    assert json.loads(json.dumps(cell))["workload"]["generator"] == "fleet_ranks"


def test_the_configuration_states_the_cells_layout():
    """The deployment's file holds the layout the cell runs (the dataset's 32
    traversals over four ranks, 512 members a card) and the per-card
    configuration of ``oxford.fleet``, so each card's step is that cell's."""
    cell = cellspec.load_cell(CELL)
    conf, p = cell["config"], cell["workload"]["params"]
    layout = conf["cluster"]
    assert layout["ranks"] == layout["cards"] == p["ranks"] == cell["entry"]["chips"]
    assert (layout["drives_per_rank"], layout["members_per_rank"]) == (p["drives"], p["batch"])
    assert conf["traversals"] == p["ranks"] * p["drives"]
    one_card = cellspec.load_cell("oxford.fleet")["config"]
    for key in ("preset", "overrides", "precision", "sizes", "drive", "reduced"):
        assert conf[key] == one_card[key], key
