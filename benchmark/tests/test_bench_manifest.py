"""``BENCHMARK.json`` and the files it names, and a cell added as files
alone."""

import json
import shutil

import pytest

from benchmark import cellspec
from benchmark.cellspec import BENCH, NAME, ROOT, UNIT

from .conftest import INDOOR_CONFIG

M = cellspec.manifest()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(M) == KEYS
    assert len(json.dumps(M).encode()) <= 64 * 1024
    assert M["paths"] == ["benchmark"]
    assert M["command"][:2] == ["python3", "benchmark/run.py"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells, every run and compile allowance, fits 12 hours
    cells = 24
    assert (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in M["end_to_end"] + M["per_layer"])) == \
        len(M["end_to_end"]) + len(M["per_layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = [w["name"] for w in M["workloads"]]
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for c in (m.get("workloads") or cells):
            assert c in cells and _reports(e2e[m["moves"]], c)
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer(cell):
    c = cellspec.load_cell(cell)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    from benchmark import check

    lim = c["workload"]["limits"]
    assert set(lim) <= set(check.NUMBERS) and lim["exact_mismatches"] == 0
    assert all(0 <= v < 1 for v in lim.values())


NEW_CELL = {
    "name": "indoor_small.fleet", "config": "indoor_small", "traffic": "fleet",
    "generator": "fleet", "chips": 1,
    "why": "two members on a short lap, to show a configuration and a cell added as data",
    "params": {"batch": 2, "drives": 2, "chunk": 2, "warmup_frames": 2,
               "check_frames": 2, "check_members": 2},
    "limits": {"pose_gap_m": 0.08, "pose_gap_median_m": 0.001, "yaw_gap_rad": 0.015,
               "scan_gap_m": 0.01, "cell_gap_rel": 0.005, "exact_mismatches": 0,
               "bias_gap": 0.1},
}


def test_a_new_cell_is_run_from_files_alone(tmp_path):
    """A copy of the benchmark with one more configuration file, one more
    workload file and their ``BENCHMARK.json`` entries, and no other change:
    the harness finds the cell, parses it, and runs it (here on the CPU at a
    tiny size)."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf_file = "benchmark/configs/indoor_small.json"
    (root / conf_file).write_text(json.dumps(dict(INDOOR_CONFIG, name="indoor_small")))
    m["configs"].append(dict(name="indoor_small", source="https://example.org/indoor",
                             file=conf_file, reduced=[], why="a test"))
    (root / "benchmark" / "workloads" / "indoor_small.fleet.json").write_text(
        json.dumps(NEW_CELL))
    m["workloads"].append({k: NEW_CELL[k] for k in ("name", "config", "traffic", "chips",
                                                    "why")})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    cell = cellspec.load_cell("indoor_small.fleet", root=root)
    assert cell["workload"]["params"]["batch"] == 2
    assert [x["name"] for x in cell["per_layer"]] == []  # no metric lists the new cell
    assert cellspec.generator(cell["workload"]["generator"]).__name__.endswith(".fleet")
    cell["config"]["drive"]["lap_frames"] = 12
    gen = cellspec.generator(cell["workload"]["generator"])
    run = gen.make(cell, 2**31 + 11, device="cpu", workers=2)
    try:
        run.start()
        run.setup()
        e2e = run.window(0.01, trace=False)
        run.free_program()
        compared = run.check(cell["workload"]["limits"])
    finally:
        run.close()
    assert e2e["fleet_fps"] > 0 and run.attempted == 4
    assert all(v <= lim for _, v, lim in compared)


def test_a_cell_that_the_files_do_not_define_is_refused(tmp_path):
    with pytest.raises(cellspec.CellError):
        cellspec.load_cell("no.such_cell")
    with pytest.raises(cellspec.CellError):
        cellspec.load_cell("../x")
