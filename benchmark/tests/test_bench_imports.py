"""Nothing the benchmark runs imports JAX or the JAX package (nor the
smoke test or the scripts), and the reference imports nothing of the
program.  Top-level module names are compared whole: ``randt_slam_torch``
begins with the letters of ``randt_slam_tpu`` and is not it."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.cellspec import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "randt_slam_tpu", "chip_smoke", "scripts"}


def _run_modules():
    """Every module the harness can run: all of ``benchmark/`` but its tests."""
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def _top_levels(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", _run_modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import_statically(path):
    found = _top_levels(path) & FORBIDDEN
    assert not found, f"{path.relative_to(ROOT)} imports {found}"
    if "reference" in path.relative_to(BENCH).parts:
        assert "randt_slam_torch" not in _top_levels(path)
        assert "benchmark" not in _top_levels(path)


def test_names_are_compared_whole():
    assert "randt_slam_torch".split(".")[0] not in FORBIDDEN
    assert "randt_slam_tpu.ops".split(".")[0] in FORBIDDEN


LOAD_ALL = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark import cellspec, check, trace, device
from benchmark.reference.pipeline import frontend
from benchmark.reference import config
m = cellspec.manifest()
for w in m["workloads"]:
    cell = cellspec.load_cell(w["name"])
    gen = cellspec.generator(cell["workload"]["generator"])
    cellspec.program_config(cell["config"])
    cellspec.reference_config(cell["config"])
for x in m["per_layer"]:
    cellspec.metric_reader(x["name"])
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

REF_ONLY = r"""
import json, sys
sys.path.insert(0, {root!r})
from benchmark.reference.pipeline import frontend
from benchmark.reference import config
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_loading_every_cell_config_and_metric_loads_no_forbidden_module():
    found = _loaded(LOAD_ALL) & FORBIDDEN
    assert not found, found


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(REF_ONLY)
    assert "randt_slam_torch" not in loaded
    assert not loaded & FORBIDDEN
