"""Finding a cell's files by name.

``BENCHMARK.json`` (the repository's root) names the cells, the
configurations and the metrics.  Everything else is found from those names,
so that a later cell or metric is added as files and never by editing one:

* ``benchmark/workloads/<cell>.json``: the cell's configuration, traffic
  (the mix's name), ``generator`` (``benchmark/traffic/<generator>.py``),
  the generator's ``params``, ``chips``, ``why`` and the ``limits`` of the
  numbers its check compares;
* ``benchmark/configs/<config>.json``: the program's preset and overrides,
  the deployment and its source, and the ``drive`` the inputs are rendered
  from;
* ``benchmark/metrics/<metric>.py``: one reader per per-layer metric, a
  function ``read(ctx)`` that returns a number or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class CellError(ValueError):
    """A cell, configuration or metric that the files do not define."""


def manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name``: its workload file, its configuration file, its
    ``BENCHMARK.json`` entry and the metrics it reports."""
    root = Path(root)
    if not NAME.match(name):
        raise CellError(f"not a cell name: {name!r}")
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"BENCHMARK.json has no workload {name!r}")
    bench = root / "benchmark"
    wl_path = bench / "workloads" / f"{name}.json"
    if not wl_path.is_file():
        raise CellError(f"no workload file {wl_path.relative_to(root)}")
    workload = json.loads(wl_path.read_text())
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise CellError(f"{wl_path.name}: {key} {workload[key]!r} but BENCHMARK.json "
                            f"says {entry[key]!r}")
    if not IDENT.match(workload["generator"]):
        raise CellError(f"not a generator name: {workload['generator']!r}")
    conf_entry = next((c for c in m["configs"] if c["name"] == workload["config"]), None)
    if conf_entry is None:
        raise CellError(f"BENCHMARK.json has no config {workload['config']!r}")
    config = json.loads((root / conf_entry["file"]).read_text())

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return dict(name=name, entry=entry, workload=workload, config=config,
                run_seconds=m["run_seconds"],
                end_to_end=[x for x in m["end_to_end"] if mine(x)],
                per_layer=[x for x in m["per_layer"] if mine(x)])


def generator(kind: str):
    """The traffic generator module ``benchmark/traffic/<kind>.py``."""
    if not IDENT.match(kind):
        raise CellError(f"not a generator name: {kind!r}")
    return importlib.import_module(f"{__package__}.traffic.{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    if not NAME.match(name):
        raise CellError(f"not a metric name: {name!r}")
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise CellError(f"no reader {path.name} for metric {name!r}")
    mod_name = f"{__package__}.metrics._" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_config(conf: dict):
    """The port's ``SlamConfig`` of a configuration file."""
    from randt_slam_torch import config as C
    return getattr(C, conf["preset"])(**conf["overrides"])


def reference_config(conf: dict):
    """The same configuration as the plain reference's own copy builds it."""
    from .reference import config as R
    return getattr(R, conf["preset"])(**conf["overrides"])
