"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, path or metric
lives in a file of its own and is found here by name, so a new cell or
metric is new files and new entries, never an edit:

- ``<root>/BENCHMARK.json``: the cells and metrics;
- the configuration's ``file`` (``port_bench/configs/<config>.json``),
  with, under ``checks.<path>``, the segments each path judges and the
  limits of its compared numbers;
- ``port_bench/traffic/<mix>.json``: the mix's parameters, among them the
  ``path`` that drives it;
- ``port_bench/paths/<path>.py``: one driver per entry into the port;
- ``port_bench/metrics/<metric>.py``: one reader per metric.

``root`` is the checkout (the directory that holds ``BENCHMARK.json``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = "port_bench"


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_names(root: Path = ROOT) -> list:
    return [w["name"] for w in load_benchmark(root)["workloads"]]


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    with open(Path(root) / BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _load_file(path: Path, modname: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_driver(name: str, root: Path = ROOT) -> ModuleType:
    """``port_bench/paths/<name>.py``: a module with a ``Driver`` class."""
    return _load_file(Path(root) / BENCH_DIR / "paths" / f"{name}.py",
                      f"port_bench_path_{name}")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``port_bench/metrics/<name>.py``: a module with ``read(run)``, which
    returns the metric's value or None where it finds nothing to read."""
    return _load_file(Path(root) / BENCH_DIR / "metrics" / f"{name}.py",
                      "port_bench_metric_" + name.replace(".", "_").replace("-", "_"))


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those that list it under ``workloads``, and those with no such key."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
