"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names every cell, metric
and configuration. Each part lives in a file of its own under
``benchmark/``, found by its name:

- a configuration: ``configs/<name>.json``;
- a traffic mix: ``traffic/<name>.json``, whose ``driver`` names the
  request generator ``drivers/<driver>.py`` that reads it;
- a metric: the reader ``metrics/<name>.py``, else ``metrics/<name up
  to its first dot>.py``: one reader for a quantity split by cell
  (``hands_per_s.league``), each part with a bound of its own, or by the
  end-to-end metric it moves (``device_idle_pct.league``).

So a cell, a configuration, a traffic mix or a metric is added by adding
files and entries, with no edit to a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # benchmark/
CHECKOUT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = CHECKOUT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: Path = HERE):
    """The request generator ``drivers/<name>.py`` as a module."""
    return _load_module(base / "drivers" / f"{name}.py",
                        f"mcbench_driver_{name}")


def reader(metric: str, base: Path = HERE):
    """The reader of metric ``metric`` as a module."""
    for stem in (metric, metric.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.is_file():
            return _load_module(path, "mcbench_metric_"
                                + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for {metric!r} under "
                            f"{base / 'metrics'}")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that cell
    ``cell`` reports: those whose ``workloads`` list it, or, without that
    key, every end-to-end metric, and every per-layer metric whose
    ``moves`` the cell reports."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
