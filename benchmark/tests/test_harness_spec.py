"""The benchmark finds every part of a cell by name, and a configuration,
a traffic mix, a cell and a metric are added by adding files and entries
alone."""

import json
import re
import shutil

import pytest

from harness_small import BENCH
from mcbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("cell", ["std6_league_es9_es8",
                                  "std6_selfplay_random", "equity_sweep169"])
def test_cell_parts_found_by_name(bench, cell):
    w = spec.workload(bench, cell)
    assert w["chips"] == 1
    cfg = spec.config(w["config"])
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"benchmark/configs/{w['config']}.json"
    assert cfg["name"] == w["config"] and cfg["reduced"] == entry["reduced"]
    traffic = spec.traffic(w["traffic"])
    mod = spec.driver(traffic["driver"])
    assert isinstance(mod.MAIN_KERNEL, str) and hasattr(mod, "Driver")
    e2e = spec.cell_metrics(bench, cell, "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = spec.cell_metrics(bench, cell, "per_layer")
    assert per_layer
    for m in e2e + per_layer:
        assert callable(spec.reader(m["name"]).read)
    for m in per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("cell,metrics", [
    ("equity_hu_queries", ["queries_per_s.hu", "device_idle_pct.hu",
                           "k1_roofline"])])
def test_held_cell_returns_by_entries_alone(bench, cell, metrics):
    """A cell held back from ``BENCHMARK.json`` keeps every part under its
    name, so entries alone put it back."""
    from harness_small import HELD
    w = HELD[cell]
    assert all(x["name"] != cell for x in bench["workloads"])
    assert spec.config(w["config"])["name"] == w["config"]
    mod = spec.driver(spec.traffic(w["traffic"])["driver"])
    assert hasattr(mod, "Driver")
    for m in metrics:
        assert callable(spec.reader(m).read)


def test_every_config_used(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_add_by_files_and_entries(bench, tmp_path):
    """A new configuration, traffic mix and per-layer metric, each a new
    file under a copy of the folder and a new entry, are found with no
    existing file edited."""
    base = tmp_path / "benchmark"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = dict(spec.config("equity_holdem"), name="equity_holdem_b")
    (base / "configs" / "equity_holdem_b.json").write_text(json.dumps(cfg))
    tr = dict(spec.traffic("sweep169_1e7"), rollouts=1000)
    (base / "traffic" / "sweep169_1e3.json").write_text(json.dumps(tr))
    (base / "metrics" / "answers_per_request.py").write_text(
        "def read(ctx):\n    return len(ctx.latencies_s)\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "equity_holdem_b", "source": "x",
                           "file": "benchmark/configs/equity_holdem_b.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "sweep_small", "config":
                             "equity_holdem_b", "traffic": "sweep169_1e3",
                             "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "answers_per_request", "unit": "1",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves": "rollouts_per_s.sweep",
                             "workloads": ["sweep_small"]})
    for m in new["end_to_end"]:
        if m["name"] == "rollouts_per_s.sweep":
            m["workloads"].append("sweep_small")
    w = spec.workload(new, "sweep_small")
    assert spec.config(w["config"], base)["name"] == "equity_holdem_b"
    assert spec.traffic(w["traffic"], base)["rollouts"] == 1000
    assert spec.driver(spec.traffic(w["traffic"], base)["driver"], base)
    per = spec.cell_metrics(new, "sweep_small", "per_layer")
    assert [m["name"] for m in per] == ["answers_per_request"]
    assert spec.reader("answers_per_request", base).read(
        type("C", (), {"latencies_s": [1, 2]})) == 2
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_reader_falls_back_to_base_name():
    a = spec.reader("device_idle_pct.league")
    b = spec.reader("device_idle_pct.sweep")
    assert a.read.__doc__ == b.read.__doc__
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


@pytest.mark.parametrize("net", ["es9", "es8"])
def test_frozen_nets_equal_the_repos(net):
    """The configuration's frozen nets are the repo's trained ones, whose
    evaluations its ``source`` cites."""
    import numpy as np
    frozen = BENCH / spec.config("holdem6_standard")["nets"][net]
    with np.load(frozen) as a, \
            np.load(BENCH.parent / "data" / f"policy_6max_{net}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
