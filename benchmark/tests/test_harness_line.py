"""The result's last line, the command's refusals, and one short run on the
card."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from harness_small import BENCH, measure_small, run_small, small_cell
from mcbench import core

ROOT = BENCH.parent


def test_last_line_shape():
    result, err = run_small("equity_sweep169")
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(result)
    assert set(result["metrics"]) == {"rollouts_per_s.sweep",
                                      "request_p95_ms.sweep", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    n = len(result["checks"])
    assert all(line.startswith("check ") for line in err[-n:])


def test_traced_line_shape():
    result, _ = run_small("equity_sweep169", trace=1)
    assert "breakdown" in result and "busy_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"
    # no device ran on the CPU: no kernel share is reported
    assert "k2_roofline" not in result["metrics"]


@pytest.mark.parametrize("phase", ["check", "reader"])
def test_no_result_when_jax_is_loaded_after_the_window(monkeypatch, phase):
    """A forbidden module that the check or a metric's reader loads, after
    the window has closed, still stops the result: exit 3, nothing on
    standard output, the module named on standard error."""
    parts = small_cell("equity_hu_queries")
    mod = parts[-1]
    fake = types.ModuleType("jax")

    def load_jax(orig):
        def wrapped(*a, **k):
            monkeypatch.setitem(sys.modules, "jax", fake)
            return orig(*a, **k)
        return wrapped

    monkeypatch.delitem(sys.modules, "jax", raising=False)
    if phase == "check":
        monkeypatch.setattr(mod.Driver, "check", load_jax(mod.Driver.check))
    else:
        monkeypatch.setattr(core.spec, "reader", load_jax(core.spec.reader))
    out, err, code = measure_small(parts)
    assert code == 3 and out.strip() == ""
    assert "jax" in err.splitlines()[-1]


def _run(cwd, *args):
    env = dict(os.environ)
    env.pop("BENCH_RUN", None)
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=600)


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, "--workload", "equity_sweep169", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_cell_on_card(card):
    r = _run(ROOT, "--workload", "equity_sweep169", "--seed", "2147483699",
             "--seconds", "2", "--trace", "0")
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
