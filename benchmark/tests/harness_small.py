"""Helpers of the harness's tests: the cells at sizes a CPU test can hold,
run through ``mcbench.core.measure`` on the CPU, where the port's
wrappers run their plain versions."""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import sys
import time
import types

BENCH = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

# the tests run in several workers at once: one thread each
torch.set_num_threads(1)

from mcbench import core, spec  # noqa: E402

# Each traffic mix's sizes cut for the CPU; everything else as committed.
SMALL = {
    "league_h2h_2p16": {"tables": 2048, "slots": 32, "slots_per_launch": 16,
                        "check_tables": 64},
    "aks_qq_1e6": {"rollouts": 4096, "check": 3},
    "random_2p20x512": {"tables": 2048, "slots": 32, "slots_per_launch": 32,
                        "check_tables": 64},
    "sweep169_1e7": {"rollouts": 256, "check_hands": 3},
}


# Cells whose parts are kept under ``benchmark/`` but which
# ``BENCHMARK.json`` holds back (PERF.md says why); the tests still run them.
HELD = {
    "equity_hu_queries": {"name": "equity_hu_queries",
                          "config": "equity_holdem", "traffic": "aks_qq_1e6",
                          "chips": 1},
}


def small_cell(name: str):
    """(benchmark, cell, config, traffic cut to size, driver module)."""
    bench = spec.benchmark()
    cell = HELD[name] if name in HELD else spec.workload(bench, name)
    traffic = dict(spec.traffic(cell["traffic"]))
    traffic.update(SMALL[cell["traffic"]])
    return bench, cell, spec.config(cell["config"]), traffic, \
        spec.driver(traffic["driver"])


def measure_small(parts, seed: int = 12345, seconds: float = 0.3,
                  trace: int = 0):
    """One run on the CPU of a cell's parts (``small_cell``'s): (standard
    output, standard error, the exit code it asked for or None)."""
    bench, cell, config, traffic, mod = parts
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    out, err = io.StringIO(), io.StringIO()
    code = None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            core.measure(bench, cell, config, traffic, mod,
                         torch.device("cpu"), args, time.perf_counter())
        except SystemExit as e:
            code = e.code
    return out.getvalue(), err.getvalue(), code


def run_small(name: str, seed: int = 12345, seconds: float = 0.3,
              trace: int = 0):
    """One run of cell ``name`` on the CPU: (result dict, stderr lines)."""
    out, err, code = measure_small(small_cell(name), seed, seconds, trace)
    assert code is None, err
    return json.loads(out.splitlines()[-1]), err.splitlines()


def control_checks(name: str, seed: int = 777, answered: int = 9):
    """The checks with the control in the program's place."""
    _, _, config, traffic, mod = small_cell(name)
    d = mod.Driver(config, traffic, torch.device("cpu"), seed)
    d.n_answered = answered
    return [core.Check(*c) for c in d.check(control=True)]
