"""The ported solver scripts (``montecarlo_tpu_torch/scripts/river_gap.py``,
``turn_gap.py``, ``distill_nash.py``) against the JAX scripts on the CPU.

Each ``main`` runs beside its JAX twin (loaded from ``scripts/``) at a
small size: the river game at few iterations, the turn games on the
Ks8h5d2c board and the three rivers of ``tests/test_turn_solver.py``
(both scripts' game constructors narrowed the same way) at combo stride
48. The saved results have the JAX results' keys exactly, the subjects'
no-solve rows (gap, best responses) agree within 2e-4 bb and the rest
within the tolerances of ``chip_smoke.py`` path j; ``untrained`` reads
JAX's own initial leaves on both sides. Each script takes exactly its
JAX twin's options, and ``--save`` is required.
"""

import functools
import importlib
import importlib.util
import json
import re
import sys

import jax
import numpy as np
import pytest
import torch

from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.models import turn_solver as jt
from montecarlo_tpu_torch.models import turn_solver as pt
from montecarlo_tpu_torch.scripts import distill_nash, river_gap, turn_gap

torch.set_num_threads(1)

RIVERS = [36, 1, 20]   # tests/test_turn_solver.py's: Qs 3h Jd
NO_SOLVE = ("gap_bb", "br_vs_net_p1_bb", "br_vs_net_p2_bb")


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  f"scripts/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, name, argv):
    mod = jax_script(name)
    if name != "river_gap":   # the three rivers, as the port's run below
        narrow(monkeypatch, mod, jt)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()


def narrow(monkeypatch, mod, solver):
    """Make ``mod``'s game constructors use RIVERS instead of every river."""
    nodes, game = solver.turn_river_node_states, solver.make_turn_river_game
    monkeypatch.setattr(mod, "turn_river_node_states",
                        lambda board4, rivers, **kw: nodes(board4, RIVERS,
                                                           **kw))
    monkeypatch.setattr(mod, "make_turn_river_game",
                        lambda board4, **kw: game(board4, rivers=RIVERS,
                                                  **kw))


@functools.lru_cache(maxsize=None)
def jax_init_npz(tmp):
    """JAX's ``init_params(key(0))`` leaves as an artifact."""
    path = f"{tmp}/jax_init.npz"
    np.savez(path, **{f"p_{i}": np.asarray(x) for i, x in enumerate(
        jpn.init_params(jax.random.key(0)))})
    return path


def assert_same_keys(want, got, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            where, set(got) ^ set(want))
        for k in want:
            assert_same_keys(want[k], got[k], f"{where}/{k}")


def close(want, got, tol, what):
    assert abs(got - want) <= tol + 1e-9, (what, got, want)


def test_river_gap_matches_jax(monkeypatch, tmp_path):
    run_jax(monkeypatch, "river_gap",
            ["--iterations", "40", "--subjects", "untrained=INIT",
             "--save", str(tmp_path / "jax.json")])
    got = river_gap.main(
        ["--iterations", "40", "--subjects",
         f"untrained={jax_init_npz(tmp_path)}",
         "--save", str(tmp_path / "port.json")], device="cpu")
    want = json.load(open(tmp_path / "jax.json"))
    assert json.load(open(tmp_path / "port.json")) == got
    assert_same_keys(want, got)
    for b, row in want["boards"].items():
        g = got["boards"][b]
        assert g["sizes"] == row["sizes"] and g["combos"] == row["combos"]
        for k in ("solver_gap_bb", "nash_ev_p1_bb", "nash_ev_p2_bb"):
            close(row[k], g[k], 5e-4, (b, k))
        for name, srow in row["subjects"].items():
            for k, v in srow.items():
                close(v, g["subjects"][name][k],
                      2e-4 if k in NO_SOLVE else 1e-3, (b, name, k))


def test_turn_gap_matches_jax(monkeypatch, tmp_path):
    argv = ["--iterations", "60", "--combo-stride", "48", "--boards",
            "Ks8h5d2c", "--subjects", "es3=data/policy_6max_es3.npz"]
    run_jax(monkeypatch, "turn_gap",
            argv + ["untrained=INIT", "--save", str(tmp_path / "jax.json")])
    narrow(monkeypatch, turn_gap, pt)
    got = turn_gap.main(argv + [f"untrained={jax_init_npz(tmp_path)}",
                                "--save", str(tmp_path / "port.json")],
                        device="cpu")
    want = json.load(open(tmp_path / "jax.json"))
    assert json.load(open(tmp_path / "port.json")) == got
    assert_same_keys(want, got)
    for b, row in want["boards"].items():
        g = got["boards"][b]
        assert (g["sizes"], g["combos"], g["rivers"]) == (
            row["sizes"], row["combos"], row["rivers"])
        for k in ("solver_gap_bb", "nash_ev_p1_bb", "nash_ev_p2_bb"):
            close(row[k], g[k], 5e-4, (b, k))
        for name, srow in row["subjects"].items():
            for k in NO_SOLVE + ("net_p1_vs_nash_bb", "net_p2_vs_nash_bb"):
                close(srow[k], g["subjects"][name][k],
                      2e-4 if k in NO_SOLVE else 1e-3, (b, name, k))


@pytest.mark.parametrize("mode", ["nash", "br"])
def test_distill_nash_matches_jax(monkeypatch, tmp_path, mode):
    """The result file's keys and the subgame metrics that do not depend
    on the distilled weights (the start's gap or edge, the exact BR edge,
    the solver's gap); the distilled numbers are logged, both sides'
    Adam runs being held to each other in tests/test_torch_distill.py."""
    argv = ["--mode", mode, "--start", "data/policy_6max_es7.npz",
            "--combo-stride", "48", "--iterations", "60", "--steps", "10",
            "--batch", "256", "--boards", "Ks8h5d2c"]
    if mode == "br":
        argv += ["--subject", "data/policy_6max_es9.npz"]
    run_jax(monkeypatch, "distill_nash",
            argv + ["--save", str(tmp_path / "jax.npz")])
    narrow(monkeypatch, turn_gap, pt)
    params, got = distill_nash.main(
        argv + ["--save", str(tmp_path / "port.npz")], device="cpu")
    want = json.load(open(tmp_path / "jax.npz.result.json"))
    assert json.load(open(tmp_path / "port.npz.result.json")) == got
    assert_same_keys(want, got)
    assert {k: v for k, v in got.items() if k not in ("boards",
                                                      "elapsed_s")} == {
        k: v for k, v in want.items() if k not in ("boards", "elapsed_s")}
    fixed = (("gap_bb_start", 2e-4), ("gap_bb_solver", 5e-4)) \
        if mode == "nash" else (("exact_br_edge_bb", 2e-4),
                                ("start_edge_bb", 2e-4))
    for b, row in want["boards"].items():
        for k, tol in fixed:
            close(row[k], got["boards"][b][k], tol, (b, k))
    saved = np.load(tmp_path / "port.npz")
    for i, x in enumerate(params):
        np.testing.assert_array_equal(saved[f"p_{i}"], x.numpy())


@pytest.mark.parametrize("name", ["river_gap", "turn_gap", "distill_nash"])
def test_options_are_the_jax_scripts(name):
    mod = importlib.import_module(f"montecarlo_tpu_torch.scripts.{name}")
    actions = {a.dest: a for a in mod.parser()._actions}
    assert actions["save"].required and actions["save"].default is None
    jax_opts = set(re.findall(r'add_argument\("(--[a-z0-9-]+)"',
                              open(f"scripts/{name}.py").read()))
    ours = {o for a in actions.values() for o in a.option_strings
            if o.startswith("--") and o != "--help"}
    assert ours == jax_opts, ours ^ jax_opts
