"""The last ported scripts on the CPU: ``bench_kernel_variants``,
``exp_net_grid``, ``bench_step_parts``, ``exp_hands_levers``,
``check_pop_kernel``, ``check_league_routing`` and ``eval_net_kernel``
(``montecarlo_tpu_torch/scripts/``), each run through its ``main`` with
``--device cpu`` at a small size (the plain versions), their sizes and
kinds held to the JAX scripts' (loaded from their files), and what each
claims about the engine held on the plain versions: ``bench_step_parts``'
guarded settle and deal leave base's state and each ablation changes it
(where the JAX script's ``no_merge`` and ``no_update`` patched names the
engine never read), ``exp_hands_levers``' levers leave the state as base
leaves it. ``validate_tpu`` is ``tests/test_torch_validate_tpu.py``'s.
"""

import ast
import importlib.util
import os
from pathlib import Path

import jax
import pytest
import torch

from montecarlo_tpu_torch.engine import bets as bets_mod
from montecarlo_tpu_torch.engine import step as step_mod
from montecarlo_tpu_torch.engine import street as street_mod
from montecarlo_tpu_torch.engine.state import TableConfig, _tree_map
from montecarlo_tpu_torch.ops import cuda_k1_variants as kv
from montecarlo_tpu_torch.scripts import bench_kernel_variants as bkv
from montecarlo_tpu_torch.scripts import bench_step_parts as bsp
from montecarlo_tpu_torch.scripts import check_league_routing as clr
from montecarlo_tpu_torch.scripts import check_pop_kernel as cpk
from montecarlo_tpu_torch.scripts import eval_net_kernel as enk
from montecarlo_tpu_torch.scripts import exp_hands_levers as ehl
from montecarlo_tpu_torch.scripts import exp_net_grid as eng

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")


def _load_script(name):
    """A JAX script from ``scripts/``; its import points JAX's compile cache
    at its TPU directory and makes that directory: both are undone."""
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    makedirs = os.makedirs
    os.makedirs = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(
            f"reference_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.makedirs = makedirs
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _argparse_defaults(name, names=None):
    """``--flag`` -> default of every ``add_argument`` in a JAX script's
    source (the defaults evaluated as Python expressions over ``names``)."""
    out = {}
    for node in ast.walk(ast.parse((ROOT / "scripts" / f"{name}.py")
                                   .read_text())):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            for kw in node.keywords:
                if kw.arg == "default":
                    out[node.args[0].value] = eval(compile(
                        ast.Expression(kw.value), name, "eval"),
                        dict(names or {}))
    return out


def _equal(a, b):
    flat = []
    _tree_map(lambda x, y: flat.append(torch.equal(x, y)), a, b)
    return all(flat)


def test_sizes_and_kinds_are_the_jax_scripts():
    theirs = _load_script("exp_net_grid")
    assert (eng.N_STEPS, eng.REPS) == (theirs.N_STEPS, theirs.REPS)
    assert len(eng.keys()) == 14 and eng.keys()[:3] == [
        "net[standard,2^16,reset]", "engine[standard,2^16]",
        "net[standard,2^18,reset]"]
    assert "net[reference,2^18,noreset]" in eng.keys()
    theirs = _load_script("exp_hands_levers")
    assert (ehl.N_TABLES, ehl.N_STEPS) == (theirs.N_TABLES, theirs.N_STEPS)
    theirs = _load_script("bench_kernel_variants")
    assert tuple(theirs.VARIANTS) == kv.VARIANTS
    d = _argparse_defaults("bench_kernel_variants",
                           {"VARIANTS": theirs.VARIANTS})
    ours = {a.option_strings[0]: a.default for a in bkv.parser()._actions
            if a.option_strings}
    for flag in ("--n", "--variants", "--tiles", "--tile_variant"):
        assert ours[flag] == d[flag], flag
    d = _argparse_defaults("bench_step_parts")
    assert (d["--tables"], d["--steps"], d["--L"], d["--PL"]) == (
        1 << 20, 64, 12, 24)
    kinds = {n.value for n in ast.walk(ast.parse(
        (ROOT / "scripts" / "bench_step_parts.py").read_text()))
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
        and (n.value.startswith("no_") and n.value != "no_"
             or n.value in bsp.KINDS)}
    assert kinds <= set(bsp.KINDS + bsp.ABLATIONS)
    assert set(d["--kinds"].split(",")) <= set(bsp.KINDS)
    assert _argparse_defaults("eval_net_kernel") == {"--tables": 1 << 16,
                                                     "--steps": 512}
    assert (cpk.N_TABLES, cpk.N_STEPS, cpk.SEED) == (4096, 256, 314)
    assert (clr.N_TABLES, clr.N_STEPS, clr.SEED) == (1 << 14, 256, 991)


def test_bench_kernel_variants_main_cpu(tmp_path):
    out = tmp_path / "variants.json"
    r = bkv.main(["--n", str(1 << 14), "--tiles", "512x16,1024x4",
                  "--runs", "1", "--device", "cpu", "--save", str(out)])
    assert set(r["runs"]) == set(kv.VARIANTS) | {
        "current tile=512x16", "current tile=1024x4"}
    assert [labels for labels, _ in r["classes"]][0][-2:] == [
        "current tile=512x16", "current tile=1024x4"]
    assert all(ok for _, ok in r["classes"]) and out.is_file()
    for v in kv.EXACT_CLASS:
        line = r["runs"][v]
        assert abs(line["eq"] - 0.4587) < 5 * line["stderr"], v


def test_exp_net_grid_main_cpu(tmp_path):
    out = tmp_path / "grid.json"
    r = eng.main(["--log2-tables", "10", "--steps", "16", "--reps", "1",
                  "--device", "cpu", "--save", str(out)])
    assert list(r) == eng.keys([10]) and out.is_file()
    assert all(v > 0 for v in r.values())


def test_bench_step_parts_main_cpu_and_prng_refused():
    kinds = ",".join(bsp.KINDS + bsp.ABLATIONS)
    r = bsp.main(["--tables", "256", "--steps", "8", "--runs", "1",
                  "--kinds", kinds, "--device", "cpu"])
    assert list(r) == kinds.split(",")
    with pytest.raises(SystemExit):
        bsp.main(["--prng", "rbg", "--device", "cpu"])


CFG = TableConfig(num_seats=6)


@pytest.fixture(scope="module")
def base_final():
    return bsp.run_kind("base", CFG, 256, 32, "cpu", runs=1)[1]


@pytest.mark.parametrize("kind", ["settle", "deal", "both"])
def test_guarded_pieces_leave_base_state(base_final, kind):
    """The settle and deal kept only where time < 0 are never taken: the
    final state is base's."""
    final = bsp.run_kind(kind, CFG, 256, 32, "cpu", runs=1)[1]
    assert _equal(final, base_final)


@pytest.mark.parametrize("kind", ["table", "const_action", "policy_only",
                                  "carry_only"])
def test_other_kinds_do_other_work(base_final, kind):
    final = bsp.run_kind(kind, CFG, 256, 32, "cpu", runs=1)[1]
    assert not _equal(final, base_final)


@pytest.mark.parametrize("ablation", bsp.ABLATIONS)
def test_each_ablation_changes_the_state(base_final, ablation):
    """Every ablation takes effect (the JAX script's no_merge and no_update
    did not), and the names are restored after the run."""
    originals = {"merge_bets": street_mod.merge_bets,
                 "update_bets": street_mod.update_bets,
                 "append_layers": step_mod.append_layers,
                 "stage_transition": step_mod.stage_transition}
    final = bsp.run_kind(ablation, CFG, 256, 32, "cpu", runs=1)[1]
    assert not _equal(final, base_final)
    assert street_mod.merge_bets is bets_mod.merge_bets is \
        originals["merge_bets"]
    assert street_mod.update_bets is bets_mod.update_bets is \
        originals["update_bets"]
    assert step_mod.append_layers is originals["append_layers"]
    assert step_mod.stage_transition is originals["stage_transition"]


def test_jax_ablation_sites_are_not_read_here():
    """The JAX script's no_merge / no_update targets: the port's engine/
    step.py has no such names to patch, street.py reads them."""
    assert not hasattr(step_mod, "merge_bets")
    assert not hasattr(step_mod, "update_bets")
    assert hasattr(street_mod, "merge_bets")
    assert set(bsp.PATCHES) == set(bsp.ABLATIONS)


def test_exp_hands_levers_states_and_main(tmp_path):
    """body2 is base's work in loops of two actions, and the 6-layer caps
    give base's state where no latch is set."""
    c8 = TableConfig(num_seats=6, max_layers=8, max_pot_layers=16)
    c6 = TableConfig(num_seats=6, max_layers=6, max_pot_layers=12)
    base = ehl.perpetual(0, c8, 32, 1, 256, "cpu")
    assert _equal(ehl.perpetual(0, c8, 32, 2, 256, "cpu"), base)
    caps = ehl.perpetual(0, c6, 32, 1, 256, "cpu")
    assert not bool((caps.bets.overflow | caps.pots.overflow).any())
    for f in base._fields:
        if f not in ("bets", "pots"):
            assert torch.equal(getattr(caps, f), getattr(base, f)), f
    for a, b in ((caps.bets, base.bets), (caps.pots, base.pots)):
        live = torch.arange(a.capacity)[None] < a.count[:, None]
        assert torch.equal(a.count, b.count)
        for f in ("amt", "mem", "orig", "n"):
            x, y = getattr(a, f), getattr(b, f)[:, :a.capacity]
            assert torch.equal(torch.where(live, x, 0),
                               torch.where(live, y, 0)), f
    out = tmp_path / "levers.json"
    r = ehl.main(["--tables", "256", "--steps", "8", "--runs", "1",
                  "--device", "cpu", "--save", str(out)])
    assert list(r) == [v for v, _, _ in ehl.VARIANTS] and out.is_file()
    assert all(line["overflowed"] == 0 for line in r.values())


def test_check_pop_kernel_cpu():
    r = cpk.main(["--tables", "1024", "--steps", "16", "--device", "cpu"])
    assert r["ok"] and len(r["candidates"]) == 4
    assert all(c["hands_pop"] > 0 for c in r["candidates"])


def test_check_league_routing_cpu():
    r = clr.main(["--tables", "1024", "--steps", "256", "--device", "cpu"])
    assert r["ok"]
    assert r["call_at_seat0_vs_raisers"][0] > 0 > \
        r["raise_at_seat0_vs_callers"][0]


def test_eval_net_kernel_cpu():
    r = enk.main(["--tables", "1024", "--steps", "16", "--device", "cpu"])
    assert set(r) == {"trained", "untrained"}
    for line in r.values():
        assert line["hands"] > 0 and len(line["per_seat_bb"]) == 6
        assert abs(sum(line["per_seat_bb"])) < 1e-9
