"""``montecarlo_tpu_torch/scripts/validate_tpu.py`` on the CPU: the checks
that a CPU can run at a small size, on the plain versions (K3 against the
plain engine on two injected streams, K4's slots a hand and position
deltas against the plain perpetual engine, chip conservation under
standard rules, the trained net against the untrained one, the population
and league forms exact, bank routing, K5 against the plain net pipeline,
and the equity section's kernels against their plain paths), each at its
gate. Tournaments to completion and the mesh (which starts a process
group) run on the card only. The JAX script's constants are held to the
port's.
"""

import importlib.util
import os
from pathlib import Path

import jax
import torch

from montecarlo_tpu_torch.scripts import validate_tpu as vt

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _load_jax_script():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    makedirs = os.makedirs
    os.makedirs = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_validate_tpu", ROOT / "scripts" / "validate_tpu.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.makedirs = makedirs
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def test_constants_are_the_jax_scripts():
    theirs = _load_jax_script()
    assert (vt.H, vt.D, vt.S, vt.C, vt.N) == (theirs.H, theirs.D, theirs.S,
                                              theirs.C, theirs.N)
    assert [(n, [int(c) for c in h], [int(c) for c in v], a)
            for n, h, v, a in theirs.MATCHUPS] == vt.MATCHUPS


def test_engine_checks_pass_on_the_plain_versions():
    cpu = vt.torch.device("cpu")
    cfg = vt.TableConfig(num_seats=6, max_layers=8, max_pot_layers=16)
    assert vt._check_det(1024, 24, cpu) == 0
    assert vt._check_prng(cfg, 1024, 256, cpu) == 0
    assert vt._check_standard(1024, cpu) == 0
    assert vt._check_policy_net(1024, 64, cpu) == 0


def test_det_check_sees_a_broken_stream():
    """The det check fails when the engine replays another stream than
    K3's (the plain versions of both, one step's actions changed)."""
    cfg = vt.TableConfig(num_seats=6, bets_impl="levels")
    acts, cards = vt.injected_stream(23, 1024, 8, 0.08, "cpu")
    out, agree, rep = vt.det_against_engine(cfg, acts, cards, 8)
    assert not any(bool(b.any()) for b in agree.mismatch.values())
    other = vt.ce.run_perpetual_det(
        vt.ce.pack_state(cfg, vt.ce._stash_rows(cards).permute(2, 0, 1)[:, 0]),
        torch.where(acts == 0, -1, acts), cards, 6, 8, 5, 10)
    bad = vt.erp.against_k3(other, vt.TableConfig(
        num_seats=6, max_layers=12, max_pot_layers=48, bets_impl="levels"),
        rep)
    assert any(bool(b.any()) for b in bad.mismatch.values())


def test_net_checks_pass_on_the_plain_versions():
    assert vt.check_net_kernels("cpu", 1024, 64) == 0
    assert vt.check_net_det("cpu", 1024, 24) == 0


def test_equity_checks_pass_on_the_plain_versions():
    cpu = vt.torch.device("cpu")
    assert vt._check_sweep(1 << 16, cpu) == 0
    assert vt._check_flop(1 << 20, cpu) == 0
    assert vt._check_multiway(1 << 19, cpu) == 0
    assert vt._check_matchups(1 << 17, cpu) == 0
