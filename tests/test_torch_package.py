"""Package-level properties of the port: no JAX at runtime, the shared
encodings, and no silent CPU fallback where a card was asked for."""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import montecarlo_tpu_torch.actions as tactions
import montecarlo_tpu_torch.cards as tcards
import montecarlo_tpu_torch.handval as thandval
from montecarlo_tpu import actions, cards, handval
from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu.models import features as jfeatures
from montecarlo_tpu.models import policy_net as jpolicy_net
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import bots, pushfold, train_es
from montecarlo_tpu_torch.models import features as tfeatures
from montecarlo_tpu_torch.models import policy_net as tpolicy_net
from montecarlo_tpu_torch.ops import cuda_carry as cc
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.ops import cuda_stages as cs
from montecarlo_tpu_torch.ops import evaluator as tev
from montecarlo_tpu_torch.ops import philox
from montecarlo_tpu_torch.rollout import equity as teq
from montecarlo_tpu_torch.rollout import evaluate as tev_
from montecarlo_tpu_torch.rollout import policy as tpol
from montecarlo_tpu_torch.rollout import selfplay as tsp
from montecarlo_tpu_torch.scripts import build_pushfold_cr as bpc
from montecarlo_tpu_torch.scripts import debug_kernel_compile as dkc
from montecarlo_tpu_torch.scripts import exp_carry_model as ecm

ROOT = Path(__file__).resolve().parent.parent
MODULES = [
    "montecarlo_tpu_torch",
    "montecarlo_tpu_torch.cards",
    "montecarlo_tpu_torch.handval",
    "montecarlo_tpu_torch.device",
    "montecarlo_tpu_torch.actions",
    "montecarlo_tpu_torch.engine",
    "montecarlo_tpu_torch.engine.bets",
    "montecarlo_tpu_torch.engine.street",
    "montecarlo_tpu_torch.engine.state",
    "montecarlo_tpu_torch.engine.step",
    "montecarlo_tpu_torch.engine.public",
    "montecarlo_tpu_torch.engine.replay",
    "montecarlo_tpu_torch.ops._build",
    "montecarlo_tpu_torch.ops.evaluator",
    "montecarlo_tpu_torch.ops.philox",
    "montecarlo_tpu_torch.ops.cuda_equity",
    "montecarlo_tpu_torch.ops.cuda_engine",
    "montecarlo_tpu_torch.ops.cuda_net",
    "montecarlo_tpu_torch.ops.cuda_carry",
    "montecarlo_tpu_torch.ops.cuda_stages",
    "montecarlo_tpu_torch.models.features",
    "montecarlo_tpu_torch.models.policy_net",
    "montecarlo_tpu_torch.models.bots",
    "montecarlo_tpu_torch.models.train_es",
    "montecarlo_tpu_torch.models.pushfold",
    "montecarlo_tpu_torch.models",
    "montecarlo_tpu_torch.rollout",
    "montecarlo_tpu_torch.rollout.equity",
    "montecarlo_tpu_torch.rollout.policy",
    "montecarlo_tpu_torch.rollout.selfplay",
    "montecarlo_tpu_torch.rollout.evaluate",
    "montecarlo_tpu_torch.scripts",
    "montecarlo_tpu_torch.scripts.exp_carry_model",
    "montecarlo_tpu_torch.scripts.debug_kernel_compile",
    "montecarlo_tpu_torch.scripts.build_pushfold_cr",
    "montecarlo_tpu_torch.scripts.count_engine_ops",
    "montecarlo_tpu_torch.scripts.time_step_table",
    "montecarlo_tpu_torch.models.cma",
    "montecarlo_tpu_torch.models.leash",
    "montecarlo_tpu_torch.models.train",
    "montecarlo_tpu_torch.scripts.league_eval",
    "montecarlo_tpu_torch.scripts.exploit_probe",
    "montecarlo_tpu_torch.scripts.opt_bot",
    "montecarlo_tpu_torch.scripts.train_es_kernel",
    "montecarlo_tpu_torch.scripts.train_policy",
    "montecarlo_tpu_torch.scripts.train_br",
    "montecarlo_tpu_torch.scripts.exp_leak_anatomy",
    "montecarlo_tpu_torch.scripts.fold_gate_check",
    "montecarlo_tpu_torch.scripts.policy_diff",
    "montecarlo_tpu_torch.scripts.make_fold_anchor",
    "montecarlo_tpu_torch.scripts.eval_attacker",
    "montecarlo_tpu_torch.scripts.train_mix",
]
# The ported training, exploitability and analysis scripts
# (``montecarlo_tpu_torch/scripts/<name>.py`` beside ``scripts/<name>.py``,
# every function and constant kept).
SCRIPTS = ["league_eval", "exploit_probe", "opt_bot", "train_es_kernel",
           "train_policy", "train_br", "exp_leak_anatomy", "fold_gate_check",
           "policy_diff", "make_fold_anchor", "eval_attacker", "train_mix"]
# Runs the port's CPU path (equity and multiway equity, range equity and
# push/fold, the table engine's step and host view, self-play under every
# rule set, a net policy in a duplicate match, the net pipeline's replay,
# the engine kernels' plain versions under every rule set, tournaments to completion,
# net evaluation, an ES generation on the population form with a rule
# bot's league, the two ported probe scripts) in a fresh process, then
# lists what it loaded of JAX and of the JAX package.
CPU_PATH = """
import json, sys
import torch
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import bots, train_es
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.ops import cuda_engine as ce, cuda_net as cn
from montecarlo_tpu_torch.rollout import equity as teq
torch.set_num_threads(1)
r = teq.equity_vs_hand(1, [0, 12], [25, 38], 4096, device="cpu")
assert r.n == 4096
eq, n = teq.equity_multiway(1, [[0, 12], [25, 38], [5, 6]], 4096,
                            device="cpu")
assert n == 4096 and abs(eq.sum() - 1) < 1e-12
from montecarlo_tpu_torch.models import pushfold as pf
qk = teq.expand_range(["QQ", "KK"])
assert teq.equity_vs_range(1, [0, 12], qk, 4096, device="cpu").n == 4096
assert teq.sample_distinct(1, 48, 5, 64, device="cpu").shape == (64, 5)
r = teq.equity_exact_range_vs_range(qk, teq.expand_range(["AKs"]),
                                    board=[1, 2, 3, 4], device="cpu")
assert 0 < r.equity < 1
assert pf.matchup_equity_matrix(1, n_per=2, device="cpu").shape == (169, 169)
import numpy as np
with np.load("data/pushfold_eq169_cr.npz") as d:
    sol = pf.solve_push_fold_cr(d["equity"], d["n_pairs"], 10.0)
assert round(sol.jam_fraction, 4) == 0.5825
from montecarlo_tpu_torch.engine import public as ep, state as es, step as est
for rules in ("reference", "standard", "tournament"):
    cfg = TableConfig(num_seats=6, rules=rules)
    st = es.init_state(3, cfg, 16, device="cpu")
    st = est.step_table(st, est.clamp_action(st, 0), rules=rules)
    assert int(st.time.sum()) == 16
    assert ep.public_board(st, list("abcdef"), 1)["time"] == 1
    assert ce.selfplay_perpetual_kernel(2, cfg, 1024, 32, device="cpu")[1] > 0
from montecarlo_tpu_torch.rollout import evaluate as ev, policy as pol, \
    selfplay as sp
from montecarlo_tpu_torch.engine import replay as rp
from montecarlo_tpu_torch.models.policy_net import net_policy
for rules in ("reference", "standard"):
    cfg = TableConfig(num_seats=6, rules=rules)
    assert int(sp.play_hands_perpetual(3, cfg, 16, 40, device="cpu")[1]) > 0
    assert bool(sp.play_hands(3, cfg, 16, device="cpu").hand_over.all())
tour = TableConfig(num_seats=3, rules="tournament", starting_stack=20)
assert sp.play_tournament(3, tour, 16, 60, device="cpu")[1].min() < 60
hu = load_params("data/policy_hu_300.npz")
assert ev.duplicate_match(3, net_policy(hu), pol.random_policy, 16,
                          device="cpu").n_tables == 16
std6 = TableConfig(num_seats=6, rules="standard")
st0 = es.init_state(3, std6, 16, device="cpu")
decks = st0.deck[:, None].expand(16, 2, 52)
rep = rp.replay_net_det(std6, st0, [bots.panel()["fof_raise"]], None, decks, 8)
assert rep.state.time.shape == (16,)
tour = TableConfig(num_seats=6, rules="tournament", starting_stack=20)
state, _ = ce.tournaments_to_completion(2, tour, 1024, 64, device="cpu")
assert ce.tournament_results(state, tour)[1].all()
std = TableConfig(num_seats=6, rules="standard")
es3 = load_params("data/policy_6max_es3.npz")
means, errs, hands = cn.selfplay_net_eval_kernel(2, std, es3, 1, 1024, 32,
                                                 device="cpu")
assert hands > 0 and means.shape == (6,)
pool = train_es.kernel_pool_eval_pop_fn(
    std, [None, bots.panel()["fof_raise"]], n_tables=1024, n_steps=16,
    device="cpu")
out = train_es.train_es(2, es3, eval_pop_fn=pool, generations=1, pop=1)
assert out.hands_total > 0
from montecarlo_tpu_torch.scripts import debug_kernel_compile, exp_carry_model
assert len(exp_carry_model.main(device="cpu", n_blocks=1, n_steps=2)) == 19
for stage in debug_kernel_compile.STAGES:
    debug_kernel_compile.compile_variant(stage, 2, 1, device="cpu")
from montecarlo_tpu_torch.models import train as tr
from montecarlo_tpu_torch.rollout.policy import always_call
out = tr.train_policy(1, cfg=TableConfig(num_seats=2, rules="standard"),
                      opponent=always_call, tables=16, steps=1, max_steps=8,
                      device="cpu")
assert out.mean_reward_bb.shape == (1,)
from montecarlo_tpu_torch.models.cma import CMAES
from montecarlo_tpu_torch.models.leash import make_anchor_score
es = CMAES([0.0, 0.0], 0.5, popsize=4)
es.tell(-(es.ask() ** 2).sum(1))
assert make_anchor_score("data/fold_anchor.npz")[0](es3) < 0
from montecarlo_tpu_torch.scripts import exp_leak_anatomy as ela
_, recs = ela.collect(3, std, 4, es3, es3, 4, device="cpu")
assert ela.flatten_recs(recs)[0].shape == (16, 24)
print(json.dumps(sorted(k for k in sys.modules if k == "jax"
                        or k.startswith(("jax.", "montecarlo_tpu."))
                        or k == "montecarlo_tpu")))
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith(('jax.', 'montecarlo_tpu.')) "
            "or k == 'montecarlo_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_cpu_path_loads_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", CPU_PATH], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _public(module):
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and not callable(v)
            and not isinstance(v, type(sys))}


def test_ported_modules_hold_every_public_name_of_jax():
    """The self-play, policy, evaluation, REINFORCE, CMA-ES and leash
    modules define every public name their JAX counterparts define, each
    ported script every function and constant of its JAX twin; the net
    modules the table-engine forms."""
    import importlib

    for name in ("rollout.policy", "rollout.selfplay", "rollout.evaluate"):
        theirs = importlib.import_module("montecarlo_tpu." + name)
        ours = importlib.import_module("montecarlo_tpu_torch." + name)
        names = {k for k, v in vars(theirs).items() if not k.startswith("_")
                 and getattr(v, "__module__", None) == theirs.__name__}
        assert names and names <= set(vars(ours)), names - set(vars(ours))
    for name in ("models.cma", "models.leash", "models.train"):
        theirs = importlib.import_module("montecarlo_tpu." + name)
        ours = importlib.import_module("montecarlo_tpu_torch." + name)
        names = {k for k, v in vars(theirs).items() if not k.startswith("_")
                 and getattr(v, "__module__", None) == theirs.__name__}
        names |= {k for k in ("CLIP_LOG_P",) if hasattr(theirs, k)}
        assert names and names <= set(vars(ours)), names - set(vars(ours))
    # the ported scripts: every function and constant of the JAX script
    # (its private helpers too: other scripts import them)
    for name in SCRIPTS:
        path = ROOT / "scripts" / f"{name}.py"
        ours = importlib.import_module("montecarlo_tpu_torch.scripts." + name)
        tree = ast.parse(path.read_text())
        theirs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        theirs |= {t.id for n in tree.body if isinstance(n, ast.Assign)
                   for t in n.targets if isinstance(t, ast.Name)
                   and not t.id.startswith("_I") and t.id != "I32"}
        assert theirs <= set(vars(ours)), (name, theirs - set(vars(ours)))
    for mod, names in ((tfeatures, ("state_features", "features")),
                       (tpolicy_net, ("action_from_index", "net_policy",
                                      "save_params", "load_params"))):
        assert all(callable(getattr(mod, n)) for n in names)


def test_shared_encodings_and_table_config_match_jax():
    import montecarlo_tpu_torch

    assert not hasattr(montecarlo_tpu_torch, "__getattr__")
    # the port's copies: every public name, values and functions alike
    for ours, theirs in ((tcards, cards), (thandval, handval),
                         (tactions, actions)):
        names = {k for k in vars(theirs) if not k.startswith("_")
                 and not isinstance(vars(theirs)[k], type(sys))}
        assert names <= set(vars(ours)), names - set(vars(ours))
        assert _public(ours) == _public(theirs)
    for c in range(52):
        assert tcards.card_name(c) == cards.card_name(c)
        assert tcards.card_suit(c) == cards.card_suit(c)
        assert tcards.card_rank(c) == cards.card_rank(c)
    for key in (0x812345, 0x5EDCBA, 0x100000, 0x0E9876):
        assert thandval.unpack_value(key) == handval.unpack_value(key)
        assert thandval.describe(key) == handval.describe(key)
    assert thandval.pack_value(3, [9, 9, 9], [14, 2]) == \
        handval.pack_value(3, [9, 9, 9], [14, 2])
    assert tfeatures.NUM_FEATURES == jfeatures.NUM_FEATURES
    assert tpolicy_net.NUM_ACTIONS == jpolicy_net.NUM_ACTIONS
    assert tpolicy_net.MLPParams._fields == jpolicy_net.MLPParams._fields
    assert tev.NUM_RANKS == cards.NUM_RANKS
    assert teq.NUM_CARDS == cards.NUM_CARDS
    assert tev.CAT_SHIFT == handval.CAT_SHIFT
    for name in ("CAT_HIGH", "CAT_PAIR", "CAT_TWO_PAIR", "CAT_TRIPS",
                 "CAT_STRAIGHT", "CAT_FLUSH", "CAT_FULL_HOUSE", "CAT_QUADS",
                 "CAT_STRAIGHT_FLUSH"):
        assert getattr(tev, name) == getattr(handval, name), name
    assert all(teq.make_card(s, r) == cards.make_card(s, r)
               for s in range(4) for r in range(2, 15))
    ours = [(f.name, f.default) for f in dataclasses.fields(TableConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxTableConfig)]
    assert ours == theirs


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the wrappers launch kernels here")
    from montecarlo_tpu_torch.device import cuda_device

    with pytest.raises(RuntimeError):
        cuda_device()
    with pytest.raises((RuntimeError, AssertionError)):
        teq.equity_vs_hand(0, [0, 1], [2, 3], 1024, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        cq.equity_sweep_kernel(0, [[0, 1]], 1024, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        teq.equity_multiway(0, [[0, 1], [2, 3]], 1024, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        teq.sample_distinct(0, 48, 5, 1024, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        teq.equity_vs_range(0, [0, 1], [[2, 3], [4, 5]], 1024,
                            device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        teq.equity_exact_range_vs_range([[0, 1]], [[2, 3]], board=[4, 5, 6],
                                        device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        teq.equity_exact_vs_range([0, 1], [[2, 3]], board=[4, 5, 6],
                                  device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        pushfold.matchup_equity_matrix(0, n_per=2, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        pushfold.matchup_equity_matrix_exact(device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        tev.every_hand_keys(8, device="cuda")
    cfg = TableConfig(num_seats=6)
    with pytest.raises((RuntimeError, AssertionError)):
        ce.selfplay_perpetual_kernel(0, cfg, 1024, 16, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        tsp.play_hands_perpetual(0, cfg, 16, 2, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        tev_.duplicate_match(0, tpol.always_call, tpol.always_call, 16,
                             device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        philox.philox_blocks(torch.zeros((1, 6), dtype=torch.int64,
                                         device="cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        cn.selfplay_net_eval_kernel(
            0, TableConfig(num_seats=6, rules="standard"),
            tpolicy_net.load_params(ROOT / "data" / "policy_6max_es3.npz"),
            1, 1024, 16, device="cuda")
    assert all(v == 0 for v in {**cq.LAUNCHES, **ce.LAUNCHES, **cn.LAUNCHES,
                                **philox.LAUNCHES}.values())


STD = TableConfig(num_seats=6, rules="standard")
ENTRY_POINTS = {
    "equity_vs_hand": lambda: teq.equity_vs_hand(0, [0, 1], [2, 3], 1024),
    "equity_vs_random": lambda: teq.equity_vs_random(0, [0, 1], 1024),
    "equity_exact": lambda: teq.equity_exact([0, 1], [2, 3], [4, 5, 6, 7]),
    "equity_sweep_kernel": lambda: cq.equity_sweep_kernel(0, [[0, 1]], 1024),
    "equity_multiway": lambda: teq.equity_multiway(
        0, [[0, 1], [2, 3], [4, 5]], 1024),
    "equity_multiway_kernel": lambda: cq.equity_multiway_kernel(
        0, [[0, 1], [2, 3]], 1024, [7, 8, 9]),
    "tournaments_to_completion": lambda: ce.tournaments_to_completion(
        0, TableConfig(num_seats=6, rules="tournament"), 1024),
    "selfplay_perpetual_kernel": lambda: ce.selfplay_perpetual_kernel(
        0, TableConfig(num_seats=6), 1024, 16),
    "selfplay_net_eval_kernel": lambda: cn.selfplay_net_eval_kernel(
        0, STD, tpolicy_net.load_params(ROOT / "data" /
                                        "policy_6max_es3.npz"), 1, 1024, 16),
    "selfplay_net_league": lambda: cn.selfplay_net_league(
        0, STD, [bots.action_bot(1)] * 2, (0, 1) * 3, 1024, 16),
    "selfplay_net_eval_pop": lambda: cn.selfplay_net_eval_pop(
        0, STD, [bots.action_bot(1)] * 2, 1, 1024, 16),
    "selfplay_net_league_pop": lambda: cn.selfplay_net_league_pop(
        0, STD, [bots.action_bot(1)] * 2, bots.action_bot(3), 1024, 16),
    "train_es": lambda: train_es.train_es(
        0, bots.action_bot(1), generations=1, pop=1,
        eval_pop_fn=train_es.kernel_eval_pop_fn(STD, 1, 1024, 16)),
    "initial_packed_state": lambda: cn.initial_packed_state(0, STD, 1024),
    "init_state": lambda: tstate.init_state(0, TableConfig(num_seats=6),
                                            1024),
    "play_hands": lambda: tsp.play_hands(0, TableConfig(num_seats=6), 16),
    "play_hands_perpetual": lambda: tsp.play_hands_perpetual(
        0, TableConfig(num_seats=6), 16, 2),
    "play_tournament": lambda: tsp.play_tournament(
        0, TableConfig(num_seats=6, rules="tournament"), 16, 2),
    "policy_key": lambda: tpol.policy_key(0, 16, tpol.SUB_HANDS),
    "duplicate_match": lambda: tev_.duplicate_match(
        0, tpol.always_call, tpol.tight_policy, 16),
    "duplicate_match_multihand": lambda: tev_.duplicate_match_multihand(
        0, tpol.always_call, tpol.tight_policy, 16, 2),
    "deal_stash": lambda: cn.deal_stash(0, 1024, 6, 2),
    "exp_carry_model.main": lambda: ecm.main(n_blocks=1, n_steps=2),
    "sample_distinct": lambda: teq.sample_distinct(0, 48, 5, 1024),
    "equity_vs_range": lambda: teq.equity_vs_range(
        0, [0, 1], teq.expand_range(["QQ"]), 1024),
    "equity_exact_range_vs_range": lambda: teq.equity_exact_range_vs_range(
        [[0, 1]], [[2, 3]], board=[4, 5, 6]),
    "equity_exact_vs_range": lambda: teq.equity_exact_vs_range(
        [0, 1], [[2, 3]], board=[4, 5, 6]),
    "matchup_equity_matrix": lambda: pushfold.matchup_equity_matrix(
        0, n_per=2),
    "matchup_equity_matrix_exact": lambda:
        pushfold.matchup_equity_matrix_exact(),
    "matchup_equity_matrix_cr": lambda: pushfold.matchup_equity_matrix_cr(),
    "every_hand_keys": lambda: tev.every_hand_keys(8),
    "build_pushfold_cr.main": lambda: bpc.main(
        ["--out", str(ROOT / "montecarlo_tpu_torch" / "_build" / "pf")]),
    "debug_kernel_compile.compile_variant": lambda: dkc.compile_variant(
        "full", 2, 1),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Without a ``device``, an entry point runs on the card: with none
    present it raises rather than run the plain version on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
    assert all(v == 0 for v in {**cq.LAUNCHES, **ce.LAUNCHES, **cn.LAUNCHES,
                                **philox.LAUNCHES, **cc.LAUNCHES,
                                **cs.LAUNCHES}.values())


def test_build_splits_the_sources_by_seat_count():
    """The library without a seat count, a seat count's library and the
    probes' own builds hold every ``csrc/*.cu`` between them, once; a seat
    count's sources get its MC_SEATS, and seat counts outside 2..10 are
    refused."""
    from montecarlo_tpu_torch.ops import _build

    common, none = _build._sources(None)
    seat, defines = _build._sources(6)
    probe = [_build.CSRC / name for name in _build.PROBE_SOURCES]
    assert none == [] and defines == ["-DMC_SEATS=6"]
    assert all(f.is_file() for f in probe)
    assert sorted(common + seat + probe) == sorted(_build.CSRC.glob("*.cu"))
    assert not set(common) & set(seat)
    assert not (set(common) | set(seat)) & set(probe)
    for bad in (1, 11):
        with pytest.raises(ValueError):
            _build._sources(bad)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = _clean_env()
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert here.returncode != 0 and '"ok": true' not in here.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env.pop("PYTHONPATH")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert alone.returncode != 0 and '"ok": true' not in alone.stdout
