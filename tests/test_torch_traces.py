"""The port's table engine against the conformance anchors of the JAX
package: the pure-Python oracle (``tests/oracle_engine.py``, as
``tests/test_conformance.py`` drives it) and every committed trace of
``tests/golden/`` that the JAX tests replay through the engine.

The port regenerates each trace with its own functions and compares with
the committed ``.jsonl`` (the JAX generator, ``scripts/dump_golden_traces.py``,
is not run). Where a trace was made from a seeded JAX deck, that deck (the
threefry permutation the JAX ``begin_hand`` draws) is injected with
``redeal``: the port's own decks come from Philox. Tolerance 0 throughout.
"""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.engine import (
    TableConfig,
    clamp_action,
    head_info,
    init_state,
    next_hand,
    public_board,
    redeal,
    settle_showdown,
    step_action,
    step_table,
)
from test_torch_rules import bets_spec, layers_spec, seats, stacks
from tests.oracle_engine import OracleGame
from tests.test_conformance import gen_action, oracle_snapshot
from tests.test_derived_extensions import (
    DECK_SIDEPOT,
    DECK_TOURN_H1,
    DECK_TOURN_H2,
)
from tests.test_derived_traces import (
    DECK_3WAY_H1,
    DECK_3WAY_H2,
    FOLD_MERGE_SCRIPT,
    HEADS_UP_SCRIPT,
    IDENTITY,
    REV_BLINDS_SCRIPT,
    THREE_WAY_H1,
    THREE_WAY_H2,
    drive_oracle,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def one_table(n, seed=0, **kw):
    return init_state(seed, TableConfig(num_seats=n, **kw), 1, "cpu")


def deal(st, deck):
    return redeal(st, torch.tensor([list(deck)], dtype=torch.int32))


def load(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


def assert_trace(got, want, who):
    assert len(got) == len(want), (who, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        g = json.loads(json.dumps(g, sort_keys=True))
        assert g == w, f"{who} state {i}: {g} != {w}"


# ---- the oracle (tests/test_conformance.py) -----------------------------

def port_snapshot(st):
    over = bool(st.hand_over[0])
    return {
        "bets": bets_spec(st),
        "pots": layers_spec(st.pots),
        "stacks": stacks(st),
        "in_hand": seats(st.in_hand),
        "remaining": seats(st.to_act),
        "stage": int(st.stage[0]),
        "time": int(st.time[0]),
        "n_revealed": int(st.n_community[0]),
        "head": None if over else int(head_info(st)[0][0]),
        "over": over,
    }


@pytest.mark.parametrize("n_seats,seed", [
    (2, 0), (2, 1), (3, 2), (3, 3), (3, 4), (4, 5), (4, 6), (6, 7), (6, 8),
    (6, 9), (3, 10), (6, 11), (2, 12), (4, 13), (6, 14), (8, 15), (9, 16),
    (2, 20), (3, 21), (6, 22), (6, 23), (9, 24)])
def test_random_game_trajectory_equals_oracle(n_seats, seed):
    """Random games (folds, calls, exact all-ins, over-raises) through the
    port and the oracle: every public state equal, then the settled
    stacks and pots (the cases of test_random_game_trajectory and
    test_random_game_trajectory_levels)."""
    rng = random.Random(seed)
    deck = list(range(52))
    rng.shuffle(deck)
    st = deal(one_table(n_seats, seed, max_layers=24, max_pot_layers=64),
              deck)
    g = OracleGame(n=n_seats, small=5, big=10, deck=deck)
    assert port_snapshot(st) == oracle_snapshot(g)
    for step in range(300):
        if g.over:
            break
        raw = gen_action(rng, g)
        a = int(clamp_action(st, raw)[0])
        assert a == g.clamp(raw), (step, raw)
        st = step_action(st, a)
        g.act(a)
        assert not bool(st.bets.overflow[0] | st.pots.overflow[0])
        assert port_snapshot(st) == oracle_snapshot(g), f"step {step}"
    else:
        pytest.fail("game did not terminate in 300 actions")
    st = settle_showdown(st)
    g.settle()
    assert stacks(st) == g.stacks
    assert layers_spec(st.pots) == oracle_snapshot(g)["pots"]


@pytest.mark.parametrize("n_seats,seed", [(2, 100), (3, 101), (4, 102),
                                          (6, 103)])
def test_multi_hand_trajectory_equals_oracle(n_seats, seed):
    """Three consecutive hands, settle -> rotate -> deal: stacks persist,
    busted players keep playing, blinds go negative."""
    rng = random.Random(seed)
    st = one_table(n_seats, seed, max_layers=24, max_pot_layers=64)
    oracle_stacks = [100] * n_seats
    for hand in range(3):
        deck = list(range(52))
        rng.shuffle(deck)
        st = deal(st, deck)
        g = OracleGame(n=n_seats, small=5, big=10, deck=deck,
                       stacks=list(oracle_stacks))
        assert port_snapshot(st) == oracle_snapshot(g), f"hand {hand}"
        for step in range(300):
            if g.over:
                break
            raw = gen_action(rng, g)
            a = int(clamp_action(st, raw)[0])
            assert a == g.clamp(raw)
            st = step_action(st, a)
            g.act(a)
            assert port_snapshot(st) == oracle_snapshot(g), \
                f"hand {hand} step {step}"
        else:
            pytest.fail("no termination")
        st = settle_showdown(st)
        g.settle()
        assert stacks(st) == g.stacks, f"hand {hand}"
        oracle_stacks = g.stacks[1:] + g.stacks[:1]
        st = next_hand(st)
        assert int(st.button[0]) == (hand + 1) % n_seats
        pre = stacks(st)
        pre[0] += 5
        pre[1] += 10
        assert pre == oracle_stacks, f"hand {hand} rotation"


# ---- tests/test_golden_traces.py ----------------------------------------

def jax_deck(seed, hand):
    """The deck the JAX engine deals for hand ``hand`` of a table keyed
    ``jax.random.key(seed)`` (``engine/state.py:begin_hand``)."""
    return np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.key(seed), hand), 52))


def port_traces():
    """``scripts/dump_golden_traces.generate_traces`` on the port."""
    def run(cfg, seed, script, ids, rules, continuous=False):
        st = deal(init_state(0, cfg, 1, "cpu"), jax_deck(seed, 0))
        out = [public_board(st, ids)]
        for a in script:
            step = step_table if continuous else step_action
            nxt = step(st, clamp_action(st, a), rules=rules)
            if int(nxt.hand_idx[0]) != int(st.hand_idx[0]):
                nxt = deal(nxt, jax_deck(seed, int(nxt.hand_idx[0])))
            st = nxt
            out.append(public_board(st, ids))
        if not continuous and bool(st.hand_over[0]):
            st = settle_showdown(st, rules=rules)
            out.append(public_board(st, ids))
        return out

    return {
        "heads_up_reference.jsonl": run(
            TableConfig(num_seats=2, small_blind=5, big_blind=5), 2024,
            [0] * 8, ["hero", "villain"], "reference"),
        "three_way_reference.jsonl": run(
            TableConfig(num_seats=3), 7, [0, 10, -1, 0, 5, 0, 0, 0, 0, 0, 3,
                                          0], ["p1", "p2", "p3"],
            "reference"),
        "all_in_standard.jsonl": run(
            TableConfig(num_seats=3, rules="standard"), 7, [90, 0, 0],
            ["p1", "p2", "p3"], "standard"),
        "continuous_reference.jsonl": run(
            TableConfig(num_seats=2), 5, [-1, -1, -1], ["a", "b"],
            "reference", continuous=True),
    }


@pytest.fixture(scope="module")
def fresh():
    return port_traces()


@pytest.mark.parametrize("name", [
    "heads_up_reference.jsonl", "three_way_reference.jsonl",
    "all_in_standard.jsonl", "continuous_reference.jsonl"])
def test_golden_trace(name, fresh):
    assert_trace(fresh[name], load(name), name)


# ---- tests/test_derived_traces.py (the engine half) ---------------------

def drive_engine(cfg, deck, script, ids, state=None):
    if state is None:
        state = init_state(0, cfg, 1, "cpu")
    st = deal(state, deck)
    out = [public_board(st, ids)]
    for a in script:
        st = step_action(st, clamp_action(st, a))
        out.append(public_board(st, ids))
    assert bool(st.hand_over[0]), "scenario must end the hand"
    st = settle_showdown(st)
    out.append(public_board(st, ids))
    return out, st


@pytest.mark.parametrize("name,seats_,blinds,script,ids", [
    ("derived_heads_up.jsonl", 2, (5, 10), HEADS_UP_SCRIPT,
     ["hero", "villain"]),
    ("derived_reversed_blinds.jsonl", 2, (10, 5), REV_BLINDS_SCRIPT,
     ["p1", "p2"]),
    ("derived_fold_merge.jsonl", 3, (5, 10), FOLD_MERGE_SCRIPT,
     ["p1", "p2", "p3"]),
])
def test_derived_trace(name, seats_, blinds, script, ids):
    cfg = TableConfig(num_seats=seats_, small_blind=blinds[0],
                      big_blind=blinds[1])
    got, _ = drive_engine(cfg, IDENTITY, script, ids)
    want = load(name)
    assert_trace(got, want, "port")
    # the oracle agrees with the same committed trace
    assert_trace(drive_oracle(seats_, *blinds, IDENTITY, script, ids),
                 want, "oracle")


def test_derived_three_way_two_hands():
    cfg = TableConfig(num_seats=3, small_blind=5, big_blind=10)
    ids = ["p1", "p2", "p3"]
    got1, st = drive_engine(cfg, DECK_3WAY_H1, THREE_WAY_H1, ids)
    got2, _ = drive_engine(cfg, DECK_3WAY_H2, THREE_WAY_H2, ids,
                           state=next_hand(st))
    assert_trace(got1 + got2, load("derived_three_way.jsonl"), "port")


# ---- tests/test_derived_extensions.py -----------------------------------

def _check_state(st, want):
    assert stacks(st) == want["stacks"]
    assert st.all_in[0].tolist() == want["all_in"]
    assert st.in_hand[0].tolist() == want["in_hand"]
    assert int(st.stage[0]) == want["stage"]
    assert int(st.n_community[0]) == want["n_community"]
    if "head" in want:
        pos, _, exists = head_info(st)
        assert bool(exists[0]) and int(pos[0]) == want["head"]
    if want.get("hand_over"):
        assert bool(st.hand_over[0])


def _check_settle(before, after, want):
    P = after.num_seats
    got = [[int(after.pots.amt[0, j]),
            [k for k in range(P) if int(after.pots.orig[0, j]) >> k & 1]]
           for j in range(int(after.pots.count[0]))]
    assert got == want["pots"]
    assert [a - b for a, b in zip(stacks(after), stacks(before))] == \
        want["payout"]
    assert stacks(after) == want["stacks"]


def _drive(cfg, deck0, lines, decks=None):
    st = deal(init_state(0, cfg, 1, "cpu"), deck0)
    rules = cfg.rules
    for line in lines:
        kind = line["t"]
        if kind == "override_stacks":
            st = st._replace(stacks=torch.tensor([line["stacks"]],
                                                 dtype=torch.int32))
        elif kind == "action":
            st = step_action(st, clamp_action(st, line["amt"]), rules=rules)
        elif kind == "state":
            _check_state(st, line)
        elif kind == "settle":
            settled = settle_showdown(st, rules=rules)
            _check_settle(st, settled, line)
            st = settled
        elif kind == "next_hand":
            st = next_hand(st._replace(
                hand_over=torch.zeros_like(st.hand_over)), rules=rules)
            st = deal(st, decks[line["deck"]])
            assert stacks(st) == line["stacks"]
            assert int(st.button[0]) == line["button"]
            pos, _, exists = head_info(st)
            assert bool(exists[0]) and int(pos[0]) == line["head"]
        elif kind == "freeze":
            st = next_hand(st._replace(
                hand_over=torch.zeros_like(st.hand_over)), rules=rules)
            assert bool(st.hand_over[0]) and not bool(st.order_mask.any())
        else:
            raise AssertionError(kind)
    return st


def test_standard_sidepot_trace_matches_paper_derivation():
    lines = [{"t": "override_stacks", "stacks": [95, 50, 25]}] + \
        load("derived_standard_sidepot.jsonl")
    _drive(TableConfig(num_seats=3, rules="standard"), DECK_SIDEPOT, lines)


def test_tournament_elimination_trace_matches_paper_derivation():
    _drive(TableConfig(num_seats=3, rules="tournament"), DECK_TOURN_H1,
           load("derived_tournament_elim.jsonl"), decks={"H2": DECK_TOURN_H2})
