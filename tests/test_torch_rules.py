"""The port's table engine on the JAX package's rule scenarios.

Mirrors of ``tests/test_engine.py`` (the reference's scripted scenarios),
``tests/test_standard_rules.py`` (real poker accounting: all-in showdown
eligibility, side pots, runouts, odd chips, stepwise chip conservation)
and ``tests/test_tournament.py`` (elimination, blinds over dead seats, the
freeze), on one table of the port's batched state with the same literal
expectations. The scenarios that play whole hands with a policy
(``play_hands``, ``play_tournament``) wait for the port of self-play.
"""

import random

import numpy as np
import pytest
import torch

from montecarlo_tpu.cards import make_card
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
from tests.test_engine import _showdown_deck, _swap_p1_p3
from tests.util import fs

torch.set_num_threads(1)

H, D, S, C = 0, 1, 2, 3
I32 = torch.int32


def mkstate(n, **kw):
    return init_state(0, TableConfig(num_seats=n, **kw), 1, "cpu")


def act(st, action, rules="reference"):
    return step_action(st, clamp_action(st, action), rules=rules)


def layers_spec(layers, num_seats=23):
    """Table 0's layers -> [(amt, members, orig, n), ...]."""
    out = []
    for i in range(int(layers.count[0])):
        mem, orig = int(layers.mem[0, i]), int(layers.orig[0, i])
        out.append((int(layers.amt[0, i]),
                    frozenset(j for j in range(num_seats) if mem >> j & 1),
                    frozenset(j for j in range(num_seats) if orig >> j & 1),
                    int(layers.n[0, i])))
    return out


def bets_spec(st):
    from montecarlo_tpu_torch.engine.street import bets_as_layers

    return layers_spec(bets_as_layers(st.bets, st.folded))


def head(st):
    return int(head_info(st)[0][0])


def seats(mask):
    return frozenset(np.nonzero(mask[0].numpy())[0].tolist())


def stacks(st):
    return st.stacks[0].tolist()


def with_stacks(st, values):
    return st._replace(stacks=torch.tensor([values], dtype=I32))


def deal(st, deck):
    return redeal(st, torch.tensor([deck], dtype=I32))


# ---- tests/test_engine.py ------------------------------------------------

def test_play_blinds_two_players():
    st = mkstate(2)
    assert bets_spec(st) == [(5, fs(0, 1), fs(0, 1), 2), (5, fs(1), fs(1), 1)]
    assert stacks(st) == [95, 90]
    assert head(st) == 0
    assert seats(st.to_act) == fs(0, 1)
    assert int(st.time[0]) == 0


def test_play_blinds_three_players():
    st = mkstate(3)
    assert bets_spec(st) == [(5, fs(0, 1), fs(0, 1), 2), (5, fs(1), fs(1), 1)]
    assert head(st) == 2
    assert seats(st.to_act) == fs(0, 1, 2)


def test_scenario_no_one_left_for_turn():
    st = mkstate(3)
    st = act(st, 0)
    assert bets_spec(st) == [(5, fs(0, 1, 2), fs(0, 1, 2), 3),
                             (5, fs(1, 2), fs(1, 2), 2)]
    assert stacks(st) == [95, 90, 90]
    assert head(st) == 0 and int(st.time[0]) == 1
    assert seats(st.to_act) == fs(0, 1)
    st = act(st, 10)
    assert bets_spec(st) == [(5, fs(0, 1, 2), fs(0, 1, 2), 4),
                             (5, fs(0, 1, 2), fs(0, 1, 2), 3),
                             (10, fs(0), fs(0), 1)]
    assert stacks(st) == [80, 90, 90]
    assert head(st) == 1 and seats(st.to_act) == fs(1, 2)
    st = act(st, -1)
    assert bets_spec(st) == [(10, fs(0, 2), fs(0, 1, 2), 3),
                             (10, fs(0), fs(0), 1)]
    assert seats(st.in_hand) == fs(0, 2)
    assert head(st) == 2 and seats(st.to_act) == fs(2)
    st = act(st, -1)
    assert bool(st.hand_over[0]) and seats(st.in_hand) == fs(0)
    st = settle_showdown(st)
    assert layers_spec(st.pots) == [(10, fs(0), fs(0, 1, 2), 3),
                                    (10, fs(0), fs(0), 1)]
    assert stacks(st) == [120, 90, 90]


def test_scenario_all_the_way_to_showdown():
    st = deal(mkstate(3), _showdown_deck())
    st = act(st, 0)
    st = act(st, 0)
    assert bets_spec(st) == [(5, fs(0, 1, 2), fs(0, 1, 2), 4),
                             (5, fs(0, 1, 2), fs(0, 1, 2), 3)]
    st = act(st, -1)
    assert int(st.stage[0]) == 1 and int(st.n_community[0]) == 3
    assert layers_spec(st.pots) == [(10, fs(0, 2), fs(0, 1, 2), 3)]
    assert bets_spec(st) == []
    assert head(st) == 0
    st = act(st, 10)
    st = act(st, 0)
    assert int(st.stage[0]) == 2 and int(st.n_community[0]) == 4
    assert [s[0] for s in layers_spec(st.pots)] == [10, 10]
    st = act(st, 0)
    assert bets_spec(st) == []
    st = act(st, 17)
    st = act(st, 0)
    assert int(st.stage[0]) == 3 and int(st.n_community[0]) == 5
    st = act(st, 3)
    st = act(st, 0)
    assert bool(st.hand_over[0])
    st = settle_showdown(st)
    assert [s[0] for s in layers_spec(st.pots)] == [10, 10, 17, 3]
    assert stacks(st) == [150, 90, 60]


def test_all_in_side_pot():
    st = deal(mkstate(3), _swap_p1_p3(_showdown_deck()))
    st = with_stacks(st, [95, 90, 40])
    st = act(st, 30)
    assert seats(st.in_hand) == fs(0, 1)
    assert int(st.stacks[0, 2]) == 0
    assert bets_spec(st) == [(5, fs(0, 1, 2), fs(0, 1, 2), 3),
                             (5, fs(1, 2), fs(1, 2), 2),
                             (30, fs(2), fs(2), 1)]
    assert seats(st.to_act) == fs(0, 1)
    st = act(st, 0)
    st = act(st, 0)
    assert int(st.stage[0]) == 1
    assert layers_spec(st.pots) == [(5, fs(0, 1, 2), fs(0, 1, 2), 5),
                                    (5, fs(0, 1, 2), fs(0, 1, 2), 4),
                                    (30, fs(0, 1, 2), fs(0, 1, 2), 3)]
    assert head(st) == 0
    for _ in range(6):
        st = act(st, 0)
    assert bool(st.hand_over[0])
    st = settle_showdown(st)
    assert int(st.stacks[0, 2]) == 0
    assert sum(stacks(st)) == 95 + 90 + 0 - 65 + 135


def test_step_table_continuous_next_hand():
    st2 = step_table(mkstate(2), -1)
    assert int(st2.hand_idx[0]) == 1 and int(st2.button[0]) == 1
    assert int(st2.stage[0]) == 0 and int(st2.time[0]) == 0
    assert not bool(st2.hand_over[0])
    assert bets_spec(st2) == [(5, fs(0, 1), fs(0, 1), 2),
                              (5, fs(1), fs(1), 1)]
    assert stacks(st2) == [105 - 5, 95 - 10]


def test_step_table_leaves_a_finished_hand_unchanged():
    """A table whose hand is over (here ended by step_action, not yet
    settled, its winner still in the play order) is a fixed point of
    step_table, as in the JAX engine."""
    st = step_action(mkstate(2), -1)
    assert bool(st.hand_over[0]) and bool(head_info(st)[2][0])
    again = step_table(st, 0)
    for a, b in zip(_leaves(st), _leaves(again)):
        assert torch.equal(a, b)


def _leaves(x):
    if isinstance(x, tuple):
        return [y for f in x for y in _leaves(f)]
    return [x]


def test_clamp_action_matches_player_validation():
    st = mkstate(3)
    for raw, want in ((95, 90), (200, 90), (50, 50), (0, 0), (-3, -3)):
        assert int(clamp_action(st, raw)[0]) == want


def test_public_board_shape():
    st = mkstate(3)
    ids = ["G__1", "G__2", "G__3"]
    pb = public_board(st, ids)
    assert pb["time"] == 0
    assert pb["community-cards"] == []
    assert pb["remaining-players"] == ids
    assert pb["play-order"] == ["G__3", "G__1", "G__2"]
    assert pb["players"] == [{"id": i, "stack": s}
                             for i, s in zip(ids, [95, 90, 100])]
    assert pb["bets"][0] == {"bet": 5, "players": ["G__1", "G__2"],
                             "original-players": ["G__1", "G__2"], "n": 2}


def test_batched_step_runs_every_table():
    st = init_state(7, TableConfig(num_seats=3), 64, "cpu")
    stepped = step_action(st, torch.zeros(64, dtype=I32))
    assert int(stepped.time.sum()) == 64


# ---- tests/test_standard_rules.py ---------------------------------------

STD = "standard"


def mk3(deck=None, stack_values=None):
    st = init_state(0, TableConfig(num_seats=3, rules=STD, max_layers=16,
                                   max_pot_layers=48), 1, "cpu")
    if deck is not None:
        st = deal(st, deck)
    if stack_values is not None:
        st = with_stacks(st, stack_values)
    return st


def sact(st, a):
    return act(st, a, STD)


def _deck(used):
    rest = iter(c for c in range(52)
                if c not in {x for x in used if x is not None})
    deck = [c if c is not None else next(rest) for c in used]
    return deck + [c for c in range(52) if c not in set(deck)]


def test_all_in_seat_wins_at_showdown():
    st = mk3(deck=_swap_p1_p3(_showdown_deck()), stack_values=[95, 90, 40])
    st = sact(st, 30)
    assert bool(st.all_in[0, 2]) and bool(st.in_hand[0, 2])
    st = sact(st, 0)
    st = sact(st, 0)
    for _ in range(6):
        st = sact(st, 0)
    assert bool(st.hand_over[0])
    st = settle_showdown(st, rules=STD)
    assert stacks(st) == [60, 60, 120]


def test_all_in_for_less_creates_side_pot():
    st = sact(mk3(stack_values=[95, 90, 4]), 0)
    assert bool(st.all_in[0, 2]) and int(st.stacks[0, 2]) == 0
    assert bets_spec(st) == [(4, fs(0, 1, 2), fs(0, 1, 2), 3),
                             (1, fs(0, 1), fs(0, 1), 2),
                             (5, fs(1), fs(1), 1)]


def test_everyone_all_in_runs_out_the_board():
    st = mk3()
    for a in (90, 0, 0):
        st = sact(st, a)
    assert bool(st.hand_over[0])
    assert int(st.n_community[0]) == 5 and int(st.stage[0]) == 3
    st = settle_showdown(st, rules=STD)
    assert sum(stacks(st)) == 300


def test_odd_chip_goes_to_first_position_winner():
    lows = [make_card(1, 2), make_card(2, 2), make_card(3, 2),
            make_card(1, 3), make_card(2, 3), make_card(3, 3)]
    royal = [make_card(0, r) for r in (14, 13, 12, 11, 10)]
    st = mk3(deck=_deck(lows + [None] + royal[:3] + [None, royal[3], None,
                                                       royal[4]]))
    for a in (1, 0, 0) + (0,) * 6:
        st = sact(st, a)
    st = settle_showdown(st, rules=STD)
    back = [s - b for s, b in zip(stacks(st), [89, 89, 89])]
    assert sum(stacks(st)) == 300 and back == [11, 11, 11]
    # an odd pot: the small blind folds after the call, so the pot is 5 x 3
    # + 5 x 2 = 25 between positions 1 and 2, who tie on the board: 12
    # each, and the odd chip to the first-position winner (position 1)
    st = mk3(deck=_deck(lows + [None] + royal[:3] + [None, royal[3], None,
                                                       royal[4]]))
    for a in (0, -1) + (0,) * 7:
        st = sact(st, a)
    assert bool(st.hand_over[0])
    st = settle_showdown(st, rules=STD)
    assert stacks(st) == [95, 90 + 13, 90 + 12]


def _chips_in_layers(layers):
    return sum(int(layers.amt[0, i]) * bin(int(layers.orig[0, i])).count("1")
               for i in range(int(layers.count[0])))


@pytest.mark.parametrize("n_seats,seed", [(2, 41), (3, 42), (4, 43), (6, 44)])
def test_stepwise_chip_conservation(n_seats, seed):
    """Standard rules: stacks + chips in the street and pot layers is
    invariant after every action."""
    from montecarlo_tpu_torch.engine.street import bets_as_layers

    rng = random.Random(seed)
    st = init_state(seed, TableConfig(num_seats=n_seats, rules=STD,
                                      max_layers=16, max_pot_layers=48),
                    1, "cpu")
    total0 = 100 * n_seats

    def invariant(st):
        return (sum(stacks(st))
                + _chips_in_layers(bets_as_layers(st.bets, st.folded))
                + _chips_in_layers(st.pots))

    assert invariant(st) == total0
    for step in range(200):
        if bool(st.hand_over[0]):
            break
        u = rng.random()
        st = sact(st, -1 if u < 0.2 else (0 if u < 0.7
                                          else rng.randint(1, 40)))
        assert invariant(st) == total0, f"step {step}"
    else:
        pytest.fail("no termination")
    st = settle_showdown(st, rules=STD)
    assert sum(stacks(st)) == total0


def test_cascading_side_pots_textbook_payouts():
    lo1, lo2 = make_card(2, 2), make_card(3, 7)
    KH, KD, AH, AD = (make_card(0, 13), make_card(1, 13), make_card(0, 14),
                      make_card(1, 14))
    deck = _deck([lo1, KH, AH, lo2, KD, AD, None, make_card(2, 3),
                  make_card(3, 4), make_card(2, 9), None, make_card(3, 10),
                  None, make_card(2, 12)])
    st = with_stacks(mk3(deck=deck), [95, 50, 20])
    for a in (90, 200, 0):
        st = sact(st, a)
    assert bool(st.hand_over[0])
    assert [(a, m) for a, m, _, _ in layers_spec(st.pots, 3)] == [
        (5, fs(0, 1, 2)), (5, fs(0, 1, 2)), (10, fs(0, 1, 2)),
        (40, fs(0, 1)), (40, fs(0))]
    st = settle_showdown(st, rules=STD)
    assert stacks(st) == [40, 80, 60]


# ---- tests/test_tournament.py -------------------------------------------

def tour(seed, **kw):
    kw = {"num_seats": 6, "rules": "tournament", "small_blind": 25,
          "big_blind": 50, "max_layers": 16, "max_pot_layers": 48, **kw}
    return init_state(seed, TableConfig(**kw), 1, "cpu")


def test_blinds_advance_over_eliminated_seats():
    st = with_stacks(tour(0, small_blind=5, big_blind=10),
                     [100, 0, 0, 100, 100, 100])
    nxt = next_hand(st, rules="tournament")
    assert int(nxt.button[0]) == (int(st.button[0]) + 3) % 6
    assert nxt.in_hand[0].tolist() == [True, True, True, True, False, False]
    assert stacks(nxt) == [95, 90, 100, 100, 0, 0]
    assert int(nxt.cursor[0]) == 2


def test_bb_skips_dead_seat_between_blinds():
    st = with_stacks(tour(1, small_blind=5, big_blind=10),
                     [100, 100, 0, 100, 100, 100])
    nxt = next_hand(st, rules="tournament")
    assert stacks(nxt) == [95, 0, 90, 100, 100, 100]
    assert nxt.in_hand[0].tolist() == [True, False, True, True, True, True]
    assert int(nxt.cursor[0]) == 3


def test_table_freezes_with_single_survivor():
    st = with_stacks(tour(2), [600, 0, 0, 0, 0, 0])
    frozen = next_hand(st, rules="tournament")
    assert bool(frozen.hand_over[0])
    assert int(frozen.pots.count[0]) == 0 and int(frozen.bets.count[0]) == 0
    again = next_hand(frozen, rules="tournament")
    assert bool(again.hand_over[0])
    assert stacks(again) == stacks(frozen)
    stepped = step_table(frozen, 0, rules="tournament")
    assert stacks(stepped) == stacks(frozen)
    assert sum(stacks(stepped)) == 600
