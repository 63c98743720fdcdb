"""The port's river solver (``montecarlo_tpu_torch/models/river_solver.py``)
against the JAX module on the CPU.

- ``make_river_game``: W and mask equal JAX's exactly.
- CFR+: every leaf of the average strategy within 1e-5 of JAX's after 1, 3
  and 200 iterations on games whose action values do not tie exactly. At
  an exact tie (at pot = bet, for instance, values like 50/3 = 50/3 recur)
  each implementation's float rounding picks the action, so leaves there
  cannot be compared; the tied game of ``tests/test_river_solver.py``
  (pot 4 = bet 4 on a 120-combo subset) is held by its values instead.
- ``strategy_values``, ``best_response_values`` and ``exploitability_gap``
  on the same profile within 1e-5 (relative to the pot).
- The JAX tests' closed forms and certificates, on the port; the engine
  terminal payoffs on the port's engine.
- ``river_node_states`` equal to JAX's field by field but the key (the
  street through the port's layer view); ``net_river_strategy``, on the
  port's node states carried into JAX, within 1e-6
  for the calling and pot-raising bots and within 1e-5 for es3, whose
  logits (up to 81 in size) differ from JAX's by up to 2.5e-5: the port's
  MLP sums in a fixed order (the net kernels' order) where JAX multiplies
  matrices, and the repo holds logits within 2e-6 of the largest one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import state as jstate
from montecarlo_tpu.models import bots as jbots
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.models import river_solver as jr
from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine.street import street_to_layers
from montecarlo_tpu_torch.models import bots as tbots
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.models import river_solver as pr

torch.set_num_threads(1)

BOARD = np.array([make_card(2, 13), make_card(0, 8), make_card(1, 5),
                  make_card(3, 2), make_card(2, 12)], np.int32)
COMBOS = jr.all_combos(BOARD)


def _subset120():
    rng = np.random.default_rng(5)
    return COMBOS[rng.choice(len(COMBOS), size=120, replace=False)]


def games(name):
    """(JAX game, port game) of a named test game."""
    if name == "half_street":
        W, m = np.array([[1.0], [0.0]], np.float32), np.ones((2, 1),
                                                             np.float32)
        kw = dict(pot=1.0, bet=1.0, raise_=1.0, p2_can_bet=False,
                  p2_can_raise=False)
        return (jr.RiverGame(jnp.asarray(W), jnp.asarray(m), **kw),
                pr.RiverGame(torch.tensor(W), torch.tensor(m), **kw))
    hero, kw = {
        "first80": (COMBOS[:80], dict(pot=4.0, bet=4.0, raise_=8.0)),
        "artifact": (COMBOS[::7], dict(pot=20.0, bet=20.0, raise_=50.0)),
        "subset120": (_subset120(), dict(pot=4.0, bet=4.0, raise_=8.0)),
    }[name]
    jg, _, _ = jr.make_river_game(BOARD, hero, hero, **kw)
    pg, _, _ = pr.make_river_game(BOARD, hero, hero, device="cpu", **kw)
    return jg, pg


@functools.lru_cache(maxsize=None)
def jax_solution(name, iterations):
    return jr.solve_cfr_plus(games(name)[0], iterations)


def to_port(strat):
    return pr.RiverStrategy(*(torch.tensor(np.asarray(x)) for x in strat))


def test_make_river_game_equals_jax():
    hero, vill = COMBOS[::3], COMBOS[1::5]
    jg, jh, jv = jr.make_river_game(BOARD, hero, vill, pot=20.0, bet=20.0,
                                    raise_=50.0)
    pg, ph, pv = pr.make_river_game(BOARD, hero, vill, pot=20.0, bet=20.0,
                                    raise_=50.0, device="cpu")
    np.testing.assert_array_equal(pg.W.numpy(), np.asarray(jg.W))
    np.testing.assert_array_equal(pg.mask.numpy(), np.asarray(jg.mask))
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pv, jv)
    assert (pg.pot, pg.bet, pg.raise_) == (jg.pot, jg.bet, jg.raise_)


@pytest.mark.parametrize("iterations", [1, 3, 200])
@pytest.mark.parametrize("name", ["first80", "artifact", "half_street"])
def test_cfr_plus_leaves_match_jax(name, iterations):
    """Every leaf of every node's average strategy within 1e-5; the 1- and
    3-iteration cases pin the alternating update order."""
    want = jax_solution(name, iterations)
    got = pr.solve_cfr_plus(games(name)[1], iterations)
    for node, w, g in zip(pr.RiverStrategy._fields, want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=node)


def _random_profile(H, V, seed):
    rng = np.random.default_rng(seed)

    def rows(n, k):
        return rng.dirichlet(np.ones(k), n).astype(np.float32)

    return jr.RiverStrategy(*(jnp.asarray(rows(n, k)) for n, k in (
        (H, 2), (V, 2), (H, 2), (V, 3), (H, 2))))


@pytest.mark.parametrize("profile", ["solved", "random"])
@pytest.mark.parametrize("name", ["subset120", "artifact", "half_street"])
def test_evaluation_matches_jax(name, profile):
    """strategy_values, best_response_values and exploitability_gap of one
    profile within 1e-5 of the pot."""
    jg, pg = games(name)
    strat = (jax_solution(name, 200) if profile == "solved"
             else _random_profile(*jg.W.shape, seed=3))
    tol = 1e-5 * jg.pot
    for fn in ("strategy_values", "best_response_values"):
        want = getattr(jr, fn)(jg, strat)
        got = getattr(pr, fn)(pg, to_port(strat))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=fn)
    assert pr.exploitability_gap(pg, to_port(strat)) == pytest.approx(
        jr.exploitability_gap(jg, strat), abs=tol)


def test_tied_game_values_match_jax():
    """The 120-combo pot = bet game ties at many infosets, so each solver's
    rounding picks there; both profiles certify (gap < 2% of the pot) and
    their EVs lie within the sum of the two gaps."""
    jg, pg = games("subset120")
    js, ps = jax_solution("subset120", 1500), pr.solve_cfr_plus(pg, 1500)
    jgap, pgap = jr.exploitability_gap(jg, js), pr.exploitability_gap(pg, ps)
    assert 0 <= pgap < 0.02 * pg.pot and jgap < 0.02 * jg.pot
    ev, ev2 = pr.strategy_values(pg, ps)
    assert ev + ev2 == pytest.approx(pg.pot, abs=1e-3)
    assert abs(ev - jr.strategy_values(jg, js)[0]) <= jgap + pgap + 1e-4


# ---------------------------------------------------------------------------
# The closed forms and certificates of tests/test_river_solver.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pot,bet,value", [(1.0, 1.0, 0.75), (2.0, 2.0, 1.5)])
def test_half_street_closed_form(pot, bet, value):
    """Nuts or air against a bluff-catcher who may only call or fold: the
    nuts always bet; with P = B air bluffs 1/2, P2 calls 1/2, and P1's
    value is 0.75 P (tests/test_river_solver.py derives it)."""
    W, m = torch.tensor([[1.0], [0.0]]), torch.ones(2, 1)
    game = pr.RiverGame(W, m, pot=pot, bet=bet, raise_=1.0,
                        p2_can_bet=False, p2_can_raise=False)
    strat = pr.solve_cfr_plus(game, iterations=4000)
    s0, s3 = strat.s0.numpy(), strat.s3.numpy()
    assert s0[0, 1] > 0.99
    assert abs(s0[1, 1] - 0.5) < 0.02
    assert abs(s3[0, 1] - 0.5) < 0.02
    ev1, ev2 = pr.strategy_values(game, strat)
    assert abs(ev1 - value) < 0.01 * pot
    assert abs(ev1 + ev2 - pot) < 1e-5
    assert pr.exploitability_gap(game, strat) < 0.01 * pot


def test_gap_detects_bad_strategy():
    _, pg = games("first80")
    H = V = pg.W.shape[0]
    uni = pr.RiverStrategy(
        s0=torch.full((H, 2), 0.5), s1=torch.full((V, 2), 0.5),
        s2=torch.full((H, 2), 0.5), s3=torch.full((V, 3), 1 / 3),
        s4=torch.full((H, 2), 0.5))
    solved = pr.solve_cfr_plus(pg, 1500)
    assert pr.exploitability_gap(pg, uni) > 10 * max(
        pr.exploitability_gap(pg, solved), 1e-4)


def _play_line(hero_hole, villain_hole, actions, cfg):
    """A fresh HU hand on the port's engine, on an injected deck, checked
    to the river, then the river ``actions``; P1's settled chip delta."""
    deck = np.zeros(52, np.int32)
    pos = [0, 1, 2, 3, 5, 6, 7, 9, 11]
    dealt = np.array([hero_hole[0], villain_hole[0], hero_hole[1],
                      villain_hole[1], *BOARD], np.int32)
    deck[pos] = dealt
    deck[[p for p in range(52) if p not in pos]] = np.setdiff1d(
        np.arange(52), dealt)
    st = tstate.redeal(tstate.init_state(0, cfg, 1, "cpu"), deck[None])
    start = int(st.stacks[0, 0]) + cfg.small_blind
    st = pr._advance(st, [0] * 6 + list(actions), cfg.rules)
    assert int(st.hand_idx[0]) == 1, "the line finished the hand"
    # the next hand's blinds are posted: old position 0 is new position 1
    return int(st.stacks[0, 1]) + cfg.big_blind - start


@pytest.mark.parametrize("w_case", ["hero_wins", "villain_wins", "tie"])
def test_engine_terminal_payoffs_match_solver_model(w_case):
    """Every terminal line's chip delta on the port's engine equals the
    solver's payoff minus P1's pre-river contribution (one big blind)."""
    cfg = tstate.TableConfig(num_seats=2, rules="standard")
    hero, vill, w = {
        "hero_wins": ([make_card(2, 14), make_card(0, 13)],
                      [make_card(0, 9), make_card(1, 9)], 1.0),
        "villain_wins": ([make_card(0, 9), make_card(1, 9)],
                         [make_card(2, 14), make_card(0, 13)], 0.0),
        "tie": ([make_card(0, 14), make_card(1, 7)],
                [make_card(1, 14), make_card(3, 7)], 0.5),
    }[w_case]
    pot, B, R = 20.0, 20.0, 60.0
    U = pr._payoffs(pr.RiverGame(torch.tensor([[w]]), torch.ones(1, 1),
                                 pot, B, R))

    def u(name):
        v = U[name]
        return float(v if isinstance(v, float) else v[0, 0])

    lines = {"cc": [0, 0], "xbf": [0, int(B), -1], "xbc": [0, int(B), 0],
             "bf": [int(B), -1], "bc": [int(B), 0],
             "brf": [int(B), int(R), -1], "brc": [int(B), int(R), 0]}
    for name, acts in lines.items():
        assert _play_line(hero, vill, acts, cfg) == int(
            u(name) - cfg.big_blind), name


# ---------------------------------------------------------------------------
# Node states and net extraction
# ---------------------------------------------------------------------------

def live_layers(ly, t=None):
    """A layer list's live layers as (amt, mem, orig, n) tuples, with its
    count and overflow (table ``t`` of a batched one)."""
    pick = (lambda x: np.asarray(x)) if t is None else (
        lambda x: np.asarray(x)[t])
    c = int(pick(ly.count))
    return ([tuple(int(v) for v in pick(f)[:c])
             for f in (ly.amt, ly.mem, ly.orig, ly.n)],
            c, bool(pick(ly.overflow)))


def assert_state_equal(want, got, where):
    """A JAX state (one table, or a batch) equals the port's in every field
    but key; the JAX street is in the layers form, so the port's street is
    compared through its layer view, on the live layers."""
    batched = np.asarray(want.hand_idx).ndim == 1
    view = street_to_layers(got.bets, got.folded)
    for t in range(got.n_tables):
        assert live_layers(want.bets, t if batched else None) == \
            live_layers(view, t), (where, "bets", t)
    got = tstate.state_to_numpy(got)
    for name in tstate.TableState._fields:
        if name in ("key", "bets"):
            continue
        w, g = getattr(want, name), getattr(got, name)
        for sub, x, y in (zip(w._fields, w, g) if isinstance(w, tuple)
                          else [("", w, g)]):
            x = np.asarray(x)
            np.testing.assert_array_equal(y.reshape(x.shape), x,
                                          err_msg=f"{where} {name} {sub}")


def jax_state(st):
    """The port's state as a JAX state in the levels street form (the key
    a fixed JAX key): JAX's extraction then reads exactly the port's
    states, without JAX's own engine run."""
    from montecarlo_tpu.engine import bets as jbets
    from montecarlo_tpu.engine import street as jstreet

    st = tstate.state_to_numpy(st)
    fields = {}
    for name in jstate.TableState._fields:
        x = getattr(st, name)
        if name == "key":
            fields[name] = jax.random.split(jax.random.key(0),
                                            st.hand_idx.shape[0])
        elif name in ("bets", "pots"):
            kind = jstreet.Street if name == "bets" else jbets.Layers
            fields[name] = kind(*(jnp.asarray(v) for v in x))
        else:
            fields[name] = jnp.asarray(x)
    return jstate.TableState(**fields)


def jax_node(st):
    """``jax_state`` of a one-table node without its table axis."""
    return jax.tree.map(lambda x: x[0], jax_state(st))


def test_river_node_states_equal_jax():
    jstates, jsizes = jr.river_node_states(BOARD)
    pstates, psizes = pr.river_node_states(BOARD, device="cpu")
    assert psizes == jsizes == dict(pot=20.0, bet=20.0, raise_=50.0)
    for node in jstates:
        assert_state_equal(jstates[node], pstates[node], node)


@functools.lru_cache(maxsize=None)
def node_states():
    """(JAX states, port states) of the river tree on BOARD: the port's,
    and the same states as JAX states."""
    pstates = pr.river_node_states(BOARD, device="cpu")[0]
    return {k: jax_node(v) for k, v in pstates.items()}, pstates


@pytest.mark.parametrize("subject,tol", [("es3", 1e-5), ("call_bot", 1e-6),
                                         ("pot_bot", 1e-6)])
def test_net_river_strategy_matches_jax(subject, tol):
    """The extracted strategy at every node within ``tol``."""
    if subject == "es3":
        jp = jpn.load_params("data/policy_6max_es3.npz")
        tp = tpn.load_params("data/policy_6max_es3.npz")
    else:
        action = 1 if subject == "call_bot" else 3
        jp, tp = jbots.action_bot(action), tbots.action_bot(action)
    hero, vill = COMBOS[::5], COMBOS[2::7]
    jstates, pstates = node_states()
    want = jr.net_river_strategy(jp, jstates, hero, vill)
    got = pr.net_river_strategy(tp, pstates, hero, vill)
    for node, w, g in zip(pr.RiverStrategy._fields, want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol, err_msg=node)


def test_net_river_strategy_extraction_matches_bot_rules():
    """fof_call facing the check-bet calls exactly the pair-or-better
    combos and never bets the root (tests/test_river_solver.py)."""
    from montecarlo_tpu_torch.handval import CAT_SHIFT

    states = node_states()[1]
    combos = COMBOS[:200]
    strat = pr.net_river_strategy(tbots.panel()["fof_call"], states, combos,
                                  combos)
    keys = pr._hand_keys(combos, BOARD, torch.device("cpu")).numpy()
    has_pair = (keys >> CAT_SHIFT) >= 1
    s2, s0 = strat.s2.numpy(), strat.s0.numpy()
    assert np.all(s2[has_pair, 1] > 0.99)
    assert np.all(s2[~has_pair, 0] > 0.99)
    assert np.all(s0[:, 0] > 0.99)
