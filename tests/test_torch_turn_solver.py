"""The port's turn+river solver (``montecarlo_tpu_torch/models/
turn_solver.py``) against the JAX module on the CPU, on the rivers and
combo strides of ``tests/test_turn_solver.py``.

- ``make_turn_river_game``: keys, has_r, mask0, cnt and rivers equal.
- CFR+ after 1 and 3 iterations (the alternating update order: the P1
  river pass on the reaches before the update, the P2 pass on the updated
  P1 strategies, the river averages of the regrets after both updates
  weighted by the reaches before them): at most 0.5% of the leaves differ
  from JAX's by more than 1e-5. Those are exact ties between two actions'
  values (a value such as 50/3 reached by two sums), where float rounding
  picks the action in each implementation, and JAX's jitted solve and
  its own helpers run one by one disagree there too. Five wrong update
  orders move 1.4% to 46% of the leaves at these counts. After 200
  iterations the profiles' EVs and best-response values agree within
  1e-4 chips (pot 20).
- ``strategy_values``, ``best_response_values``, ``exploitability_gap``
  and ``chance_averaged_equity`` within 1e-5 on the same profile;
  ``best_response_strategy`` one-hot, equal to JAX's on at least 99% of
  the rows (the rest ties: es3 always calls, so P1's check and bet values
  at the turn root are both 680 up to rounding), and either side's mixed
  with the profile reproduces br1 and br2 (``tests/test_distill.py``).
- The two reductions and certificates of ``tests/test_turn_solver.py``,
  and its mesh-sharded solve on a gloo world of two ranks.
- ``turn_river_node_states`` (with the prelude) equal to JAX's field by
  field but the key (the street through the port's layer view);
  ``net_turn_river_strategy`` on the port's states carried into JAX
  within 1e-6 for the
  calling and pot-raising bots and 1e-5 for es3 (the MLP's summation
  order, ``tests/test_torch_river_solver.py``).
"""

import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh

from montecarlo_tpu.models import bots as jbots
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.models import turn_solver as jt
from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.models import bots as tbots
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.models import river_solver as pr
from montecarlo_tpu_torch.models import turn_solver as pt
from montecarlo_tpu_torch.parallel import local
from montecarlo_tpu_torch.parallel import mesh as tm

import torch_parallel_workers as workers
from test_torch_river_solver import assert_state_equal, jax_node, jax_state

torch.set_num_threads(1)

BOARD4 = [make_card(2, 13), make_card(0, 8), make_card(1, 5),
          make_card(3, 2)]  # Ks 8h 5d 2c
RIVERS = [make_card(2, 12), make_card(0, 3), make_card(1, 9)]
STRIDES = (16, 24, 32, 48)
# the no-raise artifact game at the nets' measured sizes
ARTIFACT = dict(pot=20.0, bet=20.0, river_bets=(20.0, 30.0, 30.0, 30.0),
                turn_raise=False, river_raise=False)


@functools.lru_cache(maxsize=None)
def games(stride, **kw):
    kw = kw or ARTIFACT
    combos = jt.turn_combos(BOARD4)[::stride]
    jg, _ = jt.make_turn_river_game(BOARD4, rivers=RIVERS, combos=combos,
                                    **kw)
    pg, _ = pt.make_turn_river_game(BOARD4, rivers=RIVERS, combos=combos,
                                    device="cpu", **kw)
    return jg, pg, combos


@functools.lru_cache(maxsize=None)
def jax_solution(stride, iterations):
    return jt.solve_turn_river(games(stride)[0], iterations)


def to_port(strat):
    return pt.TurnRiverStrategy(*(torch.tensor(np.asarray(x))
                                  for x in strat))


@pytest.mark.parametrize("stride", STRIDES)
def test_make_turn_river_game_equals_jax(stride):
    jg, pg, _ = games(stride)
    for f in ("keys", "has_r", "mask0", "cnt", "rivers"):
        np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert pg[5:] == jg[5:]
    np.testing.assert_array_equal(pg.pots_l, jg.pots_l)
    np.testing.assert_array_equal(pg.c1_l, jg.c1_l)


@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("stride", STRIDES)
def test_cfr_leaves_match_jax(stride, iterations):
    want = jax_solution(stride, iterations)
    got = pt.solve_turn_river(games(stride)[1], iterations)
    off = np.concatenate([
        (np.abs(g.numpy() - np.asarray(w)) > 1e-5).ravel()
        for w, g in zip(want, got)])
    assert off.mean() <= 0.005, f"{off.sum()} of {off.size} leaves differ"


@pytest.mark.parametrize("stride", [16, 48])
def test_cfr_values_match_jax_after_200(stride):
    jg, pg, _ = games(stride)
    want = jax_solution(stride, 200)
    got = pt.solve_turn_river(pg, 200)
    np.testing.assert_allclose(pt.strategy_values(pg, got),
                               jt.strategy_values(jg, want), atol=1e-4)
    np.testing.assert_allclose(pt.best_response_values(pg, got),
                               jt.best_response_values(jg, want), atol=1e-4)


def _random_profile(C, Rn, seed):
    rng = np.random.default_rng(seed)

    def rows(*shape):
        return rng.dirichlet(np.ones(shape[-1]), shape[:-1]).astype(
            np.float32)

    turn = [rows(C, k) for k in (2, 2, 2, 3, 2)]
    river = [rows(4, Rn, C, k) for k in (2, 2, 2, 3, 2)]
    return jt.TurnRiverStrategy(*(jax.numpy.asarray(x) for x in turn + river))


@functools.lru_cache(maxsize=None)
def node_states():
    """(JAX turn, river states; port turn, river, prelude states): the
    port's, and the same states carried into JAX."""
    pts, prs, _, ppre = pt.turn_river_node_states(BOARD4, RIVERS,
                                                  with_prelude=True,
                                                  device="cpu")
    jts = {k: jax_node(v) for k, v in pts.items()}
    jrs = {L: {k: jax_state(v) for k, v in ns.items()}
           for L, ns in prs.items()}
    return jts, jrs, pts, prs, ppre


def profile(name, stride):
    jg, _, combos = games(stride)
    if name == "solved":
        return jax_solution(stride, 200)
    if name == "random":
        return _random_profile(len(combos), len(RIVERS), seed=2)
    jts, jrs, *_ = node_states()
    return jt.net_turn_river_strategy(
        jpn.load_params("data/policy_6max_es3.npz"), jts, jrs, combos)


@pytest.mark.parametrize("name", ["solved", "random", "es3"])
def test_evaluation_matches_jax(name):
    stride = 24
    jg, pg, _ = games(stride)
    strat = profile(name, stride)
    ps = to_port(strat)
    tol = 1e-5 * jg.pot
    np.testing.assert_allclose(pt.strategy_values(pg, ps),
                               jt.strategy_values(jg, strat), atol=tol)
    np.testing.assert_allclose(pt.best_response_values(pg, ps),
                               jt.best_response_values(jg, strat), atol=tol)
    assert pt.exploitability_gap(pg, ps) == pytest.approx(
        jt.exploitability_gap(jg, strat), abs=tol)

    # best responses: one-hot rows, equal to JAX's away from ties; each
    # side's, mixed with the profile, reproduces br1 and br2
    br1, br2 = pt.best_response_values(pg, ps)
    mine = pt.best_response_strategy(pg, ps)
    theirs = to_port(jt.best_response_strategy(jg, strat))
    for br in (mine, theirs):
        ev1, _ = pt.strategy_values(pg, pt.mix_strategies(br, ps))
        _, ev2 = pt.strategy_values(pg, pt.mix_strategies(ps, br))
        assert ev1 == pytest.approx(br1, abs=1e-3 * max(1.0, abs(br1)))
        assert ev2 == pytest.approx(br2, abs=1e-3 * max(1.0, abs(br2)))
    rows = np.concatenate([(m != t).any(-1).ravel().numpy()
                           for m, t in zip(mine, theirs)])
    assert rows.mean() <= 0.01, f"{rows.sum()} of {rows.size} rows differ"
    for node in mine:
        assert torch.all(node.amax(-1) == 1.0) and torch.all(
            node.sum(-1) == 1.0)


def test_chance_averaged_equity_matches_jax():
    jg, pg, _ = games(24)
    w = pt.chance_averaged_equity(pg).numpy()
    np.testing.assert_allclose(w, np.asarray(jt.chance_averaged_equity(jg)),
                               rtol=0, atol=1e-5)
    m = pg.mask0.numpy()
    np.testing.assert_allclose((w + w.T)[m > 0], 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# The certificates and reductions of tests/test_turn_solver.py, on the port
# ---------------------------------------------------------------------------

def test_two_street_gap_converges_and_constant_sum():
    _, pg, _ = games(16, pot=4.0, bet=4.0, raise_=12.0)
    strat = pt.solve_turn_river(pg, iterations=500)
    gap = pt.exploitability_gap(pg, strat)
    ev1, ev2 = pt.strategy_values(pg, strat)
    assert -1e-3 <= gap < 0.06 * pg.pot, gap
    assert ev1 + ev2 == pytest.approx(pg.pot)
    br1, br2 = pt.best_response_values(pg, strat)
    assert pg.pot - br2 - 1e-4 <= ev1 <= br1 + 1e-4


def test_no_raise_game_brc_unreachable():
    _, pg, _ = games(24, pot=4.0, bet=4.0, turn_raise=False,
                     river_raise=False)
    strat = pt.solve_turn_river(pg, iterations=400)
    assert pt.exploitability_gap(pg, strat) < 0.06 * pg.pot
    assert float(strat.t3[:, 2].abs().max()) == 0.0
    assert float(strat.s3[..., 2].abs().max()) == 0.0


def test_river_betting_off_reduces_to_one_street():
    """Rivers checking down: EV-equivalent to one street on the
    chance-averaged equity matrix (the port's river solver)."""
    _, pg, _ = games(16, pot=4.0, bet=2.0, raise_=6.0, river_betting=False)
    strat = pt.solve_turn_river(pg, iterations=600)
    gap2 = pt.exploitability_gap(pg, strat)
    ev1, _ = pt.strategy_values(pg, strat)
    ref = pr.RiverGame(W=pt.chance_averaged_equity(pg), mask=pg.mask0,
                       pot=4.0, bet=2.0, raise_=6.0)
    rstrat = pr.solve_cfr_plus(ref, iterations=600)
    gap1 = pr.exploitability_gap(ref, rstrat)
    rev1, _ = pr.strategy_values(ref, rstrat)
    assert gap2 < 0.05 and gap1 < 0.05, (gap2, gap1)
    assert abs(ev1 - rev1) <= gap1 + gap2 + 1e-3


def test_turn_check_down_single_river_is_the_river_subgame():
    r = RIVERS[0]
    combos = jt.turn_combos(BOARD4)[::16]
    pot, frac = 4.0, 0.5
    game, _ = pt.make_turn_river_game(BOARD4, rivers=[r], combos=combos,
                                      pot=pot, river_bet_frac=frac,
                                      turn_betting=False, device="cpu")
    strat = pt.solve_turn_river(game, iterations=600)
    gap2 = pt.exploitability_gap(game, strat)
    ev1, _ = pt.strategy_values(game, strat)
    sub = np.array([c for c in combos if r not in (int(c[0]), int(c[1]))],
                   np.int32)
    ref, _, _ = pr.make_river_game(list(BOARD4) + [r], sub, sub, pot=pot,
                                   bet=frac * pot,
                                   raise_=pot + 2 * frac * pot, device="cpu")
    rstrat = pr.solve_cfr_plus(ref, iterations=600)
    gap1 = pr.exploitability_gap(ref, rstrat)
    rev1, _ = pr.strategy_values(ref, rstrat)
    assert float(game.mask0.sum()) == pytest.approx(float(ref.mask.sum()))
    assert gap2 < 0.05 and gap1 < 0.05, (gap2, gap1)
    assert abs(ev1 - rev1) <= gap1 + gap2 + 1e-3


# ---------------------------------------------------------------------------
# The rivers sharded over ranks (solve_turn_river(mesh=)), mirroring
# tests/test_turn_solver.py::test_mesh_sharded_solve_matches_single_device:
# 8 rivers, stride-24 combos, 300 iterations, on a gloo world of two CPU
# ranks. The EVs agree within the two gaps plus 1e-3 (the unique
# zero-sum Nash EV), with the port's single solve and with JAX's 8-device
# mesh solve: two ranks sum V1 and V2 in another float32 order. A world of
# one equals the single solve bit for bit.
# ---------------------------------------------------------------------------

MESH_ITERATIONS = 300


@pytest.fixture(scope="module")
def mesh_world():
    return local.spawn(workers.turn_solve, 2, "gloo", "cpu",
                       MESH_ITERATIONS)


@pytest.fixture(scope="module")
def mesh1():
    assert not dist.is_initialized()
    mesh = tm.make_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_mesh_sharded_solve_matches_single_and_jax(mesh_world):
    (strat0, refused), (strat1, _) = mesh_world
    for a, b in zip(strat0, strat1):
        np.testing.assert_array_equal(a, b)
    game = workers.turn_game(8, 24)
    sharded = to_port(strat0)
    single = pt.solve_turn_river(game, iterations=MESH_ITERATIONS)
    g1 = pt.exploitability_gap(game, single)
    g2 = pt.exploitability_gap(game, sharded)
    assert g1 < 0.05 and g2 < 0.05, (g1, g2)
    ev1, _ = pt.strategy_values(game, single)
    ev2, _ = pt.strategy_values(game, sharded)
    assert abs(ev1 - ev2) <= g1 + g2 + 1e-3, (ev1, ev2)

    dead = {int(c) for c in BOARD4}
    jgame, _ = jt.make_turn_river_game(
        BOARD4, rivers=[c for c in range(52) if c not in dead][:8],
        combos=jt.turn_combos(BOARD4)[::24], pot=4.0, bet=4.0, raise_=12.0)
    jmesh = JaxMesh(np.array(jax.devices()[:8]), ("r",))
    jstrat = jt.solve_turn_river(jgame, iterations=MESH_ITERATIONS,
                                 mesh=jmesh)
    g3 = jt.exploitability_gap(jgame, jstrat)
    ev3, _ = jt.strategy_values(jgame, jstrat)
    assert g3 < 0.05 and abs(ev2 - ev3) <= g2 + g3 + 1e-3, (ev2, ev3)
    assert refused and "must divide" in refused


def test_mesh_of_one_is_the_single_solve(mesh1):
    game = workers.turn_game(8, 24)
    for a, b in zip(pt.solve_turn_river(game, 100, mesh=mesh1),
                    pt.solve_turn_river(game, 100)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # a ragged tail runs a full chunk, as JAX's mesh mode: 70 -> 100
    for a, b in zip(pt.solve_turn_river(game, 70, mesh=mesh1),
                    pt.solve_turn_river(game, 100)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# Node states and net extraction
# ---------------------------------------------------------------------------

def test_node_states_with_prelude_equal_jax():
    """Every node (turn, each line's river nodes, the prelude) equals the
    JAX module's in every field but the key; the sizes equal."""
    jts, jrs, jsizes, jpre = jt.turn_river_node_states(BOARD4, RIVERS,
                                                       with_prelude=True)
    _, _, pts, prs, ppre = node_states()
    assert pt.turn_river_node_states(BOARD4, RIVERS, device="cpu")[2] \
        == jsizes == {"pot": 20.0, "bet": 20.0,
                      "river_bets": (20.0, 30.0, 30.0, 30.0)}
    for node in jts:
        assert_state_equal(jts[node], pts[node], f"turn {node}")
    for node in jpre:
        assert_state_equal(jpre[node], ppre[node], f"prelude {node}")
    for line in jrs:
        for node in jrs[line]:
            assert_state_equal(jrs[line][node], prs[line][node],
                               f"{line} {node}")


@pytest.mark.parametrize("subject,tol", [("es3", 1e-5), ("call_bot", 1e-6),
                                         ("pot_bot", 1e-6)])
def test_net_turn_river_strategy_matches_jax(subject, tol):
    if subject == "es3":
        jp = jpn.load_params("data/policy_6max_es3.npz")
        tp = tpn.load_params("data/policy_6max_es3.npz")
    else:
        action = 1 if subject == "call_bot" else 3
        jp, tp = jbots.action_bot(action), tbots.action_bot(action)
    combos = jt.turn_combos(BOARD4)[::24]
    jts, jrs, pts, prs, _ = node_states()
    want = jt.net_turn_river_strategy(jp, jts, jrs, combos)
    got = pt.net_turn_river_strategy(tp, pts, prs, combos)
    for f, w, g in zip(pt.TurnRiverStrategy._fields, want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol, err_msg=f)
    if subject == "call_bot":   # never bets, never folds
        np.testing.assert_allclose(got.t0[:, 0].numpy(), 1.0, atol=1e-4)
        np.testing.assert_allclose(got.t2[:, 1].numpy(), 1.0, atol=1e-4)
        np.testing.assert_allclose(got.s1[:3, ..., 0].numpy(), 1.0,
                                   atol=1e-4)
    if subject == "pot_bot":    # always bets; facing a bet continues
        np.testing.assert_allclose(got.t0[:, 1].numpy(), 1.0, atol=1e-4)
        np.testing.assert_allclose(got.t3[:, 1].numpy(), 1.0, atol=1e-4)
        np.testing.assert_allclose(got.s0[:3, ..., 1].numpy(), 1.0,
                                   atol=1e-4)
