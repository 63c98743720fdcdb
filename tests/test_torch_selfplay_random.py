"""The port's self-play under the random policy: the cases of
``tests/test_selfplay.py`` and ``tests/test_tournament.py:87,121`` on the
port, and random play held against JAX's statistically.

The port draws its random actions from Philox words and JAX from threefry
keys, so the two agree in distribution only: on the same configuration,
steps per hand (the ``time`` of a settled hand) and each position's
settled bb/hand agree within 4 sigma of their difference (the two
standard errors combined).
"""

import jax
import numpy as np
import torch

from montecarlo_tpu.engine.state import TableConfig as JaxConfig
from montecarlo_tpu.rollout import selfplay as jsp
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.rollout import policy as tpol
from montecarlo_tpu_torch.rollout import selfplay as tsp

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)


def test_selfplay_completes_and_is_deterministic():
    cfg = TableConfig(num_seats=6, max_layers=16, max_pot_layers=48)
    final = tsp.play_hands(42, cfg, 64, num_hands=2, device="cpu")
    assert bool(final.hand_over.all()), "some hands did not complete"
    assert not bool(final.bets.overflow.any())
    assert not bool(final.pots.overflow.any())
    assert int(final.hand_idx.max()) == 1  # 2 hands: idx 0, 1
    assert bool((final.time > 0).all())
    again = tsp.play_hands(42, cfg, 64, num_hands=2, device="cpu")
    assert torch.equal(final.stacks, again.stacks)
    stats = tsp.selfplay_stats(final)
    assert stats["tables"] == 64
    assert float(stats["bet_overflow_frac"]) == 0.0
    assert int(stats["hands_played"]) == 1


def test_selfplay_heads_up():
    cfg = TableConfig(num_seats=2, max_layers=16, max_pot_layers=48)
    final = tsp.play_hands(3, cfg, 32, num_hands=1, device="cpu")
    assert bool(final.hand_over.all())


def test_seat_policies_agent_vs_agent():
    """A calling station against a half-folder, heads up, standard rules:
    the caller profits from the blinds the folder surrenders."""
    cfg = TableConfig(num_seats=2, rules="standard")
    policy = tpol.seat_policies([tpol.always_call, tpol.tight_policy])
    final = tsp.play_hands(17, cfg, 256, num_hands=1, policy=policy,
                           device="cpu")
    assert bool(final.hand_over.all())
    sums = final.stacks.sum(1)
    assert bool((sums == 200).all())
    assert float(final.stacks[:, 0].float().mean()) > 100.0


def test_collect_deltas_and_position_winrates():
    cfg = TableConfig(num_seats=3, rules="standard")
    final, deltas = tsp.play_hands(23, cfg, 128, num_hands=4,
                                   collect_deltas=True, device="cpu")
    assert tuple(deltas.shape) == (128, 4, 3)
    assert not bool(deltas.sum(2).any())  # chips conserve hand by hand
    assert int(deltas.sum()) == int(final.stacks.sum()) - 128 * 300
    mean_bb, se = tsp.position_winrates(deltas.numpy(), cfg.big_blind)
    assert mean_bb.shape == (3,) and np.all(np.isfinite(se))
    want = jsp.position_winrates(deltas.numpy(), cfg.big_blind)
    np.testing.assert_array_equal(mean_bb, want[0])
    np.testing.assert_array_equal(se, want[1])


def test_play_hands_perpetual_counts_hands():
    cfg = TableConfig(num_seats=6)
    final, hands = tsp.play_hands_perpetual(11, cfg, 64, 96, device="cpu")
    assert int(hands) > 64  # a hand every ~26 actions
    assert int(final.hand_idx.max()) >= 1
    assert bool((final.stacks < 10_000).all())


def _tour_cfg(**kw):
    kw = {"num_seats": 6, "rules": "tournament", "small_blind": 25,
          "big_blind": 50, "max_layers": 16, "max_pot_layers": 48, **kw}
    return TableConfig(**kw)


def test_tournaments_terminate_conserve_and_crown_a_winner():
    """``tests/test_tournament.py:87`` on the port."""
    cfg = _tour_cfg()
    n_tables, max_hands = 256, 64
    _, busted, seat_stacks = tsp.play_tournament(3, cfg, n_tables,
                                                 max_hands, device="cpu")
    stacks = seat_stacks.numpy().astype(np.int64)
    busted = busted.numpy().astype(np.int64)
    total = cfg.num_seats * cfg.starting_stack
    np.testing.assert_array_equal(stacks.sum(axis=1),
                                  np.full(n_tables, total))
    done = (stacks > 0).sum(axis=1) == 1
    assert done.mean() > 0.95, f"only {done.mean():.0%} terminated"
    d = done.nonzero()[0]
    assert ((stacks[d] == total).sum(axis=1) == 1).all()
    assert ((stacks[d] == 0).sum(axis=1) == cfg.num_seats - 1).all()
    assert ((busted[d] <= max_hands).sum(axis=1) == cfg.num_seats - 1).all()
    places = tsp.tournament_placements(busted, stacks)
    assert places.shape == (n_tables, cfg.num_seats)
    np.testing.assert_array_equal(
        np.sort(places, axis=1),
        np.tile(np.arange(1, cfg.num_seats + 1), (n_tables, 1)))
    win_seat = places[d].argmin(axis=1)
    assert (stacks[d, win_seat] == total).all()


def test_heads_up_tournament():
    """``tests/test_tournament.py:121`` on the port."""
    cfg = _tour_cfg(num_seats=2)
    _, _, seat_stacks = tsp.play_tournament(4, cfg, 128, 48, device="cpu")
    stacks = seat_stacks.numpy().astype(np.int64)
    np.testing.assert_array_equal(stacks.sum(axis=1), np.full(128, 200))
    done = (stacks > 0).sum(axis=1) == 1
    assert done.mean() > 0.95
    assert ((stacks[done] == 200).sum(axis=1) == 1).all()


def test_random_play_agrees_with_jax_within_4_sigma():
    """Steps per hand and each position's bb/hand of one independent
    6-max standard-rules hand, the port's Philox draws against JAX's
    threefry draws on 2,048 tables each: |z| < 4 for each statistic."""
    n = 2048
    jcfg = JaxConfig(num_seats=6, rules="standard")
    jfinal, jdeltas = jsp.play_hands(jax.random.split(jax.random.key(8), n),
                                     jcfg, num_hands=1, collect_deltas=True)
    final, deltas = tsp.play_hands(8, TableConfig(num_seats=6,
                                                  rules="standard"), n,
                                   collect_deltas=True, device="cpu")

    def z(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        return (a.mean() - b.mean()) / se

    steps = z(final.time.numpy(), np.asarray(jfinal.time))
    assert abs(steps) < 4, steps
    assert 15 < float(final.time.float().mean()) < 40
    pos = [z(deltas[:, 0, k].numpy() / 10, np.asarray(jdeltas)[:, 0, k] / 10)
           for k in range(6)]
    assert max(abs(x) for x in pos) < 4, pos
    assert not bool(deltas.sum(2).any())
