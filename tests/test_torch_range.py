"""The port's range equity (``rollout/equity.py``: ``sample_distinct``,
``expand_range``, ``equity_vs_range`` and the exact range functions) and
the evaluator's key table against the JAX package, on the CPU.

The exact functions must equal JAX's: the wins and ties of every combo
pair as integers, the pair equities and the aggregate in float64. The
draws come from the port's Philox streams, not from ``jax.random``, so
Monte Carlo results are held to exact ones within 4 sigma.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.cards import make_card
from montecarlo_tpu.ops import evaluator as jev
from montecarlo_tpu.rollout import equity as jeq
from montecarlo_tpu_torch.ops import evaluator as tev
from montecarlo_tpu_torch.rollout import equity as teq

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

H, D, S, C = 0, 1, 2, 3


@pytest.mark.parametrize("labels", [
    ["AA"], ["AKs"], ["AKo"], ["QQ", "AKs"], ["72o", "T9s", "22", "KQ"]])
def test_expand_range_matches_jax(labels):
    if labels[-1] == "KQ":  # neither pair, suited nor offsuit
        with pytest.raises(ValueError):
            teq.expand_range(labels)
        with pytest.raises(ValueError):
            jeq.expand_range(labels)
        return
    got = teq.expand_range(labels)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jeq.expand_range(labels))


# tests/test_equity.py's exact range cases: a flop (1,176 boards swept,
# 990 live a pair), a turn (48, 44) and a weighted turn.
RANGE_CASES = {
    "flop_qq_vs_aks": (jeq.expand_range(["QQ"])[:4], jeq.expand_range(["AKs"]),
                       None, None,
                       [make_card(0, 12), make_card(1, 7), make_card(2, 2)]),
    "turn_tt_a9s_vs_kqs_66": (jeq.expand_range(["TT", "A9s"]),
                              jeq.expand_range(["KQs", "66"]), None, None,
                              [make_card(0, 11), make_card(1, 8),
                               make_card(2, 3), make_card(3, 13)]),
    "turn_weighted_aa_vs_kk_22": (jeq.expand_range(["AA"]),
                                  jeq.expand_range(["KK", "22"]),
                                  np.linspace(0.5, 2.0, 6),
                                  np.array([1.0] * 6 + [0.25] * 6),
                                  [make_card(2, 9), make_card(3, 6),
                                   make_card(1, 4), make_card(0, 10)]),
}


@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_exact_range_vs_range_matches_jax(case):
    hero, vill, wh, wv, board = RANGE_CASES[case]
    fixed = np.asarray(board, np.int32)
    boards3d, valid2d = jeq._enumerate_boards(fixed, 1 << 24,
                                              len(hero) * len(vill))
    t_boards, t_valid = teq._enumerate_boards(fixed, 1 << 24,
                                              len(hero) * len(vill))
    np.testing.assert_array_equal(t_boards, boards3d)
    np.testing.assert_array_equal(t_valid, valid2d)
    # wins and ties of every pair, as integers
    jw, jt = jeq._range_pair_counts(
        jnp.asarray(boards3d), jnp.asarray(valid2d),
        jev.suit_masks_from_cards(jnp.asarray(hero)),
        jev.suit_masks_from_cards(jnp.asarray(vill)))
    tw, tt = teq._range_pair_counts(
        torch.from_numpy(t_boards.reshape(-1, 5)),
        torch.from_numpy(t_valid.reshape(-1)),
        tev.suit_masks_from_cards(torch.from_numpy(hero)),
        tev.suit_masks_from_cards(torch.from_numpy(vill)), t_boards.shape[1])
    assert tw.dtype == tt.dtype == torch.int64
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw, np.int64))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt, np.int64))
    # the pair equities and the aggregate, in float64
    want = jeq.equity_exact_range_vs_range(hero, vill, wh, wv, board=board)
    got = teq.equity_exact_range_vs_range(hero, vill, wh, wv, board=board,
                                          device="cpu")
    assert got.equity == want.equity and got.n_boards == want.n_boards
    np.testing.assert_array_equal(got.pair_weight, want.pair_weight)
    np.testing.assert_array_equal(got.pair_equity, want.pair_equity)
    h = next(h for h in hero.tolist() if not set(h) & set(board))
    one = jeq.equity_exact_vs_range(h, vill, wv, board=board)
    assert teq.equity_exact_vs_range(h, vill, wv, board=board,
                                     device="cpu").equity == one.equity


def test_exact_range_vs_range_small_chunks_equal_one_chunk():
    """The sweep's chunking (four chunks, the last one padding) does not
    change the counts."""
    hero, vill, _, _, board = RANGE_CASES["flop_qq_vs_aks"]
    whole = teq.equity_exact_range_vs_range(hero, vill, board=board,
                                            device="cpu")
    done = []
    parts = teq.equity_exact_range_vs_range(hero, vill, board=board,
                                            elem_budget=300 * 16,
                                            progress=done.append,
                                            device="cpu")
    np.testing.assert_array_equal(parts.pair_equity, whole.pair_equity)
    assert done[-1] == math.comb(49, 2)


def test_exact_range_vs_range_rejects_disjointless_ranges():
    aa = teq.expand_range(["AA"])
    with pytest.raises(ValueError):
        teq.equity_exact_range_vs_range(aa[:1], aa[:1], device="cpu")


def test_sample_distinct_is_distinct_and_in_range():
    slots = teq.sample_distinct(0, 48, 5, 4096, device="cpu")
    assert slots.shape == (4096, 5) and slots.dtype == torch.int32
    assert int(slots.min()) >= 0 and int(slots.max()) < 48
    assert all(len(set(row)) == 5 for row in slots.tolist())
    full = teq.sample_distinct(3, 7, 7, 512, device="cpu")
    assert all(sorted(row) == list(range(7)) for row in full.tolist())


def test_sample_distinct_uniform_marginals():
    B = 40_000
    slots = teq.sample_distinct(1, 48, 5, B, device="cpu").numpy()
    counts = np.bincount(slots.reshape(-1), minlength=48)
    expected = B * 5 / 48
    sigma = np.sqrt(B * 5 * (1 / 48) * (47 / 48))
    assert np.all(np.abs(counts - expected) < 6 * sigma), counts
    # every draw position alone is uniform too
    for t in range(5):
        c = np.bincount(slots[:, t], minlength=48)
        s = np.sqrt(B * (1 / 48) * (47 / 48))
        assert np.all(np.abs(c - B / 48) < 6 * s), (t, c)


def test_sample_distinct_same_slots_for_a_seed():
    a = teq.sample_distinct(7, 48, 5, 1000, device="cpu")
    assert torch.equal(a, teq.sample_distinct(7, 48, 5, 1000, device="cpu"))
    # row r depends on r and the seed alone
    assert torch.equal(a[:100], teq.sample_distinct(7, 48, 5, 100,
                                                    device="cpu"))
    assert not torch.equal(a, teq.sample_distinct(8, 48, 5, 1000,
                                                  device="cpu"))


def test_equity_vs_range_within_4_sigma_of_exact():
    """tests/test_equity.py:279's check, on a weighted two-combo range (an
    exact preflop sweep costs about 2 s a combo on one CPU thread)."""
    hero = [make_card(H, 14), make_card(H, 13)]                  # AhKh
    vill = [[make_card(S, 12), make_card(C, 12)],               # QsQc
            [make_card(D, 13), make_card(S, 13)]]               # KdKs
    w = [1.0, 3.0]
    exact = teq.equity_exact_vs_range(hero, vill, w, device="cpu")
    mc = teq.equity_vs_range(3, hero, vill, 1 << 18, weights=w,
                             batch_size=1 << 16, device="cpu")
    assert mc.n == 1 << 18 and mc.wins + mc.ties + mc.losses == mc.n
    assert abs(mc.equity - exact.equity) < 4 * mc.stderr, (mc.equity,
                                                           exact.equity)
    # the same rollouts in other batches give the same counts
    again = teq.equity_vs_range(3, hero, vill, 1 << 18, weights=w,
                                device="cpu")
    assert again == mc


def test_equity_vs_range_drops_hero_combos():
    hero = [make_card(H, 14), make_card(D, 14)]                  # AhAd
    aa = teq.expand_range(["AA"])                   # one combo survives
    res = teq.equity_vs_range(14, hero, aa, 4096, device="cpu")
    assert res.n == 4096 and res.ties > res.wins + res.losses
    with pytest.raises(ValueError):
        teq.equity_vs_range(0, hero, aa[:1], 1024, device="cpu")
    with pytest.raises(ValueError):
        teq.equity_vs_range(0, [hero[0], hero[0]], aa, 1024, device="cpu")


def test_every_hand_keys_match_jax_on_a_small_deck():
    """The walk chip_smoke.py runs over all C(52, 7) hands, on the hands of
    the first 17 cards (all hearts, four diamonds): its (packed, cmp)
    table equals the JAX evaluator's over the same hands."""
    n, table = tev.every_hand_keys(17, device="cpu")
    hands = np.array(list(itertools.combinations(range(17), 7)), np.int32)
    assert n == len(hands) == math.comb(17, 7)
    m = jev.suit_masks_from_cards(jnp.asarray(hands))
    packed = np.asarray(jev.eval_masks(*m)).astype(np.int64)
    cmp = np.asarray(jev.eval_masks_cmp(*m)).astype(np.int64)
    want = np.unique(np.stack([packed, cmp], axis=1), axis=0)
    np.testing.assert_array_equal(table.numpy(), want)
