"""The port's equity rollouts (K1/K2/B3 plain versions) against the JAX
kernels.

The JAX kernels draw their words from the TPU's PRNG, which has no CPU
lowering. So the JAX side here runs the kernel bodies' own jnp pieces
(``_sample_cards``, ``_masks_of``, ``eval_masks_cmp_impl``) on one
(128, 128) tile, with ``_uniform_draws`` patched to return injected numpy
words; for B3 it runs the kernel body of ``_make_multiway_kernel`` itself,
with ``pl`` and ``pltpu`` replaced by stubs that feed it the words. The
port's plain versions get the same words. Counts must be equal.
"""

import json
import math
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.cards import make_card
from montecarlo_tpu.ops import pallas_equity as pe
from montecarlo_tpu.ops.evaluator import eval_masks_cmp_impl
from montecarlo_tpu.rollout import equity as jeq
from montecarlo_tpu_torch.ops import cuda_equity as ce
from montecarlo_tpu_torch.rollout import equity as teq

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

AKS = [make_card(0, 14), make_card(0, 13)]
QQ = [make_card(1, 12), make_card(2, 12)]
TILE_N = pe.TILE[0] * pe.TILE[1]


def _patch_words(monkeypatch, words):
    """``_uniform_draws`` returning ``words[t] % bound_t`` (uint32)."""
    def draws(shape, bounds):
        assert tuple(shape) == pe.TILE
        return [(jnp.asarray(words[t].reshape(shape)) % jnp.uint32(b))
                .astype(jnp.int32) for t, b in enumerate(bounds)]
    monkeypatch.setattr(pe, "_uniform_draws", draws)


def _jax_masks(cards):
    m = [int(x) for x in pe._masks_of([jnp.int32(c) for c in cards], ())]
    return m if cards else [0, 0, 0, 0]


@pytest.mark.parametrize("n_board", [0, 3, 4])
def test_equity_counts_plain_matches_jax_kernel_body(monkeypatch, n_board):
    rng = np.random.default_rng(100 + n_board)
    deal = rng.permutation(52)[:4 + n_board].astype(np.int32)
    hero, villain, board = deal[:2], deal[2:4], deal[4:]
    dead = sorted(int(c) for c in deal)
    n_draw = 5 - n_board
    words = rng.integers(0, 1 << 32, (n_draw, TILE_N), dtype=np.uint64)

    bmask = _jax_masks(list(board))
    hm = [h | b for h, b in zip(_jax_masks(list(hero)), bmask)]
    vm = [v | b for v, b in zip(_jax_masks(list(villain)), bmask)]
    _patch_words(monkeypatch, words.astype(np.uint32))
    bm = pe._masks_of(pe._sample_cards([jnp.int32(d) for d in dead],
                                       pe.TILE, n_draw), pe.TILE)
    vh = eval_masks_cmp_impl(*[m | h for m, h in zip(bm, hm)])
    vv = eval_masks_cmp_impl(*[m | v for m, v in zip(bm, vm)])
    want = [int(jnp.sum(vh > vv)), int(jnp.sum(vh == vv))]

    got = ce._equity_counts_plain(torch.from_numpy(words.astype(np.int64)),
                                  dead, hm, vm)
    assert got.tolist() == want
    # the CPU wrapper on injected words takes the same plain version
    dead_t, hm_t, vm_t = ce._hand_masks(hero, villain, board, "cpu")
    via_wrapper = ce.equity_counts(
        0, dead_t, hm_t, vm_t, TILE_N,
        words=torch.from_numpy(words.astype(np.int64)))
    assert via_wrapper.tolist() == want


def test_sweep_counts_plain_matches_jax_kernel_body(monkeypatch):
    rng = np.random.default_rng(7)
    heroes = np.stack([rng.permutation(52)[:2] for _ in range(3)]) \
        .astype(np.int32)
    words = rng.integers(0, 1 << 32, (7, 3, TILE_N), dtype=np.uint64)
    want = []
    for h in range(3):
        _patch_words(monkeypatch, words[:, h].astype(np.uint32))
        dead = [jnp.int32(c) for c in sorted(heroes[h].tolist())]
        cards = pe._sample_cards(dead, pe.TILE, 7)
        vm = pe._masks_of(cards[:2], pe.TILE)
        bm = pe._masks_of(cards[2:], pe.TILE)
        hmask = _jax_masks(heroes[h].tolist())
        vh = eval_masks_cmp_impl(*[b | m for b, m in zip(bm, hmask)])
        vv = eval_masks_cmp_impl(*[b | v for b, v in zip(bm, vm)])
        want.append([int(jnp.sum(vh > vv)), int(jnp.sum(vh == vv))])

    from montecarlo_tpu_torch.ops.evaluator import suit_masks_from_cards
    ht = torch.from_numpy(heroes)
    dead_t = torch.sort(ht, dim=1).values
    hm_t = torch.stack(suit_masks_from_cards(ht), dim=1)
    got = ce._sweep_counts_plain(torch.from_numpy(words.astype(np.int64)),
                                 dead_t, hm_t)
    assert got.T.tolist() == want


@pytest.mark.parametrize("board", [(), (make_card(3, 2), make_card(1, 7),
                                        make_card(2, 13))])
def test_equity_exact_matches_jax(board):
    want = jeq.equity_exact(AKS, QQ, board)
    got = teq.equity_exact(AKS, QQ, board, device="cpu")
    assert (got.wins, got.ties, got.n) == (want.wins, want.ties, want.n)


def test_equity_vs_hand_cpu_within_4_sigma_of_exact():
    exact = teq.equity_exact(AKS, QQ, device="cpu").equity
    r = teq.equity_vs_hand(1234, AKS, QQ, 1 << 20, device="cpu")
    assert r.n == 1 << 20 and r.wins + r.ties + r.losses == r.n
    assert abs(r.equity - exact) < 4 * r.stderr, (r.equity, exact)


def test_equity_vs_random_cpu_within_4_sigma_of_sweep_record():
    rec = json.loads((Path(__file__).resolve().parent.parent / "data"
                      / "sweep169.json").read_text())["equity"]
    hands = dict(teq.canonical_hands())
    r = teq.equity_vs_random(99, hands["AA"], 1 << 18, device="cpu")
    assert abs(r.equity - rec["AA"]) < 4 * r.stderr, (r.equity, rec["AA"])


def test_canonical_hands_and_card_maps_match_jax():
    assert teq.canonical_hands() == [(lab, tuple(int(c) for c in cards))
                                     for lab, cards in jeq.canonical_hands()]
    dead = [3, 17, 40, 41]
    np.testing.assert_array_equal(teq.complement(dead).numpy(),
                                  np.asarray(jeq.complement(dead)))
    slots = np.arange(48, dtype=np.int32)
    np.testing.assert_array_equal(
        teq.slots_to_cards(torch.from_numpy(slots), torch.tensor(dead)),
        np.asarray(jeq.slots_to_cards(jnp.asarray(slots),
                                      jnp.asarray(dead))))
    with pytest.raises(ValueError):
        teq.equity_vs_hand(0, AKS, [AKS[0], QQ[0]], 16, device="cpu")


@pytest.mark.parametrize("n_hands", [2, 3, 6])
@pytest.mark.parametrize("n_board", [0, 3, 4])
def test_multiway_shares_plain_matches_jax_kernel_body(monkeypatch, n_hands,
                                                       n_board):
    """B3 on one (128, 128) tile of injected words: the JAX kernel body
    (program 0 of ``_make_multiway_kernel``) and the port's plain version
    give equal integer shares."""
    rng = np.random.default_rng(10 * n_hands + n_board)
    deal = rng.permutation(52)[:2 * n_hands + n_board].astype(np.int32)
    hands, board = deal[:2 * n_hands].reshape(n_hands, 2), deal[2 * n_hands:]
    dead, hm = ce._multiway_masks(hands, board, "cpu")
    n_draw = 5 - n_board
    words = rng.integers(0, 1 << 32, (n_draw, TILE_N), dtype=np.int64)
    draws = iter([jnp.asarray(w.astype(np.uint32).reshape(pe.TILE))
                  for w in words])
    monkeypatch.setattr(pe, "pl", types.SimpleNamespace(
        program_id=lambda axis: 0,
        when=lambda cond: (lambda body: body() if cond else None)))
    monkeypatch.setattr(pe, "pltpu", types.SimpleNamespace(
        prng_seed=lambda seed: None,
        prng_random_bits=lambda shape: next(draws)))
    scale = math.lcm(*range(1, n_hands + 1))
    want = np.zeros(n_hands, np.int32)
    pe._make_multiway_kernel(n_hands, len(dead), n_draw, scale)(
        np.zeros(1, np.int32), dead.numpy(), hm.numpy(), want)
    assert next(draws, None) is None  # every word consumed
    got = ce.multiway_shares(0, dead, hm, TILE_N,
                             words=torch.from_numpy(words))
    assert got.tolist() == want.tolist()
    assert int(got.sum()) == scale * TILE_N


AA = [make_card(0, 14), make_card(1, 14)]
KK = [make_card(2, 13), make_card(3, 13)]
SEVEN_SIX = [make_card(0, 7), make_card(1, 6)]


def test_equity_multiway_cpu():
    """tests/test_equity.py's multiway case on the port's CPU path."""
    hands = [AA, KK, SEVEN_SIX]
    eq, n = teq.equity_multiway(31, hands, 1 << 17, device="cpu")
    assert n == 1 << 17 and eq.shape == (3,)
    assert abs(float(eq.sum()) - 1.0) < 1e-12  # the equities partition 1
    assert eq[0] > eq[1] > 0.15                # AA > KK
    assert eq[2] < 0.30
    assert 0.5 < eq[0] < 0.68, eq              # about 0.58 / 0.24 / 0.18
    # two hands: the same question as equity_vs_hand
    two = teq.equity_multiway(32, hands[:2], 1 << 17, device="cpu")[0]
    pair = teq.equity_vs_hand(33, AA, KK, 1 << 17, device="cpu")
    assert abs(float(two[0]) - pair.equity) < 0.01
    # the Philox words of the CPU wrapper are the kernel's
    dead, hm = ce._multiway_masks(hands, (), "cpu")
    assert torch.equal(
        ce.multiway_shares(31, dead, hm, 5000),
        ce._multiway_shares_plain(ce.multiway_words(31, 5, 0, 5000, "cpu"),
                                  dead.tolist(), hm.tolist()))


def test_equity_multiway_rejects_overlaps_and_bad_sizes():
    ah = make_card(2, 14)
    with pytest.raises(ValueError):
        teq.equity_multiway(0, [[ah, make_card(2, 13)], [ah, make_card(3, 2)]],
                            1000, device="cpu")
    with pytest.raises(ValueError):
        teq.equity_multiway(0, [AA, KK], 1000, board=[AA[0]], device="cpu")
    with pytest.raises(ValueError):  # one hand is no pot to split
        teq.equity_multiway(0, [AA], 1000, device="cpu")
    thirteen = np.arange(26).reshape(13, 2)
    with pytest.raises(ValueError):  # lcm(1..13) shares overflow int32
        teq.equity_multiway(0, thirteen, 1000, device="cpu")
    with pytest.raises(ValueError):  # six board cards
        teq.equity_multiway(0, [AA, KK], 1000, board=[20, 21, 22, 23, 24, 25],
                            device="cpu")
