"""The port's torch evaluator against the JAX evaluator, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.cards import make_card
from montecarlo_tpu.ops import evaluator as jev
from montecarlo_tpu_torch.ops import evaluator as tev
from test_evaluator import GOLDEN

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

# Golden hands made of distinct physical cards with real ranks (card ids
# cannot encode the synthetic rank-1 cards of some reference vectors).
GOLDEN_IDS = [[make_card(s, r) for s, r in cards] for cards, _ in GOLDEN
              if len(set(cards)) == 5 and all(r >= 2 for _, r in cards)]


def _random_hands(n, k, seed):
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((n, 52)), axis=1)[:, :k].astype(np.int32)


def _both(hands):
    jm = jev.suit_masks_from_cards(jnp.asarray(hands))
    tm = tev.suit_masks_from_cards(torch.from_numpy(hands))
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return jm, tm


@pytest.mark.parametrize("hand", GOLDEN_IDS)
def test_golden_hands_match_jax(hand):
    hands = np.asarray([hand], np.int32)
    jm, tm = _both(hands)
    assert (tev.eval7_from_cards(torch.from_numpy(hands)).tolist()
            == np.asarray(jev.eval7_from_cards(jnp.asarray(hands)))
            .astype(np.int64).tolist())
    assert (tev.eval_masks_cmp_impl(*tm).tolist()
            == np.asarray(jev.eval_masks_cmp(*jm)).tolist())


@pytest.mark.parametrize("k", [5, 7])
def test_random_hands_match_jax(k):
    hands = _random_hands(200_000, k, seed=k)
    jm, tm = _both(hands)
    packed = tev.eval_masks_impl(*tm).numpy()
    np.testing.assert_array_equal(
        packed.astype(np.int64),
        np.asarray(jev.eval_masks(*jm)).astype(np.int64))
    cmp = tev.eval_masks_cmp_impl(*tm).numpy()
    np.testing.assert_array_equal(cmp, np.asarray(jev.eval_masks_cmp(*jm)))
    # the comparison key orders and ties hands exactly like the packed key
    order = np.argsort(packed, kind="stable")
    p, c = packed[order], cmp[order]
    same = p[1:] == p[:-1]
    np.testing.assert_array_equal(same, c[1:] == c[:-1])
    assert np.all(c[1:][~same] > c[:-1][~same])


def test_popcount_and_msb_emulation():
    x = torch.arange(0, 1 << 16, dtype=torch.int32)
    want_pop = np.array([bin(v).count("1") for v in range(1 << 16)])
    np.testing.assert_array_equal(tev._popcount(x).numpy(), want_pop)
    want_msb = np.array([v.bit_length() - 1 for v in range(1 << 16)])
    np.testing.assert_array_equal(tev._msb(x).numpy(), want_msb)


@pytest.mark.parametrize("name", ["eval_masks", "eval_masks_cmp"])
@pytest.mark.parametrize("k", [5, 6, 7])
def test_public_names_match_jax_jitted(name, k):
    """The JAX module's public names (its jitted forms) exist in the port
    and give the same keys on a few thousand seeded hands."""
    hands = _random_hands(4096, k, seed=100 + k)
    jm, tm = _both(hands)
    ours = getattr(tev, name)(*tm).numpy().astype(np.int64)
    theirs = np.asarray(getattr(jev, name)(*jm)).astype(np.int64)
    np.testing.assert_array_equal(ours, theirs)
