"""Philox4x32-10 in plain PyTorch (``montecarlo_tpu_torch/ops/philox.py``):
the published known answers, and the word order that the kernels and the
plain versions share (chunking and stream keying change no result)."""

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import philox
from montecarlo_tpu_torch.rollout import equity as teq

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

# (counter x0..x3, key k0 k1) -> output: the philox4x32 10-round vectors of
# the Random123 distribution's kat_vectors (Salmon et al., SC'11).
PHILOX_KAT = [
    ([0, 0, 0, 0, 0, 0],
     [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 6,
     [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822,
      0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


@pytest.mark.parametrize("ctr_key,want", PHILOX_KAT)
def test_plain_philox_known_answers(ctr_key, want):
    got = philox.philox_blocks(torch.tensor([ctr_key], dtype=torch.int64))
    assert got[0].tolist() == want


def test_stream_words_are_block_outputs_in_order():
    lo = torch.tensor([0, 7, 0xFFFFFFFF], dtype=torch.int64)
    words = philox.stream_words(123, lo, 5, 2, 0, 12)
    assert words.shape == (12, 3)
    for j, stream in enumerate(lo.tolist()):
        rows = torch.tensor([[b, 5, 2, 0, 123, stream] for b in range(3)])
        blocks = philox.philox_blocks(rows)
        assert words[:, j].tolist() == blocks.reshape(-1).tolist()
    # any window of a stream is a slice of the whole stream
    for start, n in ((3, 7), (4, 4), (1, 1), (5, 7)):
        np.testing.assert_array_equal(
            philox.stream_words(123, lo, 5, 2, start, n),
            words[start:start + n])
    assert int(words.min()) >= 0 and int(words.max()) < 1 << 32


def test_equity_philox_words_key_rollouts_by_64_bit_index():
    """Rollout r is stream (seed, r mod 2^32, r >> 32, 0): a window across
    2^32 keys by the full index, and counts do not depend on chunking."""
    start = (1 << 32) - 3
    w = cq.equity_words(9, 5, start, 6, "cpu")
    for i in range(6):
        r = start + i
        want = philox.stream_words(9, torch.tensor([r & 0xFFFFFFFF]),
                                   r >> 32, 0, 0, 5)[:, 0]
        assert w[:, i].tolist() == want.tolist()
    dead, hm, vm = (m.tolist() for m in cq._hand_masks(
        [0, 12], [25, 38], [5, 6, 7], "cpu"))
    counts = [cq._equity_counts_plain_philox(4, dead, hm, vm, 5000, "cpu",
                                             chunk=c).tolist()
              for c in (5000, 1024, 333)]
    assert counts[0] == counts[1] == counts[2]


def test_sweep_philox_words_and_chunking():
    w = cq.sweep_words(3, 4, 10, 5, "cpu")
    assert w.shape == (7, 4, 5)
    for h in range(4):
        want = philox.stream_words(3, torch.arange(10, 15), 0, h + 1, 0, 7)
        assert torch.equal(w[:, h], want)
    heroes = torch.tensor([[0, 13], [5, 40], [12, 25]], dtype=torch.int32)
    dead = torch.sort(heroes, dim=1).values
    hm = torch.stack(cq.suit_masks_from_cards(heroes), dim=1)
    a = cq._sweep_counts_plain_philox(8, dead, hm, 3000, chunk=9000)
    b = cq._sweep_counts_plain_philox(8, dead, hm, 3000, chunk=1000)
    assert torch.equal(a, b)
    assert torch.equal(cq.sweep_counts(8, dead, hm, 3000), a)


def test_prng_words_iterations_tile_one_stream():
    T, P, n_steps = 16, 6, 48
    n_iter, W, _ = ce.prng_words_shape(T, P, n_steps)
    whole = philox.stream_words(77, torch.arange(T), 0, 0, 0, n_iter * W)
    for it in range(n_iter):
        assert torch.equal(ce.prng_words(77, T, P, n_steps, it, "cpu"),
                           whole[it * W:(it + 1) * W])


@pytest.mark.parametrize("P,n_steps", [(6, 32), (2, 24)])
def test_prng_plain_philox_equals_plain_on_the_same_words(P, n_steps):
    cfg = TableConfig(num_seats=P)
    T = ce.TABLES_PER_BLOCK
    state = ce.pack_state(cfg, ce.first_deal(1, T, P, "cpu"))
    n_iter = ce.prng_words_shape(T, P, n_steps)[0]
    words = torch.stack([ce.prng_words(42, T, P, n_steps, it, "cpu")
                         for it in range(n_iter)])
    got = ce.run_perpetual_prng(42, state, P, n_steps, 5, 10)
    assert torch.equal(got, ce._run_prng_plain(state, words, P, n_steps,
                                               5, 10))


def test_first_deal_is_distinct_and_seeded():
    deal = ce.first_deal(5, 4096, 9, "cpu")
    assert deal.shape == (4096, 23) and deal.dtype == torch.int32
    assert int(deal.min()) >= 0 and int(deal.max()) < 52
    assert bool((deal.sort(dim=1).values.diff(dim=1) > 0).all())
    assert torch.equal(deal, ce.first_deal(5, 4096, 9, "cpu"))
    assert not torch.equal(deal, ce.first_deal(6, 4096, 9, "cpu"))


def test_cpu_wrappers_are_seeded_by_philox():
    hero, villain = [0, 12], [25, 38]
    r = teq.equity_vs_hand(11, hero, villain, 4096, device="cpu")
    dead, hm, vm = (m.tolist() for m in cq._hand_masks(hero, villain, (),
                                                        "cpu"))
    want = cq._equity_counts_plain(cq.equity_words(11, 5, 0, 4096, "cpu"),
                                   dead, hm, vm)
    assert [r.wins, r.ties] == want.tolist()
