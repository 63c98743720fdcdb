"""Cards, hand keys and random words for the plain reference.

A frozen copy of the semantics the port's kernels implement, in plain
PyTorch, so that a later change to the port cannot move the yardstick:

- Philox4x32-10 (Salmon et al., SC'11) on int64 tensors: a stream is keyed
  by (seed, stream_lo) with the counter words (block, stream_hi, sub, 0);
  word i of a stream is output i % 4 of block i // 4;
- card ids ``suit * 13 + rank - 2`` and four suit masks a hand (bit ``r`` of
  mask ``s`` set when the hand holds rank ``r`` in suit ``s``);
- the 7-card keys: ``eval_masks`` (the packed ``cat << 20 | ranks`` key the
  net's features read) and ``eval_masks_cmp`` (the comparison key, whose
  ``<``/``==`` order equals the packed key's);
- k distinct cards from k words: draw t is word t modulo the ``n - t`` live
  slots, rank-shifted past the earlier draws and then past the dead cards.

``draw_bits=16`` (the control's sampler) takes each draw from the word's
high 16 bits, the draw a cheaper sampler would make.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
MASK = 0xFFFFFFFF
NUM_RANKS = 13
CAT_SHIFT = 20
(CAT_HIGH, CAT_PAIR, CAT_TWO_PAIR, CAT_TRIPS, CAT_STRAIGHT, CAT_FLUSH,
 CAT_FULL_HOUSE, CAT_QUADS, CAT_STRAIGHT_FLUSH) = range(9)

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a, m: int):
    p1 = a * (m >> 16)
    p0 = a * (m & 0xFFFF)
    mid = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (mid >> 32), mid & MASK


def philox(ctr, key):
    """Philox4x32-10 of four counter words and two key words (int64
    tensors or ints in [0, 2^32) that broadcast): four int64 words."""
    x0, x1, x2, x3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(x0, M0)
        hi1, lo1 = _mulhilo(x2, M1)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + W0) & MASK
        k1 = (k1 + W1) & MASK
    return x0, x1, x2, x3


def stream_words(seed: int, stream_lo, stream_hi, sub, start: int, n: int):
    """Words ``start .. start + n - 1`` of streams (seed, stream_lo,
    stream_hi, sub): int64 [n, *shape of the broadcast stream ids]."""
    lo = torch.as_tensor(stream_lo, dtype=I64)
    hi = torch.as_tensor(stream_hi, dtype=I64, device=lo.device)
    sb = torch.as_tensor(sub, dtype=I64, device=lo.device)
    lo, hi, sb = torch.broadcast_tensors(lo, hi, sb)
    zero = torch.zeros_like(lo)
    words = []
    for block in range(start // 4, (start + n - 1) // 4 + 1):
        words.extend(philox((zero + block, hi, sb, zero),
                            (int(seed) & MASK, lo)))
    first = start % 4
    return torch.stack(words[first:first + n])


# ---------------------------------------------------------------------------
# Hand keys
# ---------------------------------------------------------------------------

def _popcount(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def _msb(x):
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return _popcount(x) - 1


def _bit(pos):
    one = torch.ones_like(pos)
    return torch.where(pos >= 0, one << pos.clamp(min=0), 0)


def _top_ranks(mask, k):
    out = []
    for _ in range(k):
        p = _msb(mask)
        mask = mask & ~_bit(p)
        out.append(p.clamp(min=0))
    return out


def _run5_top(mask):
    r = mask & (mask >> 1) & (mask >> 2) & (mask >> 3) & (mask >> 4)
    return torch.where(r > 0, _msb(r) + 4, -1)


def suit_masks(cards):
    """[..., K] distinct card ids -> four [...]-shaped int32 suit masks."""
    cards = torch.as_tensor(cards).to(I32)
    suits = cards // NUM_RANKS
    rank_bits = torch.ones_like(cards) << (2 + cards % NUM_RANKS)
    masks = []
    for s in range(4):
        contrib = torch.where(suits == s, rank_bits, 0)
        m = torch.zeros(cards.shape[:-1], dtype=I32, device=cards.device)
        for j in range(cards.shape[-1]):
            m = m | contrib[..., j]
        masks.append(m)
    return masks


def masks_of(cards):
    """Four suit masks of a list of same-shaped card tensors."""
    return suit_masks(torch.stack(cards, dim=-1))


def _categories(m0, m1, m2, m3):
    present = m0 | m1 | m2 | m3
    c2p = (m0 & m1) | (m0 & m2) | (m0 & m3) | (m1 & m2) | (m1 & m3) | (m2 & m3)
    c3p = (m0 & m1 & m2) | (m0 & m1 & m3) | (m0 & m2 & m3) | (m1 & m2 & m3)
    c4 = m0 & m1 & m2 & m3
    trips = c3p & ~c4
    pairs = c2p & ~c3p
    straight_top = _run5_top(present)
    fmask = torch.zeros_like(m0)
    for m in (m0, m1, m2, m3):
        fmask = fmask | torch.where(_popcount(m) >= 5, m, 0)
    sf_top = _run5_top(fmask)
    flags = {
        "sf": sf_top >= 0,
        "quads": c4 != 0,
        "fh": (trips != 0) & ((pairs != 0) | (_popcount(trips) >= 2)),
        "flush": fmask != 0,
        "straight": straight_top >= 0,
        "trips": trips != 0,
        "two_pair": _popcount(pairs) >= 2,
        "pair": pairs != 0,
    }
    return present, c4, trips, pairs, fmask, straight_top, sf_top, flags


def eval_masks(m0, m1, m2, m3):
    """Suit masks -> packed key ``cat << 20 | r0 << 16 | ... | r4``."""
    present, c4, trips, pairs, fmask, straight_top, sf_top, f = \
        _categories(m0, m1, m2, m3)
    q = _msb(c4).clamp(min=0)
    qk = _msb(present & ~_bit(q)).clamp(min=0)
    t = _msb(trips).clamp(min=0)
    p_fh = _msb((trips | pairs) & ~_bit(t)).clamp(min=0)
    tk1, tk2 = _top_ranks(present & ~_bit(t), 2)
    hp, lp = _top_ranks(pairs, 2)
    tpk = _msb(present & ~_bit(hp) & ~_bit(lp)).clamp(min=0)
    p1 = _msb(pairs).clamp(min=0)
    pk1, pk2, pk3 = _top_ranks(present & ~_bit(p1), 3)
    table = [
        (f["sf"], CAT_STRAIGHT_FLUSH,
         [(sf_top - i).clamp(min=0) for i in range(5)]),
        (f["quads"], CAT_QUADS, [q, q, q, q, qk]),
        (f["fh"], CAT_FULL_HOUSE, [t, t, t, p_fh, p_fh]),
        (f["flush"], CAT_FLUSH, _top_ranks(fmask, 5)),
        (f["straight"], CAT_STRAIGHT,
         [(straight_top - i).clamp(min=0) for i in range(5)]),
        (f["trips"], CAT_TRIPS, [t, t, t, tk1, tk2]),
        (f["two_pair"], CAT_TWO_PAIR, [hp, hp, lp, lp, tpk]),
        (f["pair"], CAT_PAIR, [p1, p1, pk1, pk2, pk3]),
    ]
    cat = torch.full_like(m0, CAT_HIGH)
    ranks = _top_ranks(present, 5)
    for cond, c, rs in reversed(table):
        cat = torch.where(cond, c, cat)
        ranks = [torch.where(cond, a, b) for a, b in zip(rs, ranks)]
    key = cat << CAT_SHIFT
    for i, r in enumerate(ranks):
        key = key | (r << (16 - 4 * i))
    return key


def _keep_top(mask, n, max_clears):
    for _ in range(max_clears):
        mask = torch.where(_popcount(mask) > n, mask & (mask - 1), mask)
    return mask


def eval_masks_cmp(m0, m1, m2, m3):
    """Suit masks -> comparison key ``cat << 19 | payload``."""
    present, c4, trips, pairs, fmask, straight_top, sf_top, f = \
        _categories(m0, m1, m2, m3)
    q = _msb(c4).clamp(min=0)
    qk = _msb(present & ~_bit(q)).clamp(min=0)
    t = _msb(trips).clamp(min=0)
    p_fh = _msb((trips | pairs) & ~_bit(t)).clamp(min=0)
    top2_pairs = _keep_top(pairs, 2, 1)
    p1 = _msb(pairs).clamp(min=0)
    table = [
        (f["sf"], CAT_STRAIGHT_FLUSH, sf_top.clamp(min=0)),
        (f["quads"], CAT_QUADS, (q << 4) | qk),
        (f["fh"], CAT_FULL_HOUSE, (t << 4) | p_fh),
        (f["flush"], CAT_FLUSH, _keep_top(fmask, 5, 2)),
        (f["straight"], CAT_STRAIGHT, straight_top.clamp(min=0)),
        (f["trips"], CAT_TRIPS, (t << 15) | _keep_top(present & ~_bit(t),
                                                      2, 2)),
        (f["two_pair"], CAT_TWO_PAIR,
         (top2_pairs << 4) | _msb(present & ~top2_pairs).clamp(min=0)),
        (f["pair"], CAT_PAIR, (p1 << 15) | _keep_top(present & ~_bit(p1),
                                                     3, 2)),
    ]
    key = _keep_top(present, 5, 2)
    for cond, c, payload in reversed(table):
        key = torch.where(cond, (c << 19) | payload, key)
    return key


# ---------------------------------------------------------------------------
# Drawing cards
# ---------------------------------------------------------------------------

def draw_slots(words, n_avail: int, draw_bits: int = 32):
    """k distinct slots in [0, ``n_avail``) from int64 words [k, ...]:
    draw t is the word modulo ``n_avail - t``, shifted past the earlier
    draws in ascending order. Returns k int32 tensors."""
    sorted_chosen, slots = [], []
    for t in range(words.shape[0]):
        w = words[t] if draw_bits == 32 else words[t] >> (32 - draw_bits)
        x = (w % (n_avail - t)).to(I32)
        for c in sorted_chosen:
            x = x + (x >= c).to(I32)
        new_sorted, carry = [], x
        for c in sorted_chosen:
            new_sorted.append(torch.minimum(carry, c))
            carry = torch.maximum(carry, c)
        new_sorted.append(carry)
        sorted_chosen = new_sorted
        slots.append(x)
    return slots


def shift_past(slots, dead):
    """Live-deck slots to card ids past the ascending ``dead`` cards (ints
    or tensors that broadcast against ``slots``)."""
    for d in dead:
        slots = slots + (slots >= d).to(slots.dtype)
    return slots


def draw_cards(words, dead, draw_bits: int = 32):
    """k distinct live cards from words [k, ...], ``dead`` ascending."""
    return [shift_past(s, dead)
            for s in draw_slots(words, 52 - len(dead), draw_bits)]
