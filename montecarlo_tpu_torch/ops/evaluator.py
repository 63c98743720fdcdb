"""Branchless bitmask 7-card hand evaluator on int32 tensors.

The counterpart of ``montecarlo_tpu/ops/evaluator.py``, op for op. A hand
is four int32 *suit masks*; bit ``r`` of mask ``s`` is set iff the hand
holds rank ``r`` (2..14) in suit ``s``. Every function is elementwise, so it
runs on masks of any shape and on any device.

Two keys:

- ``eval_masks_impl``: the packed ``[category hit-ranks kickers]`` key of
  ``handval`` (``cat << 20 | r0 << 16 | ... | r4``). It is
  below 2^24, so int32 holds it with the same order as the JAX uint32 key.
- ``eval_masks_cmp_impl``: the comparison-only key (``cat << 19 |
  payload``) that the kernels use; its ``<``/``==`` relations equal the
  packed key's.

``eval_masks`` and ``eval_masks_cmp`` are the two under the JAX module's
public names.

torch has no ``clz``/``popcount`` on int tensors: ``_popcount`` is the SWAR
count and ``_msb`` a bit smear followed by it. Both are exact for the
non-negative int32 values used here. The device form of the comparison key
is ``csrc/evaluator.cuh`` (``__popc``/``__clz``), the same logic.
"""

from __future__ import annotations

import math

import torch

from montecarlo_tpu_torch.cards import NUM_RANKS
from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.handval import (
    CAT_FLUSH,
    CAT_FULL_HOUSE,
    CAT_HIGH,
    CAT_PAIR,
    CAT_QUADS,
    CAT_SHIFT,
    CAT_STRAIGHT,
    CAT_STRAIGHT_FLUSH,
    CAT_TRIPS,
    CAT_TWO_PAIR,
)

I32 = torch.int32
I64 = torch.int64


def _popcount(x):
    """Set bits of each non-negative int32 element (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def _msb(x):
    """Position of the highest set bit; -1 for x == 0 (elementwise)."""
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return _popcount(x) - 1


def _bit(pos):
    """1 << pos, safe for pos == -1 (yields 0)."""
    one = torch.ones_like(pos)
    return torch.where(pos >= 0, one << pos.clamp(min=0), 0)


def _pop_msb(x):
    """(msb position, mask with that bit cleared)."""
    p = _msb(x)
    return p, x & ~_bit(p)


def _top_ranks(mask, k):
    """The k highest set-bit positions of mask, descending (0-padded)."""
    out = []
    for _ in range(k):
        p, mask = _pop_msb(mask)
        out.append(p.clamp(min=0))
    return out


def _run5_top(mask):
    """Top rank of the best 5-long run of consecutive set bits (else -1)."""
    r = mask & (mask >> 1) & (mask >> 2) & (mask >> 3) & (mask >> 4)
    return torch.where(r > 0, _msb(r) + 4, -1)


def _pack(cat, ranks):
    key = cat << CAT_SHIFT
    for i, r in enumerate(ranks):
        key = key | (r << (16 - 4 * i))
    return key


def suit_masks_from_cards(cards):
    """[..., K] card ids -> four [...]-shaped int32 suit masks.

    Cards must be distinct within a hand; ids follow ``cards.py``.
    """
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


def _categories(m0, m1, m2, m3):
    """Multiplicity masks and category flags shared by both keys."""
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


def eval_masks_impl(m0, m1, m2, m3):
    """Suit masks -> the packed hand key (int32, elementwise)."""
    (present, c4, trips, pairs, fmask, straight_top, sf_top,
     f) = _categories(m0, m1, m2, m3)

    sf_ranks = [(sf_top - i).clamp(min=0) for i in range(5)]
    q = _msb(c4).clamp(min=0)
    qk = _msb(present & ~_bit(q)).clamp(min=0)
    quad_ranks = [q, q, q, q, qk]
    t_fh = _msb(trips).clamp(min=0)
    p_fh = _msb((trips | pairs) & ~_bit(t_fh)).clamp(min=0)
    fh_ranks = [t_fh, t_fh, t_fh, p_fh, p_fh]
    flush_ranks = _top_ranks(fmask, 5)
    straight_ranks = [(straight_top - i).clamp(min=0) for i in range(5)]
    t = _msb(trips).clamp(min=0)
    tk1, tk2 = _top_ranks(present & ~_bit(t), 2)
    trips_ranks = [t, t, t, tk1, tk2]
    hp, lp = _top_ranks(pairs, 2)
    tpk = _msb(present & ~_bit(hp) & ~_bit(lp)).clamp(min=0)
    two_pair_ranks = [hp, hp, lp, lp, tpk]
    p1 = _msb(pairs).clamp(min=0)
    pk1, pk2, pk3 = _top_ranks(present & ~_bit(p1), 3)
    pair_ranks = [p1, p1, pk1, pk2, pk3]
    high_ranks = _top_ranks(present, 5)

    table = [
        (f["sf"], CAT_STRAIGHT_FLUSH, sf_ranks),
        (f["quads"], CAT_QUADS, quad_ranks),
        (f["fh"], CAT_FULL_HOUSE, fh_ranks),
        (f["flush"], CAT_FLUSH, flush_ranks),
        (f["straight"], CAT_STRAIGHT, straight_ranks),
        (f["trips"], CAT_TRIPS, trips_ranks),
        (f["two_pair"], CAT_TWO_PAIR, two_pair_ranks),
        (f["pair"], CAT_PAIR, pair_ranks),
    ]
    cat = torch.full_like(m0, CAT_HIGH)
    ranks = high_ranks
    for cond, c, rs in reversed(table):
        cat = torch.where(cond, c, cat)
        ranks = [torch.where(cond, a, b) for a, b in zip(rs, ranks)]
    return _pack(cat, ranks)


def _keep_top(mask, n, max_clears):
    """Clear lowest set bits until at most ``n`` remain (``max_clears``
    bounds the loop)."""
    for _ in range(max_clears):
        mask = torch.where(_popcount(mask) > n, mask & (mask - 1), mask)
    return mask


def eval_masks_cmp_impl(m0, m1, m2, m3):
    """Suit masks -> the comparison-only key (int32, elementwise).

    Layout ``cat << 19 | payload`` with the payloads of the JAX
    ``eval_masks_cmp_impl`` (rank bitmasks instead of five 4-bit ranks).
    """
    (present, c4, trips, pairs, fmask, straight_top, sf_top,
     f) = _categories(m0, m1, m2, m3)

    q = _msb(c4).clamp(min=0)
    qk = _msb(present & ~_bit(q)).clamp(min=0)
    t_fh = _msb(trips).clamp(min=0)
    p_fh = _msb((trips | pairs) & ~_bit(t_fh)).clamp(min=0)
    trips_kick = _keep_top(present & ~_bit(t_fh), 2, 2)
    top2_pairs = _keep_top(pairs, 2, 1)
    tp_kick = _msb(present & ~top2_pairs).clamp(min=0)
    p1 = _msb(pairs).clamp(min=0)
    pair_kick = _keep_top(present & ~_bit(p1), 3, 2)

    table = [
        (f["sf"], CAT_STRAIGHT_FLUSH, sf_top.clamp(min=0)),
        (f["quads"], CAT_QUADS, (q << 4) | qk),
        (f["fh"], CAT_FULL_HOUSE, (t_fh << 4) | p_fh),
        (f["flush"], CAT_FLUSH, _keep_top(fmask, 5, 2)),
        (f["straight"], CAT_STRAIGHT, straight_top.clamp(min=0)),
        (f["trips"], CAT_TRIPS, (t_fh << 15) | trips_kick),
        (f["two_pair"], CAT_TWO_PAIR, (top2_pairs << 4) | tp_kick),
        (f["pair"], CAT_PAIR, (p1 << 15) | pair_kick),
    ]
    key = _keep_top(present, 5, 2)  # high card
    for cond, c, payload in reversed(table):
        key = torch.where(cond, (c << 19) | payload, key)
    return key


# The JAX module's public names: there the jitted forms of the two
# functions above; eager torch has nothing to compile, so they are aliases.
eval_masks = eval_masks_impl
eval_masks_cmp = eval_masks_cmp_impl


def eval7_from_cards(cards):
    """[..., K] distinct card ids -> packed int32 hand keys."""
    return eval_masks_impl(*suit_masks_from_cards(cards))


def _colex_subsets(n: int, k: int, device) -> torch.Tensor:
    """All k-subsets of range(n) as int64 bitmasks [C(n, k)], in colex
    order: by largest element, so the first C(m, k) are those of
    range(m)."""
    sets = torch.zeros(1, dtype=I64, device=device)
    for j in range(1, k + 1):
        sets = torch.cat([sets[:math.comb(m, j - 1)] | (1 << m)
                          for m in range(j - 1, n)])
    return sets


def every_hand_keys(n_cards: int = 52, device=None):
    """Both keys of every 7-card hand of card ids 0 .. ``n_cards`` - 1 (all
    C(52, 7) = 133,784,560 by default), on ``device`` (the card when None),
    a highest card at a time.

    Returns (hands, table): ``table`` the distinct (packed, cmp) pairs of
    ``eval_masks_impl`` and ``eval_masks_cmp_impl``, int64 [K, 2], sorted
    by packed key then cmp key (the table ``native/certify_evaluator.cpp``
    digests)."""
    dev = resolve(device)
    low = _colex_subsets(n_cards - 1, 6, dev)
    hands, pairs = 0, []
    for top in range(6, n_cards):
        cards = low[:math.comb(top, 6)] | (1 << top)
        masks = [(((cards >> (NUM_RANKS * s)) & 0x1FFF) << 2).to(I32)
                 for s in range(4)]
        packed = eval_masks_impl(*masks).to(I64)
        cmp = eval_masks_cmp_impl(*masks).to(I64)
        pairs.append(torch.unique((packed << 32) | cmp))
        hands += cards.shape[0]
    table = torch.unique(torch.cat(pairs))
    return hands, torch.stack([table >> 32, table & 0xFFFFFFFF], dim=1)
