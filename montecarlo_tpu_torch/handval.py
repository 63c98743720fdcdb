"""Packed hand-value format.

The reference's hand value is a lexicographically-compared triple
``[category hit-ranks kicker-ranks]`` (``hand_evaluator.clj:112-133``,
compared with Clojure ``compare`` at ``:156-160``). We pack that triple into
a single uint32 key so scalar integer comparison reproduces the reference's
ordering exactly::

    key = category << 20 | r0 << 16 | r1 << 12 | r2 << 8 | r3 << 4 | r4

where ``[r0..r4] = hit-ranks ++ kicker-ranks`` (always 5 ranks total, each
2..14, fitting a nibble). Per-category nibble layout (matching the golden
vectors in ``hand_evaluator_test.clj:57-137``):

    8 straight flush : 5 ranks desc, no kickers
    7 four of a kind : q q q q k
    6 full house     : t t t p p   (trips rank then pair rank, no kickers)
    5 flush          : 5 ranks desc
    4 straight       : 5 ranks desc
    3 three of a kind: t t t k1 k2 (kickers desc)
    2 two pair       : hi hi lo lo k
    1 pair           : p p k1 k2 k3
    0 high card      : 5 ranks desc (the reference passes the whole hand as
                       the hit via ``(ret 0 [] cards)``, kickers empty)

Within each category the reference's hit/kicker vectors have fixed lengths,
so elementwise lexicographic compare == comparing these 5 nibbles in order,
and cross-category compare is decided by the category nibble. One deliberate
divergence: the reference's full-house value stores a *lazy seq* of ranks
(``hand_evaluator.clj:104-106``) which crashes Clojure ``compare`` whenever
two full houses are compared; we implement the evident intent (trips rank,
then pair rank).
"""

from __future__ import annotations

from typing import Sequence, Tuple

CATEGORY_NAMES = (
    "high-card",
    "pair",
    "two-pair",
    "three-of-a-kind",
    "straight",
    "flush",
    "full-house",
    "four-of-a-kind",
    "straight-flush",
)

CAT_HIGH = 0
CAT_PAIR = 1
CAT_TWO_PAIR = 2
CAT_TRIPS = 3
CAT_STRAIGHT = 4
CAT_FLUSH = 5
CAT_FULL_HOUSE = 6
CAT_QUADS = 7
CAT_STRAIGHT_FLUSH = 8

CAT_SHIFT = 20


def pack_value(category: int, hit_ranks: Sequence[int], kickers: Sequence[int]) -> int:
    """Pack a reference-style ``[category hit-ranks kickers]`` triple."""
    ranks = list(hit_ranks) + list(kickers)
    assert len(ranks) == 5, (category, hit_ranks, kickers)
    key = category << CAT_SHIFT
    for i, r in enumerate(ranks):
        assert 0 <= r <= 15
        key |= r << (16 - 4 * i)
    return key


def unpack_value(key: int) -> Tuple[int, Tuple[int, ...]]:
    """Unpack a key into (category, 5 ranks in comparison order)."""
    category = key >> CAT_SHIFT
    ranks = tuple((key >> (16 - 4 * i)) & 0xF for i in range(5))
    return category, ranks


def describe(key: int) -> str:
    cat, ranks = unpack_value(key)
    return f"{CATEGORY_NAMES[cat]} {list(ranks)}"
