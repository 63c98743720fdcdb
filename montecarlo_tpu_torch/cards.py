"""Card encoding.

The reference deck (``card.clj:10-13``) is generated suit-major::

    (for [suit [:hearts :diamonds :spades :clubs]
          rank (range 2 15)]
      (->Card suit rank))

We encode a card as an integer id in ``[0, 52)`` preserving that exact
generation order, so ``deck == arange(52)`` is the reference's
``COMPLETE-DECK``::

    suit = id // 13     (0 hearts, 1 diamonds, 2 spades, 3 clubs)
    rank = 2 + id % 13  (2..14, ace always high — ace is 14, never 1)
"""

from __future__ import annotations

NUM_CARDS = 52
NUM_RANKS = 13
NUM_SUITS = 4

# Index order matches the reference deck generation order (card.clj:11).
SUIT_NAMES = ("hearts", "diamonds", "spades", "clubs")

MIN_RANK = 2
MAX_RANK = 14  # ace, always high (no wheel straight — hand_evaluator.clj:32-40)


def card_suit(card: int) -> int:
    """Suit index 0..3 of a card id (works on ints and jnp arrays)."""
    return card // NUM_RANKS


def card_rank(card: int) -> int:
    """Rank 2..14 of a card id (works on ints and jnp arrays)."""
    return 2 + card % NUM_RANKS


def make_card(suit: int, rank: int) -> int:
    """Card id from suit index 0..3 and rank 2..14."""
    return suit * NUM_RANKS + (rank - 2)


def card_name(card: int) -> str:
    return f"{card_rank(card)}-of-{SUIT_NAMES[card_suit(card)]}"
