"""Plain reference of the equity service's answers.

- ``matchup_counts``: heads-up hand vs hand on a known board of 0, 3 or 4
  cards: (wins, ties) of the hero over rollouts ``0 .. n - 1`` of a seed.
  Rollout r draws its ``5 - len(board)`` board cards from the words of
  Philox stream (seed, r mod 2^32, r >> 32, 0), without the four holes and
  the known board.
- ``sweep_counts``: each hero hand h of a list against a random villain:
  rollout r of hand h draws the villain's two cards, then five board
  cards, from stream (seed, r mod 2^32, r >> 32, h + 1), without the
  hero's holes.

A hand beats another when its comparison key is higher; equal keys tie.
Everything runs in chunks of rollouts on the device of the caller's
choice; ``draw_bits=16`` is the control's sampler (``cards.draw_slots``).
"""

from __future__ import annotations

import torch

from mcref.cards import (
    I32,
    I64,
    MASK,
    draw_cards,
    eval_masks_cmp,
    masks_of,
    stream_words,
    suit_masks,
)

CHUNK = 1 << 22


def hand_masks(cards):
    """Four int suit masks of a few cards (python ints)."""
    if not cards:
        return [0, 0, 0, 0]
    return [int(m) for m in suit_masks(torch.tensor(list(cards)))]


def matchup_counts(seed: int, hero, villain, board, n: int, device,
                   draw_bits: int = 32, chunk: int = CHUNK):
    """(wins, ties) as python ints."""
    board = list(board)
    dead = sorted(list(hero) + list(villain) + board)
    bm = hand_masks(board)
    hm = [a | b for a, b in zip(hand_masks(hero), bm)]
    vm = [a | b for a, b in zip(hand_masks(villain), bm)]
    n_draw = 5 - len(board)
    wins = ties = 0
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        r = torch.arange(start, start + m, dtype=I64, device=device)
        words = stream_words(seed, r & MASK, r >> 32, 0, 0, n_draw)
        drawn = masks_of(draw_cards(words, dead, draw_bits))
        kh = eval_masks_cmp(*[d | h for d, h in zip(drawn, hm)])
        kv = eval_masks_cmp(*[d | v for d, v in zip(drawn, vm)])
        wins += int((kh > kv).sum())
        ties += int((kh == kv).sum())
    return wins, ties


def sweep_counts(seed: int, heroes, hand_index, n: int, device,
                 draw_bits: int = 32, chunk: int = CHUNK):
    """(wins, ties) as python ints of hero hand ``heroes[hand_index]`` over
    its ``n`` rollouts (its index picks its Philox sub-stream)."""
    hero = sorted(int(c) for c in heroes[hand_index])
    hm = torch.tensor(hand_masks(hero), dtype=I32, device=device)
    wins = ties = 0
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        r = torch.arange(start, start + m, dtype=I64, device=device)
        words = stream_words(seed, r & MASK, r >> 32, hand_index + 1, 0, 7)
        cards = draw_cards(words, hero, draw_bits)
        vm = masks_of(cards[:2])
        bm = masks_of(cards[2:])
        kh = eval_masks_cmp(*[b | hm[s] for s, b in enumerate(bm)])
        kv = eval_masks_cmp(*[b | v for b, v in zip(bm, vm)])
        wins += int((kh > kv).sum())
        ties += int((kh == kv).sum())
    return wins, ties
