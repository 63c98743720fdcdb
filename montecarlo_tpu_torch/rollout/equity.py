"""Monte Carlo equity estimation (the user-facing rollout API).

The counterpart of the parts of ``montecarlo_tpu/rollout/equity.py`` that
the main paths use. ``equity_vs_hand``, ``equity_vs_random`` and
``equity_multiway`` run the rollout kernels K1, K2 and B3 on the card, or
their plain versions when the caller passes ``device="cpu"``
(``ops/cuda_equity.py``); ``equity_exact`` enumerates every board
completion with the plain evaluator.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from montecarlo_tpu_torch.cards import NUM_CARDS, make_card
from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.ops import cuda_equity
from montecarlo_tpu_torch.ops.evaluator import (
    eval_masks_impl,
    suit_masks_from_cards,
)

I32 = torch.int32


class EquityResult(NamedTuple):
    wins: int
    ties: int
    losses: int
    n: int

    @property
    def p_win(self) -> float:
        return self.wins / self.n

    @property
    def equity(self) -> float:
        """Win probability counting ties as half (standard equity)."""
        return (self.wins + 0.5 * self.ties) / self.n

    @property
    def stderr(self) -> float:
        p = self.equity
        return float(np.sqrt(max(p * (1.0 - p), 1e-12) / self.n))

    @property
    def ci95(self) -> Tuple[float, float]:
        p, se = self.equity, self.stderr
        return (p - 1.96 * se, p + 1.96 * se)


def _check_disjoint(*card_groups):
    """Cards passed to the equity APIs must be distinct ids in [0, 52):
    an overlap would corrupt the dead-card shift mapping."""
    flat = [int(c) for g in card_groups for c in np.asarray(g).reshape(-1)]
    if len(flat) != len(set(flat)):
        raise ValueError(f"cards are not disjoint: {sorted(flat)}")
    if any(c < 0 or c > 51 for c in flat):
        raise ValueError(f"card ids out of range: {sorted(flat)}")


def complement(dead) -> torch.Tensor:
    """Ascending card ids not in ``dead`` (shape [52 - len(dead)])."""
    dead = torch.as_tensor(dead, dtype=torch.int64).reshape(-1)
    is_dead = torch.zeros(NUM_CARDS, dtype=torch.bool)
    is_dead[dead] = True
    return torch.nonzero(~is_dead).reshape(-1).to(I32)


def slots_to_cards(slots, dead_sorted):
    """Map live-deck slot indices to card ids by rank-shifting past the
    ascending dead cards (the order-preserving bijection onto the
    complement)."""
    cards = torch.as_tensor(slots)
    for d in torch.as_tensor(dead_sorted).reshape(-1).tolist():
        cards = cards + (cards >= d).to(cards.dtype)
    return cards


def _result(counts, n):
    w, t = (int(x) for x in counts.tolist())
    return EquityResult(wins=w, ties=t, losses=n - w - t, n=n)


def equity_vs_hand(seed: int, hero: Sequence[int], villain: Sequence[int],
                   n_rollouts: int, board: Sequence[int] = (),
                   device=None) -> EquityResult:
    """Hero hole cards vs exact villain hole cards, optionally on a known
    partial ``board`` (flop or flop+turn): K1 on the card (``device``
    None or CUDA), its plain version for ``device="cpu"``."""
    _check_disjoint(hero, villain, board)
    counts, n = cuda_equity.equity_vs_hand_counts(
        seed, hero, villain, n_rollouts, board, device)
    return _result(counts, n)


def equity_vs_random(seed: int, hero: Sequence[int], n_rollouts: int,
                     device=None) -> EquityResult:
    """Hero hole cards vs a uniformly random villain: K2 with one hand (on
    the card unless ``device="cpu"``)."""
    _check_disjoint(hero)
    device = resolve(device)
    heroes = torch.as_tensor(hero, dtype=I32).reshape(1, 2)
    dead = torch.sort(heroes, dim=1).values
    hm = torch.stack(suit_masks_from_cards(heroes), dim=1)
    counts = cuda_equity.sweep_counts(seed, dead.to(device), hm.to(device),
                                      n_rollouts)
    return _result(counts[:, 0], n_rollouts)


def equity_multiway(seed: int, hands, n_rollouts: int,
                    board: Sequence[int] = (), device=None):
    """Equity of N specified hands ([N, 2] cards, 2 <= N <= 12) against
    each other, ties split fractionally, optionally on a partial board:
    B3 on the card (``device`` None or CUDA), its plain version for
    ``device="cpu"``. Returns (equity float64 numpy [N], n)."""
    _check_disjoint(hands, board)
    return cuda_equity.equity_multiway_kernel(seed, hands, n_rollouts, board,
                                              device)


def equity_exact(hero: Sequence[int], villain: Sequence[int],
                 board: Sequence[int] = (), chunk: int = 1 << 18,
                 device=None) -> EquityResult:
    """EXACT hand-vs-hand equity by enumerating every remaining board
    completion: C(48,5) = 1,712,304 preflop, C(45,2) = 990 on a flop, 44
    on a turn. The plain evaluator runs on ``device`` (the card when
    None)."""
    _check_disjoint(hero, villain, board)
    device = resolve(device)
    fixed = np.asarray(board, np.int32).reshape(-1)
    K = fixed.shape[0]
    live = complement(np.concatenate([np.asarray(hero, np.int64).ravel(),
                                      np.asarray(villain, np.int64).ravel(),
                                      fixed])).numpy()
    slots = np.fromiter(
        itertools.chain.from_iterable(
            itertools.combinations(range(live.shape[0]), 5 - K)),
        dtype=np.int32).reshape(-1, 5 - K)
    boards = live[slots]
    if K:
        boards = np.concatenate(
            [np.tile(fixed, (boards.shape[0], 1)), boards], axis=1)
    hm = suit_masks_from_cards(torch.as_tensor(hero, dtype=I32).reshape(-1))
    vm = suit_masks_from_cards(torch.as_tensor(villain, dtype=I32).reshape(-1))
    hm = [m.to(device) for m in hm]
    vm = [m.to(device) for m in vm]
    wins = ties = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(0, boards.shape[0], chunk):
        bm = suit_masks_from_cards(
            torch.from_numpy(boards[i:i + chunk]).to(device))
        vh = eval_masks_impl(*[m | h for m, h in zip(bm, hm)])
        vv = eval_masks_impl(*[m | v for m, v in zip(bm, vm)])
        wins = wins + (vh > vv).sum()
        ties = ties + (vh == vv).sum()
    n = boards.shape[0]
    return _result(torch.stack([wins, ties]), n)


def canonical_hands():
    """The 169 canonical starting hands as (label, (card, card)).

    Pairs use hearts+diamonds; suited uses both hearts; offsuit uses
    hearts+diamonds. Order: pairs, then suited, then offsuit, high-first.
    """
    names = "23456789TJQKA"
    out = []
    for i in range(12, -1, -1):
        r = i + 2
        out.append((f"{names[i]}{names[i]}",
                    (make_card(0, r), make_card(1, r))))
    for suited, tag in ((True, "s"), (False, "o")):
        for hi in range(12, 0, -1):
            for lo in range(hi - 1, -1, -1):
                r1, r2 = hi + 2, lo + 2
                out.append((f"{names[hi]}{names[lo]}{tag}",
                            (make_card(0, r1),
                             make_card(0 if suited else 1, r2))))
    assert len(out) == 169
    return out
