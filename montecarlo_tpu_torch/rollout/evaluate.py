"""Agent evaluation by duplicate-deal matches:
``montecarlo_tpu/rollout/evaluate.py`` on the port's self-play.

Every deck is played twice with the policies' chairs swapped, cancelling
card luck, so the measured edge is strategy. Both runs of a match start
from ``init_state(seed)`` and draw from the same ``seed``: the same decks
and, for policy j of a combination, the same words; so swapping A and B
negates the estimate exactly. Policies are positional (position 0 posts
the small blind; ``rollout/policy.seat_policies``) or pinned to seats
(``pinned_seat_policies``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.rollout.policy import (
    pinned_seat_policies,
    seat_policies,
)
from montecarlo_tpu_torch.rollout.selfplay import play_hands


class MatchResult(NamedTuple):
    bb_per_hand: float       # policy A's mean edge in big blinds per hand
    stderr: float            # of the duplicate-pair estimate
    n_tables: int

    @property
    def ci95(self):
        return (self.bb_per_hand - 1.96 * self.stderr,
                self.bb_per_hand + 1.96 * self.stderr)


def _heads_up(cfg):
    cfg = cfg or TableConfig(num_seats=2, rules="standard", bets_impl="levels")
    if cfg.num_seats != 2:
        raise ValueError("duplicate matches are heads-up")
    return cfg


def duplicate_match(seed: int, policy_a: Callable, policy_b: Callable,
                    n_tables: int = 4096, cfg: TableConfig = None,
                    device=None) -> MatchResult:
    """Heads-up duplicate evaluation of policy A against policy B: each
    deck is played with A in position 0 (the small blind), then swapped.
    One hand per deal (positions are roles across hands, so multi-hand
    duplicates do not identify a persistent player)."""
    cfg = _heads_up(cfg)
    start = cfg.starting_stack
    f_ab = play_hands(seed, cfg, n_tables, num_hands=1,
                      policy=seat_policies([policy_a, policy_b]),
                      device=device)
    f_ba = play_hands(seed, cfg, n_tables, num_hands=1,
                      policy=seat_policies([policy_b, policy_a]),
                      device=device)
    a_sb = f_ab.stacks[:, 0].cpu().numpy() - start  # A as small blind
    a_bb = f_ba.stacks[:, 1].cpu().numpy() - start  # A as big blind
    bb = (a_sb + a_bb) / 2.0 / float(cfg.big_blind)
    return MatchResult(bb_per_hand=float(bb.mean()),
                       stderr=float(bb.std(ddof=1) / np.sqrt(n_tables)),
                       n_tables=n_tables)


def per_seat_deltas(deltas, button0: int = 0) -> np.ndarray:
    """[tables, hands, P] position-indexed chip deltas -> seat-indexed.

    ``play_hands`` reports deltas by hand-order POSITION (0 = that hand's
    small blind); the button moves one seat a hand, so seat ``s`` sat at
    position ``(s - button_h) % P`` in hand ``h``, ``button_h = button0 +
    h``. A relabelling: chips are untouched."""
    d = np.asarray(deltas)
    _, H, P = d.shape
    return np.stack([np.roll(d[:, h, :], (button0 + h) % P, axis=-1)
                     for h in range(H)], axis=1)


def duplicate_match_multihand(seed: int, policy_a: Callable,
                              policy_b: Callable, n_tables: int = 2048,
                              num_hands: int = 12, cfg: TableConfig = None,
                              device=None) -> MatchResult:
    """Heads-up duplicate evaluation with persistent seats: A keeps one
    chair for ``num_hands`` hands (stacks carry over, the blinds rotate
    past it), then the match replays with chairs swapped on the same
    decks. The cancellation is exact on hand 0 and approximate after (the
    stacks part with the policies); the estimate is A's mean bb/hand edge
    per table with a table-level standard error."""
    cfg = _heads_up(cfg)
    _, d_ab = play_hands(seed, cfg, n_tables, num_hands=num_hands,
                         policy=pinned_seat_policies([policy_a, policy_b]),
                         collect_deltas=True, device=device)
    _, d_ba = play_hands(seed, cfg, n_tables, num_hands=num_hands,
                         policy=pinned_seat_policies([policy_b, policy_a]),
                         collect_deltas=True, device=device)
    a_first = per_seat_deltas(d_ab.cpu().numpy())[:, :, 0]  # A in chair 0
    b_first = per_seat_deltas(d_ba.cpu().numpy())[:, :, 0]  # B in chair 0
    per_pair = (a_first - b_first) / 2.0                    # zero-sum
    bb_table = per_pair.mean(axis=1) / float(cfg.big_blind)
    return MatchResult(bb_per_hand=float(bb_table.mean()),
                       stderr=float(bb_table.std(ddof=1) / np.sqrt(n_tables)),
                       n_tables=n_tables)
