"""Batched rollouts: Monte Carlo and exact equity, self-play on the table
engine, betting policies and duplicate-match evaluation."""

from montecarlo_tpu_torch.rollout.equity import (  # noqa: F401
    EquityResult,
    RangeEquityResult,
    canonical_hands,
    equity_exact,
    equity_exact_range_vs_range,
    equity_exact_vs_range,
    equity_multiway,
    equity_vs_hand,
    equity_vs_random,
    equity_vs_range,
    expand_range,
    sample_distinct,
)
from montecarlo_tpu_torch.rollout.policy import (  # noqa: F401
    PolicyKey,
    always_call,
    pinned_seat_policies,
    policy_key,
    random_policy,
    seat_policies,
    tight_policy,
)
from montecarlo_tpu_torch.rollout.selfplay import (  # noqa: F401
    hand_action_bound,
    play_hands,
    play_hands_perpetual,
    play_one_hand,
    play_tournament,
    position_winrates,
    selfplay_stats,
    tournament_placements,
)
from montecarlo_tpu_torch.rollout.evaluate import (  # noqa: F401
    MatchResult,
    duplicate_match,
    duplicate_match_multihand,
    per_seat_deltas,
)
