"""Batched rollouts: Monte Carlo and exact equity."""

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
