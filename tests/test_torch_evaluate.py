"""The port's duplicate-match evaluation (``montecarlo_tpu_torch/rollout/
evaluate.py``) against the JAX module's cases.

Both runs of a match draw from the same seed, so: a policy against itself
scores exactly 0 (the two runs are the same hands with the chairs
swapped, and standard rules conserve chips); swapping A and B negates the
estimate exactly; the calling station beats the half-folder
(``tests/test_selfplay.py:93``); and the trained heads-up net
(``data/policy_hu_300.npz``) beats the random policy over 12 hands in one
chair with a 95% interval above 0 (``tests/test_selfplay.py:109``).
``per_seat_deltas`` gives JAX's output on the same deltas.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from montecarlo_tpu.rollout import evaluate as jev
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import load_params, net_policy
from montecarlo_tpu_torch.rollout import evaluate as tev
from montecarlo_tpu_torch.rollout import policy as tpol

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

HU_300 = Path(__file__).resolve().parent.parent / "data" / "policy_hu_300.npz"


@pytest.mark.parametrize("policy", ["always_call", "random_policy",
                                    "tight_policy"])
def test_self_match_is_exactly_zero(policy):
    p = getattr(tpol, policy)
    r = tev.duplicate_match(6, p, p, n_tables=512, device="cpu")
    assert r.bb_per_hand == 0.0 and r.n_tables == 512


def test_duplicate_match_detects_edges_and_negates_on_swap():
    r = tev.duplicate_match(5, tpol.always_call, tpol.tight_policy,
                            n_tables=1024, device="cpu")
    assert r.bb_per_hand > 0.1, (r.bb_per_hand, r.stderr)
    lo, hi = r.ci95
    assert lo < r.bb_per_hand < hi and r.stderr > 0
    swap = tev.duplicate_match(5, tpol.tight_policy, tpol.always_call,
                               n_tables=1024, device="cpu")
    assert swap.bb_per_hand == -r.bb_per_hand
    assert swap.stderr == r.stderr


def test_duplicate_matches_are_heads_up():
    with pytest.raises(ValueError):
        tev.duplicate_match(0, tpol.always_call, tpol.always_call, 8,
                            TableConfig(num_seats=3), device="cpu")
    with pytest.raises(ValueError):
        tev.duplicate_match_multihand(0, tpol.always_call, tpol.always_call,
                                      8, 2, TableConfig(num_seats=6),
                                      device="cpu")


def test_pinned_seats_multihand_duplicate_match():
    """The trained heads-up net beats random with a 95% interval above 0
    over 12 hands in one chair; the estimate negates exactly when the
    policies swap."""
    trained = net_policy(load_params(HU_300))
    r = tev.duplicate_match_multihand(5, trained, tpol.random_policy,
                                      n_tables=512, num_hands=12,
                                      device="cpu")
    lo, hi = r.ci95
    assert lo > 0.0, f"trained edge CI includes zero: [{lo:.3f}, {hi:.3f}]"
    swap = tev.duplicate_match_multihand(5, tpol.random_policy, trained,
                                         n_tables=512, num_hands=12,
                                         device="cpu")
    assert r.bb_per_hand + swap.bb_per_hand == 0.0


def test_per_seat_deltas_relabeling():
    d = np.array([[[10, -4, -6],     # hand 0: button 0, seat s = pos s
                   [1, 2, -3],       # hand 1: button 1, seat 0 = pos 2
                   [7, -5, -2]]])    # hand 2: button 2, seat 0 = pos 1
    out = tev.per_seat_deltas(d)
    np.testing.assert_array_equal(out[0, :, 0], [10, -3, -5])
    np.testing.assert_array_equal(out[0, :, 1], [-4, 1, -2])
    np.testing.assert_array_equal(out.sum(-1), d.sum(-1))


@pytest.mark.parametrize("P,button0", [(2, 0), (3, 1), (6, 4)])
def test_per_seat_deltas_equal_jax(P, button0):
    d = np.random.default_rng(P).integers(-50, 50, (16, 7, P))
    np.testing.assert_array_equal(tev.per_seat_deltas(d, button0),
                                  jev.per_seat_deltas(d, button0))


def test_match_result_ci95_equals_jax():
    for bb, se in ((0.25, 0.1), (-1.5, 0.02)):
        assert tev.MatchResult(bb, se, 9).ci95 == \
            jev.MatchResult(bb, se, 9).ci95
