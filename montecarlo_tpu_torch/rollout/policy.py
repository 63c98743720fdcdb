"""Betting policies for self-play: ``montecarlo_tpu/rollout/policy.py`` on
tables held on a leading axis.

A policy is ``policy(key, state, street_raises) -> int32 [T]``: one action
per table for its current head, in the reference encoding (negative fold,
0 call, positive raise-by-amount, ``action.clj:12-29``), passed through
``engine/step.clamp_action`` by the caller. ``street_raises`` (int32 [T])
is the caller's count of raises on the current street; the random policy
stops raising after ``max_raises_per_street``, which bounds a street at
``P * (1 + max_raises)`` actions (``selfplay.hand_action_bound``).

The key. JAX splits a threefry key per table and step. Here a
``PolicyKey`` names Philox words per table: table t draws from stream
(seed, t, counter, sub) (``ops/philox.stream_words``), so the card and
the CPU draw the same actions for the same tables, whatever the table
count. The caller moves ``counter`` once a step (``at_step``); ``fold_in``
gives policy j of a combination its own sub-stream, as JAX's
``fold_in(key, j)`` does. The sub-streams of this module are
``SUB_HANDS``, ``SUB_PERPETUAL`` and ``SUB_TOURNAMENT`` (the JAX
``fold_in`` constants 0x5E1F, 0x5CAD and 0x70A8, shifted past the ids
``ops/philox.py`` lists) plus 1 + j for policy j, and ``SUB_BOT``, the
server's house bots (``server/host.Room``: one table, the counter the
room's bot decision count, where JAX folds the count into
``key(7919 seed + 13)``).

Draws are integer compares on 32-bit words, as K4's ``mc_policy``
(``csrc/engine.cuh``; ``ops/cuda_engine._policy``): the random policy folds
where u < ``fold_prob`` 2^32 and raises where u < (``fold_prob`` +
``raise_prob``) 2^32, by word % ``max_raise`` + 1 chips: the distribution
of JAX's float form, with no float rounding between devices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableState
from montecarlo_tpu_torch.engine.step import head_info
from montecarlo_tpu_torch.engine.street import bets_needed
from montecarlo_tpu_torch.ops.philox import MASK, stream_words

I32 = torch.int32
I64 = torch.int64

# Philox sub-streams of the self-play loops (ops/philox.py lists them).
SUB_HANDS = 0x5E1F << 16
SUB_PERPETUAL = 0x5CAD << 16
SUB_TOURNAMENT = 0x70A8 << 16
SUB_BOT = 0x7919 << 16


class PolicyKey(NamedTuple):
    """Philox words per table: stream (seed, table[t], counter, sub)."""

    seed: int
    table: torch.Tensor  # int64 [T] table indices (the stream id)
    counter: int         # the step
    sub: int             # the sub-stream

    def words(self, n: int) -> torch.Tensor:
        """The first ``n`` words of every table's stream, int64 [n, T] in
        [0, 2^32)."""
        return stream_words(self.seed, self.table, self.counter & MASK,
                            self.sub, 0, n)


def policy_key(seed: int, n_tables: int, sub: int, device=None,
               first_table: int = 0) -> PolicyKey:
    """The key of tables ``first_table`` .. ``first_table + n_tables - 1``
    on ``device`` (the card when None), counter 0."""
    table = torch.arange(first_table, first_table + n_tables, dtype=I64,
                         device=resolve(device))
    return PolicyKey(int(seed) & MASK, table, 0, sub)


def at_step(key: PolicyKey, k: int) -> PolicyKey:
    """The key ``k`` steps on."""
    return key._replace(counter=key.counter + k)


def fold_in(key: PolicyKey, j: int) -> PolicyKey:
    """Policy ``j``'s own sub-stream of ``key``."""
    if not 0 <= j < 0xFFFF:
        raise ValueError(f"policy index {j}: expected 0 <= j < 65535")
    return key._replace(sub=key.sub + 1 + j)


def _threshold(p: float) -> int:
    """A probability as a bound on a 32-bit word: u < it with chance p."""
    return int(p * 2 ** 32)


def _owes(state: TableState) -> torch.Tensor:
    seat, _, _ = head_info(state)
    return bets_needed(state.bets, seat) > 0


def random_policy(key: PolicyKey, state: TableState,
                  street_raises: torch.Tensor, *, fold_prob: float = 0.15,
                  raise_prob: float = 0.30, max_raise: int = 20,
                  max_raises_per_street: int = 2) -> torch.Tensor:
    """One random action for each table's head seat.

    A fold when nothing is owed is a check (legal in the reference but
    pointless; live hands give showdown-heavy traffic)."""
    u, amt_bits = key.words(2)
    amt = (amt_bits % max_raise + 1).to(I32)
    can_raise = street_raises < max_raises_per_street
    is_fold = u < _threshold(fold_prob)
    is_raise = (u < _threshold(fold_prob + raise_prob)) & ~is_fold \
        & can_raise
    return torch.where(is_fold, torch.where(_owes(state), -1, 0),
                       torch.where(is_raise, amt, 0)).to(I32)


def _combine(policies, key, state, street_raises, who):
    """The action of policy ``who[t]`` at each table (0 where ``who`` names
    no policy); policy j draws from ``fold_in(key, j)``."""
    out = torch.zeros_like(state.stage)
    for j, p in enumerate(policies):
        action = torch.as_tensor(p(fold_in(key, j), state, street_raises),
                                 device=out.device).to(I32)
        out = torch.where(who == j, action, out)
    return out


def seat_policies(policies):
    """Per-position policies as one table policy: position j (hand order,
    position 0 the small blind) acts with ``policies[j]``. Every policy is
    evaluated on every table and the head position's action kept."""

    def policy(key, state, street_raises):
        pos, _, _ = head_info(state)
        return _combine(policies, key, state, street_raises, pos)

    return policy


def always_call(key, state, street_raises):
    """The calling station (an evaluation baseline)."""
    del key, street_raises
    return torch.zeros_like(state.stage)


def tight_policy(key, state, street_raises, fold_prob: float = 0.5):
    """Folds with chance ``fold_prob`` when it owes chips, else calls."""
    del street_raises
    u = key.words(1)[0]
    return torch.where(_owes(state) & (u < _threshold(fold_prob)), -1,
                       0).to(I32)


def pinned_seat_policies(policies):
    """Per-SEAT policies as one table policy: identities keep their chairs
    across hands (seat = (button + position) % P, the server host's
    mapping) while the blinds rotate. ``seat_policies`` pins positions
    instead."""

    def policy(key, state, street_raises):
        pos, _, _ = head_info(state)
        seat = torch.remainder(state.button + pos, state.num_seats)
        return _combine(policies, key, state, street_raises, seat)

    return policy
