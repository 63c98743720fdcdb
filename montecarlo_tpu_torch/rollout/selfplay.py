"""Batched self-play: ``montecarlo_tpu/rollout/selfplay.py`` on the port's
table engine (``engine/``), tables on a leading axis.

One table-hand is a bounded loop of ``step_action`` (the reference's
action-channel loop, ``board.clj:131-138``); multiple hands chain through
``settle_showdown`` + ``next_hand`` (the perpetual game of
``gameplay.clj:149-150``, busted players kept at the table as the
reference keeps them). JAX's ``lax.scan`` is a Python loop over batched
steps. A hand's loop stops early once every table's hand is over: the
steps left are no-ops of ``step_action``, so the result is the same. That
check is one host read every ``STOP_EVERY`` steps, and between two checks
only the tables whose hand is on are stepped (gathered, then scattered
back); ``play_tournament`` likewise plays only the tables not frozen.

Decks are the engine's Philox decks (``init_state`` / ``next_hand``);
policy draws come from ``rollout/policy.PolicyKey`` words, on sub-stream
``SUB_HANDS``, ``SUB_PERPETUAL`` or ``SUB_TOURNAMENT`` with the step as
counter (hand h's step i of a ``max_steps``-step hand is counter
h * max_steps + i). The entry points run on ``device``: the card when
None, ``"cpu"`` for the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import (
    TableConfig,
    TableState,
    _select_tree,
    init_state,
    next_hand,
)
from montecarlo_tpu_torch.engine.step import (
    _put,
    _take,
    clamp_action,
    settle_showdown,
    step_action,
    step_table,
)
from montecarlo_tpu_torch.rollout.policy import (
    SUB_HANDS,
    SUB_PERPETUAL,
    SUB_TOURNAMENT,
    PolicyKey,
    at_step,
    policy_key,
    random_policy,
)

I32 = torch.int32

# Steps between two host reads of "every table's hand is over" (a read
# costs a sync; a hand of 6-max random play takes ~26 actions).
STOP_EVERY = 8


def hand_action_bound(cfg: TableConfig, max_raises_per_street: int = 2) -> int:
    """The loop bound of a hand: a street ends after at most P (1 + R)
    actions when the policy raises at most R times a street; 4 streets."""
    return 4 * cfg.num_seats * (1 + max_raises_per_street)


def _subset(key: PolicyKey, idx: torch.Tensor) -> PolicyKey:
    """The key of the tables ``idx`` of a batch (their own streams)."""
    return key._replace(table=key.table.index_select(0, idx))


def play_one_hand(state: TableState, key: PolicyKey,
                  policy: Callable = random_policy, max_steps: int = 72,
                  rules: str = "reference") -> TableState:
    """Up to ``max_steps`` actions of each table's hand, then settle the
    showdown where the hand is over. Step i draws from ``at_step(key,
    i)``.

    Every ``STOP_EVERY`` steps the tables whose hand is still on are
    gathered and only they are stepped (a table's words are its own, so a
    policy draws the same for it in any subset); the loop ends when none
    is left."""
    street_raises = torch.zeros_like(state.stage)
    for start in range(0, max_steps, STOP_EVERY):
        live = (~state.hand_over).nonzero()[:, 0]
        if not live.numel():
            break
        sub, raises = _take(state, live), street_raises[live]
        sub_key = _subset(key, live)
        for i in range(start, min(start + STOP_EVERY, max_steps)):
            action = clamp_action(sub, policy(at_step(sub_key, i), sub,
                                              raises))
            nxt = step_action(sub, action, rules=rules)
            applied = (action > 0) & ~sub.hand_over
            raises = torch.where(nxt.stage != sub.stage, 0,
                                 raises + applied.to(I32))
            sub = nxt
        state = _put(state, live, sub)
        street_raises = street_raises.index_copy(0, live, raises)
    return _select_tree(state.hand_over, settle_showdown(state, rules=rules),
                        state)


def play_hands(seed: int, cfg: TableConfig, n_tables: int,
               num_hands: int = 1, max_steps: Optional[int] = None,
               policy: Callable = random_policy,
               collect_deltas: bool = False, device=None,
               first_table: int = 0):
    """``num_hands`` consecutive hands on ``n_tables`` tables of
    ``init_state(seed)``; policy words on ``SUB_HANDS``. The tables are
    ``first_table`` .. ``first_table + n_tables - 1`` (decks and words go
    by table index, so a shard plays as those rows of a larger batch).

    Returns the final (settled) states; with ``collect_deltas=True``
    ``(final, deltas)``, ``deltas`` int32 [tables, hands, P] the settled
    chip change of each hand by *position* (position 0 = that hand's small
    blind). Chips conserve exactly under standard rules; under reference
    rules up to the n-inflation minting (``engine/bets.py``)."""
    steps = max_steps or hand_action_bound(cfg)
    dev = resolve(device)
    st = init_state(seed, cfg, n_tables, dev, first_table)
    key = policy_key(seed, n_tables, SUB_HANDS, dev, first_table)
    deltas = []
    for i in range(num_hands):
        if i > 0:  # pre-hand stacks in this hand's position space
            pre = torch.roll(st.stacks, -1, dims=1)
            st = next_hand(st, rules=cfg.rules)
        else:
            pre = torch.full_like(st.stacks, cfg.starting_stack)
        st = play_one_hand(st, at_step(key, i * steps), policy=policy,
                           max_steps=steps, rules=cfg.rules)
        deltas.append(st.stacks - pre)
    if collect_deltas:
        return st, torch.stack(deltas, dim=1)
    return st


def play_hands_perpetual(seed: int, cfg: TableConfig, n_tables: int,
                         n_steps: int, policy: Callable = random_policy,
                         device=None, first_table: int = 0):
    """Perpetual tables: ``n_steps`` of ``step_table`` on every table of
    ``init_state(seed)`` (each hand settles and the next deals inside the
    step, the reference's endless game); policy words on
    ``SUB_PERPETUAL``; tables from ``first_table`` as in ``play_hands``.

    Returns ``(final_states, hands_completed)``, the latter the sum of
    the hand counters (a 0-dim tensor)."""
    dev = resolve(device)
    st = init_state(seed, cfg, n_tables, dev, first_table)
    key = policy_key(seed, n_tables, SUB_PERPETUAL, dev, first_table)
    street_raises = torch.zeros_like(st.stage)
    for i in range(n_steps):
        action = clamp_action(st, policy(at_step(key, i), st,
                                         street_raises))
        nxt = step_table(st, action, rules=cfg.rules)
        applied = (action > 0) & ~st.hand_over
        street_raises = torch.where(
            (nxt.stage != st.stage) | (nxt.hand_idx != st.hand_idx), 0,
            street_raises + applied.to(I32))
        st = nxt
    return st, st.hand_idx.sum()


def _seat_view(stacks: torch.Tensor, button: torch.Tensor) -> torch.Tensor:
    """Positional rows [T, P] -> seat-indexed: seat s holds position
    (s - button) % P."""
    P = stacks.shape[1]
    j = torch.arange(P, device=stacks.device)[None]
    return stacks.gather(1, torch.remainder(j - button[:, None], P).long())


def play_tournament(seed: int, cfg: TableConfig, n_tables: int,
                    max_hands: int, max_steps: Optional[int] = None,
                    policy: Callable = random_policy, device=None,
                    first_table: int = 0):
    """Up to ``max_hands`` tournament hands on every table of
    ``init_state(seed)`` (busted seats leave the deal, the blinds skip
    them, a table freezes when one player holds every chip); policy words
    on ``SUB_TOURNAMENT``; tables from ``first_table`` as in
    ``play_hands``. A frozen table is a fixed point of the hands
    that follow, so each hand plays only the tables not frozen, and the
    loop stops when none is left.

    Returns ``(final_states, busted_at, seat_stacks)``: ``busted_at[t, s]``
    (int32) is the 0-based hand at which SEAT ``s`` (stable across hands,
    seat = (button + position) % P) first held no chips, ``max_hands + 1``
    for seats alive at the end; ``seat_stacks`` the final stacks by
    seat."""
    if cfg.rules != "tournament":
        raise ValueError("play_tournament needs tournament rules")
    steps = max_steps or hand_action_bound(cfg)
    dev = resolve(device)
    st = init_state(seed, cfg, n_tables, dev, first_table)
    key = policy_key(seed, n_tables, SUB_TOURNAMENT, dev, first_table)
    busted = torch.full(st.stacks.shape, max_hands + 1, dtype=I32,
                        device=dev)
    # the tables not frozen: a frozen table is a fixed point of every
    # later hand, so only the others are gathered and played
    active = torch.arange(n_tables, device=dev)
    for i in range(max_hands):
        sub = _take(st, active)
        if i > 0:
            sub = next_hand(sub, rules=cfg.rules)
            st = _put(st, active, sub)
            dealt = (~sub.hand_over).nonzero()[:, 0]
            if not dealt.numel():
                break
            active, sub = active[dealt], _take(sub, dealt)
        sub = play_one_hand(sub, at_step(_subset(key, active), i * steps),
                            policy=policy, max_steps=steps, rules=cfg.rules)
        st = _put(st, active, sub)
        was = busted[active]
        newly = (_seat_view(sub.stacks, sub.button) <= 0) & (was > max_hands)
        busted = busted.index_copy(0, active, torch.where(newly, i, was))
    return st, busted, _seat_view(st.stacks, st.button)


def tournament_placements(busted_at, seat_stacks) -> np.ndarray:
    """[tables, P] finishing places (1 = winner) from bust times and final
    stacks: a later bust beats an earlier one; unbusted seats rank by final
    stack."""
    b = np.asarray(busted_at, np.int64)
    s = np.asarray(seat_stacks, np.int64)
    order_key = b * (s.max() + 2) + s  # bust time dominates, stack breaks
    return np.argsort(np.argsort(-order_key, axis=1, kind="stable"),
                      axis=1, kind="stable") + 1


def position_winrates(deltas, big_blind: int):
    """[tables, hands, P] chip deltas -> (bb/hand mean [P], stderr [P]);
    position 0 is each hand's small blind."""
    bb = np.asarray(deltas, np.float64) / big_blind
    flat = bb.reshape(-1, bb.shape[-1])
    return flat.mean(axis=0), flat.std(axis=0, ddof=1) / np.sqrt(flat.shape[0])


def selfplay_stats(states: TableState) -> Dict[str, object]:
    """Aggregate diagnostics over a batch of final states (0-dim tensors,
    ``tables`` an int)."""
    return {
        "tables": states.n_tables,
        "mean_stack": states.stacks.float().mean(),
        "min_stack": states.stacks.min(),
        "max_stack": states.stacks.max(),
        "bet_overflow_frac": states.bets.overflow.float().mean(),
        "pot_overflow_frac": states.pots.overflow.float().mean(),
        "hands_played": states.hand_idx.max(),
    }
