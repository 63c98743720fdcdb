"""The table step: ``montecarlo_tpu/engine/step.py`` on tables held on a
leading axis.

One action per table = one call of ``step_action`` (a single hand) or
``step_table`` (the perpetual table: settle, rotate and deal the next hand
in the same step). Everything is branch-free over the tables: candidate
states are computed for every table and selected per table, as the JAX
engine's ``jnp.where`` selects are. Plain PyTorch: no kernel of its own
(the JAX step is XLA); ``ops/cuda_engine.py``'s K3 is its fused form.

The reference semantics kept bit for bit, and the divergences where the
reference crashes, are those of the JAX module's docstring. Integer
division floors (``torch.div(..., rounding_mode="floor")``), as ``jnp``'s
does; the showdown keys are held as int64, where JAX compares them as
uint32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from montecarlo_tpu_torch.engine.bets import Layers, member_matrix
from montecarlo_tpu_torch.engine.state import (
    TableState,
    _select_tree,
    _tree_map,
    next_hand,
)
from montecarlo_tpu_torch.engine.street import (
    _pick,
    _vec,
    bets_as_layers,
    bets_empty_like,
    bets_fold_check_merge,
    bets_needed,
    bets_thread,
    bets_total,
)
from montecarlo_tpu_torch.ops.evaluator import (
    _popcount,
    eval7_from_cards,
    eval_masks_cmp_impl,
    suit_masks_from_cards,
)

I32 = torch.int32
I64 = torch.int64


def _seats(state: TableState) -> torch.Tensor:
    return torch.arange(state.num_seats, dtype=I32,
                        device=state.stacks.device)[None]


def head_info(state: TableState
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(head position, cursor after it, head exists), each [T].

    The head is the first position still in the play-order cycle, scanning
    cyclically from ``cursor`` (``board.clj:34``)."""
    P = state.num_seats
    prio = torch.remainder(_seats(state) - state.cursor[:, None], P)
    k = torch.where(state.order_mask, prio, P).amin(1)
    head = torch.remainder(state.cursor + k, P)
    cursor_after = torch.remainder(state.cursor + k + 1, P)
    return head, cursor_after, k < P


def clamp_action(state: TableState, action) -> torch.Tensor:
    """Player-side validation (``player.clj:24-32``): raises are clamped to
    ``[0, stack - needed]``; fold and call pass through. int32 [T]."""
    action = _vec(action, state.stage)
    seat, _, _ = head_info(state)
    cap = _pick(state.stacks, seat) - bets_needed(state.bets, seat)
    clamped = torch.clamp(torch.minimum(action, cap), min=0)
    return torch.where(action > 0, clamped, action)


def apply_action(state: TableState, action, rules: str = "reference"
                 ) -> TableState:
    """One fold/call/raise by each table's head (``board.clj:31-97``),
    unconditionally: callers gate on ``hand_over`` and head existence.
    ``rules="reference"`` is bit-exact to the Clojure code, quirks
    included; the others cap payments at the stack."""
    action = _vec(action, state.stage)
    seat, cursor_after, _ = head_info(state)
    onehot = _seats(state) == seat[:, None]

    is_fold = action < 0
    is_raise = action > 0
    is_call = action == 0
    r = action.clamp(min=0)

    bets = state.bets
    bet_amt = bets_total(bets)
    delta = bets_needed(bets, seat)
    stack = _pick(state.stacks, seat)

    is_check = is_call & (bet_amt == 0)
    threads = (is_call & (bet_amt > 0)) | is_raise

    if rules != "reference":
        # Payments cap at the stack: an all-in for less joins only what it
        # can cover, splitting a side pot.
        pay_call = torch.minimum(delta, stack)
        pay_raise = torch.minimum(delta + r, stack)
        amount = torch.where(is_raise, r + bet_amt - (delta + r - pay_raise),
                             bet_amt - (delta - pay_call))
        paid = torch.where(threads,
                           torch.where(is_raise, pay_raise, pay_call), 0)
    else:
        # Reference: a call pays the full delta (stacks may go negative);
        # a raise threads r + total.
        amount = torch.where(is_raise, r + bet_amt, bet_amt)
        paid = torch.where(threads, torch.where(is_raise, delta + r, delta),
                           0)

    threaded = bets_thread(bets, amount, seat)
    merged = bets_fold_check_merge(bets, is_fold, seat)
    new_bets = _select_tree(is_fold | is_check, merged, threaded)

    went_all_in = threads & (paid == stack)
    fold_here = onehot & is_fold[:, None]
    if rules != "reference":
        # All-in seats stop acting but stay live for the showdown.
        in_hand = state.in_hand & ~fold_here
        all_in = state.all_in | (onehot & went_all_in[:, None])
        actable = in_hand & ~all_in
        to_act = torch.where(is_raise[:, None], actable & ~onehot,
                             state.to_act & ~onehot)
        order_mask = state.order_mask & ~(
            onehot & (is_fold | went_all_in)[:, None])
    else:
        # Reference quirk: exact-equality all-ins leave :players entirely
        # (board.clj:53-60, 80-89).
        in_hand = state.in_hand & ~(onehot
                                    & (is_fold | went_all_in)[:, None])
        all_in = state.all_in
        to_act = torch.where(is_raise[:, None], in_hand & ~onehot,
                             state.to_act & ~onehot)
        order_mask = state.order_mask & ~fold_here

    return state._replace(
        time=state.time + 1,
        bets=new_bets,
        stacks=state.stacks - torch.where(onehot, paid[:, None], 0),
        in_hand=in_hand,
        all_in=all_in,
        folded=state.folded | fold_here,
        order_mask=order_mask,
        to_act=to_act,
        cursor=torch.where(is_fold, state.cursor, cursor_after),
        street_raises=state.street_raises + is_raise.to(I32),
        last_raiser=torch.where(is_raise, seat, state.last_raiser),
    )


def stage_end(state: TableState) -> torch.Tensor:
    """remaining-players empty (``gameplay.clj:15-17``), bool [T]."""
    return ~state.to_act.any(1)


def game_end(state: TableState) -> torch.Tensor:
    """<= 1 in-hand player, or the river street complete
    (``gameplay.clj:19-24``), bool [T]."""
    return ((state.in_hand.sum(1) <= 1)
            | (stage_end(state) & (state.stage == 3)))


def append_layers(dst: Layers, src: Layers) -> Layers:
    """``(concat pots bets)`` on fixed-shape layer lists: output row j of a
    table takes source row j - dst.count where that is a live source row
    (a gather; the JAX form is a [PL, L] placement matrix)."""
    PL, L = dst.capacity, src.capacity
    rows = torch.arange(PL, dtype=I32, device=dst.amt.device)[None]
    from_src = rows - dst.count[:, None]
    take = (from_src >= 0) & (from_src < src.count[:, None])
    at = from_src.clamp(0, L - 1).long()

    def placed(d, s):
        return torch.where(take, s.gather(1, at), d)

    return Layers(
        amt=placed(dst.amt, src.amt),
        mem=placed(dst.mem, src.mem),
        orig=placed(dst.orig, src.orig),
        n=placed(dst.n, src.n),
        count=torch.clamp(dst.count + src.count, max=PL),
        overflow=dst.overflow | src.overflow | (dst.count + src.count > PL),
    )


def stage_transition(state: TableState, rules: str = "reference"
                     ) -> TableState:
    """Deal the next street and reset the betting round
    (``gameplay.clj:94-102``): flop 3 / turn 1 / river 1 revealed, bets
    move onto the pots, remaining-players and play-order rebuild from
    ``:players`` (all-in seats drop out of the order here)."""
    reveal = torch.where(state.stage == 0, 3, 1).to(I32)
    actable = (state.in_hand & ~state.all_in if rules != "reference"
               else state.in_hand)
    return state._replace(
        n_community=state.n_community + reveal,
        to_act=actable,
        pots=append_layers(state.pots,
                           bets_as_layers(state.bets, state.folded)),
        bets=bets_empty_like(state.bets, state.num_seats),
        order_mask=actable,
        cursor=torch.zeros_like(state.cursor),
        stage=state.stage + 1,
        street_raises=torch.zeros_like(state.street_raises),
        last_raiser=torch.full_like(state.last_raiser, state.num_seats),
    )


def _seven(state: TableState) -> torch.Tensor:
    """int32 [T, P, 7]: every position's hole cards and the board."""
    T, P = state.n_tables, state.num_seats
    return torch.cat([state.hole,
                      state.community[:, None, :].expand(T, P, 5)], dim=2)


def hand_values(state: TableState) -> torch.Tensor:
    """Packed 7-card values per position, int32 [T, P]."""
    return eval7_from_cards(_seven(state))


def hand_values_cmp(state: TableState) -> torch.Tensor:
    """Comparison-only 7-card keys per position, int32 [T, P] (order- and
    tie-equal to the packed keys)."""
    return eval_masks_cmp_impl(*suit_masks_from_cards(_seven(state)))


def settle_showdown(state: TableState, rules: str = "reference"
                    ) -> TableState:
    """End-of-hand pot resolution (``gameplay.clj:122-133``): flush the
    street into the pots and pay each pot layer to its best eligible
    members.

    Reference rules: eligible = current members in :players, payout
    ``amt * n`` (the inflated n), integer split, remainders vanish.
    Standard rules: eligible = contributors not folded, payout
    ``amt * |contributors|``, odd chips to the first-position winner."""
    pots = append_layers(state.pots,
                         bets_as_layers(state.bets, state.folded))
    # JAX compares the keys as uint32: hold them as int64.
    values = (hand_values_cmp(state).to(I64) & 0xFFFFFFFF)[:, None, :]
    P = state.num_seats
    seats = torch.arange(P, device=values.device)[None, None]
    valid = (torch.arange(pots.capacity, device=values.device)[None]
             < pots.count[:, None])
    if rules != "reference":
        elig = (member_matrix(pots.orig, P) & state.in_hand[:, None, :]
                & valid[:, :, None])
        total_pot = pots.amt * torch.where(valid, _popcount(pots.orig), 0)
    else:
        elig = (member_matrix(pots.mem, P) & state.in_hand[:, None, :]
                & valid[:, :, None])
        total_pot = pots.amt * pots.n
    vmax = torch.where(elig, values, 0).amax(2, keepdim=True)
    winners = elig & (values == vmax)
    cnt = winners.sum(2, dtype=I32)
    div = cnt.clamp(min=1)
    share = torch.where(cnt > 0, torch.div(total_pot, div,
                                           rounding_mode="floor"), 0)
    payout = torch.where(winners, share[:, :, None], 0).sum(1, dtype=I32)
    if rules != "reference":
        # Odd chips to the first-position winner of each layer (the first
        # True of JAX's argmax over the winner mask).
        rem = torch.where(cnt > 0, torch.remainder(total_pot, div), 0)
        first = torch.where(winners, seats, P).amin(2, keepdim=True)
        payout = payout + torch.where(
            (seats == first) & (cnt > 0)[:, :, None], rem[:, :, None],
            0).sum(1, dtype=I32)

    return state._replace(
        stacks=state.stacks + payout,
        pots=pots,
        bets=bets_empty_like(state.bets, P),
        hand_over=torch.ones_like(state.hand_over),
    )


def _advance_streets(state: TableState, rules: str) -> TableState:
    """Street transitions after an action: at most one under reference
    rules (``board.clj:122-129``); otherwise closed betting runs the board
    out, up to 4 masked transitions in the same step. The count is a rule,
    not a tuning knob."""
    for _ in range(4 if rules != "reference" else 1):
        cond = stage_end(state) & ~game_end(state)
        state = _select_tree(cond, stage_transition(state, rules), state)
    return state


def step_action(state: TableState, action, rules: str = "reference"
                ) -> TableState:
    """One action plus street bookkeeping, *without* paying the showdown
    (the single-hand form: settle once with ``settle_showdown``). A table
    whose hand is over, or that has no head, is returned unchanged."""
    _, _, exists = head_info(state)
    acted = apply_action(state, action, rules=rules)
    advanced = _advance_streets(acted, rules)
    out = advanced._replace(hand_over=advanced.hand_over
                            | game_end(advanced))
    return _select_tree(state.hand_over | ~exists, state, out)


def _take(state: TableState, idx: torch.Tensor) -> TableState:
    """The tables ``idx`` (int64 [n]) of a state, field by field."""
    return _tree_map(lambda x: x.index_select(0, idx), state)


def _put(state: TableState, idx: torch.Tensor, sub: TableState
         ) -> TableState:
    """``state`` with the tables ``idx`` replaced by ``sub``'s rows."""
    return _tree_map(lambda x, y: x.index_copy(0, idx, y), state, sub)


def step_table(state: TableState, action, rules: str = "reference"
               ) -> TableState:
    """The perpetual-table step (``gameplay.clj:122-150``): on game end,
    settle the showdown and deal the next hand at once.

    A table with ``hand_over`` latched is returned unchanged: under
    tournament rules ``next_hand`` freezes a finished table that way, a
    fixed point of this step.

    Settling and dealing are per-table functions, so they run on the
    tables whose hand ended only (gathered, then scattered back): the same
    result as the JAX form's compute-everywhere-and-select, without a deck
    for every table at every step. Finding those tables is one host read
    a step."""
    _, _, exists = head_info(state)
    acted = apply_action(state, action, rules=rules)
    advanced = _advance_streets(acted, rules)
    live = ~state.hand_over & exists
    idx = (game_end(advanced) & live).nonzero()[:, 0]
    out = advanced
    if idx.numel():
        ended = _take(advanced, idx)
        settled = settle_showdown(ended, rules=rules)
        settled = next_hand(settled._replace(
            hand_over=torch.zeros_like(settled.hand_over)), rules=rules)
        out = _put(advanced, idx, settled)
    return _select_tree(live, out, state)
