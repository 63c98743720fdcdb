"""The engine driven on an injected stream, the way K3 is driven.

K3 (``ops/cuda_engine.run_perpetual_det``) runs fused ``step_table`` steps
on raw actions and a per-hand deal stash, and keeps meters the engine state
does not: hands completed, settled chip deltas and (tournament rules) the
hand at which each seat busted. ``replay_injected`` drives the engine's own
functions on the same stream and computes those meters beside it, as the
JAX test ``tests/test_pallas_engine.py:_replica`` does. ``k3_fields`` gives
a state under K3's field names; ``against_pack_state`` and ``against_k3``
compare a first state with ``pack_state``'s and a replay with K3's output,
field by field through ``cuda_engine.unpack_field``. ``replay_net_det``
is the engine driven the way K5 (``ops/cuda_net.run_net_det``) is, every
seat playing a net by argmax, and ``against_k5`` holds it to K5's output.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from montecarlo_tpu_torch.cards import NUM_CARDS
from montecarlo_tpu_torch.engine.bets import member_matrix
from montecarlo_tpu_torch.engine.state import (
    TableConfig,
    TableState,
    _select_tree,
    redeal,
)
from montecarlo_tpu_torch.engine.street import Street
from montecarlo_tpu_torch.engine.step import (
    _advance_streets,
    apply_action,
    clamp_action,
    head_info,
    settle_showdown,
    step_table,
)
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.models.features import state_features
from montecarlo_tpu_torch.ops.cuda_engine import unpack_field

I32 = torch.int32


class Replay(NamedTuple):
    state: TableState
    hand_ct: torch.Tensor    # int32 [T] hands completed
    delta_sum: torch.Tensor  # int32 [T, P] settled chip change by position
    bust_at: torch.Tensor    # int32 [T, P] hand a seat busted in; -1 none
    overflow_at: torch.Tensor  # int32 [T] first step a street ran out of
    #                            layers; -1 none

    @property
    def overflow(self) -> torch.Tensor:
        return self.overflow_at >= 0


def _deal_positions(P: int):
    """The deck positions a deal reads (holes, then the board past the
    burns) and the rest, in order."""
    used = list(range(2 * P)) + [2 * P + k for k in (1, 2, 3, 5, 7)]
    return used, [p for p in range(NUM_CARDS) if p not in used]


def decks_from_deals(deals: torch.Tensor) -> torch.Tensor:
    """int32 [T, 2P+5] dealt cards (holes round-robin, then the board) ->
    int32 [T, 52] decks whose consumption order (``redeal``) deals exactly
    those cards; the unused positions hold the other cards ascending."""
    T, n = deals.shape
    used, unused = _deal_positions((n - 5) // 2)
    taken = torch.zeros((T, NUM_CARDS), dtype=torch.int8,
                        device=deals.device)
    taken.scatter_(1, deals.long(), 1)
    rest = torch.sort(taken, dim=1, stable=True).indices[:, :len(unused)]
    deck = torch.empty((T, NUM_CARDS), dtype=I32, device=deals.device)
    deck[:, used] = deals.to(I32)
    deck[:, unused] = rest.to(I32)
    return deck


def _roll_rows(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``roll(x[t], shift[t])`` per table: out[t, j] = x[t, (j - s) % P]."""
    P = x.shape[1]
    j = torch.arange(P, device=x.device)[None]
    return x.gather(1, torch.remainder(j - shift[:, None], P).long())


def _replay(cfg: TableConfig, state: TableState, n_steps: int, raw_action,
            deck_of) -> Replay:
    """``n_steps`` steps of ``clamp_action`` + ``step_table`` from
    ``state`` on ``raw_action(i, state)`` (int [T]); a table whose hand
    counter moves is redealt from ``deck_of(row)`` (int32 [T, 52] for deal
    rows int64 [T]), row min(hand, hmax - 1) as the engine kernels read
    their stash (``deck_of`` clamps). The meters beside the state are
    recomputed as ``replay_injected`` says."""
    rules, P = cfg.rules, cfg.num_seats
    T = state.n_tables
    dev = state.stacks.device
    hand_start = torch.full((T, P), cfg.starting_stack, dtype=I32,
                            device=dev)
    delta_sum = torch.zeros((T, P), dtype=I32, device=dev)
    hand_ct = torch.zeros(T, dtype=I32, device=dev)
    bust_at = torch.full((T, P), -1, dtype=I32, device=dev)
    overflow_at = torch.full((T,), -1, dtype=I32, device=dev)
    seats = torch.arange(P, dtype=I32, device=dev)[None]
    for i in range(n_steps):
        st = state
        _, _, exists = head_info(st)
        ca = clamp_action(st, raw_action(i, st))
        nxt = step_table(st, ca, rules=rules)
        applied = apply_action(st, ca, rules=rules)
        # the action's own street: an action that ends the street moves
        # the latch into the pots, and the deal clears it there
        latched = applied.bets.overflow & ~st.hand_over & exists
        acted = _advance_streets(applied, rules)
        overflow_at = torch.where(latched & (overflow_at < 0), i,
                                  overflow_at)
        # a hand completed: a redeal happened, or the table froze
        done = (nxt.hand_idx != st.hand_idx) | (nxt.hand_over
                                                 & ~st.hand_over)
        settled = settle_showdown(acted, rules=rules).stacks
        if rules == "tournament":
            seat_stacks = _roll_rows(settled, st.button)
            newly = done[:, None] & (seat_stacks <= 0) & (bust_at < 0)
            bust_at = torch.where(newly, hand_ct[:, None], bust_at)
        hand_ct = hand_ct + done.to(I32)
        delta_sum = delta_sum + torch.where(done[:, None],
                                            settled - hand_start, 0)
        # the next hand's pre-blind stacks (next_hand's rotation)
        if rules == "tournament":
            shift = torch.where((settled > 0) & (seats >= 1), seats,
                                P).amin(1).clamp(1, P - 1)
            pre = _roll_rows(settled, -shift)
        else:
            pre = torch.roll(settled, -1, dims=1)
        hand_start = torch.where(done[:, None], pre, hand_start)
        redealt = redeal(nxt, deck_of(nxt.hand_idx.long()))
        state = _select_tree(nxt.hand_idx != st.hand_idx, redealt, nxt)
    return Replay(state, hand_ct, delta_sum, bust_at, overflow_at)


def _rows_of(stash: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """stash[t, min(row[t], hmax - 1)] per table, stash [T, hmax, n]."""
    T, hmax, n = stash.shape
    row = row.clamp(max=hmax - 1)
    return stash.gather(1, row.view(T, 1, 1).expand(T, 1, n))[:, 0]


def replay_injected(cfg: TableConfig, state: TableState, actions,
                    deals) -> Replay:
    """``actions.shape[0]`` steps of ``clamp_action`` + ``step_table`` from
    ``state`` on raw actions int [n_steps, T] and per-hand deals int
    [T, hmax, 2P+5]: whenever a table's hand counter moves, its new hand is
    redealt from deal row min(hand, hmax - 1), as K3 reads its stash.

    A hand's settled stacks are recomputed with the same functions
    (``settle_showdown`` of the acted state) for ``delta_sum``. The street's
    overflow latch is cleared at each deal, where K3 keeps its own, so a
    table's ``overflow_at`` is the first step whose action latched it."""
    dev = state.stacks.device
    actions = torch.as_tensor(actions, device=dev).to(I32)
    deals = torch.as_tensor(deals, device=dev).to(I32)
    return _replay(cfg, state, actions.shape[0], lambda i, st: actions[i],
                   lambda row: decks_from_deals(_rows_of(deals, row)))


def replay_net_det(cfg: TableConfig, state: TableState, banks,
                   seat_to_bank, decks, n_steps: int) -> Replay:
    """The net pipeline of K5 on the engine (``tests/test_pallas_engine.py:
    xla_net_det_reference``): ``n_steps`` steps in which each table's head
    plays its bank by argmax, ``state_features`` -> ``policy_logits`` (the
    fold masked where nothing is owed) -> ``action_from_index`` ->
    ``clamp_action`` -> ``step_table``; each new hand is dealt from
    ``decks`` int [T, hmax, 52] row min(hand_idx, hmax - 1) with
    ``redeal``.

    ``banks`` is a list of ``MLPParams``; stable seat s (= (button +
    position) % P) plays ``banks[seat_to_bank[s]]`` (every seat bank 0
    when ``seat_to_bank`` is None). Returns a ``Replay`` with K5's meters
    (``replay_injected``'s)."""
    P = cfg.num_seats
    dev = state.stacks.device
    decks = torch.as_tensor(decks, device=dev).to(I32)
    stb = torch.tensor(seat_to_bank or (0,) * P, dtype=torch.int64,
                       device=dev)
    banks = [tpn.MLPParams(*(x.to(dev, torch.float32) for x in b))
             for b in banks]

    def argmax_action(_, st):
        pos, _, _ = head_info(st)
        bank = stb[torch.remainder(st.button + pos, P).long()]
        feats = state_features(st)
        logits = tpn.policy_logits(banks[0], feats)
        for b in range(1, len(banks)):
            logits = torch.where((bank == b)[:, None],
                                 tpn.policy_logits(banks[b], feats), logits)
        return tpn.action_from_index(
            tpn.first_max(tpn.masked_logits(logits, st)), st)

    return _replay(cfg, state, n_steps, argmax_action,
                   lambda row: _rows_of(decks, row))


def _bitmask(mask: torch.Tensor) -> torch.Tensor:
    bits = torch.ones(mask.shape[1], dtype=I32, device=mask.device) \
        << torch.arange(mask.shape[1], dtype=I32, device=mask.device)
    return torch.where(mask, bits, 0).sum(1, dtype=I32)


def _levels_of(bets, num_seats: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(level, contrib, n) of a street in either form: K3 holds the levels
    form. For ``Layers`` the exact inverse of ``street_to_layers``: a
    level is the running sum of the live rows' amounts, a seat's
    contribution the sum of the amounts of the rows whose original
    members hold it, ``n`` as it is."""
    if isinstance(bets, Street):
        return bets.level, bets.contrib, bets.n
    valid = torch.arange(bets.capacity, device=bets.amt.device)[None] \
        < bets.count[:, None]
    amt = torch.where(valid, bets.amt, 0)
    level = torch.where(valid, amt.cumsum(1, dtype=I32), 0)
    held = member_matrix(bets.orig, num_seats) & valid[:, :, None]
    contrib = torch.where(held, amt[:, :, None], 0).sum(1, dtype=I32)
    return level, contrib, bets.n


def k3_fields(state: TableState, **meters) -> Dict[str, torch.Tensor]:
    """The engine state under K3's packed field names (``cuda_engine.
    _field_layout``): int32 [T] for one-row fields, [T, rows] for the
    others; seat masks as bitmasks; the street in the levels form
    whichever form the state holds (``_levels_of``). ``meters`` adds K3's
    own fields (``hand_ct``, ``delta_sum``, ``bust_at``) where given."""
    level, contrib, ln = _levels_of(state.bets, state.num_seats)
    fields = {
        "stage": state.stage, "cursor": state.cursor,
        "street_raises": state.street_raises,
        "last_raiser": state.last_raiser,
        "folded": _bitmask(state.folded), "in_hand": _bitmask(state.in_hand),
        "to_act": _bitmask(state.to_act),
        "order": _bitmask(state.order_mask), "button": state.button,
        "all_in": _bitmask(state.all_in),
        "stacks": state.stacks, "contrib": contrib,
        "hole0": state.hole[:, :, 0], "hole1": state.hole[:, :, 1],
        "board": state.community, "lvl": level, "ln": ln,
    }
    fields.update(meters)
    return fields


def against_pack_state(packed: torch.Tensor, cfg: TableConfig,
                       state: TableState) -> List[str]:
    """The fields (``name[row]``) where a first state (``init_state`` +
    ``redeal``) differs from ``cuda_engine.pack_state``'s on the same
    cards: every field the two hold, the cards and street included."""
    fields = k3_fields(state)
    if cfg.rules == "reference":  # K3 keeps no all-in row there
        del fields["all_in"]
    bad = []
    for name, v in fields.items():
        v = v if v.dim() == 2 else v[:, None]
        for k in range(v.shape[1]):
            if not torch.equal(unpack_field(packed, cfg, name, k), v[:, k]):
                bad.append(f"{name}[{k}]")
    return bad


# K3's fields that the replay holds, compared on every table within
# capacity (tournament rules add ``bust_at``).
K3_COMPARED = ("hand_ct", "stage", "cursor", "folded", "in_hand", "to_act",
               "order", "street_raises", "last_raiser", "stacks", "lvl", "ln",
               "contrib", "delta_sum")
# Observational fields (no rule reads them) that the JAX engine and the
# JAX Pallas kernel, which K3 follows, leave differently on a frozen
# tournament table: the engine keeps the last hand's values, the kernel
# shows a fresh deal's (0 raises, no raiser).
FROZEN_FIELDS = ("street_raises", "last_raiser")


class K3Agreement(NamedTuple):
    k3_overflow: torch.Tensor  # bool [T] K3's overflow latch
    # name -> bool [T]: the tables within K3's capacity where the field
    # differs, frozen tables that show a fresh deal's values left out
    mismatch: Dict[str, torch.Tensor]
    # bool [T]: frozen tables where K3 shows a fresh deal's FROZEN_FIELDS
    # and the engine its last hand's
    frozen_fresh: torch.Tensor


def against_k3(packed: torch.Tensor, cfg: TableConfig,
               rep: Replay) -> K3Agreement:
    """Hold a replay against K3's packed output on the same stream, field
    by field through ``unpack_field``, on the tables K3 did not mark
    overflowed."""
    k3_over = unpack_field(packed, cfg, "overflow") != 0
    frozen = rep.state.hand_over & ~k3_over
    fresh = dict(zip(FROZEN_FIELDS, (0, cfg.num_seats)))
    ours = k3_fields(rep.state, hand_ct=rep.hand_ct,
                     delta_sum=rep.delta_sum, bust_at=rep.bust_at)
    names = K3_COMPARED + (("bust_at",) if cfg.rules == "tournament"
                           else ())
    mismatch = {}
    frozen_fresh = torch.zeros_like(k3_over)
    for name in names:
        v = ours[name] if ours[name].dim() == 2 else ours[name][:, None]
        bad = torch.zeros_like(k3_over)
        for k in range(v.shape[1]):
            k3 = unpack_field(packed, cfg, name, k)
            diff = ~k3_over & (k3 != v[:, k])
            if name in fresh:
                shows_fresh = frozen & (k3 == fresh[name])
                frozen_fresh |= diff & shows_fresh
                diff &= ~shows_fresh
            bad |= diff
        mismatch[name] = bad
    return K3Agreement(k3_over, mismatch, frozen_fresh)


def against_k5(packed: torch.Tensor, cfg: TableConfig,
               rep: Replay) -> K3Agreement:
    """Hold ``replay_net_det`` against K5's packed output
    (``ops/cuda_net.run_net_det``) on the same deal stash: K3's field view
    and comparison (``against_k3``). The net kernels run reference and
    standard rules, where no table freezes."""
    if cfg.rules == "tournament":
        raise ValueError("the net kernels run reference and standard rules")
    return against_k3(packed, cfg, rep)
