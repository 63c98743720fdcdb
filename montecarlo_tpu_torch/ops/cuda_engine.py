"""Whole-step betting engine on the card: K3, K4 and the first state.

The counterpart of ``montecarlo_tpu/ops/pallas_engine.py:1-983``. The
state is the JAX engine's packed per-table array, unchanged:
``[n_blocks, F, 8, 128]`` int32, 1024 tables per block, field offsets from
``_field_layout``; ``state_from_numpy`` / ``state_to_numpy`` move a JAX
state in and out as it is.

- K3 (``csrc/engine.cu:mc_engine_det_kernel``, ``run_perpetual_det``): one
  fused ``step_table`` per step on injected raw actions and a per-hand
  deal stash — the bit-exact anchor.
- K4 (``mc_engine_prng_kernel``, ``run_perpetual_prng``): the random
  policy, DEFER betting slots per settle pass and an in-kernel deal, on
  Philox words (or injected words). ``prng_words`` computes the kernel's
  Philox words in plain PyTorch, so for a given seed the CPU wrapper and
  the kernel return the same state.
- A request's first state (``mc_first_state_kernel``, ``first_state``):
  the first deal and its packing in one launch; its plain version is
  ``pack_state(cfg, first_deal(...))``, which scripts and tests also call
  on cards of their own.

Reference, standard and tournament rules, selected statically as in the
JAX engine (a template parameter of the kernels). Seat counts 2..10 are
accepted. Under tournament rules busted seats leave the deal, each seat's
first bust is kept in ``bust_at``, and a table left with one player holding
chips freezes (an empty play order); ``tournaments_to_completion`` relaunches
K4 until every table has frozen and ``tournament_results`` ranks the seats.

The plain versions ``_run_det_plain`` / ``_run_prng_plain`` translate the
JAX device functions onto ``[rows, tables]`` tensors (tables on the last
axis). A wrapper runs them only for CPU tensors; for a CUDA tensor it
launches the kernel or raises. ``LAUNCHES`` counts kernel launches. The
plain versions' loops (here and in ``cuda_net``, ``cuda_stages`` and the
splits) run through ``plain_loop``: eager on the CPU, and on the card
replayed from a CUDA graph of one step (eager, those loops are
launch-bound).

The hooks of the splits. Eight keyword arguments of plain functions let
the splits' plain versions (``ops/cuda_split.py``, ``ops/cuda_net_split.py``)
replace one piece, and only they pass them; each defaults to the real
piece: ``_hand_values(evaluate=)``, ``_settle_payout(evaluate=)``,
``_step_nosettle(update=, merge=)``, ``_settle_pass(payout=)`` here,
``models/features.features(evaluate=)``, and
``ops/cuda_net._masked_logits(feats=)`` / ``_net_action(feats=)``.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops.cuda_equity import _sample_cards
from montecarlo_tpu_torch.ops.evaluator import (
    eval_masks_cmp_impl,
    suit_masks_from_cards,
)
from montecarlo_tpu_torch.ops.philox import MASK, stream_words, words_as_i32
from montecarlo_tpu_torch.utils.profiling import span

I32 = torch.int32
I64 = torch.int64

TILE = (8, 128)
TABLES_PER_BLOCK = TILE[0] * TILE[1]

# Betting slots per settle pass in the PRNG kernel (deferred settlement):
# a table whose hand ends waits, as a no-op, until the pass settles,
# rotates and redeals it. Runs whose length is not a multiple fall back to
# one settle pass per slot (the fused step), as in the JAX kernel.
DEFER = 16

# Street layer capacity (reference rules / others) and policy constants,
# as in the JAX engine.
L = 6
L_STANDARD = 10
FOLD_P_BITS = int(0.15 * 2**32)
RAISE_P_BITS = int((0.15 + 0.30) * 2**32)
MAX_RAISE = 20
MAX_RAISES_PER_STREET = 2
MAX_SEATS = 10

RULES = ("reference", "standard", "tournament")
LAUNCHES = {**{f"engine_{mode}_{rules}": 0
               for mode in ("det", "prng") for rules in RULES},
            **{f"first_state_{rules}": 0 for rules in RULES}}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _L_for(rules: str) -> int:
    return L if rules == "reference" else L_STANDARD


def _field_layout(P: int, rules: str = "reference"):
    """Name -> (offset, rows) of the packed per-table state; the JAX
    engine's layout for every rule set."""
    fields = [
        ("stage", 1), ("cursor", 1), ("street_raises", 1),
        ("last_raiser", 1), ("folded", 1), ("in_hand", 1), ("to_act", 1),
        ("order", 1), ("wait", 1), ("hand_ct", 1), ("overflow", 1),
        ("button", 1),
        ("stacks", P), ("contrib", P), ("hole0", P), ("hole1", P),
        ("hand_start", P), ("delta_sum", P), ("seat_delta", P),
        ("board", 5), ("lvl", _L_for(rules)), ("ln", _L_for(rules)),
        ("pot_amt", 4 * _L_for(rules)), ("pot_set", 4 * _L_for(rules)),
    ]
    if rules == "reference":
        fields.append(("pot_n", 4 * _L_for(rules)))
    else:
        fields.append(("all_in", 1))
    if rules == "tournament":
        fields.append(("bust_at", P))
    layout, off = {}, 0
    for name, rows in fields:
        layout[name] = (off, rows)
        off += rows
    return layout, off


def _check_config(P: int, rules: str) -> None:
    if rules not in RULES:
        raise ValueError(f"rules={rules!r}: expected one of {RULES}")
    if not 2 <= P <= MAX_SEATS:
        raise ValueError(f"num_seats={P}: expected 2..{MAX_SEATS}")


# ---------------------------------------------------------------------------
# Host-side pack / unpack
# ---------------------------------------------------------------------------

def _check_first_hand(cfg) -> None:
    """The first hand's checks: seats, rules, blinds positive."""
    _check_config(cfg.num_seats, cfg.rules)
    if cfg.small_blind <= 0 or cfg.big_blind <= 0:
        raise ValueError("blinds must be positive")


def _first_hand(cfg):
    """The first hand's scalar rules, checked (``_check_first_hand``):
    ``(sb, bb, stacks, all_in, lvl, ln)``. Under standard and tournament
    rules the blinds are capped at the stack and ``all_in`` has the seats
    whose blind takes the whole stack (0 under reference rules); ``stacks``
    [P] are the stacks after the blinds; the street opens at ``lvl``
    min(sb, bb) with 2 contributors and, when the blinds differ, max(sb,
    bb) with 1 (``ln``). ``pack_state`` packs them; the card's first state
    computes the same rules in the kernel (``csrc/engine.cuh``
    ``mc_first_hand``)."""
    _check_first_hand(cfg)
    P, rules = cfg.num_seats, cfg.rules
    sb, bb, ss = cfg.small_blind, cfg.big_blind, cfg.starting_stack
    if rules != "reference":  # blinds capped at the stack
        sb, bb = min(sb, max(ss, 0)), min(bb, max(ss, 0))
    stacks = [ss - blind for blind in [sb, bb] + [0] * (P - 2)]
    all_in = 0
    if rules != "reference":  # all-in blinds sit out, showdown-live
        all_in = sum(int(st <= 0) << k for k, st in enumerate(stacks))
    lo, hi = min(sb, bb), max(sb, bb)
    lvl, ln = ([lo], [2]) if lo == hi else ([lo, hi], [2, 1])
    return sb, bb, stacks, all_in, lvl, ln


def _check_tables(n_tables: int) -> None:
    if n_tables % TABLES_PER_BLOCK:
        raise ValueError(f"{n_tables} tables: not a multiple of "
                         f"{TABLES_PER_BLOCK}")


def pack_state(cfg, first_cards) -> torch.Tensor:
    """Initial packed state for ``n_tables`` tables, first hand dealt from
    ``first_cards`` [n_tables, 2P+5] (holes round-robin, then the board)
    and blinds posted (``_first_hand``). Returns [n_blocks, F, 8, 128]
    int32 on the device of ``first_cards``."""
    with span("pack_state"):
        P, rules = cfg.num_seats, cfg.rules
        sb, bb, stacks, all_in, lvl, ln = _first_hand(cfg)
        layout, F = _field_layout(P, rules)
        fc = torch.as_tensor(first_cards).to(I32)
        n_tables = fc.shape[0]
        _check_tables(n_tables)
        rows = torch.zeros((F, n_tables), dtype=I32, device=fc.device)

        def put(name, i, val):
            off, n = layout[name]
            assert 0 <= i < n
            rows[off + i] = val

        full = (1 << P) - 1
        put("cursor", 0, 2 % P)
        put("last_raiser", 0, P)
        put("in_hand", 0, full)
        for k in range(P):
            put("stacks", k, stacks[k])
            put("hand_start", k, cfg.starting_stack)
        if rules != "reference":
            put("all_in", 0, all_in)
        if rules == "tournament":  # nobody has busted yet
            for k in range(P):
                put("bust_at", k, -1)
        put("to_act", 0, full & ~all_in)
        put("order", 0, full & ~all_in)
        for k in range(P):
            put("hole0", k, fc[:, k])
            put("hole1", k, fc[:, P + k])
        for i, (level, n) in enumerate(zip(lvl, ln)):
            put("lvl", i, level)
            put("ln", i, n)
        put("contrib", 0, sb)
        put("contrib", 1, bb)
        for i in range(5):
            put("board", i, fc[:, 2 * P + i])
        return _to_blocks(rows)


def _to_rows(state: torch.Tensor) -> torch.Tensor:
    """[n_blocks, F, 8, 128] -> [F, n_tables] (table = block * 1024 +
    sublane * 128 + lane)."""
    nb, F = state.shape[:2]
    return state.permute(1, 0, 2, 3).reshape(F, nb * TABLES_PER_BLOCK)


def _to_blocks(rows: torch.Tensor) -> torch.Tensor:
    F, T = rows.shape
    return (rows.reshape(F, T // TABLES_PER_BLOCK, *TILE)
            .permute(1, 0, 2, 3).contiguous())


def unpack_field(state, cfg, name, i=0) -> torch.Tensor:
    """[n_blocks, F, 8, 128] -> flat [n_tables] view of one field row."""
    layout, _ = _field_layout(cfg.num_seats, cfg.rules)
    off, rows = layout[name]
    assert 0 <= i < rows
    return state[:, off + i].reshape(-1)


def state_from_numpy(arr, device=None) -> torch.Tensor:
    """A packed state as numpy (e.g. from the JAX engine) -> int32 tensor
    on ``device`` (the card when None)."""
    return torch.tensor(np.asarray(arr, np.int32), device=resolve(device))


def state_to_numpy(state: torch.Tensor) -> np.ndarray:
    return state.detach().cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# Plain versions: the JAX device functions on [rows, tables] tensors
# ---------------------------------------------------------------------------

def _unpack(rows, layout):
    return {name: rows[off] if n == 1 else rows[off:off + n]
            for name, (off, n) in layout.items()}


def _pack(st, layout):
    return torch.cat([st[name][None] if n == 1 else st[name]
                      for name, (off, n) in layout.items()], dim=0)


def _iota(n, device):
    return torch.arange(n, dtype=I32, device=device).view(n, 1)


def _pick(stacked, idx):
    """stacked[idx] per table (one-hot sum; 0 where idx is out of range)."""
    one_hot = _iota(stacked.shape[0], stacked.device) == idx[None]
    return torch.where(one_hot, stacked, 0).sum(0, dtype=I32)


def _shift_down(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def _mask_bits(bm, P):
    return (bm[None] >> _iota(P, bm.device)) & 1


def _head_info(st, P):
    cursor = st["cursor"]
    prio = (_iota(P, cursor.device) - cursor[None]) % P
    on = _mask_bits(st["order"], P) != 0
    best = torch.where(on, prio, P).amin(0)
    head = (cursor + best) % P
    return head, (head + 1) % P, st["order"] != 0


def _street_update(lvl, ln, amount, do):
    n_rows = lvl.shape[0]
    valid = lvl > 0
    cnt = valid.sum(0, dtype=I32)
    a = amount[None]
    n_inc = ln + (valid & (lvl <= a)).to(I32)
    exists = (valid & (lvl == a)).any(0)
    pos = (valid & (lvl < a)).sum(0, dtype=I32)
    new_n = torch.where(pos == cnt, 1, _pick(ln, pos) + 1)
    rows = _iota(n_rows, lvl.device)
    below, at = rows < pos[None], rows == pos[None]
    ins_lvl = torch.where(below, lvl, torch.where(at, a, _shift_down(lvl)))
    ins_ln = torch.where(below, n_inc,
                         torch.where(at, new_n[None], _shift_down(n_inc)))
    do_insert = do & ~exists
    out_lvl = torch.where(do_insert[None], ins_lvl, lvl)
    out_ln = torch.where(do_insert[None], ins_ln,
                         torch.where(do[None], n_inc, ln))
    return out_lvl, out_ln, do_insert & (cnt >= n_rows)


def _street_merge(lvl, ln, contrib, do):
    n_rows = lvl.shape[0]
    matched = (contrib[None] == lvl[:, None]).any(1)
    keep = matched & (lvl > 0)
    rank = keep.to(I32).cumsum(0, dtype=I32) - 1
    sel = ((rank[None] == _iota(n_rows, lvl.device)[:, None])
           & keep[None])
    out_lvl = torch.where(sel, lvl[None], 0).sum(1, dtype=I32)
    out_ln = torch.where(sel, ln[None], 0).sum(1, dtype=I32)
    return (torch.where(do[None], out_lvl, lvl),
            torch.where(do[None], out_ln, ln))


def _hand_values(st, evaluate=eval_masks_cmp_impl):
    """Comparison keys [P, T] of every seat's 7 cards (``evaluate`` of their
    four suit masks)."""
    bm = suit_masks_from_cards(st["board"].T)                 # 4 x [T]
    holes = torch.stack([st["hole0"], st["hole1"]], dim=-1)   # [P, T, 2]
    hm = suit_masks_from_cards(holes)                         # 4 x [P, T]
    return evaluate(*[b[None] | h for b, h in zip(bm, hm)])


def _settle_payout(st, pots_amt, pots_set, pots_n, in_hand, P,
                   evaluate=eval_masks_cmp_impl):
    """Showdown payout per pot row, [P, T]. Reference rules (``pots_n``
    given): amt * inflated n, remainders vanish. Standard rules
    (``pots_n`` None): amt * |contributors|, odd chips to the
    first-position winner of each layer. ``evaluate``: the hand values'
    evaluator (the K4 split stubs it)."""
    values = _hand_values(st, evaluate)
    dev = values.device
    in_hand_b = _mask_bits(in_hand, P) != 0
    seats = _iota(P, dev).view(1, 1, P, 1)
    set_bits = (pots_set[:, :, None] >> seats) & 1
    elig = (set_bits != 0) & in_hand_b[None, None]
    vmax = torch.where(elig, values[None, None], 0).amax(2)
    winners = elig & (values[None, None] == vmax[:, :, None])
    cnt = winners.sum(2, dtype=I32)
    if pots_n is not None:
        total_pot = pots_amt * pots_n
    else:
        total_pot = pots_amt * set_bits.sum(2, dtype=I32)
    div = cnt.clamp(min=1)
    share = torch.where(cnt > 0, total_pot // div, 0)
    pay = torch.where(winners, share[:, :, None], 0)
    if pots_n is None:
        rem = torch.where(cnt > 0, total_pot % div, 0)
        first = torch.where(winners, seats, P).amin(2)
        pay = pay + torch.where(seats == first[:, :, None], rem[:, :, None],
                                0)
    return pay.sum((0, 1), dtype=I32)


def _step_nosettle(st, raw_action, P, rules="reference",
                   update=_street_update, merge=_street_merge):
    """The betting half of ``step_table``; a table whose hand ends latches
    ``wait`` and empties its play order. ``update`` and ``merge``: the
    street algebra (the K4 split stubs them)."""
    reference = rules == "reference"
    n_lvl = st["lvl"].shape[0]
    T = st["stage"].shape[0]
    dev = st["stage"].device
    zero = torch.zeros_like(st["stage"])
    head, cursor_after, exists = _head_info(st, P)
    seats = _iota(P, dev)
    head_onehot = seats == head[None]
    head_bit = torch.ones_like(head) << head

    total = st["lvl"].amax(0)
    delta = total - _pick(st["contrib"], head)
    stack_head = _pick(st["stacks"], head)
    cap = stack_head - delta
    clamped = torch.clamp(torch.minimum(raw_action, cap), min=0)
    action = torch.where(raw_action > 0, clamped, raw_action)

    is_fold = action < 0
    is_raise = action > 0
    is_call = action == 0
    r = action.clamp(min=0)
    is_check = is_call & (total == 0)
    threads = (is_call & (total > 0)) | is_raise
    if reference:
        # a call pays the full delta (stacks may go negative)
        amount = torch.where(is_raise, r + total, total)
        paid = torch.where(threads, torch.where(is_raise, delta + r, delta),
                           0)
    else:
        # payments cap at the stack; an all-in for less joins only what it
        # covers
        pay_call = torch.minimum(delta, stack_head)
        pay_raise = torch.minimum(delta + r, stack_head)
        amount = torch.where(is_raise, r + total - (delta + r - pay_raise),
                             total - (delta - pay_call))
        paid = torch.where(threads, torch.where(is_raise, pay_raise,
                                                pay_call), 0)

    up_lvl, up_ln, ovf = update(st["lvl"], st["ln"], amount, threads)
    do_merge = is_fold | is_check
    mg_lvl, mg_ln = merge(st["lvl"], st["ln"], st["contrib"], do_merge)
    lvl = torch.where(do_merge[None], mg_lvl, up_lvl)
    ln = torch.where(do_merge[None], mg_ln, up_ln)
    contrib = torch.where(head_onehot & threads[None],
                          torch.maximum(st["contrib"], amount[None]),
                          st["contrib"])
    stacks = st["stacks"] - torch.where(head_onehot, paid[None], 0)

    went_all_in = threads & (paid == stack_head)
    fold_bit = torch.where(is_fold, head_bit, 0)
    if reference:
        # exact-equality all-ins leave :players entirely
        in_hand = st["in_hand"] & ~torch.where(is_fold | went_all_in,
                                               head_bit, 0)
        actable = in_hand
        order = st["order"] & ~fold_bit
    else:
        # all-in seats stop acting but stay showdown-live
        in_hand = st["in_hand"] & ~fold_bit
        all_in = st["all_in"] | torch.where(went_all_in, head_bit, 0)
        actable = in_hand & ~all_in
        order = st["order"] & ~torch.where(is_fold | went_all_in, head_bit,
                                           0)
    to_act = torch.where(is_raise, actable & ~head_bit,
                         st["to_act"] & ~head_bit)
    folded = st["folded"] | fold_bit
    cursor = torch.where(is_fold, st["cursor"], cursor_after)
    n_in = _mask_bits(in_hand, P).sum(0, dtype=I32)

    # flush the street into the pot slot of the current stage
    flush = (to_act == 0) | (n_in <= 1)
    live = lvl > 0
    row_amt = lvl - _shift_down(lvl)
    ge = (contrib[None] >= lvl[:, None]) & live[:, None]     # [L, P, T]
    if reference:  # :players, folds removed at flush time
        ge = ge & (_mask_bits(folded, P) == 0)[None]
    seat_bits = torch.ones_like(seats) << seats
    layer_set = torch.where(ge, seat_bits[None], 0).sum(1, dtype=I32)
    pots_amt = st["pot_amt"].reshape(4, n_lvl, T)
    pots_set = st["pot_set"].reshape(4, n_lvl, T)
    w = ((flush[None] & (_iota(4, dev) == st["stage"][None]))[:, None]
         & live[None])
    pots_amt = torch.where(w, row_amt[None], pots_amt)
    pots_set = torch.where(w, layer_set[None], pots_set)
    if reference:
        pots_n = torch.where(w, ln[None], st["pot_n"].reshape(4, n_lvl, T))
    lvl = torch.where(flush[None], 0, lvl)
    ln = torch.where(flush[None], 0, ln)
    contrib = torch.where(flush[None], 0, contrib)

    # street transitions: at most one under reference rules; standard
    # chains the board out when nobody can act
    stage = st["stage"]
    for _ in range(1 if reference else 4):
        stage_done = to_act == 0
        gend = (n_in <= 1) | (stage_done & (stage == 3))
        trans = stage_done & ~gend
        stage = torch.where(trans, stage + 1, stage)
        to_act = torch.where(trans, actable, to_act)
        order = torch.where(trans, actable, order)
        cursor = torch.where(trans, zero, cursor)
    ended = (n_in <= 1) | ((to_act == 0) & (stage == 3))
    to_act = torch.where(ended, zero, to_act)
    order = torch.where(ended, zero, order)
    wait = st["wait"] | ended.to(I32)

    applied = (action > 0) & exists
    reset = (stage != st["stage"]) | ended
    street_raises = torch.where(reset, zero,
                                st["street_raises"] + applied.to(I32))
    last_raiser = torch.where(applied, head, st["last_raiser"])
    last_raiser = torch.where(reset, zero + P, last_raiser)

    out = {
        "stage": stage, "cursor": cursor, "street_raises": street_raises,
        "last_raiser": last_raiser, "folded": folded, "in_hand": in_hand,
        "to_act": to_act, "order": order, "wait": wait,
        "overflow": st["overflow"] | ovf.to(I32),
        "stacks": stacks, "contrib": contrib, "lvl": lvl, "ln": ln,
        "pot_amt": pots_amt.reshape(4 * n_lvl, T),
        "pot_set": pots_set.reshape(4 * n_lvl, T),
    }
    if reference:
        out["pot_n"] = pots_n.reshape(4 * n_lvl, T)
    else:
        out["all_in"] = all_in
    # no-head guard: a table with an empty play order is a no-op
    guarded = {name: torch.where(exists if v.dim() == 1 else exists[None],
                                 v, st[name])
               for name, v in out.items()}
    return {**st, **guarded}


def _seat_view(pos, button, P):
    """Seat view of positional rows [P, T]: seat = (button + position) mod
    P, so roll each table's rows by its button (0 where the button is out
    of range)."""
    out = torch.where(button[None] == 0, pos, 0)
    for b in range(1, P):
        out = out + torch.where(button[None] == b, torch.roll(pos, b, dims=0),
                                0)
    return out


def _settle_pass(st, new_cards, P, sb, bb, rules="reference", ss=100,
                 reset_stacks=False, payout=_settle_payout):
    """Settlement and next hand for every table whose ``wait`` flag is up;
    ``new_cards``: [2P+5, T]. With ``reset_stacks`` every hand starts from
    ``ss`` chips a seat (independent-hand evaluation). A tournament table
    left with one player holding chips does not redeal: it keeps its
    settled stacks and hand and freezes with an empty play order.
    ``payout``: the showdown payout (``_settle_payout``; the K4 split
    stubs it)."""
    reference = rules == "reference"
    tournament = rules == "tournament"
    n_lvl = st["lvl"].shape[0]
    T = st["stage"].shape[0]
    dev = st["stage"].device
    zero = torch.zeros_like(st["stage"])
    ended = st["wait"] != 0
    pots_amt = st["pot_amt"].reshape(4, n_lvl, T)
    pots_set = st["pot_set"].reshape(4, n_lvl, T)
    pots_n = st["pot_n"].reshape(4, n_lvl, T) if reference else None

    pay = payout(st, pots_amt, pots_set, pots_n, st["in_hand"], P)
    stacks = torch.where(ended[None], st["stacks"] + pay, st["stacks"])
    hand_ct = st["hand_ct"] + ended.to(I32)
    delta = stacks - st["hand_start"]
    delta_sum = st["delta_sum"] + torch.where(ended[None], delta, 0)
    seat_delta = st["seat_delta"] + torch.where(
        ended[None], _seat_view(delta, st["button"], P), 0)
    seats = _iota(P, dev)
    seat_bits = torch.ones_like(seats) << seats
    out = {}
    if tournament:
        # each seat's first bust (the 0-based index of the hand settled),
        # from the seat view of the settled stacks
        newly = (ended[None] & (_seat_view(stacks, st["button"], P) <= 0)
                 & (st["bust_at"] < 0))
        out["bust_at"] = torch.where(newly, st["hand_ct"][None],
                                     st["bust_at"])
        # rotate to the next position holding chips; with one player left
        # the table freezes
        alive_pos = stacks > 0
        n_alive = alive_pos.sum(0, dtype=I32)
        shift = torch.where(alive_pos & (seats >= 1), seats, P).amin(0) \
            .clamp(1, P - 1)
        rot = stacks
        for b in range(1, P):
            rot = torch.where(shift[None] == b, torch.roll(stacks, -b, dims=0),
                              rot)
        freeze = ended & (n_alive <= 1)
        redeal = ended & ~freeze
        button_shift = shift
    else:
        rot = torch.roll(stacks, -1, dims=0)
        freeze = torch.zeros_like(ended)
        redeal = ended
        button_shift = 1

    # next hand: rotate the players list, blinds, deal
    if reset_stacks:
        rot = torch.full_like(rot, ss)
    hand_start = torch.where(redeal[None], rot, st["hand_start"])
    full = (1 << P) - 1
    if reference:
        blinds = torch.where(seats == 0, sb,
                             torch.where(seats == 1, bb, 0)).to(I32)
        stacks = torch.where(redeal[None], rot - blinds, stacks)
        b_lvl, b_ln = ([min(sb, bb), 0], [2, 0]) if sb == bb else \
            ([min(sb, bb), max(sb, bb)], [2, 1])
        rows = _iota(n_lvl, dev)
        blind_lvl = torch.where(rows == 0, b_lvl[0],
                                torch.where(rows == 1, b_lvl[1], 0)).to(I32)
        blind_ln = torch.where(rows == 0, b_ln[0],
                               torch.where(rows == 1, b_ln[1], 0)).to(I32)
        lvl = torch.where(redeal[None], blind_lvl, st["lvl"])
        ln = torch.where(redeal[None], blind_ln, st["ln"])
        contrib = torch.where(redeal[None], blinds, st["contrib"])
        in_hand_new = to_act_new = full
        cursor0 = 2 % P
        out["pot_n"] = torch.where(ended[None, None], 0, pots_n) \
            .reshape(4 * n_lvl, T)
    else:
        if tournament:
            # dead seats leave the deal; the big blind is the first alive
            # position >= 1 and action starts after it
            alive_new = rot > 0
            in_hand_new = torch.where(alive_new, seat_bits, 0).sum(0,
                                                                   dtype=I32)
            bb_pos = torch.where(alive_new & (seats >= 1), seats, P) \
                .amin(0).clamp(max=P - 1)
            is_bb = seats == bb_pos[None]
            pay1_cap = _pick(rot, bb_pos)
            cursor0 = (bb_pos + 1) % P
        else:
            is_bb = seats == 1
            pay1_cap = rot[1]
            cursor0 = 2 % P
            in_hand_new = full
        # blinds capped at the stack, placed through the street algebra
        pay0 = rot[0].clamp(min=0).clamp(max=sb)
        pay1 = pay1_cap.clamp(min=0).clamp(max=bb)
        pays = torch.where(seats == 0, pay0[None],
                           torch.where(is_bb, pay1[None], 0))
        new_stacks = rot - pays
        stacks = torch.where(redeal[None], new_stacks, stacks)
        z = torch.zeros_like(st["lvl"])
        l1, n1, _ = _street_update(z, z, pay0, pay0 > 0)
        l2, n2, _ = _street_update(l1, n1, pay1, pay1 > 0)
        lvl = torch.where(redeal[None], l2, st["lvl"])
        ln = torch.where(redeal[None], n2, st["ln"])
        contrib = torch.where(redeal[None], pays, st["contrib"])
        # all-in blinds (and, under standard rules, busted seats) sit out,
        # showdown-live
        dead_bm = torch.where(new_stacks <= 0, seat_bits, 0).sum(0,
                                                                 dtype=I32)
        allin_bm = dead_bm & in_hand_new
        out["all_in"] = torch.where(redeal, allin_bm, st["all_in"])
        to_act_new = in_hand_new & ~allin_bm
    to_act = torch.where(redeal, to_act_new, st["to_act"])
    order = torch.where(redeal, to_act_new, st["order"])
    # a frozen tournament table: its empty play order makes every later
    # step a no-op
    to_act = torch.where(freeze, zero, to_act)
    order = torch.where(freeze, zero, order)
    out.update({
        "stage": torch.where(redeal, zero, st["stage"]),
        "cursor": torch.where(redeal, cursor0, st["cursor"]),
        "folded": torch.where(redeal, zero, st["folded"]),
        "in_hand": torch.where(redeal, in_hand_new, st["in_hand"]),
        "to_act": to_act, "order": order,
        "wait": torch.where(ended, zero, st["wait"]),
        "hand_ct": hand_ct,
        "button": torch.where(redeal, (st["button"] + button_shift) % P,
                              st["button"]),
        "stacks": stacks, "contrib": contrib,
        "hole0": torch.where(redeal[None], new_cards[:P], st["hole0"]),
        "hole1": torch.where(redeal[None], new_cards[P:2 * P], st["hole1"]),
        "board": torch.where(redeal[None], new_cards[2 * P:], st["board"]),
        "hand_start": hand_start, "delta_sum": delta_sum,
        "seat_delta": seat_delta, "lvl": lvl, "ln": ln,
        "pot_amt": torch.where(ended[None, None], 0, pots_amt)
        .reshape(4 * n_lvl, T),
        "pot_set": torch.where(ended[None, None], 0, pots_set)
        .reshape(4 * n_lvl, T),
    })
    return {**st, **out}


def _policy(st, u, amt_bits, P):
    """random_policy on explicit words (int64 in [0, 2^32))."""
    amt = (amt_bits % MAX_RAISE).to(I32) + 1
    head, _, _ = _head_info(st, P)
    owes = (st["lvl"].amax(0) - _pick(st["contrib"], head)) > 0
    can_raise = st["street_raises"] < MAX_RAISES_PER_STREET
    is_fold = u < FOLD_P_BITS
    is_raise = (u < RAISE_P_BITS) & ~is_fold & can_raise
    return torch.where(is_fold, torch.where(owes, -1, 0).to(I32),
                       torch.where(is_raise, amt, 0).to(I32))


def _stash_rows(cards):
    """[n_blocks, hmax, 2P+5, 8, 128] deals -> [hmax, 2P+5, T]."""
    hmax, nc = cards.shape[1], cards.shape[2]
    return cards.permute(1, 2, 0, 3, 4).reshape(hmax, nc, -1)


def _stash_deal(stash, hand_ct):
    """Each table's next deal from the stash: row min(hand_ct + 1,
    hmax - 1), [2P+5, T]."""
    hmax, nc, T = stash.shape
    hand_ptr = torch.clamp(hand_ct + 1, max=hmax - 1)
    return stash.gather(0, hand_ptr.long().view(1, 1, T)
                        .expand(1, nc, T))[0]


# Whether plain_loop replays a CUDA graph on the card (the card tests set
# it false to hold the replay against the eager loop).
_GRAPH_ON_CARD = True


def replays(st, n) -> bool:
    """Whether ``plain_loop`` replays a graph for ``n`` steps on the fields
    ``st``: on the card, past one step."""
    return _GRAPH_ON_CARD and n > 1 and next(iter(st.values())).is_cuda


def plain_loop(st, step, inputs_of, n):
    """``n`` applications of ``st = step(st, *inputs_of(i))`` on the fields
    ``st`` (a dict of tensors): the loop of the plain versions. Where
    ``replays``, step 0 runs eagerly (the warm-up) and steps 1 .. n-1 are
    replayed from a CUDA graph of one step, captured on static copies of
    the fields and of the step's inputs (which are copied in before each
    replay): the same kernels on the same inputs, with no host work between
    them, so ``step`` must then read nothing from the host."""
    if not replays(st, n):
        for i in range(n):
            st = step(st, *inputs_of(i))
        return st
    st = step(st, *inputs_of(0))
    st = {k: x.clone() for k, x in st.items()}
    inputs = tuple(x.clone() for x in inputs_of(1))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        new = step(st, *inputs)
        new = {k: new[k].clone() for k in st}
        for k, x in st.items():
            x.copy_(new[k])
    for i in range(1, n):
        for buf, x in zip(inputs, inputs_of(i)):
            buf.copy_(x)
        graph.replay()
    torch.cuda.synchronize()
    del graph, new
    return st


def _run_det_plain(state, actions, cards, P, n_steps, sb, bb,
                   rules="reference"):
    """Plain version of K3: ``n_steps`` fused steps on injected raw
    actions [n_blocks, n_steps, 8, 128] and deals [n_blocks, hmax, 2P+5,
    8, 128] (hand h > 0 reads stash row min(h, hmax - 1))."""
    layout, F = _field_layout(P, rules)
    st = _unpack(_to_rows(state), layout)
    T = st["stage"].shape[0]
    acts = actions.permute(1, 0, 2, 3).reshape(actions.shape[1], T)
    stash = _stash_rows(cards)

    def step(st, act):
        deal = _stash_deal(stash, st["hand_ct"])
        st = _step_nosettle(st, act, P, rules)
        return _settle_pass(st, deal, P, sb, bb, rules)

    st = plain_loop(st, step, lambda i: (acts[i],), n_steps)
    return _to_blocks(_pack(st, layout))


# K3's warp (``csrc/engine.cuh``, ``mc_run_det``): WARP consecutive tables,
# which settle together once DET_SETTLE_MIN of them wait (engine.cuh's
# MC_DET_SETTLE_MIN) or none can step.
WARP = 32
DET_SETTLE_MIN = 16


def _where_fields(mask, new, old):
    """Each field of ``new`` on the tables where ``mask`` holds, else of
    ``old``."""
    return {k: torch.where(mask, new[k], x) for k, x in old.items()}


def _run_det_warps(state, actions, cards, P, n_steps, sb, bb,
                   rules="reference"):
    """K3's schedule in plain PyTorch: ``_run_det_plain``'s work, in the
    order in which K3's warps do it. Each table steps on its own cursor
    until its hand ends, then waits; a warp of ``WARP`` tables runs one
    settle pass for all its waiting tables once ``DET_SETTLE_MIN`` of them
    wait or none can step. A frozen table neither steps nor waits.

    Returns the state (``_run_det_plain``'s: a table's result does not
    depend on when its settle pass runs) and the counts, summed over the
    ``warps``: ``iterations`` (passes of a warp's loop in which a table
    steps), ``settle_passes``, and ``plain_settle_steps``, the steps on
    which a table of the warp settles under the plain schedule's settle
    check after every step."""
    layout, _ = _field_layout(P, rules)
    st = _unpack(_to_rows(state), layout)
    T = st["stage"].shape[0]
    W = T // WARP
    acts = actions.permute(1, 0, 2, 3).reshape(n_steps, T)
    stash = _stash_rows(cards)
    dev = acts.device
    warp_of = torch.arange(T, device=dev) // WARP
    cursor = torch.zeros(T, dtype=I64, device=dev)
    due = torch.zeros(T, dtype=torch.bool, device=dev)
    plain_steps = torch.zeros((n_steps, W), dtype=torch.bool, device=dev)
    counts = {"warps": W, "iterations": 0, "settle_passes": 0}

    def can_step(st):
        frozen = (st["order"] == 0) & (st["wait"] == 0)
        return ~due & (cursor < n_steps) & ~frozen

    while True:
        step = can_step(st)
        if bool(step.any()):
            i = cursor.clamp(max=n_steps - 1)
            new = _step_nosettle(st, acts.gather(0, i[None])[0], P, rules)
            st = _where_fields(step, new, st)
            ended = step & (st["wait"] != 0)
            plain_steps[i[ended], warp_of[ended]] = True
            cursor = cursor + step
            due = due | ended
        counts["iterations"] += int(step.view(W, WARP).any(1).sum())
        waiting = due.view(W, WARP)
        stepping = can_step(st).view(W, WARP).any(1)
        if not bool(waiting.any() | stepping.any()):
            break
        settles = waiting.any(1) & (~stepping | (waiting.sum(1)
                                                 >= DET_SETTLE_MIN))
        settle = (waiting & settles[:, None]).reshape(T)
        if bool(settle.any()):
            new = _settle_pass(st, _stash_deal(stash, st["hand_ct"]), P, sb,
                               bb, rules)
            st = _where_fields(settle, new, st)
            due = due & ~settle
            counts["settle_passes"] += int(settles.sum())
    counts["plain_settle_steps"] = int(plain_steps.sum())
    return _to_blocks(_pack(st, layout)), counts


def _defer_for(n_steps: int) -> int:
    return DEFER if n_steps % DEFER == 0 else 1


def prng_words_shape(n_tables: int, P: int, n_steps: int):
    """Shape of K4's words: [n_steps / defer, 2 * defer + 2P + 5, n_tables]
    — per table and iteration, (u, amt_bits) per betting slot, then the
    2P+5 deal words. (K6 adds four Gumbel words per slot:
    ``cuda_net.net_words_shape``.)"""
    defer = _defer_for(n_steps)
    return (n_steps // defer, 2 * defer + 2 * P + 5, n_tables)


def prng_words(seed: int, n_tables: int, P: int, n_steps: int, it: int,
               device):
    """K4's Philox words for iteration ``it`` of an ``n_steps`` launch:
    int64 [2 * defer + 2P + 5, n_tables], row ``it`` of
    ``prng_words_shape``. Table t draws from stream (seed, t, 0, 0)."""
    W = prng_words_shape(n_tables, P, n_steps)[1]
    return table_words(seed, n_tables, it * W, W, device)


def table_words(seed: int, n_tables: int, start: int, n: int, device):
    """Words ``start .. start + n - 1`` of every table's stream (seed, t,
    0, 0): int64 [n, n_tables]."""
    t = torch.arange(n_tables, dtype=I64, device=device)
    return stream_words(seed, t, 0, 0, start, n)


def _prng_plain(state, words_of, P, n_steps, sb, bb, rules="reference",
                ss=100, reset_stacks=False):
    """K4's iterations on the words ``words_of(it)`` of each iteration
    (``reset_stacks``: the settle option of the net-eval kernel, for the
    tests)."""
    layout, F = _field_layout(P, rules)
    st = _unpack(_to_rows(state), layout)
    defer = _defer_for(n_steps)

    def iteration(st, words):
        for k in range(defer):
            raw = _policy(st, words[2 * k], words[2 * k + 1], P)
            st = _step_nosettle(st, raw, P, rules)
        deal = torch.stack(_sample_cards(words[2 * defer:], []))
        return _settle_pass(st, deal, P, sb, bb, rules, ss, reset_stacks)

    st = plain_loop(st, iteration, lambda it: (words_of(it),),
                    n_steps // defer)
    return _to_blocks(_pack(st, layout))


def _run_prng_plain(state, words, P, n_steps, sb, bb, rules="reference",
                    **settle):
    """Plain version of K4 on explicit words (int64 in [0, 2^32), shape
    ``prng_words_shape``)."""
    return _prng_plain(state, lambda it: words[it], P, n_steps, sb, bb,
                       rules, **settle)


def _run_prng_plain_philox(seed, state, P, n_steps, sb, bb,
                           rules="reference"):
    """Plain version of K4's Philox mode on the state's device: the state
    the kernel returns for ``seed``."""
    T = state.shape[0] * TABLES_PER_BLOCK
    return _prng_plain(state, lambda it: prng_words(
        seed, T, P, n_steps, it, state.device), P, n_steps, sb, bb, rules)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_state(state, P, rules):
    _, F = _field_layout(P, rules)
    if state.dim() != 4 or tuple(state.shape[1:]) != (F, *TILE) \
            or state.dtype != I32:
        raise ValueError(f"state must be int32 [n_blocks, {F}, 8, 128], got "
                         f"{state.dtype} {tuple(state.shape)}")
    if state.shape[0] * TABLES_PER_BLOCK >= 1 << 31:
        raise ValueError(f"{state.shape[0]} blocks: the kernels index "
                         f"tables with int32")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {state.device}")


def _check_stash(cards, state, P):
    nb = state.shape[0]
    if cards.dim() != 5 or cards.shape[0] != nb or cards.shape[1] < 1 \
            or tuple(cards.shape[2:]) != (2 * P + 5, *TILE) \
            or cards.device != state.device:
        raise ValueError(f"cards must be [{nb}, hmax, {2 * P + 5}, 8, 128] "
                         f"on {state.device}")


def run_perpetual_det(state, actions, cards, P: int, n_steps: int, sb: int,
                      bb: int, rules: str = "reference"):
    """K3: ``n_steps`` fused ``step_table`` steps on injected raw actions
    [n_blocks, n_steps, 8, 128] and per-hand deals [n_blocks, hmax, 2P+5,
    8, 128] (hand 0 already dealt into ``state``). Returns the new state."""
    _check_config(P, rules)
    _check_state(state, P, rules)
    _check_stash(cards, state, P)
    nb = state.shape[0]
    if tuple(actions.shape) != (nb, n_steps, *TILE) \
            or actions.device != state.device:
        raise ValueError("actions do not match the state")
    if state.device.type == "cpu":
        return _run_det_plain(state, actions.to(I32), cards.to(I32), P,
                              n_steps, sb, bb, rules)
    lib = _build.library(P)
    out = state.clone()
    act = actions.to(I32).contiguous()
    crd = cards.to(I32).contiguous()
    _build.check(lib.mc_engine_det(
        out.data_ptr(), act.data_ptr(), crd.data_ptr(), nb, P,
        RULES.index(rules), n_steps, cards.shape[1], sb, bb,
        _build.stream_ptr(state.device)), "mc_engine_det")
    LAUNCHES[f"engine_det_{rules}"] += 1
    return out


def run_perpetual_prng(seed: int, state, P: int, n_steps: int, sb: int,
                       bb: int, rules: str = "reference", words=None):
    """K4: ``n_steps`` betting slots of random-policy play with deferred
    settlement. Words come from Philox keyed by (``seed``, table), the
    same on the CPU and on the card, or from ``words`` (int64 in
    [0, 2^32), shape ``prng_words_shape``)."""
    with span(f"launch.engine_prng_{rules}"):
        _check_config(P, rules)
        _check_state(state, P, rules)
        nb = state.shape[0]
        shape = prng_words_shape(nb * TABLES_PER_BLOCK, P, n_steps)
        if words is not None and (tuple(words.shape) != shape
                                  or words.device != state.device):
            raise ValueError(f"words must be {shape} on {state.device}")
        if state.device.type == "cpu":
            if words is None:
                return _run_prng_plain_philox(seed, state, P, n_steps, sb, bb,
                                              rules)
            return _run_prng_plain(state, words, P, n_steps, sb, bb, rules)
        lib = _build.library(P)
        out = state.clone()
        w32 = None if words is None else words_as_i32(words).contiguous()
        _build.check(lib.mc_engine_prng(
            out.data_ptr(), int(seed), None if w32 is None else w32.data_ptr(),
            nb, P, RULES.index(rules), n_steps, _defer_for(n_steps), sb, bb,
            FOLD_P_BITS, RAISE_P_BITS, _build.stream_ptr(state.device)),
            "mc_engine_prng")
        LAUNCHES[f"engine_prng_{rules}"] += 1
        return out


def first_deal(seed: int, n_tables: int, P: int, device=None,
               first_table: int = 0):
    """[n_tables, 2P+5] distinct cards per table on ``device`` (the card
    when None) for tables ``first_table`` .. ``first_table + n_tables -
    1``: table t's are drawn like an in-kernel deal from Philox stream
    (seed, t, 0, 1), which no kernel draws from, so every device deals
    the same cards."""
    with span("first_deal"):
        t = torch.arange(first_table, first_table + n_tables, dtype=I64,
                         device=resolve(device))
        with span("first_deal.words"):
            words = stream_words(seed, t, 0, 1, 0, 2 * P + 5)
        with span("first_deal.cards"):
            return torch.stack(_sample_cards(words, []), dim=1)


def first_state(seed: int, cfg, n_tables: int, device=None,
                first_table: int = 0) -> torch.Tensor:
    """A request's first packed state on ``device`` (the card when None):
    ``pack_state(cfg, first_deal(seed, n_tables, P, device,
    first_table))``. On the CPU it is that call; on the card one launch of
    ``mc_first_state_kernel`` (``csrc/engine.cu``) writes the same rows,
    bit for bit, under the span ``first_deal``. Table indices
    ``first_table .. first_table + n_tables - 1`` must lie in [0, 2^32),
    where ``first_deal``'s streams are."""
    dev = resolve(device)
    if first_table < 0 or first_table + n_tables > 1 << 32:
        raise ValueError(f"tables {first_table} .. {first_table + n_tables}"
                         f" - 1: outside [0, 2^32)")
    if dev.type != "cuda":
        return pack_state(cfg, first_deal(seed, n_tables, cfg.num_seats,
                                          dev, first_table))
    with span("first_deal"):
        P, rules = cfg.num_seats, cfg.rules
        _check_first_hand(cfg)
        _check_tables(n_tables)
        nb = n_tables // TABLES_PER_BLOCK
        state = torch.empty((nb, _field_layout(P, rules)[1], *TILE),
                            dtype=I32, device=dev)
        _build.check(_build.library(P).mc_first_state(
            state.data_ptr(), int(seed) & MASK, first_table, nb, P,
            RULES.index(rules), cfg.small_blind, cfg.big_blind,
            cfg.starting_stack, _build.stream_ptr(dev)), "mc_first_state")
        LAUNCHES[f"first_state_{rules}"] += 1
        return state


def selfplay_perpetual_kernel(seed: int, cfg, n_tables: int, n_steps: int,
                              steps_per_launch: int = 512, device=None):
    """Random-policy perpetual self-play on ``device`` (the card when
    None), under any rule set: the first hand dealt from a seeded
    generator (``first_state``), every later deal and policy draw in the
    kernel.

    Returns ``(final_packed_state, hands_completed, overflowed_tables)``.
    """
    state = first_state(seed, cfg, n_tables, device)
    done = 0
    while done < n_steps:
        chunk = min(steps_per_launch, n_steps - done)
        state = run_perpetual_prng((seed + done * 7919) & 0x7FFFFFFF, state,
                                   cfg.num_seats, chunk, cfg.small_blind,
                                   cfg.big_blind, rules=cfg.rules)
        done += chunk
    with span("selfplay.read"):
        hands = int(unpack_field(state, cfg, "hand_ct").sum())
        ovf = int(unpack_field(state, cfg, "overflow").sum())
    return state, hands, ovf


def position_deltas(state, cfg):
    """Accumulated settled chip change per hand-order position (position
    0 = each hand's small blind): (sums float64 [P], hands). Mean bb/hand
    per position = sums / hands / big_blind."""
    P = cfg.num_seats
    sums = np.array([float(unpack_field(state, cfg, "delta_sum", k)
                           .sum(dtype=I64)) for k in range(P)])
    hands = int(unpack_field(state, cfg, "hand_ct").sum())
    return sums, hands


def tournaments_to_completion(seed: int, cfg, n_tables: int,
                              steps_per_launch: int = 512,
                              max_steps: int = 1 << 17, device=None):
    """Tournament-rules tables on ``device`` (the card when None), K4
    relaunched until every table has frozen (one player holds every chip):
    total placements, no unfinished tail.

    The first deal comes from ``first_state`` (Philox, so a seed does not
    reproduce a JAX run); launch seeds are (seed + steps done * 7919) &
    0x7FFFFFFF. Frozen tables are no-ops inside the kernel. Between
    launches the frozen count (``order == 0``, which only a launch boundary
    makes exact: a table waiting for its settle pass has an empty play
    order too) is summed on the device and read once. Returns ``(state,
    steps_used)``; raises ``RuntimeError`` when ``max_steps`` runs out with
    live tables."""
    if cfg.rules != "tournament":
        raise ValueError(f"rules={cfg.rules!r}: expected 'tournament'")
    state = first_state(seed, cfg, n_tables, device)
    return run_to_completion(seed, state, cfg, steps_per_launch, max_steps)


def run_to_completion(seed: int, state, cfg, steps_per_launch: int = 512,
                      max_steps: int = 1 << 17):
    """The loop of ``tournaments_to_completion`` on a given packed
    tournament state (on its device): K4 relaunched with launch seeds
    (seed + steps done * 7919) & 0x7FFFFFFF until every table has frozen.
    Returns ``(state, steps_used)``; raises ``RuntimeError`` when
    ``max_steps`` runs out with live tables."""
    if cfg.rules != "tournament":
        raise ValueError(f"rules={cfg.rules!r}: expected 'tournament'")
    P = cfg.num_seats
    n_tables = state.shape[0] * TABLES_PER_BLOCK
    done = 0
    while done < max_steps:
        state = run_perpetual_prng((seed + done * 7919) & 0x7FFFFFFF, state,
                                   P, steps_per_launch, cfg.small_blind,
                                   cfg.big_blind, rules=cfg.rules)
        done += steps_per_launch
        frozen = int((unpack_field(state, cfg, "order") == 0).sum())
        if frozen == n_tables:
            return state, done
    raise RuntimeError(
        f"{n_tables - frozen} tournaments still live after {done} steps")


def tournament_results(state, cfg):
    """Finishing places per seat (1 = winner) from the bust records and
    the final stacks (``pallas_engine.tournament_results``): unbusted seats
    outrank busted ones, later busts beat earlier, and ties (the same bust
    hand, the same stack) share by stable order. Returns numpy
    ``(places [n_tables, P], frozen [n_tables] bool)``."""
    if cfg.rules != "tournament":
        raise ValueError(f"rules={cfg.rules!r}: expected 'tournament'")
    P = cfg.num_seats
    layout, _ = _field_layout(P, cfg.rules)
    names = ("bust_at", "button", "stacks", "order")
    # only these rows go to the host
    picked = [layout[n][0] + k for n in names for k in range(layout[n][1])]
    rows = state_to_numpy(_to_rows(state.index_select(1, torch.tensor(
        picked, device=state.device)))).astype(np.int64)
    starts = np.cumsum([0] + [layout[n][1] for n in names])

    def field(name):
        i = names.index(name)
        return rows[starts[i]:starts[i + 1]]

    bust = field("bust_at").T                                  # [T, P]
    button = field("button")[0]
    # positional stacks -> seat view via the button
    idx = (np.arange(P)[None, :] - button[:, None]) % P
    stacks = np.take_along_axis(field("stacks").T, idx, axis=1)
    frozen = field("order")[0] == 0
    alive_rank = np.where(bust < 0, np.iinfo(np.int32).max, bust)
    key = alive_rank * (stacks.max() + 2) + stacks
    places = np.argsort(np.argsort(-key, axis=1, kind="stable"),
                        axis=1, kind="stable") + 1
    return places, frozen
