"""Plain reference of the table engine: perpetual P-seat hold'em tables,
played by the random policy or by policy nets.

A frozen copy of the semantics of the port's engine kernels, on a dict of
``[rows, T]`` int32 tensors (tables on the last axis), one row set per
field of ``layout``. A table's play depends on its own state and its own
words alone, so the reference replays any sample of a launch's tables by
their indices.

- The first hand: table t's 2P + 5 cards come from Philox stream (seed, t,
  0, 1): holes round-robin from the small blind, then the board; blinds
  posted (``first_state``).
- A launch of ``n`` slots with launch seed s: table t reads stream (s, t,
  0, 0) in iterations of ``DEFER`` slots (of one slot where ``n`` is not a
  multiple of it). Per slot the random policy's two words (and, with nets,
  four Gumbel words), then the 2P + 5 words of the next deal. After its
  slots an iteration settles every ended hand, rotates the button and
  deals the next hand (``settle``).
- Launch seeds of a request with seed s: (s + done * 7919) & 0x7FFFFFFF
  for the slots done before the launch.
- Rules: "reference" (the reference server: calls pay the full amount owed,
  odd chips vanish), "standard" (no-limit: payments capped at the stack,
  side pots, odd chips to the first winner in position) and "tournament"
  (standard, busted seats leave, a table with one player left freezes).
- The net's decision: 24 features of the acting seat, the MLP 24-64-64-4
  with ReLU, each product and sum in the order of the port's kernel
  (the bias, then input by input), fold masked when nothing is owed, a
  Gumbel-argmax pick, and the menu fold / call / 2bb / max(pot + owed,
  2bb). ``mlp="bf16"`` (the control) rounds each product's inputs to
  bfloat16.
"""

from __future__ import annotations

import torch

from mcref.cards import (
    CAT_SHIFT,
    I32,
    I64,
    draw_cards,
    eval_masks,
    eval_masks_cmp,
    stream_words,
    suit_masks,
)

F32 = torch.float32
DEFER = 16
FOLD_P_BITS = int(0.15 * 2**32)
RAISE_P_BITS = int((0.15 + 0.30) * 2**32)
MAX_RAISE = 20
MAX_RAISES_PER_STREET = 2
FOLD_MASK = -1e9
NUM_ACTIONS = 4
NET_SLOT_WORDS = 6


def layout(P: int, rules: str):
    """Field -> (first row, rows) of a table's packed state, and the
    number of rows."""
    n_lvl = 6 if rules == "reference" else 10
    fields = [
        ("stage", 1), ("cursor", 1), ("street_raises", 1),
        ("last_raiser", 1), ("folded", 1), ("in_hand", 1), ("to_act", 1),
        ("order", 1), ("wait", 1), ("hand_ct", 1), ("overflow", 1),
        ("button", 1),
        ("stacks", P), ("contrib", P), ("hole0", P), ("hole1", P),
        ("hand_start", P), ("delta_sum", P), ("seat_delta", P),
        ("board", 5), ("lvl", n_lvl), ("ln", n_lvl),
        ("pot_amt", 4 * n_lvl), ("pot_set", 4 * n_lvl),
    ]
    fields.append(("pot_n", 4 * n_lvl) if rules == "reference"
                  else ("all_in", 1))
    if rules == "tournament":
        fields.append(("bust_at", P))
    out, off = {}, 0
    for name, rows in fields:
        out[name] = (off, rows)
        off += rows
    return out, off


def unpack(rows, lay):
    return {name: rows[off] if n == 1 else rows[off:off + n]
            for name, (off, n) in lay.items()}


def pack(st, lay):
    return torch.cat([st[name][None] if n == 1 else st[name]
                      for name, (off, n) in lay.items()], dim=0)


def _iota(n, device):
    return torch.arange(n, dtype=I32, device=device).view(n, 1)


def _pick(stacked, idx):
    one_hot = _iota(stacked.shape[0], stacked.device) == idx[None]
    return torch.where(one_hot, stacked, 0).sum(0, dtype=I32)


def _shift_down(x):
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def _mask_bits(bm, P):
    return (bm[None] >> _iota(P, bm.device)) & 1


def first_state(seed: int, tables, P: int, rules: str, sb: int, bb: int,
                ss: int):
    """Rows [F, len(tables)] of the first hand of tables ``tables`` (an
    int64 tensor of table indices on the device to use)."""
    lay, F = layout(P, rules)
    words = stream_words(seed, tables, 0, 1, 0, 2 * P + 5)
    fc = torch.stack(draw_cards(words, []), dim=1)        # [k, 2P+5]
    rows = torch.zeros((F, fc.shape[0]), dtype=I32, device=fc.device)

    def put(name, i, val):
        rows[lay[name][0] + i] = val

    if rules != "reference":
        sb, bb = min(sb, max(ss, 0)), min(bb, max(ss, 0))
    full = (1 << P) - 1
    put("cursor", 0, 2 % P)
    put("last_raiser", 0, P)
    put("in_hand", 0, full)
    all_in = 0
    for k in range(P):
        blind = sb if k == 0 else (bb if k == 1 else 0)
        put("stacks", k, ss - blind)
        put("hand_start", k, ss)
        all_in |= (ss - blind <= 0) << k
    if rules != "reference":
        put("all_in", 0, all_in)
    else:
        all_in = 0
    if rules == "tournament":
        for k in range(P):
            put("bust_at", k, -1)
    put("to_act", 0, full & ~all_in)
    put("order", 0, full & ~all_in)
    for k in range(P):
        put("hole0", k, fc[:, k])
        put("hole1", k, fc[:, P + k])
    lo, hi = min(sb, bb), max(sb, bb)
    put("lvl", 0, lo)
    put("ln", 0, 2)
    if lo != hi:
        put("lvl", 1, hi)
        put("ln", 1, 1)
    put("contrib", 0, sb)
    put("contrib", 1, bb)
    for i in range(5):
        put("board", i, fc[:, 2 * P + i])
    return rows


# ---------------------------------------------------------------------------
# Betting
# ---------------------------------------------------------------------------

def head_info(st, P):
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
    sel = (rank[None] == _iota(n_rows, lvl.device)[:, None]) & keep[None]
    out_lvl = torch.where(sel, lvl[None], 0).sum(1, dtype=I32)
    out_ln = torch.where(sel, ln[None], 0).sum(1, dtype=I32)
    return (torch.where(do[None], out_lvl, lvl),
            torch.where(do[None], out_ln, ln))


def bet(st, raw_action, P, rules):
    """One betting slot: the acting seat's raw action (-1 fold, 0
    check/call, r > 0 raise by r) applied, the street flushed into the pot
    when it closes, the stage advanced; a hand that ends waits (an empty
    play order) for the next settlement. A table with an empty play order
    is unchanged."""
    reference = rules == "reference"
    n_lvl = st["lvl"].shape[0]
    T = st["stage"].shape[0]
    dev = st["stage"].device
    zero = torch.zeros_like(st["stage"])
    head, cursor_after, exists = head_info(st, P)
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
        amount = torch.where(is_raise, r + total, total)
        paid = torch.where(threads, torch.where(is_raise, delta + r, delta),
                           0)
    else:
        pay_call = torch.minimum(delta, stack_head)
        pay_raise = torch.minimum(delta + r, stack_head)
        amount = torch.where(is_raise, r + total - (delta + r - pay_raise),
                             total - (delta - pay_call))
        paid = torch.where(threads, torch.where(is_raise, pay_raise,
                                                pay_call), 0)

    up_lvl, up_ln, ovf = _street_update(st["lvl"], st["ln"], amount, threads)
    do_merge = is_fold | is_check
    mg_lvl, mg_ln = _street_merge(st["lvl"], st["ln"], st["contrib"],
                                  do_merge)
    lvl = torch.where(do_merge[None], mg_lvl, up_lvl)
    ln = torch.where(do_merge[None], mg_ln, up_ln)
    contrib = torch.where(head_onehot & threads[None],
                          torch.maximum(st["contrib"], amount[None]),
                          st["contrib"])
    stacks = st["stacks"] - torch.where(head_onehot, paid[None], 0)

    went_all_in = threads & (paid == stack_head)
    fold_bit = torch.where(is_fold, head_bit, 0)
    if reference:
        in_hand = st["in_hand"] & ~torch.where(is_fold | went_all_in,
                                               head_bit, 0)
        actable = in_hand
        order = st["order"] & ~fold_bit
    else:
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

    flush = (to_act == 0) | (n_in <= 1)
    live = lvl > 0
    row_amt = lvl - _shift_down(lvl)
    ge = (contrib[None] >= lvl[:, None]) & live[:, None]
    if reference:
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
    guarded = {name: torch.where(exists if v.dim() == 1 else exists[None],
                                 v, st[name])
               for name, v in out.items()}
    return {**st, **guarded}


# ---------------------------------------------------------------------------
# Settlement
# ---------------------------------------------------------------------------

def _seat_view(pos, button, P):
    out = torch.where(button[None] == 0, pos, 0)
    for b in range(1, P):
        out = out + torch.where(button[None] == b, torch.roll(pos, b, dims=0),
                                0)
    return out


def _payout(st, pots_amt, pots_set, pots_n, in_hand, P, odd_chips=True):
    """Showdown payout per seat position [P, T]; ``odd_chips=False`` (the
    control) drops the standard rules' odd chips."""
    bm = suit_masks(st["board"].T)
    holes = torch.stack([st["hole0"], st["hole1"]], dim=-1)
    hm = suit_masks(holes)
    values = eval_masks_cmp(*[b[None] | h for b, h in zip(bm, hm)])
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
    if pots_n is None and odd_chips:
        rem = torch.where(cnt > 0, total_pot % div, 0)
        first = torch.where(winners, seats, P).amin(2)
        pay = pay + torch.where(seats == first[:, :, None], rem[:, :, None],
                                0)
    return pay.sum((0, 1), dtype=I32)


def settle(st, new_cards, P, sb, bb, rules, ss, reset_stacks,
           odd_chips=True):
    """Settlement and the next hand of every table whose ``wait`` is up;
    ``new_cards`` [2P + 5, T]. ``reset_stacks``: every hand from ``ss``
    chips a seat (the net evaluation's independent hands)."""
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

    pay = _payout(st, pots_amt, pots_set, pots_n, st["in_hand"], P,
                  odd_chips)
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
        newly = (ended[None] & (_seat_view(stacks, st["button"], P) <= 0)
                 & (st["bust_at"] < 0))
        out["bust_at"] = torch.where(newly, st["hand_ct"][None],
                                     st["bust_at"])
        alive_pos = stacks > 0
        n_alive = alive_pos.sum(0, dtype=I32)
        shift = torch.where(alive_pos & (seats >= 1), seats, P).amin(0) \
            .clamp(1, P - 1)
        rot = stacks
        for b in range(1, P):
            rot = torch.where(shift[None] == b,
                              torch.roll(stacks, -b, dims=0), rot)
        freeze = ended & (n_alive <= 1)
        redeal = ended & ~freeze
        button_shift = shift
    else:
        rot = torch.roll(stacks, -1, dims=0)
        freeze = torch.zeros_like(ended)
        redeal = ended
        button_shift = 1

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
            alive_new = rot > 0
            in_hand_new = torch.where(alive_new, seat_bits, 0).sum(
                0, dtype=I32)
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
        dead_bm = torch.where(new_stacks <= 0, seat_bits, 0).sum(0,
                                                                 dtype=I32)
        allin_bm = dead_bm & in_hand_new
        out["all_in"] = torch.where(redeal, allin_bm, st["all_in"])
        to_act_new = in_hand_new & ~allin_bm
    to_act = torch.where(redeal, to_act_new, st["to_act"])
    order = torch.where(redeal, to_act_new, st["order"])
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


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def random_action(st, u, amt_bits, P):
    """The random policy on two words: fold 15% when owing (else check),
    raise 1..20 chips 30% while the street has under two raises, else
    call."""
    amt = (amt_bits % MAX_RAISE).to(I32) + 1
    head, _, _ = head_info(st, P)
    owes = (st["lvl"].amax(0) - _pick(st["contrib"], head)) > 0
    can_raise = st["street_raises"] < MAX_RAISES_PER_STREET
    is_fold = u < FOLD_P_BITS
    is_raise = (u < RAISE_P_BITS) & ~is_fold & can_raise
    return torch.where(is_fold, torch.where(owes, -1, 0).to(I32),
                       torch.where(is_raise, amt, 0).to(I32))


def _div(x, d):
    """float32 x / d, correctly rounded on every device."""
    return x / torch.full((), float(d), dtype=F32, device=x.device)


def _masked_suit_masks(cards, valids):
    masks = [torch.zeros_like(cards[0]) for _ in range(4)]
    for card, valid in zip(cards, valids):
        suit = card // 13
        bit = torch.where(valid, torch.ones_like(card) << (card - 13 * suit
                                                           + 2), 0)
        masks = [m | torch.where(suit == s, bit, 0)
                 for s, m in enumerate(masks)]
    return masks


def features(st, head, P, bb):
    """The 24 features of the acting seat, float32 [24, T]."""
    total = st["lvl"].amax(0)
    pot = total + st["pot_amt"].sum(0, dtype=I32)
    needed = total - _pick(st["contrib"], head)
    stack = _pick(st["stacks"], head)
    stage = st["stage"]
    n_comm = torch.where(stage == 0, 0, torch.where(
        stage == 1, 3, torch.where(stage == 2, 4, 5))).to(I32)
    hole0 = _pick(st["hole0"], head)
    hole1 = _pick(st["hole1"], head)
    true_ = torch.ones_like(stage, dtype=torch.bool)
    valids = [true_, true_] + [i < n_comm for i in range(5)]
    key = eval_masks(*_masked_suit_masks(
        [hole0, hole1] + [st["board"][i] for i in range(5)], valids))
    category = _div((key >> CAT_SHIFT).to(F32), 8.0)
    top_rank = _div(((key >> 16) & 0xF).to(F32), 14.0)
    r0 = _div((2 + hole0 % 13).to(F32), 14.0)
    r1 = _div((2 + hole1 % 13).to(F32), 14.0)
    suited = ((hole0 // 13) == (hole1 // 13)).to(F32)
    paired = (hole0 % 13 == hole1 % 13).to(F32)
    n_in = _mask_bits(st["in_hand"], P).sum(0, dtype=I32)
    n_act = _mask_bits(st["to_act"], P).sum(0, dtype=I32)
    pot_f = pot.to(F32)
    needed_f = needed.to(F32)
    one = torch.ones_like(pot_f)
    sr = st["street_raises"]
    has_aggr = sr > 0
    rel_raiser = torch.where(
        has_aggr, _div(((st["last_raiser"] - head) % P).to(F32), P), 0.0)
    return torch.stack([
        (stage == 0).to(F32), (stage == 1).to(F32),
        (stage == 2).to(F32), (stage == 3).to(F32),
        _div(n_comm.to(F32), 5.0),
        _div(pot_f, 100.0 * P),
        _div(needed_f, 100.0),
        _div(stack.to(F32), 100.0),
        (needed == 0).to(F32),
        _div(n_in.to(F32), P),
        _div(n_act.to(F32), P),
        _div(head.to(F32), P),
        pot_f / torch.maximum(needed_f + pot_f, one),
        _div(_div(needed_f, bb), 10.0),
        category, top_rank, r0, r1, suited, paired,
        _div(sr.to(F32), 4.0),
        has_aggr.to(F32),
        rel_raiser,
        (sr >= 2).to(F32),
    ])


def mlp_logits(x, net, mlp="f32"):
    """Logits [4, T] of features [24, T] through one net's six float32
    arrays (w1 [24, 64], b1, w2 [64, 64], b2, w3 [64, 4], b3): each dense
    layer the bias, then each input's product added in input order."""
    def q(t):
        return t.to(torch.bfloat16).to(F32) if mlp == "bf16" else t

    def dense(h, w, b):
        acc = b[:, None].expand(w.shape[1], h.shape[1])
        hq, wq = q(h), q(w)
        for i in range(w.shape[0]):
            acc = acc + hq[i][None] * wq[i][:, None]
        return acc

    w1, b1, w2, b2, w3, b3 = net
    h = torch.relu(dense(x, w1, b1))
    h = torch.relu(dense(h, w2, b2))
    return dense(h, w3, b3)


def net_action(st, P, bb, nets, banks, bits, mlp="f32"):
    """The acting seat's net's raw action per table (Gumbel pick on four
    words ``bits``); ``banks``: int64 [P], each seat's net."""
    head, _, _ = head_info(st, P)
    seat = (st["button"] + head) % P
    bank = banks[seat.long()]
    x = features(st, head, P, bb)
    logits = mlp_logits(x, nets[0], mlp)
    for b in range(1, len(nets)):
        logits = torch.where(bank[None] == b, mlp_logits(x, nets[b], mlp),
                             logits)
    total = st["lvl"].amax(0)
    needed = total - _pick(st["contrib"], head)
    logits = torch.cat([logits[:1] + torch.where(needed == 0, FOLD_MASK,
                                                 0.0).to(F32)[None],
                        logits[1:]])
    u = (bits >> 8).to(F32) * 2.0 ** -24
    z = logits - torch.log(-torch.log(u.clamp(min=1e-12)))
    rows = torch.arange(NUM_ACTIONS, dtype=I32, device=z.device).view(-1, 1)
    idx = torch.where(z == z.amax(0), rows, NUM_ACTIONS).amin(0)
    pot = total + st["pot_amt"].sum(0, dtype=I32)
    small = 2 * bb
    pot_raise = torch.clamp(pot + needed, min=small)
    return torch.where(idx == 0, -1, torch.where(
        idx == 1, 0, torch.where(idx == 2, small, pot_raise))).to(I32)


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------

def launch(st, seed, tables, P, n_slots, rules, sb, bb, ss, nets=None,
           seat_to_bank=None, net_seats=0, reset_stacks=False, mlp="f32",
           odd_chips=True, decisions=None):
    """One launch of ``n_slots`` slots of tables ``tables`` with launch seed
    ``seed``: the random policy, or with ``nets`` the seats in the mask
    ``net_seats`` playing their bank's net. ``decisions``: a list to which
    the launch appends its count of net decisions. Returns the rows."""
    defer = DEFER if n_slots % DEFER == 0 else 1
    per_slot = NET_SLOT_WORDS if nets is not None else 2
    W = per_slot * defer + 2 * P + 5
    dev = tables.device
    banks = None if nets is None else torch.tensor(
        list(seat_to_bank), dtype=I64, device=dev)

    def iteration(st, words):
        st = dict(st)
        n_dec = st.pop("_decisions")
        for k in range(defer):
            w = words[per_slot * k:per_slot * (k + 1)]
            raw = random_action(st, w[0], w[1], P)
            if nets is not None:
                head, _, exists = head_info(st, P)
                seat = (st["button"] + head) % P
                use = ((torch.full_like(seat, net_seats) >> seat) & 1) != 0
                n_dec = n_dec + (use & exists).sum()
                raw = torch.where(use, net_action(
                    st, P, bb, nets, banks, w[2:], mlp), raw)
            st = bet(st, raw, P, rules)
        deal = torch.stack(draw_cards(words[per_slot * defer:], []))
        st = settle(st, deal, P, sb, bb, rules, ss, reset_stacks, odd_chips)
        st["_decisions"] = n_dec
        return st

    st = dict(st, _decisions=torch.zeros((), dtype=I64, device=dev))
    st = replay_loop(st, iteration, lambda it: (
        stream_words(seed, tables, 0, 0, it * W, W),), n_slots // defer)
    n_dec = st.pop("_decisions")
    if decisions is not None:
        decisions.append(int(n_dec))
    return st


def replay_loop(st, step, inputs_of, n):
    """``n`` applications of ``st = step(st, *inputs_of(i))`` on the dict
    of tensors ``st``. On the card, past the first (eager) step, the step is
    captured once as a CUDA graph on static copies of the fields and of its
    inputs, and replayed with each step's inputs copied in: the same
    operations on the same values, without the host's launch cost."""
    if n <= 1 or not next(iter(st.values())).is_cuda:
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
        for k, x in st.items():
            x.copy_(new[k])
    for i in range(1, n):
        for buf, x in zip(inputs, inputs_of(i)):
            buf.copy_(x)
        graph.replay()
    torch.cuda.synchronize()
    del graph, new
    return st


def launch_seeds(seed: int, n_slots: int, per_launch: int):
    """(launch seed, slots) of each launch of a request."""
    out, done = [], 0
    while done < n_slots:
        chunk = min(per_launch, n_slots - done)
        out.append(((seed + done * 7919) & 0x7FFFFFFF, chunk))
        done += chunk
    return out
