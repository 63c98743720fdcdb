"""Table state and hand setup: ``montecarlo_tpu/engine/state.py`` on tables
held on a leading axis.

A ``TableState`` holds ``T`` tables: every field of the JAX state gains a
leading table axis (``hole`` is int32 [T, P, 2], ``stage`` int32 [T], ...).
Per-player arrays are indexed by hand-order **position** (position 0 posts
the small blind); ``seat = (button + position) % P`` only at the host
boundary (``engine/public.py``). The deck is consumed at deal time: hole
cards and the five community cards (with the reference's burn offsets,
``gameplay.clj:30-54``) are materialized, and streets reveal
``n_community`` of them.

The deck. JAX shuffles hand ``h`` with a threefry permutation of
``fold_in(key, h)``, which the port does not reproduce. Here ``key`` is
int64 [T, 2], the seed and the table index, and hand ``h``'s deck is the
stable sort order of 52 Philox4x32-10 words of stream (seed, table, h,
``DECK_SUB``) (``ops/philox.py``): exact, the same on the CPU and on the
card. ``redeal`` injects an explicit deck, which is how the tests hold the
port to the JAX engine.

Rules are a Python string, as the JAX ``static_argnames`` are. The
street is in the form ``TableConfig.bets_impl`` names (``engine/street.py``):
a ``Layers`` for "layers", a ``Street`` for "levels".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Union

import numpy as np
import torch

from montecarlo_tpu_torch.cards import NUM_CARDS
from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.bets import Layers, empty_layers
from montecarlo_tpu_torch.engine.street import (
    Street,
    bets_empty_like,
    bets_thread,
    make_empty_bets,
)
from montecarlo_tpu_torch.ops.philox import MASK, philox4x32_10

I32 = torch.int32
I64 = torch.int64

RULES = ("reference", "standard", "tournament")
# The Philox sub-stream of the decks (ops/philox.py lists those taken).
DECK_SUB = 65540


@dataclass(frozen=True)
class TableConfig:
    """Static table parameters, field for field the JAX ``TableConfig``.

    Defaults mirror the reference: 100-chip starting stacks, 5/10 blinds.
    ``rules`` is "reference", "standard" or "tournament"; the engine
    kernels run all three (the net kernels the first two).
    ``bets_impl`` is the street bet form of the plain engine: "layers"
    (the default) the literal layer algebra of ``bet.clj``
    (``engine/bets.py``), "levels" the minimal boundary/contribution form
    (``engine/street.py``), trajectory-equal to it but refusing
    non-positive blinds (a zero-chip post must not create a layer). The
    engine kernels hold their own street and ignore it.
    """

    num_seats: int
    small_blind: int = 5
    big_blind: int = 10
    starting_stack: int = 100
    max_layers: int = 12       # per-street bet layers (L)
    max_pot_layers: int = 24   # accumulated across 4 streets (PL)
    rules: str = "reference"
    bets_impl: str = "layers"


class TableState(NamedTuple):
    """The complete state of ``T`` tables (the JAX fields, each with a
    leading table axis)."""

    key: torch.Tensor          # int64 [T, 2] Philox key: (seed, table)
    hand_idx: torch.Tensor     # int32 [T] hand counter (deck = f(key, h))
    deck: torch.Tensor         # int32 [T, 52] permutation of card ids
    hole: torch.Tensor         # int32 [T, P, 2] hole cards by position
    community: torch.Tensor    # int32 [T, 5] materialized at deal
    n_community: torch.Tensor  # int32 [T] cards currently revealed
    stage: torch.Tensor        # int32 [T] 0 preflop .. 3 river
    time: torch.Tensor         # int32 [T] logical clock, +1 per action
    button: torch.Tensor       # int32 [T] hand-order offset
    cursor: torch.Tensor       # int32 [T] play-order scan start
    in_hand: torch.Tensor      # bool [T, P] reference :players
    all_in: torch.Tensor       # bool [T, P] standard-rules all-in
    folded: torch.Tensor       # bool [T, P]
    order_mask: torch.Tensor   # bool [T, P] play-order membership
    to_act: torch.Tensor       # bool [T, P] reference :remaining-players
    stacks: torch.Tensor       # int32 [T, P] chips (may go negative)
    bets: Union[Layers, Street]  # current street, bets_impl's form
    pots: Layers               # accumulated pot layers
    small_blind: torch.Tensor  # int32 [T]
    big_blind: torch.Tensor    # int32 [T]
    hand_over: torch.Tensor    # bool [T]
    street_raises: torch.Tensor  # int32 [T] raises since the street began
    last_raiser: torch.Tensor    # int32 [T] position of the last raiser

    @property
    def num_seats(self) -> int:
        return self.hole.shape[1]

    @property
    def n_tables(self) -> int:
        return self.hole.shape[0]


def _tree_map(fn, *trees):
    """``fn`` applied field by field to states (or streets, layer lists)
    of the same structure."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _select_tree(pred, a, b):
    """``a`` where ``pred`` (bool [T]) else ``b``, field by field of two
    states of the same shapes."""
    return _tree_map(lambda x, y: torch.where(
        pred.view(-1, *[1] * (x.dim() - 1)), x, y), a, b)


def _check_config(cfg: TableConfig) -> None:
    if cfg.rules not in RULES:
        raise ValueError(f"rules={cfg.rules!r}: expected one of {RULES}")
    if cfg.num_seats < 2:
        raise ValueError(f"num_seats={cfg.num_seats}: at least 2")
    if cfg.bets_impl == "levels" and (cfg.small_blind <= 0
                                      or cfg.big_blind <= 0):
        raise ValueError("the levels street form requires positive blinds "
                         "(a zero-chip post must not create a layer)")


def table_keys(seed: int, n_tables: int, device=None,
               first_table: int = 0) -> torch.Tensor:
    """int64 [n_tables, 2]: (seed mod 2^32, table index), the tables
    ``first_table`` .. ``first_table + n_tables - 1``."""
    dev = resolve(device)
    return torch.stack([
        torch.full((n_tables,), int(seed) & MASK, dtype=I64, device=dev),
        torch.arange(first_table, first_table + n_tables, dtype=I64,
                     device=dev)], dim=1)


def shuffled_decks(key: torch.Tensor, hand_idx: torch.Tensor) -> torch.Tensor:
    """int32 [T, 52]: each table's deck for hand ``hand_idx``, the stable
    sort order of the 52 words of Philox stream (key[0], key[1], hand,
    ``DECK_SUB``) (ties, at 2^-32 a pair, go to the lower index).

    The 13 Philox blocks of a deck are one [T, 13] computation, so a deck
    costs one block's operations (word 4b + i is output i of block b)."""
    k0, k1 = key[:, :1], key[:, 1:]
    hand = (hand_idx.to(I64) & MASK)[:, None]
    block = torch.arange(NUM_CARDS // 4, dtype=I64, device=key.device)[None]
    zero = torch.zeros_like(hand) + 0 * block
    words = philox4x32_10((zero + block, zero + hand, zero + DECK_SUB,
                           zero), (k0, k1))
    words = torch.stack(words, dim=2).reshape(-1, NUM_CARDS)
    return torch.sort(words, dim=1, stable=True).indices.to(I32)


def _deal(deck: torch.Tensor, P: int):
    """(hole [T, P, 2], community [T, 5]) in the reference's consumption
    order (``gameplay.clj:63-75``, burns ``:30-54``): position j gets
    deck[j] and deck[P + j]; then burn 1 + flop 3, burn 1 + turn, burn 1 +
    river."""
    hole = torch.stack([deck[:, :P], deck[:, P:2 * P]], dim=2)
    base = 2 * P
    community = deck[:, [base + 1, base + 2, base + 3, base + 5, base + 7]]
    return hole, community


def init_state(seed: int, cfg: TableConfig, n_tables: int,
               device=None, first_table: int = 0) -> TableState:
    """``n_tables`` fresh tables on ``device`` (the card when None): full
    stacks, button at seat 0, the first hand dealt from each table's
    Philox deck. The tables are ``first_table`` .. ``first_table +
    n_tables - 1`` of the seed: a table's deck is a function of its index,
    so a shard of a larger batch deals as that batch's rows do."""
    _check_config(cfg)
    dev = resolve(device)
    P, T = cfg.num_seats, n_tables

    def full(value, *shape, dtype=I32):
        return torch.full((T, *shape), value, dtype=dtype, device=dev)

    state = TableState(
        key=table_keys(seed, T, dev, first_table),
        hand_idx=full(0),
        deck=torch.arange(NUM_CARDS, dtype=I32, device=dev).repeat(T, 1),
        hole=full(0, P, 2),
        community=full(0, 5),
        n_community=full(0),
        stage=full(0),
        time=full(0),
        button=full(0),
        cursor=full(0),
        in_hand=full(True, P, dtype=torch.bool),
        all_in=full(False, P, dtype=torch.bool),
        folded=full(False, P, dtype=torch.bool),
        order_mask=full(True, P, dtype=torch.bool),
        to_act=full(True, P, dtype=torch.bool),
        stacks=full(cfg.starting_stack, P),
        bets=make_empty_bets(cfg.bets_impl, cfg.max_layers, P, T, dev),
        pots=empty_layers(cfg.max_pot_layers, P, T, dev),
        small_blind=full(cfg.small_blind),
        big_blind=full(cfg.big_blind),
        hand_over=full(False, dtype=torch.bool),
        street_raises=full(0),
        last_raiser=full(P),
    )
    return begin_hand(state, rules=cfg.rules)


def _post(stacks, bets, pos, amount):
    """Post a blind of ``amount`` at position ``pos`` (both int32 [T]),
    capped at the stack (standard and tournament rules); a post of no chip
    leaves the street as it was, in either form."""
    seats = torch.arange(stacks.shape[1], dtype=I32, device=stacks.device)
    sel = seats[None] == pos[:, None]
    stack_at = torch.where(sel, stacks, 0).sum(1, dtype=I32)
    pay = torch.minimum(amount.clamp(min=0), stack_at.clamp(min=0))
    stacks = stacks - torch.where(sel, pay[:, None], 0)
    bets = _select_tree(pay > 0, bets_thread(bets, pay, pos), bets)
    return stacks, bets


def begin_hand(state: TableState, rules: str = "reference") -> TableState:
    """Reset per-hand state, shuffle, post blinds, deal (the tail of
    ``gameplay.clj:122-150`` plus ``play-blinds``/``deal-hand``).

    The caller advances ``button``/``hand_idx`` (``next_hand``). Under
    standard rules blind posts cap at the stack and busted seats sit out
    as all-in-for-nothing; tournament rules deal only alive seats, the big
    blind at the first alive position >= 1; the reference posts full
    blinds unconditionally (stacks go negative, ``gameplay.clj:83-88``),
    and in the layers form a zero-chip post threads a zero-amount layer,
    as the JAX engine's does.
    """
    P, T = state.num_seats, state.n_tables
    dev = state.stacks.device
    deck = shuffled_decks(state.key, state.hand_idx)
    hole, community = _deal(deck, P)
    bets = bets_empty_like(state.bets, P)
    seats = torch.arange(P, dtype=I32, device=dev)[None]
    stacks = state.stacks
    in_hand = torch.ones((T, P), dtype=torch.bool, device=dev)
    cursor0 = torch.full((T,), 2 % P, dtype=I32, device=dev)

    def at(pos):
        return torch.full((T,), pos, dtype=I32, device=dev)

    if rules == "tournament":
        # Position 0 is alive by next_hand's rotation; dead positions
        # still consume deck slots (their cards never play).
        alive = state.stacks > 0
        bb_pos = torch.where(alive & (seats >= 1), seats, P).amin(1)
        stacks, bets = _post(stacks, bets, at(0), state.small_blind)
        stacks, bets = _post(stacks, bets, bb_pos, state.big_blind)
        all_in = alive & (stacks <= 0)  # all-in blinds still contest
        in_hand = alive
        actable = alive & (stacks > 0)
        cursor0 = torch.remainder(bb_pos + 1, P)
    elif rules == "standard":
        stacks, bets = _post(stacks, bets, at(0), state.small_blind)
        stacks, bets = _post(stacks, bets, at(1), state.big_blind)
        all_in = stacks <= 0  # all-in blinds and busted seats sit out
        actable = ~all_in
    else:
        stacks = (stacks - torch.where(seats == 0, state.small_blind[:, None],
                                       0)
                  - torch.where(seats == 1, state.big_blind[:, None], 0))
        bets = bets_thread(bets, state.small_blind, 0)
        bets = bets_thread(bets, state.big_blind, 1)
        all_in = torch.zeros((T, P), dtype=torch.bool, device=dev)
        actable = torch.ones((T, P), dtype=torch.bool, device=dev)

    zero = torch.zeros(T, dtype=I32, device=dev)
    return state._replace(
        deck=deck,
        hole=hole,
        community=community,
        n_community=zero,
        stage=zero,
        time=zero,
        cursor=cursor0.to(I32),
        in_hand=in_hand,
        all_in=all_in,
        folded=torch.zeros((T, P), dtype=torch.bool, device=dev),
        order_mask=actable,
        to_act=actable,
        stacks=stacks,
        bets=bets,
        pots=empty_layers(state.pots.capacity, P, T, dev),
        hand_over=torch.zeros(T, dtype=torch.bool, device=dev),
        street_raises=zero,
        last_raiser=torch.full((T,), P, dtype=I32, device=dev),
    )


def redeal(state: TableState, deck) -> TableState:
    """Re-derive hole and community cards from injected decks int [T, 52]
    (the conformance tool of the JAX engine: the consumption order is what
    is conformant). Betting state is untouched."""
    deck = torch.as_tensor(deck, device=state.hole.device).to(I32)
    hole, community = _deal(deck, state.num_seats)
    return state._replace(deck=deck, hole=hole, community=community)


def next_hand(state: TableState, rules: str = "reference") -> TableState:
    """Rotate the players list (``gameplay.clj:136-137``), bump the hand
    counter and deal the next hand: positional state rolls left by one, so
    new position 0 is the old position 1. Stacks persist; the reference
    never eliminates a busted player.

    Tournament rules rotate by the distance to the next alive position,
    and a table where at most one player has chips freezes: a terminal
    ``hand_over`` state with cleared pots, a fixed point of ``next_hand``
    and ``step_table``."""
    P = state.num_seats
    if rules != "tournament":
        return begin_hand(state._replace(
            stacks=torch.roll(state.stacks, -1, dims=1),
            button=torch.remainder(state.button + 1, P),
            hand_idx=state.hand_idx + 1,
        ), rules=rules)

    alive = state.stacks > 0
    n_alive = alive.sum(1, dtype=I32)
    seats = torch.arange(P, dtype=I32, device=alive.device)[None]
    shift = torch.where(alive & (seats >= 1), seats, P).amin(1)
    shift = shift.clamp(1, P - 1)  # well-defined even when freezing
    # roll(stacks, -shift)[j] = stacks[(j + shift) % P]
    src = torch.remainder(seats + shift[:, None], P)
    nxt = begin_hand(state._replace(
        stacks=state.stacks.gather(1, src.long()),
        button=torch.remainder(state.button + shift, P),
        hand_idx=state.hand_idx + 1,
    ), rules=rules)
    none = torch.zeros_like(state.to_act)
    frozen = state._replace(
        bets=bets_empty_like(state.bets, P),
        pots=empty_layers(state.pots.capacity, P, state.n_tables,
                          alive.device),
        to_act=none,
        order_mask=none,
        hand_over=torch.ones_like(state.hand_over),
    )
    return _select_tree(n_alive <= 1, frozen, nxt)


# ---------------------------------------------------------------------------
# Carrying state across: a JAX TableState as numpy <-> the port's
# ---------------------------------------------------------------------------

def _from_numpy(x, dev) -> torch.Tensor:
    a = np.asarray(x)
    return torch.tensor(a if a.dtype == np.bool_ else a.astype(np.int32),
                        device=dev)


def state_from_numpy(st, seed: int = 0, device=None) -> TableState:
    """A batched state whose fields are numpy arrays (for example a JAX
    ``TableState`` of ``jax.vmap(init_state)``, its street in either form,
    mapped through ``np.asarray``) -> the port's ``TableState`` on
    ``device`` (the card when None). A street with a ``level`` field is a
    ``Street``, any other a ``Layers``.

    Every field but ``key`` carries across. A JAX key is a threefry key,
    which the port cannot use: the port's keys are ``table_keys(seed)``."""
    dev = resolve(device)
    fields = {}
    for name in TableState._fields:
        x = getattr(st, name)
        if name == "key":
            continue
        if name in ("bets", "pots"):
            kind = Street if hasattr(x, "level") else Layers
            fields[name] = kind(*(_from_numpy(getattr(x, f), dev)
                                  for f in kind._fields))
        else:
            fields[name] = _from_numpy(x, dev)
    fields["key"] = table_keys(seed, fields["hand_idx"].shape[0], dev)
    return TableState(**fields)


def state_to_numpy(state: TableState) -> TableState:
    """The port's state with every field a numpy array (``key`` int64,
    the rest int32 or bool), streets and layer lists included."""
    return _tree_map(lambda x: x.detach().cpu().numpy(), state)
