"""Levels street bet state: ``montecarlo_tpu/engine/street.py`` on tables
held on a leading axis, and the dispatch between the two street forms.

A street in the levels form is stored minimally and the reference layer
list (``bet.clj``) is derived only at observation points:

- ``level``   int32 [T, L]: ascending cumulative boundaries; layer ``j`` is
  the chip range ``(level[j-1], level[j]]``;
- ``n``       int32 [T, L]: the reference contribution counter per layer;
- ``contrib`` int32 [T, P]: chips each seat has put into this street.

A layer's original members are the seats whose contribution reaches its
boundary, its members those of them not folded; ``n`` is carried because
``merge-bets`` keeps the later layer's ``n`` (``bet.clj:20-23``). The JAX
module's docstring gives the proofs.

``street_update`` is ``update-bets`` (a sorted insert of the new total),
``street_merge`` is ``merge-bets`` after a fold or check (levels no
contribution sits on are dropped), ``street_to_layers`` materializes the
reference layers. Levels are strictly positive, so a zero-chip post must
not create a layer: ``engine/state.py`` refuses non-positive blinds for
this form. The literal layer algebra (``engine/bets.py``) is the other
form and covers that corner bit for bit.

``TableConfig.bets_impl`` picks the form: "layers" (the default, a
``Layers`` street) or "levels" (a ``Street``). The ``bets_*`` adapters at
the bottom dispatch on the street's type, as the JAX ones do, so one
engine runs both and the tests hold their trajectories equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.bets import (
    Layers,
    _vec,
    empty_layers,
    merge_bets,
    needed_bet,
    remove_player,
    total_bet,
    update_bets,
)

I32 = torch.int32


class Street(NamedTuple):
    """Minimal street bet state per table (see the module docstring)."""

    level: torch.Tensor    # int32 [T, L] ascending boundaries (0 padded)
    n: torch.Tensor        # int32 [T, L] reference :n per layer
    contrib: torch.Tensor  # int32 [T, P] per-seat chips in this street
    count: torch.Tensor    # int32 [T] live levels
    overflow: torch.Tensor  # bool [T] capacity exceeded at some point

    @property
    def capacity(self) -> int:
        return self.level.shape[-1]


def empty_street(max_layers: int, num_seats: int, n_tables: int,
                 device=None) -> Street:
    """``n_tables`` empty streets on ``device`` (the card when None)."""
    dev = resolve(device)
    return Street(
        level=torch.zeros((n_tables, max_layers), dtype=I32, device=dev),
        n=torch.zeros((n_tables, max_layers), dtype=I32, device=dev),
        contrib=torch.zeros((n_tables, num_seats), dtype=I32, device=dev),
        count=torch.zeros(n_tables, dtype=I32, device=dev),
        overflow=torch.zeros(n_tables, dtype=torch.bool, device=dev),
    )


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[t, i[t]] per table, 0 where ``i`` is out of range (the JAX
    one-hot reduce, as a gather)."""
    n = x.shape[1]
    inside = (i >= 0) & (i < n)
    got = x.gather(1, i.clamp(0, n - 1).long()[:, None])[:, 0]
    return torch.where(inside, got, 0)


def _rows(s: Street) -> torch.Tensor:
    return torch.arange(s.capacity, dtype=I32, device=s.level.device)[None]


def street_total(s: Street) -> torch.Tensor:
    """Total standing street bet == the top boundary
    (``helpers.clj:15-19``), int32 [T]."""
    valid = _rows(s) < s.count[:, None]
    return torch.where(valid, s.level, 0).amax(1)


def street_needed(s: Street, seat) -> torch.Tensor:
    """``helpers.clj:21-27`` for a non-folded seat: total minus the seat's
    own contribution (see the JAX function for why folded seats are never
    asked)."""
    return street_total(s) - _pick(s.contrib, _vec(seat, s.count))


def street_update(s: Street, amount, seat) -> Street:
    """``update-bets`` (``bet.clj:45-59``): the seat's street total becomes
    ``amount``; every covered layer's ``n`` increments; a new boundary is
    sorted-inserted when ``amount`` is not already a level. ``amount <= 0``
    is a no-op."""
    L = s.capacity
    idx = _rows(s)
    valid = idx < s.count[:, None]
    amount = _vec(amount, s.count)
    seat = _vec(seat, s.count)
    a = amount[:, None]

    n_inc = s.n + (valid & (s.level <= a)).to(I32)
    exists = (valid & (s.level == a)).any(1)
    pos = (valid & (s.level < a)).sum(1, dtype=I32)
    # Split: the new lower part takes the containing layer's (pre-increment)
    # n plus the splitter's own join; append starts a fresh n=1 layer.
    new_n = torch.where(pos == s.count, 1, _pick(s.n, pos) + 1)

    def insert(col, newval):
        rolled = torch.roll(col, 1, dims=1)
        return torch.where(idx < pos[:, None], col,
                           torch.where(idx == pos[:, None], newval[:, None],
                                       rolled))

    positive = (amount > 0)[:, None]
    do_insert = ~exists & (amount > 0)
    level = torch.where(do_insert[:, None], insert(s.level, amount), s.level)
    n = torch.where(positive, torch.where(do_insert[:, None],
                                          insert(n_inc, new_n), n_inc), s.n)
    count = torch.where(do_insert, torch.clamp(s.count + 1, max=L), s.count)
    live = idx < count[:, None]
    seats = torch.arange(s.contrib.shape[1], dtype=I32,
                         device=s.contrib.device)[None]
    onehot = seats == seat[:, None]
    return Street(
        level=torch.where(live, level, 0),
        n=torch.where(live, n, 0),
        contrib=torch.where(onehot & positive,
                            torch.maximum(s.contrib, a), s.contrib),
        count=count,
        overflow=s.overflow | (do_insert & (s.count >= L)),
    )


def street_merge(s: Street) -> Street:
    """``merge-bets`` (``bet.clj:10-27``): adjacent layers coalesce iff no
    seat's contribution sits on the boundary between them, so merging ==
    compacting away unmatched levels; a kept row carries its own ``n``
    (the later layer wins)."""
    idx = _rows(s)
    valid = idx < s.count[:, None]
    matched = (s.contrib[:, None, :] == s.level[:, :, None]).any(2)
    keep = valid & matched & (s.level > 0)
    rank = keep.to(I32).cumsum(1, dtype=I32) - 1
    sel = (rank[:, None, :] == idx[:, :, None]) & keep[:, None, :]
    return s._replace(
        level=torch.where(sel, s.level[:, None, :], 0).sum(2, dtype=I32),
        n=torch.where(sel, s.n[:, None, :], 0).sum(2, dtype=I32),
        count=keep.sum(1, dtype=I32),
    )


def street_to_layers(s: Street, folded) -> Layers:
    """Materialize the reference layer list (``Bet{bet players
    original-players n}``) for street end, settlement or projection."""
    P = s.contrib.shape[1]
    idx = _rows(s)
    valid = idx < s.count[:, None]
    lvl = torch.where(valid, s.level, 0)
    prev = torch.where(idx == 0, 0, torch.roll(lvl, 1, dims=1))
    ge = (s.contrib[:, None, :] >= lvl[:, :, None]) & valid[:, :, None]
    bits = torch.ones(P, dtype=I32, device=lvl.device) << torch.arange(
        P, dtype=I32, device=lvl.device)
    return Layers(
        amt=torch.where(valid, lvl - prev, 0),
        mem=torch.where(ge & ~folded[:, None, :], bits, 0).sum(2, dtype=I32),
        orig=torch.where(ge, bits, 0).sum(2, dtype=I32),
        n=torch.where(valid, s.n, 0),
        count=s.count,
        overflow=s.overflow,
    )


# ---------------------------------------------------------------------------
# Dispatch on the street form: one engine, two street implementations.
# ---------------------------------------------------------------------------

def bets_total(bets) -> torch.Tensor:
    if isinstance(bets, Street):
        return street_total(bets)
    return total_bet(bets)


def bets_needed(bets, seat) -> torch.Tensor:
    if isinstance(bets, Street):
        return street_needed(bets, seat)
    return needed_bet(bets, seat)


def bets_thread(bets, amount, seat):
    if isinstance(bets, Street):
        return street_update(bets, amount, seat)
    return update_bets(bets, amount, seat)


def bets_fold_check_merge(bets, is_fold, seat):
    """The fold/check path (``board.clj:37-41`` / ``:67-71``): a fold
    removes the seat from member sets, then both merge. In the levels form
    member sets are derived from the state's fold mask, so both are one
    merge; in the layers form a table folds where ``is_fold`` (bool [T])
    holds."""
    if isinstance(bets, Street):
        del is_fold, seat
        return street_merge(bets)
    removed = remove_player(bets, seat)
    return merge_bets(bets._replace(
        mem=torch.where(is_fold[:, None], removed.mem, bets.mem)))


def bets_empty_like(bets, num_seats: int):
    n_tables, dev = bets.count.shape[0], bets.count.device
    if isinstance(bets, Street):
        return empty_street(bets.capacity, num_seats, n_tables, dev)
    return empty_layers(bets.capacity, num_seats, n_tables, dev)


def bets_as_layers(bets, folded) -> Layers:
    """A reference layer-list view of the street (identity for
    ``Layers``)."""
    if isinstance(bets, Street):
        return street_to_layers(bets, folded)
    return bets


def make_empty_bets(impl: str, max_layers: int, num_seats: int,
                    n_tables: int, device=None):
    """The street form ``TableConfig.bets_impl`` names: ``Layers`` for
    "layers", ``Street`` for "levels"."""
    if impl == "levels":
        return empty_street(max_layers, num_seats, n_tables, device)
    if impl != "layers":
        raise ValueError(f"bets_impl={impl!r}: expected 'layers' or "
                         f"'levels'")
    return empty_layers(max_layers, num_seats, n_tables, device)
