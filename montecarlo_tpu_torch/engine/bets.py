"""Layered-bet algebra: ``montecarlo_tpu/engine/bets.py`` on tables held
on a leading axis.

The reference models a betting street and the pots as ordered lists of
*layers* (``bet.clj``): ``Bet{bet players original-players n}`` means
"``bet`` chips matched by each member of ``players``"; side pots fall out
of splitting layers. ``Layers`` holds such a list at a fixed capacity, with
player sets packed as int32 **seat bitmasks** (bit s = seat s belongs),
tables on a leading axis: every field is [T, L], ``count`` and
``overflow`` are [T].

``update_bets`` (``bet.clj:45-59``) and ``merge_bets`` (``bet.clj:10-27``)
are the literal transcription the JAX module is, branch-free over the
tables; a seat or an amount is a Python int or an int32 [T] tensor, one a
table. This is the street form of ``TableConfig(bets_impl="layers")``;
``engine/street.py`` holds the levels form, trajectory-equal where both
run. Reference quirks kept bit for bit (the JAX docstring cites them):

- ``update_bets`` threads the full standing total through every layer, so
  a seat that is already a member is "added" again: the set is unchanged
  but ``n`` increments (the inflated payout ``bet * n``);
- ``merge_bets`` keeps the **later** layer's ``n`` when coalescing;
- a fold removes the seat from ``mem`` only, never from ``orig``;
- a layer past capacity is dropped: ``count`` stops at L and ``overflow``
  latches when ``count >= L`` at a split or an append.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from montecarlo_tpu_torch.device import resolve

I32 = torch.int32

MAX_SEATS = 23  # bitmask seats must fit an int32 without the sign bit


class Layers(NamedTuple):
    """A fixed-capacity ordered list of bet layers per table.

    ``amt``/``n`` are int32 [T, L]; ``mem``/``orig`` are int32 [T, L] seat
    bitmasks; ``count`` int32 [T] is the number of live layers;
    ``overflow`` bool [T] latches if capacity was ever exceeded.
    """

    amt: torch.Tensor    # chips per member in this layer
    mem: torch.Tensor    # current member bitmask (:players)
    orig: torch.Tensor   # original member bitmask (never shrunk by folds)
    n: torch.Tensor      # contribution counter (reference :n)
    count: torch.Tensor  # number of live layers
    overflow: torch.Tensor  # capacity exceeded at some point

    @property
    def capacity(self) -> int:
        return self.amt.shape[-1]


def empty_layers(max_layers: int, num_seats: int, n_tables: int,
                 device=None) -> Layers:
    """``n_tables`` empty layer lists on ``device`` (the card when None)."""
    if num_seats > MAX_SEATS:
        raise ValueError(f"num_seats={num_seats}: bitmask seats stop at "
                         f"{MAX_SEATS}")
    dev = resolve(device)
    z = torch.zeros((n_tables, max_layers), dtype=I32, device=dev)
    return Layers(amt=z, mem=z.clone(), orig=z.clone(), n=z.clone(),
                  count=torch.zeros(n_tables, dtype=I32, device=dev),
                  overflow=torch.zeros(n_tables, dtype=torch.bool,
                                       device=dev))


def member_matrix(masks, num_seats: int) -> torch.Tensor:
    """int32 [..., L] bitmasks -> bool [..., L, P] membership."""
    seats = torch.arange(num_seats, dtype=I32, device=masks.device)
    return ((masks[..., None] >> seats) & 1) != 0


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    """An int or a per-table tensor as int32 [T] on ``like``'s device."""
    x = torch.as_tensor(x, device=like.device).to(I32)
    return x.expand(like.shape[0])


def _seat_bit(seat: torch.Tensor) -> torch.Tensor:
    """int32 [T] seats (< ``MAX_SEATS``) -> their bits, [T]."""
    return torch.ones_like(seat) << seat


def _rows(layers: Layers) -> torch.Tensor:
    return torch.arange(layers.capacity, dtype=I32,
                        device=layers.amt.device)[None]


def _valid(layers: Layers) -> torch.Tensor:
    return _rows(layers) < layers.count[:, None]


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[t, i[t]] per table, for 0 <= i < L."""
    return x.gather(1, i.long()[:, None])[:, 0]


def total_bet(layers: Layers) -> torch.Tensor:
    """Sum of all standing layer amounts (``helpers.clj:15-19``), [T]."""
    return torch.where(_valid(layers), layers.amt, 0).sum(1, dtype=I32)


def needed_bet(layers: Layers, seat) -> torch.Tensor:
    """Sum of the layers the seat is not yet a member of
    (``helpers.clj:21-27``), [T]."""
    bit = _seat_bit(_vec(seat, layers.count))
    unmet = _valid(layers) & ((layers.mem & bit[:, None]) == 0)
    return torch.where(unmet, layers.amt, 0).sum(1, dtype=I32)


def _added(layers: Layers, bit: torch.Tensor, row_mask: torch.Tensor
           ) -> Layers:
    """Add the seat of ``bit`` ([T]) to the rows of ``row_mask`` ([T, L]):
    ``players``/``original-players`` conj and ``n`` + 1, even where it is
    already a member (the reference's n-inflation)."""
    grow = torch.where(row_mask, bit[:, None], 0)
    return layers._replace(mem=layers.mem | grow, orig=layers.orig | grow,
                           n=layers.n + row_mask.to(I32))


def update_bets(layers: Layers, bet_amt, seat) -> Layers:
    """Thread a single-seat bet of ``bet_amt`` (the seat's new street
    total) through the standing layers of each table (``bet.clj:45-59``):
    join each layer the bet covers, split the first layer it covers only
    in part (a side pot), append a fresh layer for any excess."""
    L = layers.capacity
    idx = _rows(layers)
    valid = _valid(layers)
    bet_amt = _vec(bet_amt, layers.count)
    bit = _seat_bit(_vec(seat, layers.count))
    prefix = torch.where(valid, layers.amt, 0).cumsum(1, dtype=I32)
    total = prefix[:, -1]

    stop = valid & (bet_amt[:, None] <= prefix)
    has_stop = stop.any(1)
    # the first row of ``stop`` (JAX's argmax over bools; any row when
    # none: has_stop gates every use)
    i_star = torch.where(stop, idx, L).amin(1).clamp(max=L - 1)
    prefix_at = _at(prefix, i_star)
    amt_at = _at(layers.amt, i_star)
    is_eq = has_stop & (bet_amt == prefix_at)
    is_split = has_stop & ~is_eq
    upto = idx <= i_star[:, None]
    grown = torch.clamp(layers.count + 1, max=L)
    overflow = layers.overflow | (layers.count >= L)

    # the bet consumes layers 0..i* exactly: join all of them
    eq_out = _added(layers, bit, valid & upto)

    # the bet covers layer i* in part: join 0..i*-1, split i* into
    # (x, members + seat) and (rest, members), the tail shifted right by
    # one (each row reads its left neighbour past i*)
    x = bet_amt - (prefix_at - amt_at)

    def shifted(a):
        return torch.where(upto, a, torch.roll(a, 1, dims=1))

    sp_amt = torch.where(idx == i_star[:, None], x[:, None],
                         torch.where(idx == i_star[:, None] + 1,
                                     (amt_at - x)[:, None],
                                     shifted(layers.amt)))
    sp = Layers(amt=sp_amt, mem=shifted(layers.mem),
                orig=shifted(layers.orig), n=shifted(layers.n),
                count=grown, overflow=overflow)
    sp = _added(sp, bit, upto)

    # the bet exceeds every standing layer: join them all, append the
    # excess as a fresh single-seat layer
    ap = _added(layers, bit, valid)
    at_end = idx == layers.count[:, None]
    bit_at_end = torch.where(at_end, bit[:, None], 0)
    ap = Layers(amt=torch.where(at_end, (bet_amt - total)[:, None], ap.amt),
                mem=ap.mem | bit_at_end, orig=ap.orig | bit_at_end,
                n=torch.where(at_end, 1, ap.n), count=grown,
                overflow=overflow)

    def sel(a, b, c):
        pe = is_eq.view(-1, *[1] * (a.dim() - 1))
        ps = is_split.view(-1, *[1] * (a.dim() - 1))
        return torch.where(pe, a, torch.where(ps, b, c))

    return Layers(*(sel(a, b, c) for a, b, c in zip(eq_out, sp, ap)))


def merge_bets(layers: Layers) -> Layers:
    """Coalesce adjacent layers with identical member and original-member
    sets (``bet.clj:10-27``): amounts sum, the **later** layer's ``n``
    wins. Each table's groups are runs of rows, so a row is scattered to
    its group's row (the JAX form's [group, layer] mask, without it);
    rows that write nothing go to a spare column."""
    L = layers.capacity
    idx = _rows(layers)
    valid = _valid(layers)
    same_prev = (valid & torch.roll(valid, 1, dims=1)
                 & (layers.mem == torch.roll(layers.mem, 1, dims=1))
                 & (layers.orig == torch.roll(layers.orig, 1, dims=1))
                 & (idx > 0))
    new_group = valid & ~same_prev
    gid = new_group.to(I32).cumsum(1, dtype=I32) - 1
    n_groups = new_group.sum(1, dtype=I32)
    # each group's one last row: sets are equal within a group and the
    # merged n is the last member's (bet.clj:20-23)
    is_last = valid & ~torch.cat(
        [same_prev[:, 1:], torch.zeros_like(same_prev[:, :1])], dim=1)
    spare = torch.zeros((layers.amt.shape[0], L + 1), dtype=I32,
                        device=layers.amt.device)
    to_sum = torch.where(valid, gid, L).long()
    to_last = torch.where(is_last, gid, L).long()

    def last(x):
        return spare.scatter(1, to_last, x)[:, :L]

    out_valid = idx < n_groups[:, None]
    amt = spare.scatter_add(1, to_sum, torch.where(valid, layers.amt, 0))
    return layers._replace(
        amt=torch.where(out_valid, amt[:, :L], 0),
        mem=torch.where(out_valid, last(layers.mem), 0),
        orig=torch.where(out_valid, last(layers.orig), 0),
        n=torch.where(out_valid, last(layers.n), 0),
        count=n_groups,
    )


def remove_player(layers: Layers, seat) -> Layers:
    """Fold semantics (``board.clj:37-41``): drop the seat from every
    layer's members, never from its original members; callers then
    ``merge_bets``."""
    bit = _seat_bit(_vec(seat, layers.count))
    return layers._replace(mem=layers.mem & ~bit[:, None])
