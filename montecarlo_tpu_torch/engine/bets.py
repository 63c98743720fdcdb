"""Bet-layer records: the pot-record part of ``montecarlo_tpu/engine/bets.py``.

The reference models a betting street and the pots as ordered lists of
*layers* (``bet.clj``): ``Bet{bet players original-players n}`` means
"``bet`` chips matched by each member of ``players``". ``Layers`` holds such
a list at a fixed capacity, with player sets packed as int32 **seat
bitmasks** (bit s = seat s belongs), tables on a leading axis.

The port keeps only the record: the engine holds a street in the levels
form (``engine/street.py``) and derives this layer view at street end,
settlement and host projection. The literal layer algebra of the JAX module
(``update_bets``, ``merge_bets``, ``remove_player``, ``total_bet``,
``needed_bet``) is not ported: its trajectories equal the levels form's
(``tests/test_street.py``), and its ``bet.clj`` spec tests stay with the
JAX package.
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
