"""Static table parameters (``montecarlo_tpu/engine/state.py:TableConfig``).

Only the config is ported in this slice: the engine state itself is the
packed ``[n_blocks, F, 8, 128]`` int32 array of ``ops/cuda_engine.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TableConfig:
    """Static table parameters, field for field the JAX ``TableConfig``.

    Defaults mirror the reference: 100-chip starting stacks, 5/10 blinds.
    ``rules`` is "reference", "standard" or "tournament"; the engine
    kernels run all three (the net kernels the first two).
    ``bets_impl`` names the street bet form ("layers" or "levels") of the
    JAX engine and is unused by the kernels, which run the levels form.
    """

    num_seats: int
    small_blind: int = 5
    big_blind: int = 10
    starting_stack: int = 100
    max_layers: int = 12       # per-street bet layers (L)
    max_pot_layers: int = 24   # accumulated across 4 streets (PL)
    rules: str = "reference"
    bets_impl: str = "layers"
