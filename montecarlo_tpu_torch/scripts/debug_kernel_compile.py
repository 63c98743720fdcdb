"""Bisect the engine kernel's build time and cost by stages of its step body.

The port of ``scripts/debug_kernel_compile.py``: for each stage of the
whole-step body (``carry``, ``policy``, ``street``, ``deal``, ``settle``,
``full``; ``ops/cuda_stages.py``), nvcc compiles a kernel that applies
that stage alone 256 times to the packed 6-seat state (reference rules)
of 32 blocks (32,768 tables), and the script prints the stage's nvcc
seconds, ptxas's registers, stack frame and spills, and ns per
table-step (best of 3, CUDA events).

Run on a machine with a card (one stage, or all):

    python -m montecarlo_tpu_torch.scripts.debug_kernel_compile [stage]

``compile_variant(name, device="cpu")`` runs the plain version, with no
build, timed on the host clock.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_stages as cs
from montecarlo_tpu_torch.scripts._timing import best_ms, device_name

P = 6
cfg = TableConfig(num_seats=P, bets_impl="levels")
layout, F = ce._field_layout(P)
STAGES = cs.STAGES


def first_state(n_blocks: int, device) -> torch.Tensor:
    """The script's state: each table's first hand dealt from numpy
    ``default_rng(0)``, blinds posted."""
    rng = np.random.default_rng(0)
    n_tables = n_blocks * ce.TABLES_PER_BLOCK
    first = np.argsort(rng.random((n_tables, 52)), axis=-1)[:, :2 * P + 5]
    return ce.pack_state(cfg, torch.from_numpy(first).to(device))


def compile_variant(name: str, n_steps: int = 256, n_blocks: int = 32,
                    state=None, seed: int = 0, device=None,
                    rebuild: bool = True) -> dict:
    """Build stage ``name`` (afresh unless ``rebuild`` is False and this
    process built it already) and time ``n_steps`` applications of it to
    ``state`` (default ``first_state(n_blocks)``). Prints and returns the
    nvcc seconds, the ptxas report, the best time and ns per table-step;
    the returned dict also holds the first launch's output state."""
    dev = resolve(device)
    if state is None:
        state = first_state(n_blocks, dev)
    n_tables = state.shape[0] * ce.TABLES_PER_BLOCK
    build = {}
    if dev.type == "cuda":
        b = cs.stage_library(name, P, fresh=rebuild)
        build = {"nvcc_s": b.seconds, **b.ptxas}
    out, ms = best_ms(lambda: cs.run_stage(
        name, seed, state, P, n_steps, cfg.small_blind, cfg.big_blind), dev)
    result = {"stage": name, "tables": n_tables, "steps": n_steps, **build,
              "ms": ms, "ns_per_table_step": ms * 1e6 / (n_tables * n_steps),
              "device": device_name(dev)}
    print(json.dumps(result), flush=True)
    return {**result, "out": out}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    for name in STAGES:
        if which in ("all", name):
            compile_variant(name)


if __name__ == "__main__":
    main()
