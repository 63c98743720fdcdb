"""Component ablation of the engine kernel's step at the full grid: the
port of ``scripts/exp_step_split.py``.

K4 (random-policy perpetual play, reference rules, 6 seats) with one piece
of its step stubbed at a time (``ops/cuda_split.py``: ``stub_settle``,
``stub_eval``, ``stub_deal``, ``stub_policy``, ``stub_street``; ``full``
is K4 itself), at the JAX script's 2^20 tables x 512 slots from one first
state (``first_state``: Philox, where the JAX script deals
threefry permutations). Each variant is its own nvcc build (all started at
once); each is timed after one warm-up, best of 3 (CUDA events), every run
from the same seed (the JAX script salts its seeds with ``hash(tag)``,
which Python draws anew in every process). Prints one JSON line a
variant: ns per table-step, the hands completed, nvcc's seconds and
ptxas's registers, stack and spills. Variants change what the kernel
computes: measurement only.

    python -m montecarlo_tpu_torch.scripts.exp_step_split [variant ...]
        [--tables N] [--steps S] [--device cpu]

On the CPU (``--device cpu``) the plain versions run, timed on the host
clock, with no build.
"""

from __future__ import annotations

import argparse
import json

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_split as csp
from montecarlo_tpu_torch.scripts._timing import best_ms, device_name

N_TABLES = 1 << 20
N_STEPS = 512
SEED = 1
RUNS = 3
VARIANTS = csp.VARIANTS


def build_state(cfg, device=None, n_tables: int = N_TABLES):
    """The first state: every table's first hand from ``first_state(0)``,
    blinds posted."""
    return ce.first_state(0, cfg, n_tables, device)


def measure(cfg, state0, tag, n_steps: int = N_STEPS, runs: int = RUNS):
    """Variant ``tag`` on ``state0``: a warm-up and the best of ``runs``.
    Prints and returns its JSON line (with the build's nvcc seconds and
    ptxas report on the card); the returned dict also holds the output
    state."""
    dev = state0.device
    P = cfg.num_seats
    T = state0.shape[0] * ce.TABLES_PER_BLOCK
    build = {}
    if dev.type == "cuda":
        b = _build.probe_library("split", tag, P)
        build = {"nvcc_s": b.seconds, **b.ptxas}
    out, ms = best_ms(lambda: csp.run_split(
        tag, SEED, state0, P, n_steps, cfg.small_blind, cfg.big_blind), dev,
        runs)
    hands = int((ce.unpack_field(out, cfg, "hand_ct")
                 - ce.unpack_field(state0, cfg, "hand_ct")).sum())
    line = {"variant": tag, "ns_per_table_step": ms * 1e6 / (T * n_steps),
            "ms": ms, "hands": hands, "tables": T, "steps": n_steps,
            **build, "device": device_name(dev)}
    print(json.dumps(line), flush=True)
    return {**line, "out": out}


def main(argv=None, device=None) -> dict:
    """Every variant named (all by default); returns variant -> its
    ``measure`` result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=f"of {VARIANTS}")
    ap.add_argument("--tables", type=int, default=N_TABLES)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    variants = args.variants or list(VARIANTS)
    dev = resolve(args.device)
    cfg = TableConfig(num_seats=6, bets_impl="levels")
    if dev.type == "cuda":
        _build.build_probes("split", variants, cfg.num_seats)
    state0 = build_state(cfg, dev, args.tables)
    return {tag: measure(cfg, state0, tag, args.steps) for tag in variants}


if __name__ == "__main__":
    main()
