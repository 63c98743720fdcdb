"""Component ablation of the in-kernel policy-net step: the port of
``scripts/exp_net_split.py``.

K6 (``data/policy_6max_200.npz`` at seat 0, the random policy elsewhere,
standard rules, 6 seats) with one piece of the net decision stubbed at a
time (``ops/cuda_net_split.py``: ``stub_gumbel``, ``stub_feat_eval``,
``stub_features``, ``stub_net``; ``full`` is K6 itself), at the JAX
script's 2^16 tables x 256 slots from one first state (``first_state``:
Philox, where the JAX script deals threefry permutations). Each variant
is its own nvcc build (all started at once); each is timed after one
warm-up, best of 3 (CUDA events), every run from the same seed. Prints
one JSON line a variant: ns per table-step, the hands completed and
hands/s, the net decisions, nvcc's seconds and ptxas's registers, stack
and spills. Variants change what the kernel computes: measurement only.

    python -m montecarlo_tpu_torch.scripts.exp_net_split [variant ...]
        [--tables N] [--steps S] [--device cpu]

On the CPU (``--device cpu``) the plain versions run, timed on the host
clock, with no build.
"""

from __future__ import annotations

import argparse
import json

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.ops import cuda_net_split as cns
from montecarlo_tpu_torch.scripts._timing import best_ms, device_name

N_TABLES = 1 << 16
N_STEPS = 256
ARTIFACT = "data/policy_6max_200.npz"
NET_SEATS = 1
SEED = 1
RUNS = 3
VARIANTS = cns.VARIANTS


def measure(cfg, state0, weights, tag, n_steps: int = N_STEPS,
            runs: int = RUNS):
    """Variant ``tag`` on ``state0`` with the net ``weights`` at seat 0: a
    warm-up and the best of ``runs``. Prints and returns its JSON line
    (with the build's nvcc seconds and ptxas report on the card); the
    returned dict also holds the output state."""
    dev = state0.device
    P = cfg.num_seats
    T = state0.shape[0] * ce.TABLES_PER_BLOCK
    build = {}
    if dev.type == "cuda":
        b = _build.probe_library("net_split", tag, P)
        build = {"nvcc_s": b.seconds, **b.ptxas}
    decisions = torch.zeros(1, dtype=torch.int64, device=dev)

    def run():
        decisions.zero_()
        return cns.run_net_split(tag, SEED, state0, weights, P, n_steps,
                                 cfg.small_blind, cfg.big_blind,
                                 cfg.starting_stack, NET_SEATS,
                                 decisions=decisions)

    out, ms = best_ms(run, dev, runs)
    hands = int((ce.unpack_field(out, cfg, "hand_ct")
                 - ce.unpack_field(state0, cfg, "hand_ct")).sum())
    line = {"variant": tag, "ns_per_table_step": ms * 1e6 / (T * n_steps),
            "ms": ms, "hands": hands, "hands_per_sec": hands / (ms / 1e3),
            "net_decisions": int(decisions), "tables": T, "steps": n_steps,
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
    cfg = TableConfig(num_seats=6, rules="standard", bets_impl="levels")
    if dev.type == "cuda":
        _build.build_probes("net_split", variants, cfg.num_seats)
    state0 = ce.first_state(0, cfg, args.tables, dev)
    weights = cn.net_weights(load_params(ARTIFACT), dev)
    return {tag: measure(cfg, state0, weights, tag, args.steps)
            for tag in variants}


if __name__ == "__main__":
    main()
