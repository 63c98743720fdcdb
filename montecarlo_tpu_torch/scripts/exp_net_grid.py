"""The net-eval kernel's cost a table-step against the engine kernel's,
over grid sizes: the port of ``scripts/exp_net_grid.py``.

For both rule sets ("standard", "reference") and 2^16, 2^18 and 2^20
six-max tables x 512 slots from one first state (``initial_packed_state``
of seed 7), times K6 (``run_net_eval``: ``data/policy_6max_200.npz``
through the port's loader at seat 0, ``net_seats=1``, stacks reset every
hand) and K4 (``run_perpetual_prng``, random policy, perpetual), each one
launch of 512 slots; at 2^18 also K6 without the reset. Each is a warm-up
and the best of ``REPS`` (CUDA events; the host clock on the CPU), every
run from the same seed; the warm-up's hands must be > 0. Prints one JSON
line a key with ns per table-step, under the JAX script's keys
(``net[{rules},2^{k},reset]``, ``engine[{rules},2^{k}]``,
``net[{rules},2^18,noreset]``; ``keys``), then all of them with the
card's name. The JAX script wrote ``data/exp_net_grid.json`` at every
run; this writes only at ``--save OUT.json``.

    python -m montecarlo_tpu_torch.scripts.exp_net_grid [--save OUT.json]
        [--log2-tables 16,18,20] [--steps S] [--reps R] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.scripts._timing import best_ms, device_name

N_STEPS = 512
REPS = 3
LOG2_TABLES = (16, 18, 20)
RULES = ("standard", "reference")
NORESET_LOG2 = 18
ARTIFACT = "data/policy_6max_200.npz"
SEED = 1


def keys(sizes=LOG2_TABLES):
    """The keys a run over ``sizes`` (log2 of the tables) reports, in
    order."""
    out = []
    for rules in RULES:
        for k in sizes:
            out += [f"net[{rules},2^{k},reset]", f"engine[{rules},2^{k}]"]
            if k == NORESET_LOG2:
                out.append(f"net[{rules},2^{k},noreset]")
    return out


def kernel_weights(params, device=None):
    """The net's weights as the net kernels read them (``net_weights``)."""
    return cn.net_weights(params, device)


def timed(fn, state0, cfg, n_steps: int = N_STEPS, reps: int = REPS):
    """ns per table-step of ``fn(seed)`` (a new state from ``state0``): a
    warm-up, whose hands must be > 0, and the best of ``reps``."""
    out, ms = best_ms(lambda: fn(SEED), state0.device, reps)
    hands = int((ce.unpack_field(out, cfg, "hand_ct")
                 - ce.unpack_field(state0, cfg, "hand_ct")).sum())
    assert hands > 0, hands
    n_tables = state0.shape[0] * ce.TABLES_PER_BLOCK
    return ms * 1e6 / (n_tables * n_steps)


def main(argv=None, device=None) -> dict:
    """Every key's ns per table-step; returns {key: ns}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-tables", default=",".join(map(str, LOG2_TABLES)))
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    sizes = [int(k) for k in args.log2_tables.split(",") if k]
    weights = kernel_weights(load_params(ARTIFACT), dev)
    results = {}

    def report(tag, ns):
        results[tag] = ns
        print(json.dumps({tag: ns}), flush=True)

    for rules in RULES:
        cfg = TableConfig(num_seats=6, rules=rules)
        P, sb, bb, ss = (cfg.num_seats, cfg.small_blind, cfg.big_blind,
                         cfg.starting_stack)
        for k in sizes:
            state0 = cn.initial_packed_state(7, cfg, 1 << k, dev)

            def net_fn(seed, reset=True):
                return cn.run_net_eval(seed, state0, weights, P, args.steps,
                                       sb, bb, ss, rules, 1,
                                       reset_stacks=reset)

            report(f"net[{rules},2^{k},reset]",
                   timed(net_fn, state0, cfg, args.steps, args.reps))
            report(f"engine[{rules},2^{k}]", timed(
                lambda seed: ce.run_perpetual_prng(
                    seed, state0, P, args.steps, sb, bb, rules=rules),
                state0, cfg, args.steps, args.reps))
            if k == NORESET_LOG2:
                report(f"net[{rules},2^{k},noreset]", timed(
                    lambda seed: net_fn(seed, reset=False), state0, cfg,
                    args.steps, args.reps))
            del state0
    print(json.dumps({"ns_per_table_step": results,
                      "device": device_name(dev)}), flush=True)
    if args.save:
        with open(args.save, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
    return results


if __name__ == "__main__":
    main()
