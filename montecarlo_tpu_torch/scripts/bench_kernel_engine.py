"""Whole-step engine kernel K4: smoke and throughput. The port of
``scripts/bench_kernel_engine.py``.

Throughput: K4 (``ops/cuda_engine.run_perpetual_prng``: random-policy
perpetual play, 6 seats) over ``--steps`` slots of ``--tables`` tables
from one first state, built outside the timed region (``first_state``:
Philox, where the JAX script deals threefry permutations); one warm-up,
then the best of 3 on the host clock, the hand count's read to the host
being the sync; the overflow latch is asserted 0 after every run.
``--smoke``: ``selfplay_perpetual_kernel`` at 1024 tables x 64 slots, its
first call (the kernels' build included).

    python -m montecarlo_tpu_torch.scripts.bench_kernel_engine
        [--tables N] [--steps S] [--smoke] [--rules reference|standard]
        [--device cpu]

Prints one JSON line (on the card, its peak device memory on stderr).
``--device cpu`` runs the plain version.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops.cuda_engine import (
    first_state,
    run_perpetual_prng,
    selfplay_perpetual_kernel,
    unpack_field,
)
from montecarlo_tpu_torch.scripts._timing import log_peak_memory


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--rules", default="reference",
                    choices=["reference", "standard"])
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    cfg = TableConfig(num_seats=6, rules=args.rules)
    dev = resolve(args.device)

    if args.smoke:
        t0 = time.perf_counter()
        state, hands, ovf = selfplay_perpetual_kernel(
            3, cfg, 1024, 64, steps_per_launch=64, device=dev)
        out = {
            "mode": "smoke", "tables": 1024, "steps": 64,
            "hands": hands, "overflow_tables": ovf,
            "steps_per_hand": 1024 * 64 / max(hands, 1),
            "mean_stack": float(torch.stack(
                [unpack_field(state, cfg, "stacks", k).float()
                 for k in range(6)]).mean()),
            "compile_plus_run_s": time.perf_counter() - t0,
        }
        print(json.dumps(out), flush=True)
        return out

    # The first state, built once: steady-state throughput is the kernel.
    P = cfg.num_seats
    state0 = first_state(0, cfg, args.tables, dev)

    def once(seed):
        t0 = time.perf_counter()
        out = run_perpetual_prng(seed, state0, P, args.steps,
                                 cfg.small_blind, cfg.big_blind,
                                 rules=cfg.rules)
        hands = int(unpack_field(out, cfg, "hand_ct").sum())
        dt = time.perf_counter() - t0
        ovf = int(unpack_field(out, cfg, "overflow").sum())
        assert ovf == 0, f"{ovf} tables latched street overflow"
        return dt, hands

    once(0)  # warm-up
    dt, hands = min(once(i + 1) for i in range(3))
    out = {
        "mode": "kernel_perpetual", "rules": args.rules,
        "tables": args.tables, "steps": args.steps,
        "hands_completed": hands,
        "steps_per_hand": args.tables * args.steps / max(hands, 1),
        "hands_per_sec": hands / dt,
        "ns_per_table_step": dt / (args.tables * args.steps) * 1e9,
        "seconds": dt,
    }
    print(json.dumps(out), flush=True)
    log_peak_memory(dev, "bench_kernel_engine")
    return out


if __name__ == "__main__":
    main()
