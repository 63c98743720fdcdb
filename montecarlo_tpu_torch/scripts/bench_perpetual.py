"""Perpetual-table throughput against the one-hand loop: the port of
``scripts/bench_perpetual.py``.

``play_hands`` pays a loop of up to ``hand_action_bound`` (72 for 6-max)
``step_action`` steps a hand; a perpetual scan of ``clamp_action`` +
``step_table`` (settle and redeal inside the step) completes a hand every
~E[actions] steps on every table, at a higher price a step. This prints
both, and the steps a hand. Plain PyTorch on the card, no kernel (XLA in
the JAX package). The perpetual scan is ``rollout/selfplay.
play_hands_perpetual``'s loop (the random policy on ``SUB_PERPETUAL``
words, ``street_raises`` reset at each street and hand); the port's
``play_hands`` steps only the tables whose hand is on and stops when none
is (``STOP_EVERY``), where the JAX loop runs all 72 steps. Each mode: one
warm-up, then the best of 3 on the host clock, a hand count's read to the
host being the sync.

    python -m montecarlo_tpu_torch.scripts.bench_perpetual [--tables N]
        [--steps S] [--device cpu]

Prints one JSON line a mode; on the card, its peak device memory on
stderr.
"""

from __future__ import annotations

import argparse
import json
import time

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.rollout.selfplay import (
    hand_action_bound,
    play_hands,
    play_hands_perpetual,
)
from montecarlo_tpu_torch.scripts._timing import log_peak_memory


def perpetual_scan(seed, cfg, n_tables: int, n_steps: int, device=None):
    """``n_steps`` of random-policy ``clamp_action`` + ``step_table`` on
    ``n_tables`` tables of ``init_state(seed)``: the final states."""
    return play_hands_perpetual(seed, cfg, n_tables, n_steps,
                                device=device)[0]


def main(argv=None, device=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = TableConfig(num_seats=6)
    n = args.tables

    # Perpetual scan.
    def run_perp(seed):
        t0 = time.perf_counter()
        final = perpetual_scan(seed, cfg, n, args.steps, dev)
        hands = int(final.hand_idx.sum())
        return time.perf_counter() - t0, hands

    run_perp(0)
    dt, hands = min(run_perp(i + 1) for i in range(3))
    steps_total = n * args.steps
    perp = {
        "mode": "perpetual_step_table",
        "tables": n, "steps": args.steps,
        "hands_completed": hands,
        "steps_per_hand": steps_total / max(hands, 1),
        "hands_per_sec": hands / dt,
        "table_steps_per_sec": steps_total / dt,
        "seconds": dt,
    }
    print(json.dumps(perp), flush=True)

    # Reference: the one-hand loop of play_hands.
    bound = hand_action_bound(cfg)

    def run_ph(seed):
        t0 = time.perf_counter()
        final = play_hands(seed, cfg, n, num_hands=1, device=dev)
        done = int(final.time.sum())
        assert done > 0
        return time.perf_counter() - t0

    run_ph(0)
    dt2 = min(run_ph(i + 1) for i in range(3))
    one = {
        "mode": f"play_hands(num_hands=1, up to {bound} steps)",
        "tables": n,
        "hands_per_sec": n / dt2,
        "table_steps_per_sec": n * bound / dt2,
        "seconds": dt2,
    }
    print(json.dumps(one), flush=True)
    log_peak_memory(dev, "bench_perpetual")
    return [perp, one]


if __name__ == "__main__":
    main()
