"""Secondary benchmark: random-policy self-play hands/s on the plain engine
(``rollout/selfplay.play_hands``, one hand a table, 6 seats, the default
L = 12 / PL = 24, overflow flags kept): the port of
``scripts/bench_selfplay.py``. Plain PyTorch on the card, no kernel (XLA in
the JAX package).

One warm-up run (seed 1), then one timed run (seed 2) on the host clock,
the sum of the action counters read to the host being the sync.

    python -m montecarlo_tpu_torch.scripts.bench_selfplay [--tables N]
        [--device cpu]

Prints one JSON line (not the headline metric: that is ``bench.py``'s); on
the card, its peak device memory on stderr.
"""

from __future__ import annotations

import argparse
import json
import time

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.rollout.selfplay import play_hands
from montecarlo_tpu_torch.scripts._timing import log_peak_memory


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=1 << 20)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = TableConfig(num_seats=6)
    n = args.tables
    final = play_hands(1, cfg, n, num_hands=1, device=dev)
    _ = int(final.time.sum())  # warm-up + host sync

    t0 = time.perf_counter()
    final = play_hands(2, cfg, n, num_hands=1, device=dev)
    done = float(final.hand_over.float().mean())
    actions = int(final.time.sum())
    dt = time.perf_counter() - t0

    out = {
        "metric": "selfplay_full_hands_per_sec",
        "value": n / dt,
        "unit": "hands/s",
        "tables": n,
        "completed_frac": done,
        "actions_per_sec": actions / dt,
        "seconds": dt,
    }
    print(json.dumps(out))
    log_peak_memory(dev, "bench_selfplay")
    return out


if __name__ == "__main__":
    main()
