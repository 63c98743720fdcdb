"""Net-vs-net head-to-head on the league kernel (B7).

The port of ``scripts/league_eval.py``. Seats alternate A, B, A, B, ...;
the button rotates, so each net cycles through every position, and the
per-seat bb/hand (the kernel's meters) gives the paired comparison. It
first checks the banked kernel: a league whose banks are all the same net
reproduces the single-net kernel (K6, every seat the net) exactly, on the
same first state and words.

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.league_eval \\
        --a data/policy_6max_es9.npz --b data/policy_6max_es8.npz
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.ops.cuda_net import (
    initial_packed_state,
    selfplay_net_eval_kernel,
    selfplay_net_league,
)

# The self-check's size (the JAX script's).
SELFCHECK_TABLES, SELFCHECK_STEPS = 4096, 256


def selfcheck(seed, cfg, params, device=None):
    """Two identical banks at alternate seats (B7) against the single net
    at every seat (K6) from one first state -> (exact, hands of each)."""
    P = cfg.num_seats
    parity = tuple(k % 2 for k in range(P))
    state0 = initial_packed_state(seed, cfg, SELFCHECK_TABLES,
                                  resolve(device))
    m1, _, h1 = selfplay_net_eval_kernel(
        seed, cfg, params, net_seats=(1 << P) - 1,
        n_tables=SELFCHECK_TABLES, n_steps=SELFCHECK_STEPS, state0=state0)
    m2, _, h2 = selfplay_net_league(
        seed, cfg, [params, params], parity, n_tables=SELFCHECK_TABLES,
        n_steps=SELFCHECK_STEPS, state0=state0)
    return bool(np.all(m1 == m2) and h1 == h2), [h1, h2]


def league(seed, cfg, pa, pb, n_tables, n_steps, names=("A", "B"),
           device=None):
    """A at the even seats, B at the odd ones (B7) -> the JAX script's
    result, ``names`` under its "A" and "B" keys."""
    P = cfg.num_seats
    parity = tuple(k % 2 for k in range(P))
    m, e, h = selfplay_net_league(seed, cfg, [pa, pb], parity,
                                  n_tables=n_tables, n_steps=n_steps,
                                  device=resolve(device))
    a_seats = [k for k in range(P) if k % 2 == 0]
    b_seats = [k for k in range(P) if k % 2 == 1]
    a_bb = float(np.mean([m[k] for k in a_seats]))
    b_bb = float(np.mean([m[k] for k in b_seats]))
    a_err = float(np.sqrt(np.mean([e[k] ** 2 for k in a_seats])
                          / len(a_seats)))
    b_err = float(np.sqrt(np.mean([e[k] ** 2 for k in b_seats])
                          / len(b_seats)))
    return {
        "per_seat_bb_per_hand": [round(float(x), 4) for x in m],
        "per_seat_stderr": [round(float(x), 4) for x in e],
        "hands": h,
        "A": names[0], "B": names[1],
        "A_mean_bb": round(a_bb, 4), "A_stderr": round(a_err, 4),
        "B_mean_bb": round(b_bb, 4), "B_stderr": round(b_err, 4),
        "edge_A_minus_B": round(a_bb - b_bb, 4),
    }


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", default="data/policy_6max_es2.npz")
    ap.add_argument("--b", default="data/policy_6max_200.npz")
    ap.add_argument("--tables", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=2718)
    ap.add_argument("--skip-selfcheck", action="store_true")
    return ap


def main(argv=None, device=None):
    """Print the JAX script's JSON lines; return the league's result (the
    self-check's under ``"selfcheck_exact"``/``"selfcheck_hands"``).
    Exits 1 when the self-check fails, as the JAX script does."""
    args = parser().parse_args(argv)
    cfg = TableConfig(num_seats=6, rules="standard")
    pa, pb = load_params(args.a), load_params(args.b)
    check = {}
    if not args.skip_selfcheck:
        exact, hands = selfcheck(args.seed, cfg, pb, device)
        print(json.dumps({"selfcheck_exact": exact, "hands": hands}),
              flush=True)
        if not exact:
            sys.exit(1)
        check = {"selfcheck_exact": exact, "selfcheck_hands": hands}
    res = league(args.seed + 1, cfg, pa, pb, args.tables, args.steps,
                 (args.a, args.b), device)
    print(json.dumps(res), flush=True)
    return {**res, **check}


if __name__ == "__main__":
    main()
