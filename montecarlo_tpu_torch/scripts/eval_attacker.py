"""Full-game evaluation of a NET attacker against a subject artifact.

The port of ``scripts/eval_attacker.py``: the attacker's bb/hand at seat 0
against P-1 copies of the subject, button rotating, on a fresh evaluation
seed, on the league kernel (B7). The quantity and geometry of the other
exploitability families (``exploit_probe``, ``opt_bot``, ``train_br``).

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.eval_attacker \\
        --attacker data/br_solver_vs_es7.npz \\
        --subject es7=data/policy_6max_es7.npz --save OUT.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.ops.cuda_net import (
    initial_packed_state,
    selfplay_net_league,
)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--attacker", required=True, help="attacker .npz")
    ap.add_argument("--subject", required=True, help="name=artifact.npz")
    ap.add_argument("--family", default="solver_br")
    ap.add_argument("--tables", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=733)
    ap.add_argument("--seats", type=int, default=6)
    ap.add_argument("--save", required=True)
    return ap


def main(argv=None, device=None):
    """Print and save the JAX script's result; return it."""
    args = parser().parse_args(argv)
    name, path = args.subject.split("=", 1)
    cfg = TableConfig(num_seats=args.seats, rules="standard",
                      bets_impl="levels")
    P = cfg.num_seats
    attacker = load_params(args.attacker)
    subject = load_params(path)

    t0 = time.perf_counter()
    state0 = initial_packed_state(args.seed, cfg, args.tables,
                                  resolve(device))
    m, e, h = selfplay_net_league(
        args.seed, cfg, [attacker, subject], (0,) + (1,) * (P - 1),
        n_tables=args.tables, n_steps=args.steps, state0=state0)
    out = {
        "opponent": name, "artifact": path,
        "attacker_artifact": args.attacker, "family": args.family,
        f"{args.family}_bb_per_hand": round(float(m[0]), 4),
        "stderr": round(float(e[0]), 4),
        "subject_seats_mean_bb": round(float(np.mean(m[1:])), 4),
        "hands": int(h), "tables": args.tables, "steps": args.steps,
        "seed": args.seed, "rules": cfg.rules,
        "elapsed_s": round(time.perf_counter() - t0, 1),
    }
    print(json.dumps(out), flush=True)
    with open(args.save, "w") as f:
        json.dump(out, f, indent=1)
    print(f"saved {args.save}")
    return out


if __name__ == "__main__":
    main()
