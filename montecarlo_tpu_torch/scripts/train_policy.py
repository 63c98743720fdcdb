"""Train a policy network by REINFORCE self-play and measure its edge.

The port of ``scripts/train_policy.py``: ``models/train.train_policy``
against the random policy on the plain table engine, then the edges of the
trained and the untrained net against random play: a duplicate match
(``rollout/evaluate.duplicate_match``) heads-up, else the net pinned to
seat 0 against random seats over 8 hands.

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.train_policy --steps 300 \\
        --tables 4096 [--save OUT.npz]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import (
    init_params,
    net_policy,
    save_params,
)
from montecarlo_tpu_torch.models.train import train_policy
from montecarlo_tpu_torch.rollout.evaluate import (
    duplicate_match,
    per_seat_deltas,
)
from montecarlo_tpu_torch.rollout.policy import (
    pinned_seat_policies,
    random_policy,
)
from montecarlo_tpu_torch.rollout.selfplay import hand_action_bound, play_hands

# The evaluations' tables (the JAX script's): a duplicate match heads-up,
# the pinned-seat run otherwise.
DUP_TABLES = 8192
SEAT_TABLES = 4096
EVAL_SEED = 9


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tables", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seats", type=int, default=2)
    ap.add_argument("--save", type=str, default="")
    return ap


def main(argv=None, device=None):
    """Train and evaluate; print the JAX script's lines. Returns the
    reward history, the seconds and each net's (edge, stderr)."""
    args = parser().parse_args(argv)
    dev = resolve(device)
    cfg = TableConfig(num_seats=args.seats, rules="standard",
                      bets_impl="levels")
    t0 = time.perf_counter()
    out = train_policy(0, cfg=cfg, opponent=random_policy,
                       tables=args.tables, steps=args.steps, lr=args.lr,
                       max_steps=hand_action_bound(cfg), device=dev)
    hist = out.mean_reward_bb.numpy()
    dt = time.perf_counter() - t0
    hands = args.steps * args.tables
    print(f"trained {args.steps} updates x {args.tables} hands "
          f"({hands:,} hands) in {dt:.1f}s ({hands / dt:,.0f} hands/s)")
    print(f"reward bb/hand: first10={hist[:10].mean():+.3f} "
          f"last10={hist[-10:].mean():+.3f}")

    edges = {}
    for name, params in [("untrained",
                          init_params(torch.Generator().manual_seed(0))),
                         ("trained", out.params)]:
        if args.seats == 2:
            r = duplicate_match(EVAL_SEED, net_policy(params),
                                random_policy, n_tables=DUP_TABLES, cfg=cfg,
                                device=dev)
            lo, hi = r.ci95
            edges[name] = (r.bb_per_hand, r.stderr)
            print(f"{name:9s} vs random: {r.bb_per_hand:+.3f} bb/hand "
                  f"95% CI [{lo:+.3f}, {hi:+.3f}]")
        else:
            # multiway: the net pinned to seat 0 against randoms, the mean
            # seat delta over 8 hands in bb/hand
            pol = pinned_seat_policies(
                [net_policy(params)] + [random_policy] * (args.seats - 1))
            _, d = play_hands(EVAL_SEED, cfg, SEAT_TABLES, num_hands=8,
                              policy=pol, collect_deltas=True, device=dev)
            bb = per_seat_deltas(d.cpu().numpy())[:, :, 0].mean(axis=1) \
                / cfg.big_blind
            se = bb.std(ddof=1) / np.sqrt(bb.shape[0])
            edges[name] = (float(bb.mean()), float(se))
            print(f"{name:9s} seat-0 vs {args.seats - 1} randoms: "
                  f"{bb.mean():+.3f} bb/hand +/- {1.96 * se:.3f}")

    if args.save:
        save_params(args.save, out.params)
        print(f"saved {args.save}")
    return {"history": hist, "seconds": dt, "edges": edges,
            "params": out.params}


if __name__ == "__main__":
    main()
