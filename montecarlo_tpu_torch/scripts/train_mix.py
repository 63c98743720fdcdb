"""Gradient hardening against a MIXED opponent pool (min-slack selection).

The port of ``scripts/train_mix.py``. REINFORCE updates
(``models/train.py``) CYCLE through the opponent pool, one update
function per opponent sharing one Adam state, so the subject trains at
once against a hole (e.g. ``bot:fof_raise``), its own frozen start
(``self``) and ``random``. Every ``--eval-every`` updates the candidate is
league-evaluated on a fixed seed against each pool entry
(``train_es_kernel.eval_vs``: K6 for random seats, B7 for a net) and
scored min_i(edge_i - floor_i); the best score
is kept (min-slack holdout selection), and the final number is a fresh
seed's evaluation of it at twice the tables.

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.train_mix --seats 2 \\
        --start data/policy_hu_300.npz \\
        --opponents 'bot:fof_raise%0,self%-0.03,random%1.8' --save OUT.npz
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import (
    init_params,
    load_params,
    net_policy,
    save_params,
    softened,
)
from montecarlo_tpu_torch.models.train import fold_seed, make_update_step
from montecarlo_tpu_torch.rollout.policy import random_policy
from montecarlo_tpu_torch.scripts.train_es_kernel import (
    eval_vs,
    resolve_opponent,
)

HOLDOUT = 777
FINAL_SEED = 991


def parse_pool(spec_csv, start_params):
    """'spec[%floor],...' -> [(name, params_or_None, floor)].

    params None = random seats (the kernel's random policy in evaluations,
    ``rollout/policy.random_policy`` in updates). 'self' = the start
    params, frozen. Other specs go through
    ``train_es_kernel.resolve_opponent``."""
    pool = []
    for item in spec_csv.split(","):
        item = item.strip()
        floor = 0.0
        if "%" in item:
            item, f = item.rsplit("%", 1)
            floor = float(f)
        if item == "self":
            pool.append(("self", start_params, floor))
        else:
            tag, params, _geom = resolve_opponent(item)
            pool.append((tag, params, floor))
    return pool


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seats", type=int, default=2)
    ap.add_argument("--start", default="data/policy_hu_300.npz")
    ap.add_argument("--opponents",
                    default="bot:fof_raise%0,self%-0.03,random%1.8")
    ap.add_argument("--updates", type=int, default=300)
    ap.add_argument("--tables", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-steps", type=int, default=48)
    ap.add_argument("--seed", type=int, default=59)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--eval-tables", type=int, default=1 << 16)
    ap.add_argument("--save", required=True,
                    help="output artifact (not in data/: its files are "
                         "the reference)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --save + its .progress.json")
    ap.add_argument("--soften", type=float, default=0.0,
                    help="divide the START's w3,b3 by K before training "
                         "(argmax-preserving margin shrink); the 'self' "
                         "anchor stays the original params")
    return ap


def main(argv=None, device=None):
    """Train; print and save the JAX script's result; return it."""
    args = parser().parse_args(argv)
    dev = resolve(device)
    cfg = TableConfig(num_seats=args.seats, rules="standard",
                      max_layers=8, max_pot_layers=16, bets_impl="levels")
    cfg_eval = TableConfig(num_seats=args.seats, rules="standard",
                           bets_impl="levels")

    start = (init_params(torch.Generator().manual_seed(args.seed))
             if args.start == "INIT" else load_params(args.start))
    pool = parse_pool(args.opponents, start)  # 'self' = the original
    if args.soften > 1.0:
        start = softened(start, args.soften)
        print(json.dumps({"softened": args.soften}), flush=True)

    def score(p, seed, n_tables):
        """min over the pool of (p alone at seat 0 against opp) - floor."""
        per, slack = {}, np.inf
        for name, opp, floor in pool:
            per[name] = eval_vs(cfg_eval, p, opp, seed, n_tables,
                                device=dev)[:2]
            slack = min(slack, per[name][0] - floor)
        return slack, per

    # one update function per pool entry; they share one Adam state, so
    # the moments carry across opponents
    updates, opt_init = [], None
    for name, opp, _floor in pool:
        policy = random_policy if opp is None else net_policy(opp)
        opt_init, upd = make_update_step(
            cfg, opponent=policy, tables=args.tables, lr=args.lr,
            max_steps=args.max_steps, device=dev)
        updates.append((name, upd))

    side = args.save + ".progress.json"
    done = 0
    params = start
    if args.resume and os.path.exists(args.save) and os.path.exists(side):
        with open(side) as f:
            done = json.load(f).get("updates_done", 0)
        params = load_params(args.save)
        print(json.dumps({"resumed_at": done}), flush=True)

    opt = opt_init(params)
    t0 = time.perf_counter()
    s0, per0 = score(start, HOLDOUT, args.eval_tables)
    print(json.dumps({"start_slack_bb": round(s0, 4),
                      **{f"start_{n}": round(v[0], 4)
                         for n, v in per0.items()}}), flush=True)
    best_slack, best_params = s0, start

    for i in range(done, args.updates):
        name, upd = updates[i % len(updates)]
        params, opt, mean_r, _ = upd(params, opt,
                                     fold_seed(args.seed, 1000 + i))
        if (i + 1) % 10 == 0:
            print(json.dumps({
                "update": i + 1, "opp": name, "train_bb": round(mean_r, 4),
                "elapsed_s": round(time.perf_counter() - t0, 1)}),
                flush=True)
        if (i + 1) % args.eval_every == 0 or i == args.updates - 1:
            slack, per = score(params, HOLDOUT, args.eval_tables)
            print(json.dumps({
                "update": i + 1, "holdout_slack_bb": round(slack, 4),
                **{f"holdout_{n}": round(v[0], 4)
                   for n, v in per.items()}}), flush=True)
            if slack > best_slack:
                best_slack, best_params = slack, params
                save_params(args.save, params)
            with open(side, "w") as f:
                json.dump({"updates_done": i + 1,
                           "best_slack": round(best_slack, 4)}, f)

    # the honest final number: best-by-holdout params, fresh seed
    slack, per = score(best_params, FINAL_SEED, args.eval_tables * 2)
    out = {"start": args.start, "opponents": args.opponents,
           "final_slack_bb": round(slack, 4),
           "per_opponent": {n: {"bb": round(v[0], 4),
                                "stderr": round(v[1], 4)}
                            for n, v in per.items()},
           "updates": args.updates, "tables": args.tables,
           "train_seconds": round(time.perf_counter() - t0, 1),
           "improved_over_start": bool(best_slack > s0)}
    print(json.dumps(out), flush=True)
    save_params(args.save, best_params)
    with open(args.save + ".result.json", "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
