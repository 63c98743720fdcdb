"""Learned best response: a REINFORCE exploiter against a FROZEN artifact.

The port of ``scripts/train_br.py``. The learner plays every position
(rotating across the batch) against P-1 copies of the frozen net
(``models/train.py`` on the plain table engine, the opponent
``net_policy(frozen)``), with a holdout league evaluation on a fixed seed
every ``--eval-every`` updates (best-by-holdout kept), then the trained
exploiter's edge is measured on the league kernel (B7: seat 0 against P-1
frozen copies, button rotating, fresh seed), the probe panel's geometry.

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.train_br \\
        --opponent es9=data/policy_6max_es9.npz --save OUT.npz
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
from montecarlo_tpu_torch.ops.cuda_net import selfplay_net_league
from montecarlo_tpu_torch.scripts.train_es_kernel import resolve_opponent

HOLDOUT = 777
# The league evaluations' size (the JAX script's).
EVAL_TABLES, EVAL_STEPS = 1 << 16, 512


def league_eval(cfg, cand, frozen, seed=991, n_tables=None, n_steps=None,
                device=None):
    """``cand`` alone at seat 0 against P-1 copies of ``frozen`` (B7) ->
    (bb/hand, stderr, hands); ``EVAL_TABLES`` x ``EVAL_STEPS`` unless
    given."""
    stb = (0,) + (1,) * (cfg.num_seats - 1)
    m, e, h = selfplay_net_league(seed, cfg, [cand, frozen], stb,
                                  n_tables=n_tables or EVAL_TABLES,
                                  n_steps=n_steps or EVAL_STEPS,
                                  device=device)
    return float(m[0]), float(e[0]), int(h)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--opponent", default="es3=data/policy_6max_es3.npz",
                    help="name=artifact.npz (frozen)")
    ap.add_argument("--updates", type=int, default=300)
    ap.add_argument("--tables", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--max-steps", type=int, default=72)
    ap.add_argument("--seats", type=int, default=6)
    ap.add_argument("--seed", type=int, default=41)
    ap.add_argument("--start", default="data/policy_6max_200.npz",
                    help="learner init: artifact path, 'INIT' (random), "
                         "or 'optbot:PATH.json:SUBJECT[:T-M-B]' (a CMA "
                         "attacker warm start)")
    ap.add_argument("--soften", type=float, default=1.0,
                    help="divide the start's output layer by this "
                         "(REINFORCE needs sampling entropy)")
    ap.add_argument("--save", required=True,
                    help="output artifact (not in data/: its files are "
                         "the reference)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-every", type=int, default=50)
    return ap


def main(argv=None, device=None):
    """Train; print and save the JAX script's result. Returns it, with
    the per-update rewards (``"train_bb"``), the seconds of each update
    (``"update_seconds"``), the holdout evaluations and the count of
    training tables whose layers overflowed."""
    args = parser().parse_args(argv)
    dev = resolve(device)
    name, path = args.opponent.split("=", 1)
    frozen = load_params(path)
    cfg = TableConfig(num_seats=args.seats, rules="standard",
                      max_layers=8, max_pot_layers=16, bets_impl="levels")
    cfg_eval = TableConfig(num_seats=args.seats, rules="standard",
                           bets_impl="levels")

    side = args.save + ".progress.json"
    done = 0
    if args.resume and os.path.exists(args.save) and os.path.exists(side):
        with open(side) as f:
            done = json.load(f).get("updates_done", 0)
        params = load_params(args.save)
        print(json.dumps({"resumed_at": done}), flush=True)
    elif args.start == "INIT":
        params = init_params(torch.Generator().manual_seed(args.seed))
    elif args.start.startswith("optbot:"):
        _, params, _ = resolve_opponent(args.start)
    else:
        params = load_params(args.start)
    if args.soften != 1.0:
        params = softened(params, args.soften)

    opt_init, update = make_update_step(
        cfg, opponent=net_policy(frozen), tables=args.tables, lr=args.lr,
        max_steps=args.max_steps, device=dev)
    opt = opt_init(params)

    t0 = time.perf_counter()
    best_eval, best_params = -np.inf, params
    rewards, seconds, holdouts, overflowed = [], [], [], 0
    for i in range(done, args.updates):
        t_u = time.perf_counter()
        params, opt, mean_r, over = update(params, opt,
                                           fold_seed(args.seed, 1000 + i))
        rewards.append(mean_r)
        overflowed += over
        seconds.append(time.perf_counter() - t_u)
        if (i + 1) % 10 == 0:
            print(json.dumps({
                "update": i + 1, "train_bb": round(mean_r, 4),
                "elapsed_s": round(time.perf_counter() - t0, 1)}),
                flush=True)
        if (i + 1) % args.eval_every == 0 or i == args.updates - 1:
            # holdout league evaluation on a FIXED seed
            bb, se, _ = league_eval(cfg_eval, params, frozen, seed=HOLDOUT,
                                    device=dev)
            holdouts.append((i + 1, bb, se))
            print(json.dumps({"update": i + 1,
                              "holdout_league_bb": round(bb, 4),
                              "stderr": round(se, 4)}), flush=True)
            if bb > best_eval:
                best_eval = bb
                best_params = params
                save_params(args.save, params)
            with open(side, "w") as f:
                json.dump({"updates_done": i + 1, "best_eval": best_eval}, f)

    # the honest final number: best-by-holdout params, fresh seed
    bb, se, h = league_eval(cfg_eval, best_params, frozen, seed=991,
                            device=dev)
    out = {"opponent": name, "artifact": path,
           "learned_br_bb_per_hand": round(bb, 4),
           "stderr": round(se, 4), "hands": h,
           "updates": args.updates, "tables": args.tables,
           "train_seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out), flush=True)
    with open(args.save + ".result.json", "w") as f:
        json.dump(out, f, indent=1)
    return {**out, "train_bb": rewards, "update_seconds": seconds,
            "holdout": holdouts, "overflowed_tables": overflowed,
            "params": best_params}


if __name__ == "__main__":
    main()
