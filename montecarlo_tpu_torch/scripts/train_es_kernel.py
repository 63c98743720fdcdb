"""ES fine-tuning of the 6-max policy on the net kernels.

The port of ``scripts/train_es_kernel.py``. Starts from an artifact
(``--start``), evaluates every perturbed candidate with the kernels'
seat meters (``models/train_es.py``: B8, one launch a generation; K6 one
launch a candidate with ``--per-candidate``; B8 with two banks against
``--opponent``; a pool of opponents with ``--opponents``), ascends the
antithetic ES direction, then reports a final evaluation of start against
trained on a fresh seed (K6 against random seats, B7 against a net).

Options as the JAX script's: the fold leash (``--fold-anchor``,
``models/leash.py``), adaptive attacker slots refreshed by a short CMA
attack (``adaptive:T-M[-B]`` with ``--adapt-every``,
``opt_bot.quick_attack``), checkpoints beside ``--save`` and
``--resume``. The perturbations come from a ``torch.Generator``
(``train_es``), so they differ from the JAX package's draws.

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.train_es_kernel \\
        --start data/policy_6max_200.npz --opponents random,bot:jam_loose \\
        --fold-anchor data/fold_anchor.npz --save OUT.npz
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.bots import panel
from montecarlo_tpu_torch.models.leash import make_anchor_score
from montecarlo_tpu_torch.models.policy_net import load_params, save_params
from montecarlo_tpu_torch.models.train_es import (
    kernel_eval_fn,
    kernel_eval_pop_fn,
    kernel_league_eval_pop_fn,
    kernel_pool_eval_pop_fn,
    layer_mask,
    train_es,
)
from montecarlo_tpu_torch.ops.cuda_net import (
    selfplay_net_eval_kernel,
    selfplay_net_league,
)
from montecarlo_tpu_torch.scripts.opt_bot import make_bot, quick_attack

# Center quality on a FIXED holdout seed (common random numbers across the
# run); the final evaluation's seed; the tables of both (the JAX script's).
HOLDOUT = 777
FINAL_SEED = 991
EVAL_TABLES = 1 << 16
EVAL_STEPS = 256


def resolve_opponent(spec):
    """One ``--opponents`` pool entry -> (tag, params_or_None, geometry).

    "NAME@lone" = the opponent sits ALONE at seat 0 against P-1 candidate
    copies; the default geometry puts the candidate alone at seat 0. Specs:
    'random', 'bot:NAME' (the ``models/bots.py`` panel), an artifact path,
    'adaptive:T-M[-B]' (a slot refreshed during training, None until the
    first refresh at generation 0), or 'optbot:PATH.json:SUBJECT[:T-M-B]'
    (the CMA attacker of an ``opt_bot`` output, rebuilt from its vector:
    ``best_pair`` unless an action spec is given)."""
    geom = "five"
    if spec.endswith("@lone"):
        spec, geom = spec[:-5], "lone"
    if spec == "random" or spec.startswith("adaptive:"):
        return spec, None, geom
    if spec.startswith("bot:"):
        return spec, panel()[spec[4:]], geom
    if spec.startswith("optbot:"):
        parts = spec.split(":")
        path, subj = parts[1], parts[2]
        with open(path) as f:
            sub = json.load(f)["subjects"][subj]
        pair = (parts[3].replace("-", ":") if len(parts) > 3
                else sub["best_pair"])
        acts = tuple(int(v) for v in pair.split(":"))
        x = np.asarray(sub["per_pair"][pair]["x"], np.float32)
        return spec, make_bot(x, acts), geom
    return spec, load_params(spec), geom


def eval_vs(cfg, p, opp, seed, n_tables=None, geom="five", device=None):
    """(bb/hand, stderr, hands) of net ``p`` against one opponent (None =
    random seats). "five": p alone at seat 0 against P-1 opponents;
    "lone": the opponent alone at seat 0 against P-1 copies of p, reported
    as the SUM over p's seats (minus the opponent's extraction), stderr the
    fully-correlated bound (the sum of the seats' stderrs)."""
    P = cfg.num_seats
    n_tables = n_tables or EVAL_TABLES
    cand_seats = [0] if geom == "five" else list(range(1, P))
    if opp is None:
        m, e, h = selfplay_net_eval_kernel(
            seed, cfg, p, net_seats=sum(1 << k for k in cand_seats),
            n_tables=n_tables, n_steps=EVAL_STEPS, device=device)
    else:
        stb = tuple(0 if k in cand_seats else 1 for k in range(P))
        m, e, h = selfplay_net_league(
            seed, cfg, [p, opp], stb, n_tables=n_tables,
            n_steps=EVAL_STEPS, device=device)
    red = np.sum if geom == "lone" else np.mean
    return float(red(m[cand_seats])), float(red(e[cand_seats])), int(h)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--generations", type=int, default=120)
    ap.add_argument("--pop", type=int, default=8)
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--tables", type=int, default=1 << 14)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--noise-floor", type=float, default=0.003,
                    help="bb/hand spread floor for fitness "
                         "standardization")
    ap.add_argument("--start", default="data/policy_6max_200.npz")
    ap.add_argument("--mask", default="",
                    help="comma-separated MLPParams fields to perturb "
                         "(empty = all)")
    ap.add_argument("--save", required=True,
                    help="output artifact (not in data/: its files are "
                         "the reference); checkpoints go beside it")
    ap.add_argument("--opponent", default="",
                    help="artifact path: league fitness against this net "
                         "at seats 1..P-1 instead of random opponents")
    ap.add_argument("--opponents", default="",
                    help="comma-separated opponent POOL: 'random', "
                         "'bot:NAME', 'optbot:PATH.json:SUBJECT[:T-M-B]', "
                         "'adaptive:T-M[-B]' or an artifact path, each "
                         "optionally '@lone'")
    ap.add_argument("--adapt-every", type=int, default=0,
                    help="with 'adaptive:' pool slots: every N "
                         "generations, a short CMA attack on the current "
                         "center refreshes those slots")
    ap.add_argument("--adapt-gens", type=int, default=10)
    ap.add_argument("--adapt-popsize", type=int, default=16)
    ap.add_argument("--adapt-tables", type=int, default=1 << 12)
    ap.add_argument("--per-candidate", action="store_true",
                    help="one launch per candidate (K6) instead of one a "
                         "generation")
    ap.add_argument("--seats", type=int, default=6,
                    help="table size (2 = heads-up hardening runs)")
    ap.add_argument("--soften", type=float, default=0.0,
                    help="divide the start's w3,b3 by K before training "
                         "(argmax-preserving margin shrink); ignored on "
                         "--resume from a checkpoint")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <save>.ckpt.npz/<save>."
                         "progress.json if present")
    ap.add_argument("--fold-anchor", default="",
                    help="fold-preservation leash: .npz of feature rows "
                         "where the distilled net folds "
                         "(make_fold_anchor); shaped fitness = bb/hand + "
                         "lambda * mean(clipped log P(fold))")
    ap.add_argument("--fold-lambda", type=float, default=0.15,
                    help="leash weight")
    return ap


def main(argv=None, device=None):
    """Train; print the JAX script's JSON lines. Returns a summary: the
    ``ESResult`` (``"result"``), the generations run, the training
    seconds, the start's anchor score (with a leash) and the final
    evaluations."""
    args = parser().parse_args(argv)
    dev = resolve(device)
    cfg = TableConfig(num_seats=args.seats, rules="standard")
    summary = {}

    def emit(d):
        print(json.dumps(d), flush=True)

    # Durable progress: every center evaluation persists the current center
    # (<save>.ckpt.npz), the attempt's progress (<save>.progress.json) and,
    # when the holdout quality improves, the best center (<save>).
    ckpt_path = args.save + ".ckpt.npz"
    side_path = args.save + ".progress.json"
    prog = {"gens_done": 0, "best_bb": -1e30}
    start_path = args.start
    if args.resume and os.path.exists(ckpt_path) \
            and os.path.exists(side_path):
        with open(side_path) as f:
            prog.update(json.load(f))
        start_path = ckpt_path
        emit({"resumed_at_gen": prog["gens_done"],
              "best_bb": prog["best_bb"]})
    base_done = int(prog["gens_done"])
    gens_left = max(0, args.generations - base_done)
    params0 = load_params(start_path)
    if args.soften > 1.0 and start_path != ckpt_path:
        params0 = params0._replace(w3=params0.w3 / args.soften,
                                   b3=params0.b3 / args.soften)
        emit({"softened": args.soften})

    def checkpoint(g, center, best, best_quality):
        save_params(ckpt_path, center)
        if float(best_quality) > prog["best_bb"]:
            prog["best_bb"] = float(best_quality)
            save_params(args.save, best)
        prog["gens_done"] = base_done + g + 1
        with open(side_path, "w") as f:
            json.dump(prog, f)

    pool = ([resolve_opponent(s) for s in args.opponents.split(",") if s]
            if args.opponents else [])
    adapt_kw = {}
    if pool:
        # shared mutable state: the pool evaluator re-reads it every call,
        # so the adaptive hook swaps slot weights in place
        opp_entries = [(p, g) for _, p, g in pool]
        eval_kw = {"eval_pop_fn": kernel_pool_eval_pop_fn(
            cfg, opp_entries, n_tables=args.tables, n_steps=args.steps,
            device=dev)}
        adaptive = [(i, tag) for i, (tag, _p, _g) in enumerate(pool)
                    if tag.startswith("adaptive:")]
        if adaptive:
            if args.adapt_every <= 0:
                raise SystemExit("adaptive: pool slots need --adapt-every N")
            # one attack per attacker family per refresh, applied to every
            # slot of that family (their geometries differ)
            fams = {}
            for i, tag in adaptive:
                acts = tuple(int(v) for v in tag.split(":")[1].split("-"))
                fams.setdefault(acts, []).append(i)
            warm = {}

            def adapt_fn(g, center):
                for acts, slots in fams.items():
                    x, bot, bb = quick_attack(
                        center, cfg, acts, generations=args.adapt_gens,
                        popsize=args.adapt_popsize,
                        tables=args.adapt_tables, steps=args.steps,
                        seed=args.seed * 31 + 1009 * (base_done + g),
                        x0=warm.get(acts), device=dev)
                    warm[acts] = x
                    for i in slots:
                        opp_entries[i] = (bot, pool[i][2])
                    emit({"adapt_at_gen": base_done + g,
                          "pair": ":".join(str(a) for a in acts),
                          "attacker_bb": round(bb, 4), "slots": slots})

            adapt_kw = {"adapt_fn": adapt_fn,
                        "adapt_every": args.adapt_every}
    elif args.per_candidate:
        eval_kw = {"eval_fn": kernel_eval_fn(
            cfg, net_seats=1, n_tables=args.tables, n_steps=args.steps,
            device=dev)}
    elif args.opponent:
        eval_kw = {"eval_pop_fn": kernel_league_eval_pop_fn(
            cfg, load_params(args.opponent), n_tables=args.tables,
            n_steps=args.steps, device=dev)}
    else:
        eval_kw = {"eval_pop_fn": kernel_eval_pop_fn(
            cfg, net_seats=1, n_tables=args.tables, n_steps=args.steps,
            device=dev)}
    mask = layer_mask(params0, set(args.mask.split(","))) if args.mask \
        else None

    anchor_score = None
    if args.fold_anchor:
        anchor_score, anc_feats = make_anchor_score(args.fold_anchor)
        lam = args.fold_lambda
        summary["start_anchor_logp"] = anchor_score(params0)
        emit({"fold_anchor": args.fold_anchor, "rows": int(len(anc_feats)),
              "lambda": lam,
              "start_anchor_logp": round(summary["start_anchor_logp"], 4)})
        if "eval_pop_fn" in eval_kw:
            base_pop = eval_kw["eval_pop_fn"]

            def leashed_pop(params_list, eval_seed):
                f, h = base_pop(params_list, eval_seed)
                pen = np.asarray([anchor_score(p) for p in params_list])
                return np.asarray(f) + lam * pen, h

            eval_kw["eval_pop_fn"] = leashed_pop
        else:
            base_one = eval_kw["eval_fn"]

            def leashed_one(p, eval_seed):
                f, h = base_one(p, eval_seed)
                return f + lam * anchor_score(p), h

            eval_kw["eval_fn"] = leashed_one

    t0 = time.perf_counter()

    def progress(g, mean_fit, best_fit, spread):
        emit({"gen": g, "mean_bb": round(mean_fit, 4),
              "best_bb": round(best_fit, 4),
              "spread_bb": round(spread, 5),
              "elapsed_s": round(time.perf_counter() - t0, 1)})

    opponent = load_params(args.opponent) if args.opponent else None

    def center_eval(p):
        if pool:
            # adaptive slots are left out: their attacker moves between
            # refreshes, so it is no fixed holdout
            per = {f"{name}@{geom}" if geom != "five" else name:
                   eval_vs(cfg, p, opp, HOLDOUT, geom=geom, device=dev)[0]
                   for name, opp, geom in pool
                   if not name.startswith("adaptive:")}
            if not per:
                return 0.0
            mean = sum(per.values()) / len(per)
            extra = {}
            if anchor_score is not None:
                # the snapshot honours the leash too
                alp = anchor_score(p)
                extra = {"anchor_logp": round(alp, 4)}
                mean = mean + args.fold_lambda * alp
            emit({"center_bb": round(mean, 4),
                  **{f"center_{n}": round(v, 4) for n, v in per.items()},
                  **extra,
                  "elapsed_s": round(time.perf_counter() - t0, 1)})
            return mean
        bb, _, _ = eval_vs(cfg, p, opponent, HOLDOUT, device=dev)
        emit({"center_bb": round(bb, 4),
              "elapsed_s": round(time.perf_counter() - t0, 1)})
        return bb

    out = train_es(args.seed + base_done, params0, generations=gens_left,
                   pop=args.pop, sigma=args.sigma, lr=args.lr,
                   momentum=args.momentum, mask=mask, progress=progress,
                   noise_floor=args.noise_floor, center_eval_fn=center_eval,
                   checkpoint_fn=checkpoint, **eval_kw, **adapt_kw)
    dt = time.perf_counter() - t0
    emit({"training_seconds": round(dt, 1),
          "training_hands": out.hands_total,
          "training_hands_per_sec": round(out.hands_total / dt)})
    summary.update(result=out, generations=gens_left, training_seconds=dt)

    # Final: start against trained on a fresh seed, on the opponents the
    # run trained against; <save> holds the best-by-holdout center.
    es_params = load_params(args.save) if os.path.exists(args.save) \
        else out.params
    finals = []
    for name, p in (("start", params0), ("es", es_params)):
        if pool:
            rows = {}
            for oname, opp, geom in pool:
                bb, se, h = eval_vs(cfg, p, opp, FINAL_SEED, geom=geom,
                                    device=dev)
                key = f"{oname}@{geom}" if geom != "five" else oname
                rows[key] = {"bb": round(bb, 4), "stderr": round(se, 4),
                             "hands": h}
            mean = sum(r["bb"] for r in rows.values()) / len(rows)
            line = {"final_eval": name, "pool_mean_bb": round(mean, 4),
                    "per_opponent": rows}
        else:
            bb, se, h = eval_vs(cfg, p, opponent, FINAL_SEED, device=dev)
            line = {"final_eval": name, "bb_per_hand_seat0": round(bb, 4),
                    "stderr": round(se, 4), "hands": h}
        emit(line)
        finals.append(line)
    summary["final"] = finals

    if not os.path.exists(args.save):
        save_params(args.save, out.params)
    print(f"saved {args.save} (best holdout "
          f"{max(prog['best_bb'], -999.0):.4f})")
    return summary


if __name__ == "__main__":
    main()
