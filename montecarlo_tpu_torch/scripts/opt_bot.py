"""Adaptive rule-bot exploitability: CMA-ES over the linear-bot family.

The port of ``scripts/opt_bot.py``. CMA-ES (``models/cma.py``) searches the
continuous rule families, ``vector_bot(score_vec, threshold, hi, lo)``
(every linear decision rule over the policy features, per discrete
(hi, lo) pair, NUM_FEATURES + 1 dims) and ``ladder_bot(score1, t1,
score2, t2, top, mid, bot)`` (per action triple, twice that), maximizing
the bot's seat-0 bb/hand against five copies of the subject net: one
population launch of the league kernel (B8 with two banks,
``selfplay_net_league_pop``) per CMA generation. A ``--pairs`` entry with
two fields (``3:0``) selects the linear family, three (``3:1:0``) the
ladder family.

Protocol (winner's-curse-safe): per-generation fitness on a fresh seed
(common random numbers across candidates by construction); the running
answer is the CMA mean evaluated on a FIXED holdout seed every
``--holdout-every`` generations (B7, ``selfplay_net_league``); the
reported number is a large fresh-seed evaluation of the best-by-holdout
bot.

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.opt_bot \\
        --subjects es9=data/policy_6max_es9.npz --pairs 3:0 --save OUT.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.bots import _HOLE, ladder_bot, vector_bot
from montecarlo_tpu_torch.models.cma import CMAES
from montecarlo_tpu_torch.models.features import NUM_FEATURES
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.ops.cuda_net import (
    initial_packed_state,
    selfplay_net_league,
    selfplay_net_league_pop,
)

HOLDOUT = 777
FINAL_SEED = 991

# jam_loose's hole-strength score as a warm start for jam-family pairs
# (models/bots.py _HOLE): indices 16/17 hole ranks, 19 paired, 18 suited.
_HOLE_VEC = np.zeros(NUM_FEATURES, np.float32)
for _i, _w in _HOLE.items():
    _HOLE_VEC[_i] = _w
_JAM_X0 = np.concatenate([_HOLE_VEC, [0.85]])  # [score, threshold]
# nit_ladder-style warm start for ladder triples: hole score for both
# rules, thresholds 1.15 (top) / 0.95 (mid).
_LADDER_X0 = np.concatenate([_HOLE_VEC, [1.15], _HOLE_VEC, [0.95]])
BOUND = 3.0  # the CMA box, per coordinate


def spec_dim(acts) -> int:
    """Search-space dimension: linear pair 25, ladder triple 50."""
    return (NUM_FEATURES + 1) * (len(acts) - 1)


def _norm_rule(v, t):
    """Scale (score, threshold) jointly into ladder_bot's safe range
    (|slope*(s-t)| <= 32 for |features| <= 2, ``models/bots.py``). The
    decision s > t is scale-invariant; only the mixing band widens."""
    c = max(1.0, (2.0 * float(np.abs(v).sum()) + abs(t)) / 4.0)
    return v / c, t / c


def make_bot(x, acts):
    """A CMA vector -> the bot's ``MLPParams``. A vector from an older,
    shorter feature set gets each rule's score zero-padded: features are
    only appended (``models/features.py``), so the rule is unchanged."""
    x = np.asarray(x, np.float32)
    n_rules = len(acts) - 1
    old_nf = len(x) // n_rules - 1
    if old_nf < NUM_FEATURES:
        if len(x) != n_rules * (old_nf + 1):
            raise ValueError(f"vector of {len(x)} values for acts {acts}")
        rules = x.reshape(n_rules, old_nf + 1)
        pad = np.zeros((n_rules, NUM_FEATURES - old_nf), np.float32)
        x = np.concatenate(
            [rules[:, :old_nf], pad, rules[:, old_nf:]], axis=1).reshape(-1)
    if len(acts) == 2:
        return vector_bot(x[:NUM_FEATURES], float(x[NUM_FEATURES]),
                          acts[0], acts[1])
    k = NUM_FEATURES + 1
    v1, t1 = _norm_rule(x[:NUM_FEATURES], float(x[NUM_FEATURES]))
    v2, t2 = _norm_rule(x[k:k + NUM_FEATURES], float(x[k + NUM_FEATURES]))
    return ladder_bot(v1, t1, v2, t2, top=acts[0], mid=acts[1], bot=acts[2])


def _x0(acts):
    """The warm start of an action spec."""
    if len(acts) == 3:
        return _LADDER_X0
    if tuple(acts) == (3, 0):
        return _JAM_X0
    return np.zeros(spec_dim(acts))


def _cma(x0, sigma0, popsize, seed, acts):
    return CMAES(np.asarray(x0, np.float64), sigma0=sigma0, popsize=popsize,
                 seed=seed, lower=np.full(spec_dim(acts), -BOUND),
                 upper=np.full(spec_dim(acts), BOUND))


def quick_attack(subject, cfg, acts=(3, 0), generations=10, popsize=16,
                 tables=1 << 12, steps=256, seed=23, sigma0=0.5, x0=None,
                 device=None):
    """A short CMA attack for probing inside a training loop
    (``train_es_kernel.py --adapt-every``).

    Returns ``(x, bot_params, attacker_bb)``, ``attacker_bb`` one league
    evaluation of the CMA mean on a seed the optimizer never saw. ``x0``
    warm-starts from the previous refresh's solution."""
    dev = resolve(device)
    stb = (0,) + (1,) * (cfg.num_seats - 1)
    es = _cma(_x0(acts) if x0 is None else x0, sigma0, popsize, seed, acts)
    for g in range(generations):
        seed_g = seed * 1_000_003 + g
        state0 = initial_packed_state(seed_g, cfg, tables, dev)
        bots = [make_bot(x, acts) for x in es.ask()]
        m, _, _ = selfplay_net_league_pop(
            seed_g, cfg, bots, subject, n_tables=tables, n_steps=steps,
            seat_to_bank=stb, state0=state0)
        es.tell(np.asarray(m)[:, 0])
    x = es.mean.copy()
    bot = make_bot(x, acts)
    m, _, _ = selfplay_net_league(
        seed * 7919 + 991, cfg, [bot, subject], stb, n_tables=tables * 2,
        n_steps=steps, device=dev)
    return x, bot, float(m[0])


def pair_key(acts) -> int:
    """A pair's seed offset; the arity term keeps (3, 1) and (3, 1, 0) on
    distinct seed streams."""
    return 1000 * len(acts) + sum(13 ** i * a for i, a in enumerate(acts))


def final_eval(subject, cfg, x, acts, eval_tables, eval_steps, device=None):
    """The honest final number: the bot of ``x`` at seat 0 against the
    subject on ``FINAL_SEED`` -> (bb/hand, stderr, hands)."""
    stb = (0,) + (1,) * (cfg.num_seats - 1)
    final_state = initial_packed_state(FINAL_SEED, cfg, eval_tables,
                                       resolve(device))
    m, e, h = selfplay_net_league(
        FINAL_SEED, cfg, [make_bot(x, acts), subject], stb,
        n_tables=eval_tables, n_steps=eval_steps, state0=final_state)
    return float(m[0]), float(e[0]), int(h)


def optimize_pair(subject, cfg, acts, args, log, device=None):
    dev = resolve(device)
    stb = (0,) + (1,) * (cfg.num_seats - 1)
    pair_tag = ":".join(str(a) for a in acts)
    key = pair_key(acts)
    x0 = _x0(acts)
    es = _cma(x0, args.sigma0, args.popsize, args.seed + key, acts)
    holdout_state = initial_packed_state(HOLDOUT, cfg, args.eval_tables, dev)

    def holdout_eval(x):
        m, e, _ = selfplay_net_league(
            HOLDOUT, cfg, [make_bot(x, acts), subject], stb,
            n_tables=args.eval_tables, n_steps=args.eval_steps,
            state0=holdout_state)
        return float(m[0]), float(e[0])

    best_x, best_hold = x0, -np.inf
    t0 = time.perf_counter()
    for g in range(args.generations):
        seed_g = args.seed * 1_000_003 + 7919 * key + g
        state0 = initial_packed_state(seed_g, cfg, args.tables, dev)
        bots = [make_bot(x, acts) for x in es.ask()]
        m, _, _ = selfplay_net_league_pop(
            seed_g, cfg, bots, subject, n_tables=args.tables,
            n_steps=args.steps, seat_to_bank=stb, state0=state0)
        fits = np.asarray(m)[:, 0]
        es.tell(fits)
        row = {"pair": pair_tag, "gen": g,
               "gen_best_bb": round(float(fits.max()), 4),
               "gen_mean_bb": round(float(fits.mean()), 4)}
        if g % args.holdout_every == args.holdout_every - 1 \
                or g == args.generations - 1:
            hb, _ = holdout_eval(es.mean)
            if hb > best_hold:
                best_hold, best_x = hb, es.mean.copy()
            row.update({"holdout_mean_bb": round(hb, 4),
                        "cma_sigma": round(es.sigma, 4)})
        row["elapsed_s"] = round(time.perf_counter() - t0, 1)
        log(row)

    bb, se, h = final_eval(subject, cfg, best_x, acts, args.eval_tables,
                           args.eval_steps, dev)
    return {"bot_bb_per_hand": round(bb, 4), "stderr": round(se, 4),
            "hands": h, "holdout_bb": round(best_hold, 4),
            "x": [round(float(v), 4) for v in best_x]}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subjects", nargs="+", default=[
        "es3=data/policy_6max_es3.npz"], help="name=artifact.npz")
    ap.add_argument("--pairs", default="3:0,1:0,3:1:0,3:1",
                    help="comma-separated action specs: hi:lo (linear "
                         "family) or top:mid:bot (ladder family)")
    ap.add_argument("--generations", type=int, default=50)
    ap.add_argument("--popsize", type=int, default=24)
    ap.add_argument("--sigma0", type=float, default=0.5)
    ap.add_argument("--tables", type=int, default=1 << 14)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--eval-tables", type=int, default=1 << 16)
    ap.add_argument("--eval-steps", type=int, default=512)
    ap.add_argument("--holdout-every", type=int, default=10)
    ap.add_argument("--seats", type=int, default=6)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--save", required=True,
                    help="output JSON (not in data/: its files are the "
                         "reference)")
    return ap


def main(argv=None, device=None):
    """Run the optimizer; print JSON lines as the JAX script does and
    return the saved document."""
    args = parser().parse_args(argv)
    cfg = TableConfig(num_seats=args.seats, rules="standard")
    pairs = [tuple(int(v) for v in p.split(":"))
             for p in args.pairs.split(",")]

    def log(d):
        print(json.dumps(d), flush=True)

    out = {"tables": args.tables, "steps": args.steps,
           "generations": args.generations, "popsize": args.popsize,
           "seats": args.seats, "rules": cfg.rules, "subjects": {}}

    def save():
        with open(args.save, "w") as f:
            json.dump(out, f, indent=1)

    for spec in args.subjects:
        name, path = spec.split("=", 1)
        subject = load_params(path)
        rows = {}
        out["subjects"][name] = {"artifact": path, "per_pair": rows}
        for acts in pairs:
            tag = ":".join(str(a) for a in acts)
            log({"subject": name, "start_pair": tag})
            rows[tag] = optimize_pair(subject, cfg, acts, args, log, device)
            log({"subject": name, "pair": tag,
                 **{k: v for k, v in rows[tag].items() if k != "x"}})
            best = max(rows, key=lambda k: rows[k]["bot_bb_per_hand"])
            out["subjects"][name].update(
                adaptive_bot_lb_bb=rows[best]["bot_bb_per_hand"],
                best_pair=best)
            save()  # partial results survive an interrupted run
        log({"subject": name,
             "best_pair": out["subjects"][name]["best_pair"],
             "adaptive_bot_lb_bb":
                 out["subjects"][name]["adaptive_bot_lb_bb"]})
    print(f"saved {args.save}")
    return out


if __name__ == "__main__":
    main()
