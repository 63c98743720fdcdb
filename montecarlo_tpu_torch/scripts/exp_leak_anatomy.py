"""Why does every 6-max artifact leak ~1.2 bb/hand to fold-capable rule
bots? The port of ``scripts/exp_leak_anatomy.py``.

Two diagnostics on the plain table engine:

1. margin freeze: collect the subject's decision points from perpetual
   self-play (``collect``), then measure the logit-margin distribution
   (top1 - top2 of the masked logits), the fraction of decisions an ES
   perturbation at the production recipe flips (sigma 0.05 on w2, b2, w3,
   b3) and the sampling stochasticity;
2. attacker anatomy: decode the winning CMA vectors of an ``opt_bot``
   output into named-feature weights, and replay subject against attacker
   for per-street action histograms of both sides.

``collect`` is the port's; the statistics below it are the JAX module's
numpy functions, copied (``FEATURE_NAMES`` .. ``decode_attacker``), so on
the same records they give the same numbers. The JAX ``collect`` also
carries a count of the street's raises that nothing reads; the port
leaves it out.

Run from the repository root (the card by default):
    python -m montecarlo_tpu_torch.scripts.exp_leak_anatomy --save OUT.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig, init_state
from montecarlo_tpu_torch.engine.step import clamp_action, head_info, step_table
from montecarlo_tpu_torch.engine.street import bets_needed
from montecarlo_tpu_torch.models.features import NUM_FEATURES, state_features
from montecarlo_tpu_torch.models.leash import to_host
from montecarlo_tpu_torch.models.policy_net import (
    MLPParams,
    action_from_index,
    fold_masked,
    gumbel_pick,
    load_params,
    policy_logits,
)
from montecarlo_tpu_torch.rollout.policy import (
    SUB_PERPETUAL,
    at_step,
    policy_key,
)

I32 = torch.int32
F32 = torch.float32

FEATURE_NAMES = [
    "stage_preflop", "stage_flop", "stage_turn", "stage_river",
    "n_community/5", "pot/(100P)", "needed/100", "stack/100",
    "free_to_check", "in_hand/P", "to_act/P", "seat/P",
    "pot_odds", "needed/bb/10", "hand_category/8", "top_rank/14",
    "hole_rank0/14", "hole_rank1/14", "suited", "paired",
    # feature-set v2 (betting history)
    "street_raises/4", "has_aggressor", "raiser_relpos", "re_raised",
]
ACTION_NAMES = ["fold", "check/call", "min-raise", "pot-raise"]


def collect(seed, cfg, n_steps, seat0_params, rest_params, n_tables,
            device=None):
    """Perpetual self-play (``step_table``) of ``n_tables`` tables of
    ``init_state(seed)`` that RECORDS every step: the head's features,
    its position, its free-to-check flag, the stage and the sampled menu
    index. Position 0 plays ``seat0_params``, the others ``rest_params``
    (pass the same params for pure self-play); a pick is ``gumbel_pick``
    on the step's words of sub-stream ``SUB_PERPETUAL``.

    Returns ``(final_state, (feats [T, S, F], seat [T, S], free [T, S],
    stage [T, S], idx [T, S]))`` (int32 but ``free`` bool, ``feats``
    float32), tables on the leading axis as the JAX module's ``vmap``."""
    dev = resolve(device)
    st = init_state(seed, cfg, n_tables, dev)
    key = policy_key(seed, n_tables, SUB_PERPETUAL, dev)
    same = seat0_params is rest_params
    nets = [MLPParams(*(x.to(dev, F32) for x in p))
            for p in (seat0_params, rest_params)]
    recs = []
    for i in range(n_steps):
        feats = state_features(st)
        seat, _, _ = head_info(st)
        logits = policy_logits(nets[1], feats)
        if not same:  # self-play runs the net once
            logits = torch.where((seat == 0)[:, None],
                                 policy_logits(nets[0], feats), logits)
        free = bets_needed(st.bets, seat) == 0
        idx = gumbel_pick(at_step(key, i), fold_masked(logits, free))
        action = clamp_action(st, action_from_index(idx, st))
        recs.append((feats, seat.to(I32), free, st.stage.to(I32),
                     idx.to(I32)))
        st = step_table(st, action, rules=cfg.rules)
    return st, tuple(torch.stack(c, dim=1) for c in zip(*recs))


def flatten_recs(recs):
    feats, seat, free, stage, idx = (to_host(x) for x in recs)
    n = feats.shape[0] * feats.shape[1]
    return (feats.reshape(n, NUM_FEATURES), seat.reshape(n),
            free.reshape(n), stage.reshape(n), idx.reshape(n))


def np_logits(params, feats):
    p = {k: to_host(getattr(params, k)) for k in
         ("w1", "b1", "w2", "b2", "w3", "b3")}
    h = np.maximum(feats @ p["w1"] + p["b1"], 0.0)
    h = np.maximum(h @ p["w2"] + p["b2"], 0.0)
    return h @ p["w3"] + p["b3"]


def masked_argmax(logits, free):
    lg = logits.copy()
    lg[free, 0] = -1e9
    return lg.argmax(axis=1), lg


def margin_stats(params, feats, free):
    """Margin distribution + sampling stochasticity on real decisions."""
    idx, lg = masked_argmax(np_logits(params, feats), free)
    srt = np.sort(lg, axis=1)
    margin = srt[:, -1] - srt[:, -2]
    # categorical sampling: P(non-argmax) = 1 - softmax_top
    z = lg - lg.max(axis=1, keepdims=True)
    p_top = 1.0 / np.exp(z).sum(axis=1)
    return idx, margin, {
        "margin_p10": float(np.percentile(margin, 10)),
        "margin_p50": float(np.percentile(margin, 50)),
        "margin_p90": float(np.percentile(margin, 90)),
        "frac_margin_lt_4.6": float((margin < 4.6).mean()),
        "frac_sample_nonargmax_gt_1pct": float((p_top < 0.99).mean()),
        "mean_p_nonargmax": float((1 - p_top).mean()),
    }


def fold_gate(params, feats, free):
    """Among FACING-A-BET decisions (fold legal): does the artifact ever
    fold, and how much probability mass does fold carry?"""
    facing = ~free
    idx, lg = masked_argmax(np_logits(params, feats), free)
    lgf = lg[facing]
    z = lgf - lgf.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    rank = (lgf > lgf[:, [0]]).sum(axis=1)  # actions above fold
    return {
        "facing_bet_decisions": int(facing.sum()),
        "fold_argmax_frac": float((idx[facing] == 0).mean()),
        "mean_p_fold": float(p[:, 0].mean()),
        "frac_p_fold_gt_1pct": float((p[:, 0] > 0.01).mean()),
        "fold_logit_rank_hist": [float((rank == r).mean())
                                 for r in range(4)],
    }


def es_flip_fraction(params, feats, free, sigma=0.05,
                     layers=("w2", "b2", "w3", "b3"), draws=16, seed=0):
    """Fraction of real decisions flipped by one ES perturbation at the
    production recipe (train_es_kernel: sigma on w2,b2,w3,b3 only)."""
    rng = np.random.default_rng(seed)
    base_idx, _ = masked_argmax(np_logits(params, feats), free)
    per_draw = []
    flipped_any = np.zeros(len(feats), bool)
    for _ in range(draws):
        d = {k: to_host(getattr(params, k)).copy() for k in
             ("w1", "b1", "w2", "b2", "w3", "b3")}
        for k in layers:
            d[k] = d[k] + sigma * rng.standard_normal(
                d[k].shape).astype(np.float32)
        idx, _ = masked_argmax(np_logits(MLPParams(**d), feats), free)
        flip = idx != base_idx
        per_draw.append(float(flip.mean()))
        flipped_any |= flip
    return {"sigma": sigma, "draws": draws,
            "mean_flip_frac": float(np.mean(per_draw)),
            "max_flip_frac": float(np.max(per_draw)),
            "flipped_by_any_draw": float(flipped_any.mean())}


def behavior_hist(stage, idx, sel):
    """Per-street action histogram over selected decisions."""
    out = {}
    for s, sname in enumerate(["preflop", "flop", "turn", "river"]):
        m = sel & (stage == s)
        n = int(m.sum())
        row = {"decisions": n}
        if n:
            for a, aname in enumerate(ACTION_NAMES):
                row[aname] = round(float((idx[m] == a).mean()), 4)
        out[sname] = row
    return out


def decode_attacker(path, subject_key):
    """Named-weight table for the winning CMA vector(s) in an opt_bot
    artifact (linear pairs only: x = [score_vec, threshold])."""
    with open(path) as f:
        d = json.load(f)
    sub = d["subjects"][subject_key]
    out = {}
    for pair, row in sub["per_pair"].items():
        x = np.asarray(row["x"], np.float64)
        if len(x) != NUM_FEATURES + 1:     # ladder family: skip decode
            out[pair] = {"bot_bb_per_hand": row["bot_bb_per_hand"],
                         "family": "ladder", "dims": len(x)}
            continue
        w = {FEATURE_NAMES[i]: round(float(x[i]), 3)
             for i in np.argsort(-np.abs(x[:NUM_FEATURES]))
             if abs(x[i]) > 0.05}
        out[pair] = {"bot_bb_per_hand": row["bot_bb_per_hand"],
                     "threshold": round(float(x[NUM_FEATURES]), 3),
                     "weights_by_magnitude": w}
    return out


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=128)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--save", required=True,
                    help="output JSON (not in data/: its files are the "
                         "reference)")
    return ap


def main(argv=None, device=None):
    """The JAX script's report (the same artifacts, keys and lines);
    returns the saved document."""
    from montecarlo_tpu_torch.scripts.opt_bot import make_bot

    args = parser().parse_args(argv)
    out = {"tables": args.tables, "steps": args.steps, "seed": args.seed}

    # ---------- 6-max artifacts ----------
    cfg6 = TableConfig(num_seats=6, rules="standard")
    es3 = load_params("data/policy_6max_es3.npz")
    es4 = load_params("data/policy_6max_es4.npz")
    _, recs = collect(args.seed, cfg6, args.steps, es3, es3, args.tables,
                      device)
    feats, seat, free, stage, idx = flatten_recs(recs)
    print(json.dumps({"collected_6max_selfplay": len(feats)}), flush=True)

    sub = {}
    for name, p in [("es3", es3), ("es4", es4)]:
        _, _, ms = margin_stats(p, feats, free)
        ms["es_flip"] = es_flip_fraction(p, feats, free)
        ms["fold_gate"] = fold_gate(p, feats, free)
        sub[name] = ms
    # behavioral identity across the lineage on es3's state distribution
    i3, _ = masked_argmax(np_logits(es3, feats), free)
    i4, _ = masked_argmax(np_logits(es4, feats), free)
    sub["es3_vs_es4_argmax_disagree"] = float((i3 != i4).mean())
    out["sixmax"] = sub

    # subject-vs-attacker behavior: the es3 call/fold killer (pair 1:0)
    with open("data/exploitability_opt.json") as f:
        opt = json.load(f)
    row = opt["subjects"]["es3"]["per_pair"]["1:0"]
    bot = make_bot(np.asarray(row["x"], np.float32), (1, 0))
    _, recs_b = collect(args.seed, cfg6, args.steps, bot, es3, args.tables,
                        device)
    _, sb, _, stb, ib = flatten_recs(recs_b)
    out["vs_attacker"] = {
        "attacker_pair": "1:0",
        "attacker_bb_per_hand_tpu": row["bot_bb_per_hand"],
        "attacker_behavior": behavior_hist(stb, ib, sb == 0),
        "subject_behavior": behavior_hist(stb, ib, sb != 0),
        "subject_selfplay_behavior": behavior_hist(stage, idx, seat >= 0),
    }
    out["attacker_decode"] = {
        "es3": decode_attacker("data/exploitability_opt.json", "es3"),
    }
    if os.path.exists("data/exploitability_opt_es5.json"):
        out["attacker_decode"]["es5"] = decode_attacker(
            "data/exploitability_opt_es5.json", "es5")

    # ---------- HU artifacts ----------
    # (the repository holds no policy_hu_mix.npz, which the JAX script
    # loads unconditionally and so fails here; the port compares it when
    # present, as it does the es5 decode above)
    cfg2 = TableConfig(num_seats=2, rules="standard")
    hu = load_params("data/policy_hu_300.npz")
    subjects = [("hu300", hu)]
    if os.path.exists("data/policy_hu_mix.npz"):
        subjects.append(("hu_mix", load_params("data/policy_hu_mix.npz")))
    _, recs2 = collect(args.seed + 1, cfg2, args.steps, hu, hu, args.tables,
                       device)
    f2, _, fr2, _, _ = flatten_recs(recs2)
    print(json.dumps({"collected_hu_selfplay": len(f2)}), flush=True)

    huo = {}
    for name, p in subjects:
        _, _, ms = margin_stats(p, f2, fr2)
        ms["es_flip"] = es_flip_fraction(p, f2, fr2)
        ms["fold_gate"] = fold_gate(p, f2, fr2)
        huo[name] = ms
    if len(subjects) == 2:
        ia, _ = masked_argmax(np_logits(hu, f2), fr2)
        ib2, _ = masked_argmax(np_logits(subjects[1][1], f2), fr2)
        huo["hu300_vs_hu_mix_argmax_disagree"] = float((ia != ib2).mean())
    out["hu"] = huo

    with open(args.save, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"saved": args.save}))
    for k in ("sixmax", "hu"):
        print(json.dumps({k: out[k]}, default=float), flush=True)
    return out


if __name__ == "__main__":
    main()
