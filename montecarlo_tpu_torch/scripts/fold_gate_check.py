"""Per-artifact fold-gate and v2-feature-usage diagnostic.

The port of ``scripts/fold_gate_check.py``: for each subject artifact,
collect its self-play decision points (``exp_leak_anatomy.collect``) and
report (a) the fold-gate statistics (fold=argmax fraction, mean P(fold),
margin percentiles) and (b) how much the policy reads the v2
betting-history features (indices 20-23): the argmax flip fraction when
they are zeroed, and each feature's w1 row norm and nonzero share.

Run from the repository root (the card by default):
    python -m montecarlo_tpu_torch.scripts.fold_gate_check \\
        --subjects es9=data/policy_6max_es9.npz --save OUT.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.features import NUM_FEATURES
from montecarlo_tpu_torch.models.leash import to_host
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.scripts.exp_leak_anatomy import (
    FEATURE_NAMES,
    collect,
    flatten_recs,
    fold_gate,
    margin_stats,
    masked_argmax,
    np_logits,
)

V2_START = 20


def v2_usage(params, feats, free):
    """How much the net reads features 20-23 on real decisions."""
    idx, _ = masked_argmax(np_logits(params, feats), free)
    feats0 = feats.copy()
    feats0[:, V2_START:] = 0.0
    idx0, _ = masked_argmax(np_logits(params, feats0), free)
    w1 = to_host(params.w1)
    sens = {}
    for k in range(V2_START, NUM_FEATURES):
        live = feats[:, k] != 0
        sens[FEATURE_NAMES[k]] = {
            "w1_row_l2": round(float(np.linalg.norm(w1[k])), 4),
            "nonzero_frac": round(float(live.mean()), 4),
        }
    return {
        "argmax_flip_when_v2_zeroed": round(float((idx != idx0).mean()), 5),
        "per_feature": sens,
    }


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subjects", required=True,
                    help="name=path,... policy artifacts (6-max assumed "
                         "unless the name contains 'hu')")
    ap.add_argument("--tables", type=int, default=128)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--save", required=True,
                    help="output JSON (not in data/: its files are the "
                         "reference)")
    return ap


def main(argv=None, device=None):
    """Print the JAX script's lines, save its document; return the
    document and, under ``"records"``, each subject's flattened records
    (for statistics over groups of tables)."""
    args = parser().parse_args(argv)
    out = {"tables": args.tables, "steps": args.steps, "seed": args.seed,
           "subjects": {}}
    records = {}
    for spec in args.subjects.split(","):
        name, path = spec.split("=")
        params = load_params(path)
        seats = 2 if "hu" in name else 6
        cfg = TableConfig(num_seats=seats, rules="standard",
                          bets_impl="levels")
        _, recs = collect(args.seed, cfg, args.steps, params, params,
                          args.tables, device)
        feats, seat, free, stage, idx = records[name] = flatten_recs(recs)
        _, _, ms = margin_stats(params, feats, free)
        ms["fold_gate"] = fold_gate(params, feats, free)
        ms["v2_usage"] = v2_usage(params, feats, free)
        ms["artifact"] = path
        ms["decisions"] = int(len(feats))
        out["subjects"][name] = ms
        print(json.dumps({name: ms["v2_usage"]
                          ["argmax_flip_when_v2_zeroed"],
                          "fold_argmax": ms["fold_gate"]
                          .get("fold_argmax_frac")}), flush=True)

    with open(args.save, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"saved": args.save}), flush=True)
    return {**out, "records": records}


if __name__ == "__main__":
    main()
