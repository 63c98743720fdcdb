"""Behavioral diff between two policy artifacts.

The port of ``scripts/policy_diff.py``: collect each subject's self-play
decision points (``exp_leak_anatomy.collect``), then measure how often the
OTHER artifact's masked argmax differs on the same states, on BOTH state
distributions, per street, with fold-gate statistics for each artifact on
each distribution.

One repair over the JAX script: two subjects given the same name (say
``--a es9=old.npz --b es9=new.npz``) wrote one ``on_<name>_selfplay``
block over the other and one ``fold_gate`` entry over the other. Here the
tags get ``_a`` and ``_b`` appended when the names collide, so every
block and entry survives (``subject_tags``).

Run from the repository root (the card by default):
    python -m montecarlo_tpu_torch.scripts.policy_diff \\
        --a es9=data/policy_6max_es9.npz --b es8=data/policy_6max_es8.npz \\
        --save OUT.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.scripts.exp_leak_anatomy import (
    ACTION_NAMES,
    collect,
    flatten_recs,
    fold_gate,
    masked_argmax,
    np_logits,
)

STAGE_NAMES = ["preflop", "flop", "turn", "river"]


def parse_subject(spec):
    name, path = spec.split("=", 1)
    return name, load_params(path)


def subject_tags(na, nb):
    """The two subjects' tags in the output: their names, or, when the
    names are equal, the names with ``_a`` and ``_b`` appended."""
    return (na, nb) if na != nb else (na + "_a", nb + "_b")


def diff_on(feats, free, stage, pa, pb):
    """Argmax disagreement of pb vs pa on pa-or-pb-generated states."""
    ia, _ = masked_argmax(np_logits(pa, feats), free)
    ib, _ = masked_argmax(np_logits(pb, feats), free)
    dis = ia != ib
    out = {
        "decisions": int(len(feats)),
        "argmax_disagree": float(dis.mean()),
        "per_street": {
            STAGE_NAMES[s]: float(dis[stage == s].mean())
            for s in range(4) if int((stage == s).sum())
        },
    }
    # where they disagree, what does each pick? (a_action -> b_action)
    flows = {}
    for s in np.flatnonzero(dis)[:200000]:
        k = f"{ACTION_NAMES[ia[s]]}->{ACTION_NAMES[ib[s]]}"
        flows[k] = flows.get(k, 0) + 1
    total = max(1, sum(flows.values()))
    out["disagree_flows"] = {
        k: round(v / total, 4)
        for k, v in sorted(flows.items(), key=lambda kv: -kv[1])
    }
    return out


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="name=artifact.npz")
    ap.add_argument("--b", required=True, help="name=artifact.npz")
    ap.add_argument("--seats", type=int, default=6)
    ap.add_argument("--tables", type=int, default=128)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--save", required=True,
                    help="output JSON (not in data/: its files are the "
                         "reference)")
    return ap


def main(argv=None, device=None):
    """Print the JAX script's lines, save its document; return the
    document and, under ``"records"``, each tag's flattened records."""
    args = parser().parse_args(argv)
    na, pa = parse_subject(args.a)
    nb, pb = parse_subject(args.b)
    ta, tb = subject_tags(na, nb)
    cfg = TableConfig(num_seats=args.seats, rules="standard",
                      bets_impl="levels")

    out = {"a": args.a, "b": args.b, "seats": args.seats,
           "tables": args.tables, "steps": args.steps, "seed": args.seed}
    records = {}
    for tag, params in ((ta, pa), (tb, pb)):
        _, recs = collect(args.seed, cfg, args.steps, params, params,
                          args.tables, device)
        records[tag] = feats, _, free, stage, _ = flatten_recs(recs)
        blk = diff_on(feats, free, stage, pa, pb)
        blk["fold_gate"] = {ta: fold_gate(pa, feats, free),
                            tb: fold_gate(pb, feats, free)}
        out[f"on_{tag}_selfplay"] = blk
        print(json.dumps({f"on_{tag}_selfplay":
                          blk["argmax_disagree"]}), flush=True)

    with open(args.save, "w") as f:
        json.dump(out, f, indent=1)
    print(f"saved {args.save}")
    return {**out, "records": records}


if __name__ == "__main__":
    main()
