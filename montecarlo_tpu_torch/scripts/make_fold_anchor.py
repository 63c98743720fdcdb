"""Build the fold-preservation anchor batch for leashed ES.

The port of ``scripts/make_fold_anchor.py``: 6-max self-play decisions
(``exp_leak_anatomy.collect``) under two reach profiles (the distilled
net's own play and, with ``--subject``, the subject's), filtered to
facing-a-bet spots where the distilled net's argmax is fold. Saved: the
features [N, 24], the distilled net's P(fold) on them, and provenance
counts in ``<save>.json``.

One repair over the JAX script: it seeded each profile with
``seed + hash(name) % 1000``, and Python randomizes ``str`` hashes per
process, so its anchor changed from run to run. Here the offset is
``zlib.crc32(name) % 1000`` (``profile_seed``), the same in every process.

Run from the repository root (the card by default):
    python -m montecarlo_tpu_torch.scripts.make_fold_anchor \\
        --distill data/policy_6max_distill.npz \\
        --subject data/policy_6max_es8.npz --save OUT.npz
"""

from __future__ import annotations

import argparse
import json
import zlib

import numpy as np

from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.scripts.exp_leak_anatomy import (
    collect,
    flatten_recs,
    masked_argmax,
    np_logits,
)


def profile_seed(seed: int, name: str) -> int:
    """A reach profile's collection seed: ``seed`` plus a stable offset
    of its name."""
    return seed + zlib.crc32(name.encode()) % 1000


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--distill", default="data/policy_6max_distill.npz",
                    help="the fold-capable net whose folds define the "
                         "anchor")
    ap.add_argument("--subject", default=None,
                    help="optional second reach profile (e.g. the es8 "
                         "artifact) so the anchor covers states the ES "
                         "run actually visits")
    ap.add_argument("--tables", type=int, default=192)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--max-rows", type=int, default=16384)
    ap.add_argument("--save", required=True,
                    help="output .npz (not in data/: its files are the "
                         "reference)")
    return ap


def main(argv=None, device=None):
    """Build and save the anchor; return its metadata (``<save>.json``)."""
    args = parser().parse_args(argv)
    cfg = TableConfig(num_seats=6, rules="standard")
    distill = load_params(args.distill)

    profiles = [("distill", distill, distill)]
    if args.subject:
        subj = load_params(args.subject)
        profiles.append(("subject", subj, subj))

    feats_all, prov = [], {}
    for name, p0, prest in profiles:
        _, recs = collect(profile_seed(args.seed, name), cfg, args.steps,
                          p0, prest, args.tables, device)
        feats, _, free, _, _ = flatten_recs(recs)
        am, _ = masked_argmax(np_logits(distill, feats), free)
        keep = (~free) & (am == 0)          # facing a bet, distill folds
        feats_all.append(feats[keep])
        prov[name] = {"decisions": int(len(feats)),
                      "facing_bet": int((~free).sum()),
                      "fold_rows": int(keep.sum())}
        print(json.dumps({"profile": name, **prov[name]}), flush=True)

    feats = np.concatenate(feats_all)
    if len(feats) > args.max_rows:
        rng = np.random.default_rng(args.seed)
        feats = feats[rng.choice(len(feats), args.max_rows, replace=False)]

    # reference: the distill net's own P(fold) on the kept rows
    lg = np_logits(distill, feats)
    z = lg - lg.max(axis=1, keepdims=True)
    p = np.exp(z)
    p_fold = p[:, 0] / p.sum(axis=1)

    np.savez(args.save, feats=feats.astype(np.float32),
             p_fold_ref=p_fold.astype(np.float32))
    meta = {"rows": int(len(feats)),
            "distill": args.distill, "subject": args.subject,
            "p_fold_ref_mean": round(float(p_fold.mean()), 4),
            "provenance": prov}
    with open(args.save + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta), flush=True)
    print(f"saved {args.save}")
    return meta


if __name__ == "__main__":
    main()
