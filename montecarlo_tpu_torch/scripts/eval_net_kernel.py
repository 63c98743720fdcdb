"""Seat-pinned policy-net evaluation on the net kernel (K6): the port of
``scripts/eval_net_kernel.py``.

The trained 6-max net (``data/policy_6max_200.npz``) at seat 0 against
five random seats (standard rules, every hand from full stacks), then the
untrained net (``init_params`` of seed 0) as a baseline, each on
``--tables`` x ``--steps`` (2^16 x 512, the script's) from seed 11. Prints
one JSON line a net: seat 0's bb/hand and clustered standard error, the
other seats' mean, every seat's bb/hand and error, the hands, hands/s and
seconds (host clock incl. the sync).

    python -m montecarlo_tpu_torch.scripts.eval_net_kernel
        [--tables N] [--steps S] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import init_params, load_params
from montecarlo_tpu_torch.ops import cuda_net as cn

ARTIFACT = "data/policy_6max_200.npz"
SEED = 11


def main(argv=None, device=None) -> dict:
    """Returns {net: its JSON line}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = TableConfig(num_seats=6, rules="standard")
    trained = load_params(ARTIFACT)
    untrained = init_params(torch.Generator().manual_seed(0))
    out = {}
    for name, params in (("trained", trained), ("untrained", untrained)):
        t0 = time.perf_counter()
        means, errs, hands = cn.selfplay_net_eval_kernel(
            SEED, cfg, params, 0b000001, args.tables, args.steps,
            device=dev)
        dt = time.perf_counter() - t0
        out[name] = {
            "net": name, "seat0_bb_per_hand": float(means[0]),
            "seat0_stderr": float(errs[0]),
            "other_seats_mean": float(means[1:].mean()),
            "per_seat_bb": [float(x) for x in means],
            "per_seat_stderr": [float(x) for x in errs],
            "hands": hands, "hands_per_sec": hands / dt, "seconds": dt,
            "tables": args.tables, "steps": args.steps}
        print(json.dumps(out[name]), flush=True)
    return out


if __name__ == "__main__":
    main()
