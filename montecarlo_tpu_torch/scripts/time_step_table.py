"""Time the table engine's step on the card, for one checkout or two.

``engine/step.step_table`` is plain PyTorch. This script times
``--steps`` steps of ``clamp_action`` + ``step_table`` at ``--tables``
6-max tables under each rule set (K3's capacities; raw actions drawn as
K3's injected stream: folds 20%, calls 72%, raises of 1..20 8%; the
tournament tables with 20-chip stacks), with CUDA events around the
steps after a warm-up, and prints one JSON line of ns per table-step.

    python montecarlo_tpu_torch/scripts/time_step_table.py [--tree DIR]
    python montecarlo_tpu_torch/scripts/time_step_table.py --ab PARENT

``--tree`` imports ``montecarlo_tpu_torch`` from the checkout ``DIR``
(default: this script's). ``--ab PARENT`` times the checkout ``PARENT``
and this one in fresh processes, in the order parent, this, this, parent,
and prints each run's line and then a summary line (each tree's mean).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
RULES = ("reference", "standard", "tournament")


def _time(tree: Path, tables: int, steps: int, seed: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    from montecarlo_tpu_torch.engine import state as tstate
    from montecarlo_tpu_torch.engine import step as tstep
    from montecarlo_tpu_torch.ops import cuda_engine as ce

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((steps, tables), generator=g, device=dev)
    raises = torch.randint(1, 21, (steps, tables), generator=g, device=dev)
    acts = torch.where(u < 0.20, -1, torch.where(u < 0.92, 0, raises)) \
        .to(torch.int32)
    out = {"tree": str(tree), "tables": tables, "steps": steps,
           "card": torch.cuda.get_device_name(0)}
    for rules in RULES:
        L = ce._L_for(rules)
        cfg = tstate.TableConfig(
            num_seats=6, rules=rules, max_layers=L, max_pot_layers=4 * L,
            starting_stack=20 if rules == "tournament" else 100,
            bets_impl="levels")
        st0 = tstate.init_state(seed, cfg, tables, dev)

        def run(n):
            st = st0
            for i in range(n):
                st = tstep.step_table(st, tstep.clamp_action(st, acts[i]),
                                      rules=rules)
            return st

        run(4)  # warm-up
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st = run(steps)
        b.record()
        b.synchronize()
        out[rules] = a.elapsed_time(b) * 1e6 / (tables * steps)
        out[rules + "_hands"] = int(st.hand_idx.sum())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--ab", type=Path, default=None)
    ap.add_argument("--tables", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args(argv)
    if args.ab is None:
        out = _time(args.tree.resolve(), args.tables, args.steps, args.seed)
        print(json.dumps(out), flush=True)
        return out
    runs = []
    for tree in (args.ab, HERE, HERE, args.ab):
        line = subprocess.run(
            [sys.executable, __file__, "--tree", str(tree.resolve()),
             "--tables", str(args.tables), "--steps", str(args.steps),
             "--seed", str(args.seed)], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    summary = {}
    for name, tree in (("parent", args.ab.resolve()), ("this", HERE)):
        mine = [r for r in runs if r["tree"] == str(tree)]
        summary[name] = {rules: sum(r[rules] for r in mine) / len(mine)
                         for rules in RULES}
    print(json.dumps({"ns_per_table_step": summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
