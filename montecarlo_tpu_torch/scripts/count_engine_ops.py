"""Count the PyTorch operations and bytes of one table-engine step.

``engine/step.step_table`` is plain PyTorch: every operation is a kernel
launch over the whole batch, reading and writing its tensors in device
memory. This script runs one ``clamp_action`` + ``step_table`` under each
rule set (6-max, K3's capacities) on ``--tables`` tables on the CPU and
counts, through a dispatch mode, the operations and the bytes of their
tensor inputs and outputs, scaled to 2^20 tables: a step in which no
table's hand ends (a call on the first action, ``continues``) and one in
which every table's hand ends (the fifth fold, ``ends``: the settlement
and the next deal run on the ended tables only); and the same for
``state.shuffled_decks``, the deal of ``next_hand``. Counts only: a time
comes from a run on the card.

    python -m montecarlo_tpu_torch.scripts.count_engine_ops [--tables N]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine import step as tstep
from montecarlo_tpu_torch.ops.cuda_engine import RULES, _L_for

FULL = 1 << 20


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = self.read = self.written = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        self.read += _nbytes(args)
        self.written += _nbytes(out if isinstance(out, (tuple, list))
                                else [out])
        return out


def count(fn, n_tables: int) -> dict:
    with _Count() as c:
        fn()
    scale = FULL / n_tables
    return {"ops": c.ops, "read_gb_at_2^20": c.read * scale / 1e9,
            "written_gb_at_2^20": c.written * scale / 1e9}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=1024)
    args = ap.parse_args(argv)
    out = {}
    for rules in RULES:
        L = _L_for(rules)
        cfg = tstate.TableConfig(num_seats=6, rules=rules, max_layers=L,
                                 max_pot_layers=4 * L, bets_impl="levels")
        st = tstate.init_state(0, cfg, args.tables, "cpu")
        last = st
        for _ in range(cfg.num_seats - 2):
            last = tstep.step_table(last, -1, rules=rules)
        out[rules] = {
            "continues": count(lambda: tstep.step_table(
                st, tstep.clamp_action(st, 0), rules=rules), args.tables),
            "ends": count(lambda: tstep.step_table(
                last, tstep.clamp_action(last, -1), rules=rules),
                args.tables)}
    out["shuffled_decks"] = count(
        lambda: tstate.shuffled_decks(st.key, st.hand_idx), args.tables)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
