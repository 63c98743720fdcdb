"""League-kernel bank routing with extreme deterministic nets: the port of
``scripts/check_league_routing.py``.

Bank "callbot" always checks or calls (``b3`` +100 on action 1), bank
"raisebot" always pot-raises (+100 on action 3). With seat_to_bank =
(0, 1, 1, 1, 1, 1), reference rules, 2^14 tables x 256 slots (seed 991):

- [callbot, raisebot]: seat 0 calls into five pot-raisers;
- [raisebot, callbot]: seat 0 pot-raises into five calling stations;
- the population form (B8 with two banks): candidate 0 the callbot,
  candidate 1 the raisebot, each against the raisebot.

Under reference rules an all-in seat is left out of the showdown
(``board.clj:53-60``), so a jammer loses its stack: if each seat plays its
own bank, seat 0 wins as the callbot and loses as the raisebot, by far; a
selection collapsed to one bank makes every case self-play, near 0. Prints
one JSON line a case and a verdict; exits 1 unless seat 0's bb/hand is
above 0 as the callbot and below 0 as the raisebot, the two at least
``MARGIN`` bb/hand apart, and the population's candidates ordered alike.

    python -m montecarlo_tpu_torch.scripts.check_league_routing
        [--tables N] [--steps S] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import bots
from montecarlo_tpu_torch.ops import cuda_net as cn

N_TABLES = 1 << 14
N_STEPS = 256
SEED = 991
STB = (0, 1, 1, 1, 1, 1)
# The least gap between seat 0's bb/hand as the callbot and as the raisebot.
MARGIN = 1.0


def biased_net(action: int):
    """A net that always plays menu index ``action`` (zero weights, +100
    on that output's bias)."""
    return bots.action_bot(action)


def main(argv=None, device=None) -> dict:
    """Returns {case: per-seat bb/hand, ..., "ok": bool}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=N_TABLES)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = TableConfig(num_seats=6)
    callbot, raisebot = biased_net(1), biased_net(3)
    out = {}
    for name, banks in (("call_at_seat0_vs_raisers", [callbot, raisebot]),
                        ("raise_at_seat0_vs_callers", [raisebot, callbot])):
        m, e, h = cn.selfplay_net_league(SEED, cfg, banks, STB, args.tables,
                                         args.steps, device=dev)
        out[name] = [float(x) for x in m]
        print(json.dumps({"case": name, "per_seat_bb": out[name],
                          "seat0_stderr": float(e[0]), "hands": h}),
              flush=True)
    m, _, h = cn.selfplay_net_league_pop(SEED, cfg, [callbot, raisebot],
                                         raisebot, args.tables, args.steps,
                                         seat_to_bank=STB, device=dev)
    pop = [float(m[0, 0]), float(m[1, 0])]
    out["pop_cand0_call_cand1_raise_vs_raise_opp"] = pop
    print(json.dumps({"case": "pop_cand0_call_cand1_raise_vs_raise_opp",
                      "cand_seat0_bb": pop, "hands": [int(x) for x in h]}),
          flush=True)
    call = out["call_at_seat0_vs_raisers"][0]
    jam = out["raise_at_seat0_vs_callers"][0]
    out["ok"] = bool(call > 0 > jam and call - jam >= MARGIN
                     and pop[0] > pop[1])
    print(json.dumps({"seat0_call_minus_raise": call - jam,
                      "margin": MARGIN, "ok": out["ok"]}), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
