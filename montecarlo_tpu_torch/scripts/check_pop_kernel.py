"""Check on the card that the population net-eval kernel (B8) reproduces
the one-candidate kernel (K6) exactly: the port of
``scripts/check_pop_kernel.py``.

Table t of every candidate reads Philox stream (seed, t), as K6's table t
does (``ops/cuda_net.run_net_eval_pop``), so candidate c of one B8 launch
must equal a K6 launch with c's weights bit for bit: the packed state,
and with it the meters (bb/hand and clustered standard error a seat, the
hands). Four candidates (``policy_6max_es``, ``policy_6max_200`` and two
untrained nets, ``init_params`` of seeds 7 and 8), standard rules, the net
at seat 0, 4,096 tables x 256 slots from one first state (seed 314).
Prints one JSON line a candidate and a summary with both timings (host
clock incl. the sync, after a warm-up launch of each form); exits 1
unless every candidate is exact.

    python -m montecarlo_tpu_torch.scripts.check_pop_kernel
        [--tables N] [--steps S] [--device cpu]

On the CPU (``--device cpu``) the plain versions run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import init_params, load_params
from montecarlo_tpu_torch.ops import cuda_net as cn

N_TABLES = 4096
N_STEPS = 256
SEED = 314
ARTIFACTS = ("data/policy_6max_es.npz", "data/policy_6max_200.npz")
UNTRAINED = (7, 8)


def candidates():
    """The four candidates' parameters."""
    return [load_params(a) for a in ARTIFACTS] + [
        init_params(torch.Generator().manual_seed(s)) for s in UNTRAINED]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, device=None) -> dict:
    """Returns {"candidates": [line, ...], "ok": bool, ...timings}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=N_TABLES)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = TableConfig(num_seats=6, rules="standard")
    P, sb, bb, ss = (cfg.num_seats, cfg.small_blind, cfg.big_blind,
                     cfg.starting_stack)
    cands = candidates()
    state0 = cn.initial_packed_state(SEED, cfg, args.tables, dev)

    def launches(step, state):
        return cn._chunks(step, SEED, state, args.steps, 256)

    pop0 = state0[None].expand(len(cands), *state0.shape).contiguous()
    w = cn.pop_weights(cands, dev)
    # a warm-up of each form, so that neither timing holds the library's
    # first load
    cn.run_net_eval_pop(SEED, pop0, w, P, 16, sb, bb, ss, cfg.rules, 1)
    cn.run_net_eval(SEED, state0, w[0, 0], P, 16, sb, bb, ss, cfg.rules, 1)
    t0 = time.perf_counter()
    pop = launches(lambda s, st, n: cn.run_net_eval_pop(
        s, st, w, P, n, sb, bb, ss, cfg.rules, 1), pop0)
    pm, pe, ph = cn.pop_meters(pop, cfg)
    _sync(dev)
    t_pop = time.perf_counter() - t0

    ok, lines, t_single = True, [], 0.0
    for c, params in enumerate(cands):
        t0 = time.perf_counter()
        wc = cn.net_weights(params, dev)
        single = launches(lambda s, st, n: cn.run_net_eval(
            s, st, wc, P, n, sb, bb, ss, cfg.rules, 1), state0)
        m, e, h = cn.seat_meters(single, cfg)
        _sync(dev)
        t_single += time.perf_counter() - t0
        exact = bool(torch.equal(single, pop[c]) and np.array_equal(m, pm[c])
                     and np.array_equal(e, pe[c]) and h == ph[c])
        ok &= exact
        line = {"candidate": c, "bb_seat0_pop": float(pm[c][0]),
                "bb_seat0_single": float(m[0]), "hands_pop": int(ph[c]),
                "hands_single": int(h), "exact": exact}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"pop_launch_s": t_pop, "four_single_launches_s": t_single,
               "speedup": t_single / t_pop, "tables": args.tables,
               "steps": args.steps, "ok": ok}
    print(json.dumps(summary), flush=True)
    return {"candidates": lines, **summary}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
