"""Net-eval and ES-training throughput at production scale: the port of
``scripts/bench_net_throughput.py``.

``bench_net_eval`` times seat-pinned policy-net evaluation on K6
(``ops/cuda_net.selfplay_net_eval_kernel``: the net at seat 0, the random
policy elsewhere, launches of 256 slots); ``bench_es_generation`` one ES
generation of ``2 * pop`` candidates on B8 (``selfplay_net_eval_pop``, one
launch a 256-slot chunk), each candidate ``params + 0.05 N(0, 1)`` per
leaf from numpy ``default_rng(0)`` in the leaves' order, as the JAX script
draws them. The two figures are ``bench.py``'s ``net_eval_hands_per_sec``
and ``train_hands_per_sec``. The first state (``initial_packed_state``)
is built outside the timed region; each timing is one warm-up, then the
best of ``reps`` on the host clock, the meters' read to the host being
the sync.

    python -m montecarlo_tpu_torch.scripts.bench_net_throughput
        [--tables N] [--steps S] [--train-tables N] [--train-steps S]
        [--pop K] [--artifact PATH] [--device cpu]

Prints one JSON line a figure. ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.models.policy_net import params_from_numpy
from montecarlo_tpu_torch.ops.cuda_net import (
    initial_packed_state,
    selfplay_net_eval_kernel,
    selfplay_net_eval_pop,
)

SIGMA = 0.05


def bench_net_eval(cfg, params, n_tables, n_steps, seed=11, reps=3,
                   device=None):
    state0 = initial_packed_state(seed, cfg, n_tables, resolve(device))

    def once(s):
        t0 = time.perf_counter()
        _, _, hands = selfplay_net_eval_kernel(
            s, cfg, params, net_seats=1, n_tables=n_tables,
            n_steps=n_steps, state0=state0)
        return time.perf_counter() - t0, hands

    once(seed)  # warm-up
    best, hands = min(once(seed + i + 1) for i in range(reps))
    return {"net_eval_hands_per_sec": hands / best,
            "net_eval_tables": n_tables, "net_eval_steps": n_steps,
            "net_eval_hands": hands, "net_eval_seconds": best,
            "net_eval_ns_per_table_step":
                best / (n_tables * n_steps) * 1e9}


def es_candidates(params, pop=16):
    """The generation's ``2 * pop`` candidates: each leaf ``x + 0.05
    N(0, 1)`` in float32, the noise from numpy ``default_rng(0)`` leaf by
    leaf, candidate by candidate (the JAX script's ``jax.tree.map`` order),
    as numpy leaves."""
    rng = np.random.default_rng(0)
    leaves = [np.asarray(x, np.float32) for x in params]
    return [[x + SIGMA * rng.standard_normal(x.shape).astype(np.float32)
             for x in leaves] for _ in range(2 * pop)]


def bench_es_generation(cfg, params, n_tables, n_steps, pop=16, seed=13,
                        reps=3, device=None):
    """One ES generation = 2*pop candidates in one pop-kernel launch per
    256-slot chunk: the steady-state training rate."""
    state0 = initial_packed_state(seed, cfg, n_tables, resolve(device))
    cands = [params_from_numpy(c) for c in es_candidates(params, pop)]

    def once(s):
        t0 = time.perf_counter()
        _, _, hands = selfplay_net_eval_pop(
            s, cfg, cands, net_seats=1, n_tables=n_tables,
            n_steps=n_steps, state0=state0)
        return time.perf_counter() - t0, int(np.sum(hands))

    once(seed)  # warm-up
    best, hands = min(once(seed + i + 1) for i in range(reps))
    return {"train_hands_per_sec": hands / best,
            "train_pop": 2 * pop, "train_tables": n_tables,
            "train_steps": n_steps, "train_hands": hands,
            "train_seconds": best}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--train-tables", type=int, default=1 << 14)
    ap.add_argument("--train-steps", type=int, default=256)
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--artifact", default="data/policy_6max_es3.npz")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)

    cfg = TableConfig(num_seats=6, rules="standard")
    params = load_params(args.artifact)

    out = bench_net_eval(cfg, params, args.tables, args.steps,
                         device=args.device)
    print(json.dumps(out), flush=True)
    out2 = bench_es_generation(cfg, params, args.train_tables,
                               args.train_steps, pop=args.pop,
                               device=args.device)
    print(json.dumps(out2), flush=True)
    return out, out2


if __name__ == "__main__":
    main()
