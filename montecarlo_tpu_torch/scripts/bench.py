"""Benchmark: Monte Carlo rollout and betting-engine throughput on one card.
The port of the root ``bench.py``.

Prints ONE JSON line on stdout, with exactly ``bench.py``'s keys:
``{"metric", "value", "unit", "vs_baseline", "betting_...", "sweep169_...",
"net_eval_...", "train_..."}``; diagnostics go to stderr.

The headline metric is equity rollouts/s: one rollout deals a random board
from the live deck, ranks both 7-card hands and compares them (AKs vs QQ
preflop). The axes and what they run on the card:

- equity (``_run_pallas``): K1 through ``ops/cuda_equity.
  equity_vs_hand_counts``, 8 launches of 2^30 rollouts issued back to back
  and read to the host once;
- betting (``_run_selfplay_kernel``): K4 through ``ops/cuda_engine.
  run_perpetual_prng``, 2^20 6-max tables x 512 slots from one first state
  built outside the timed region, the overflow latch asserted 0;
- sweep (``_run_sweep169``): K2 through ``ops/cuda_equity.
  equity_sweep_kernel``, 169 canonical hands x 10^7 rollouts, one launch,
  host clock including the read;
- net and training (``_run_net_axis``): ``scripts/bench_net_throughput.py``
  (K6 at 2^18 tables x 512 slots; B8 with 2 x 16 candidates at 2^14 x 256).

There is no fallback: on the card every axis runs its kernel, or the
script raises and exits non-zero. Only when the caller asks for the CPU
(``--device cpu``, with smaller sizes by flag, as the tests run it) do the
plain versions run: ``_run_xla`` (``rollout/equity.equity_vs_hand``) and
``_run_selfplay`` (the plain engine, L = 8 / PL = 16) in place of the
first two, the other two through their wrappers' CPU path; ``backend``
(stderr) and ``betting_backend`` then read ``"plain"``. Each timing is one
warm-up, then the best of 2 or 3 on the host clock, a read to the host
being the sync.

    python -m montecarlo_tpu_torch.scripts.bench [--device cpu]
        [--equity-rollouts N] [--launches K] [--tables N] [--steps S]
        [--sweep-rollouts N] [--net-tables N] [--net-steps S]
        [--train-tables N] [--train-steps S] [--pop K]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.ops.cuda_engine import (
    first_state,
    run_perpetual_prng,
    unpack_field,
)
from montecarlo_tpu_torch.ops.cuda_equity import (
    equity_sweep_kernel,
    equity_vs_hand_counts,
)
from montecarlo_tpu_torch.rollout.equity import (
    canonical_hands,
    equity_vs_hand,
    make_card,
)
from montecarlo_tpu_torch.rollout.selfplay import play_hands_perpetual
from montecarlo_tpu_torch.scripts.bench_net_throughput import (
    bench_es_generation,
    bench_net_eval,
)

# The north-star target of BASELINE.json, 10^8 rollouts/s: vs_baseline is
# the rate over this target, not over any measurement.
NORTH_STAR = 1e8

K1 = "K1 mc_equity_kernel (CUDA)"
K4 = "K4 mc_engine_prng_kernel (CUDA)"
PLAIN = "plain"


def _run_pallas(hero, villain, n, launches=8, device=None):
    """K1 steady state: ``launches`` launches of ``n`` rollouts issued back
    to back, the counters read to the host once (one sync)."""
    dev = resolve(device)

    def once(seed):
        t0 = time.perf_counter()
        parts = [equity_vs_hand_counts(seed + 31 * i, hero, villain, n,
                                       device=dev)[0]
                 for i in range(launches)]
        w, t = torch.stack(parts).sum(0).tolist()  # ONE read = ONE sync
        return time.perf_counter() - t0, w, t, n * launches

    once(0)  # warm-up (and the kernels' build)
    best, w, t, m = min(once(i + 1) for i in range(2))
    return best, w, t, m, K1


def _run_xla(hero, villain, n, device="cpu"):
    """The plain version (``rollout/equity.equity_vs_hand`` on the CPU)."""

    def once(seed):
        t0 = time.perf_counter()
        r = equity_vs_hand(seed, hero, villain, n, device=device)
        return time.perf_counter() - t0, r.wins, r.ties, r.n

    once(0)
    best, w, t, m = min(once(i + 1) for i in range(3))
    return best, w, t, m, PLAIN


def _betting(cfg, hands, best, n_tables, n_steps, backend):
    return {
        "betting_hands_per_sec": hands / best,
        "betting_rules": cfg.rules,
        "betting_tables": n_tables,
        "betting_steps_per_hand": n_tables * n_steps / hands,
        "betting_ns_per_table_step": best / (n_tables * n_steps) * 1e9,
        "betting_backend": backend,
    }


def _run_selfplay_kernel(n_tables=1 << 20, n_steps=512, device=None):
    """Full betting hands/s through K4: perpetual tables, the random
    policy, the levels street algebra, street moves, showdown and payout,
    and the next deal all inside the kernel. The first deal is outside
    the timed region; the overflow latch is asserted so that the
    measurement cannot drop a side pot."""
    dev = resolve(device)
    cfg = TableConfig(num_seats=6)
    P = cfg.num_seats
    state0 = first_state(0, cfg, n_tables, dev)

    def once(seed):
        t0 = time.perf_counter()
        out = run_perpetual_prng(seed, state0, P, n_steps, cfg.small_blind,
                                 cfg.big_blind)
        hands = int(unpack_field(out, cfg, "hand_ct").sum())
        dt = time.perf_counter() - t0
        assert hands > 0
        assert int(unpack_field(out, cfg, "overflow").sum()) == 0
        return dt, hands

    once(0)  # warm-up
    best, hands = min(once(i + 1) for i in range(3))
    return _betting(cfg, hands, best, n_tables, n_steps, K4)


def _run_sweep169(n_per_hand=10_000_000, device=None):
    """BASELINE config 5: 169 canonical hands x 10^7 vs-random rollouts in
    one K2 launch; the warm wall clock, the read to the host included."""
    heroes = torch.tensor([list(cards) for _, cards in canonical_hands()],
                          dtype=torch.int32)

    def once(seed):
        t0 = time.perf_counter()
        _, n = equity_sweep_kernel(seed, heroes, n_per_hand, device)
        return time.perf_counter() - t0, n

    once(5)  # warm-up
    best, n = min(once(5 + i) for i in range(2))
    return {"sweep169_seconds_warm": best, "sweep169_rollouts": 169 * n}


def _run_selfplay(n_tables=1 << 20, n_steps=128, device="cpu"):
    """Full betting hands/s through the plain engine (the capacities L = 8,
    PL = 16; the overflow flags asserted 0)."""
    cfg = TableConfig(num_seats=6, max_layers=8, max_pot_layers=16)

    def once(seed):
        t0 = time.perf_counter()
        final, hands = play_hands_perpetual(seed, cfg, n_tables, n_steps,
                                            device=device)
        h = int(hands)  # read to the host = sync
        dt = time.perf_counter() - t0
        assert h > 0
        assert int((final.bets.overflow | final.pots.overflow).sum()) == 0
        return dt, h

    once(0)  # warm-up
    best, hands = min(once(i + 1) for i in range(3))
    return _betting(cfg, hands, best, n_tables, n_steps, PLAIN)


def _run_net_axis(tables=1 << 18, steps=512, train_tables=1 << 14,
                  train_steps=256, pop=16, device=None):
    """The AI-testing axis: net-eval hands/s at the production grid (K6)
    and the ES-generation training hands/s on the population kernel (B8),
    ``bench_net_throughput``'s functions with two timed runs each."""
    cfg = TableConfig(num_seats=6, rules="standard")
    params = load_params("data/policy_6max_es3.npz")
    out = {}
    r = bench_net_eval(cfg, params, tables, steps, reps=2, device=device)
    out["net_eval_hands_per_sec"] = r["net_eval_hands_per_sec"]
    out["net_eval_tables"] = tables
    r = bench_es_generation(cfg, params, train_tables, train_steps,
                            pop=pop, reps=2, device=device)
    out["train_hands_per_sec"] = r["train_hands_per_sec"]
    out["train_pop"] = r["train_pop"]
    return out


def reference_keys(path) -> set:
    """The keys of the stdout line of the root ``bench.py`` at ``path``,
    read from its source (nothing of it is imported): the string keys of
    the dicts its functions return or assign, and those stored by
    subscript (its stderr line's dict is a call argument, left out)."""
    import ast

    keys = set()
    for fn in ast.parse(Path(path).read_text()).body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, (ast.Return, ast.Assign)) \
                    and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys
                         if isinstance(k, ast.Constant)}
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Store) \
                    and isinstance(node.slice, ast.Constant):
                keys.add(node.slice.value)
    return keys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu: the plain versions (the card by default)")
    ap.add_argument("--equity-rollouts", type=int, default=1 << 30)
    ap.add_argument("--launches", type=int, default=8)
    ap.add_argument("--tables", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--sweep-rollouts", type=int, default=10_000_000)
    ap.add_argument("--net-tables", type=int, default=1 << 18)
    ap.add_argument("--net-steps", type=int, default=512)
    ap.add_argument("--train-tables", type=int, default=1 << 14)
    ap.add_argument("--train-steps", type=int, default=256)
    ap.add_argument("--pop", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    plain = dev.type == "cpu"

    hero = [make_card(0, 14), make_card(0, 13)]    # AKs
    villain = [make_card(1, 12), make_card(2, 12)]  # QQ
    n = args.equity_rollouts
    if plain:
        best, w, t, m, backend = _run_xla(hero, villain, n, dev)
        betting = _run_selfplay(args.tables, args.steps, dev)
    else:
        best, w, t, m, backend = _run_pallas(hero, villain, n, args.launches,
                                             dev)
        betting = _run_selfplay_kernel(args.tables, args.steps, dev)
    sweep = _run_sweep169(args.sweep_rollouts, dev)
    net_axis = _run_net_axis(args.net_tables, args.net_steps,
                             args.train_tables, args.train_steps, args.pop,
                             dev)

    n = m
    rate = n / best
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if not plain else "cpu",
        "backend": backend,
        "rollouts": n,
        "seconds": best,
        "equity_AKs_vs_QQ": (w + 0.5 * t) / n,
    }), file=sys.stderr)
    out = {
        "metric": "equity_rollouts_per_sec",
        "value": rate,
        "unit": "rollouts/s",
        "vs_baseline": rate / NORTH_STAR,
    }
    out.update(betting)
    out.update(sweep)
    out.update(net_axis)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
