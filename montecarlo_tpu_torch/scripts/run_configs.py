"""Run the five BASELINE.json conformance configs end to end.

The port of ``scripts/run_configs.py``. Run from the repository root (the
card):
    python -m montecarlo_tpu_torch.scripts.run_configs [--quick]

1. Heads-up seeded hand (blinds 5/5, 100 stacks): full betting + showdown
   trace of public states.
2. 3-player all-in -> side-pot split and remaining-players elimination.
3. AKs vs QQ preflop equity, 1e6 rollouts with 95% CI (K1).
4. Parallel 6-player random-policy tables, full hands to showdown
   (1e6 tables at full scale; the plain table engine).
5. 169 canonical hands x 1e7 rollouts (scaled down with --quick): on the
   card the sweep kernel K2, one launch; on the CPU the plain sweep
   sharded over ``parallel/mesh.make_mesh()`` with its counters
   ``all_reduce``d. The device chooses; no failure falls back to the other.

Decks are the port's Philox decks, so the hands of configs 1 and 2 are
not the JAX script's; config 2's pots depend on no card and equal its.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.engine import (
    TableConfig,
    clamp_action,
    init_state,
    public_board,
    settle_showdown,
    step_action,
)
from montecarlo_tpu_torch.ops.cuda_equity import equity_sweep_kernel
from montecarlo_tpu_torch.parallel.mesh import equity_sweep, make_mesh
from montecarlo_tpu_torch.rollout.equity import canonical_hands, equity_vs_hand
from montecarlo_tpu_torch.rollout.selfplay import play_hands, selfplay_stats

H, D, S, C = 0, 1, 2, 3
# Config 4's tables and config 5's rollouts a hand, quick and full (the
# JAX script's numbers).
TABLES = {True: 1 << 12, False: 1 << 20}
SWEEP_ROLLOUTS = {True: 100_000, False: 10_000_000}


def banner(n, title):
    print(f"\n=== Config {n}: {title} " + "=" * max(0, 40 - len(title)))


def _act(st, a):
    return step_action(st, clamp_action(st, a))


def _stacks(st, ids):
    return dict(zip(ids, st.stacks[0].tolist()))


def config1(device=None):
    banner(1, "heads-up seeded hand trace (blinds 5/5)")
    cfg = TableConfig(num_seats=2, small_blind=5, big_blind=5,
                      bets_impl="levels")
    st = init_state(2024, cfg, 1, device)
    ids = ["hero", "villain"]
    print(json.dumps(public_board(st, ids)))
    # Scripted: SB calls (completes), BB checks -> flop; check-check x3 -> showdown.
    script = [0, 0] + [0, 0] * 3
    for a in script:
        st = _act(st, a)
        print(json.dumps(public_board(st, ids)))
    st = settle_showdown(st)
    print("final stacks:", _stacks(st, ids))
    return st


def config2(device=None):
    banner(2, "3-player all-in side pot")
    cfg = TableConfig(num_seats=3, bets_impl="levels")
    st = init_state(7, cfg, 1, device)
    st = st._replace(stacks=torch.tensor([[95, 90, 40]], dtype=torch.int32,
                                         device=st.stacks.device))
    ids = ["p1", "p2", "p3"]
    for a in [30, 0, 0]:  # p3 raise-all-in 40 total; p1, p2 call
        st = _act(st, a)
    print("after all-in street:", json.dumps(public_board(st, ids)))
    for a in [0, 0, 0, 0, 0, 0]:  # check down
        st = _act(st, a)
    st = settle_showdown(st)
    pots = public_board(st, ids)["pots"]
    print("pots:", json.dumps(pots))
    print("final stacks:", _stacks(st, ids))
    print("all-in seat excluded from showdown (reference board.clj:80-89):",
          bool(~st.in_hand[0, 2]))
    return pots


def config3(quick, device=None):
    banner(3, "AKs vs QQ equity, 1e6 rollouts, 95% CI")
    n = 1_000_000
    t0 = time.perf_counter()
    res = equity_vs_hand(3, [make_card(H, 14), make_card(H, 13)],
                         [make_card(D, 12), make_card(S, 12)], n,
                         device=device)
    dt = time.perf_counter() - t0
    lo, hi = res.ci95
    print(f"equity={res.equity:.5f}  95% CI [{lo:.5f}, {hi:.5f}] "
          f"(width {hi - lo:.5f})  n={res.n:,}  {dt:.2f}s")
    return res


def config4(quick, device=None):
    banner(4, "parallel 6-player random-policy tables to showdown")
    n_tables = TABLES[quick]
    # default L=12/PL=24; overflow flags monitored
    cfg = TableConfig(num_seats=6, bets_impl="levels")
    t0 = time.perf_counter()
    final = play_hands(4, cfg, n_tables, num_hands=1, device=device)
    done = float(final.hand_over.float().mean())
    dt = time.perf_counter() - t0
    stats = {k: float(v) if hasattr(v, "dtype") else v
             for k, v in selfplay_stats(final).items()}
    print(f"tables={n_tables:,} completed={done:.3f} "
          f"rate={n_tables / dt:,.0f} hands/s  {dt:.2f}s")
    print("stats:", json.dumps(stats))
    return done, stats


def config5(quick, device=None):
    banner(5, "169 canonical hands equity sweep")
    mesh = make_mesh(device)
    hands = canonical_hands()
    heroes = torch.tensor([list(cards) for _, cards in hands],
                          dtype=torch.int32)
    n_per = SWEEP_ROLLOUTS[quick]
    t0 = time.perf_counter()
    if mesh.device.type == "cuda":
        # The sweep kernel: the full sweep is one launch a card.
        eq, n = equity_sweep_kernel(5, heroes, n_per, mesh.device)
    else:
        # The plain sweep sharded over the mesh, counters all_reduced.
        eq, n = equity_sweep(mesh, 5, heroes, n_per,
                             per_device_batch=1 << (12 if quick else 16))
    dt = time.perf_counter() - t0
    order = np.argsort(-eq)
    top = [(hands[i][0], round(float(eq[i]), 4)) for i in order[:5]]
    bottom = [(hands[i][0], round(float(eq[i]), 4)) for i in order[-3:]]
    print(f"devices={mesh.size} rollouts/hand={n:,} total={169 * n:,} "
          f"{dt:.1f}s ({169 * n / dt:,.0f}/s)")
    print("top:", top, " bottom:", bottom)
    return eq, n


def main(argv=None, device=None):
    """Run the five configs on ``device`` (the card when None). Returns
    each config's result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    return {"config1": config1(device), "config2": config2(device),
            "config3": config3(args.quick, device),
            "config4": config4(args.quick, device),
            "config5": config5(args.quick, device)}


if __name__ == "__main__":
    main()
