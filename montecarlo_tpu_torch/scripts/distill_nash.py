"""Distill exact-subgame solver strategies into a policy-net artifact.

The port of ``scripts/distill_nash.py``. Two modes (``models/distill.py``):

- ``--mode nash``: imitate the CFR+ equilibrium of the anchored
  turn+river subgames (the turn_gap boards);
- ``--mode br --subject <artifact>``: imitate the exact best response to a
  SUBJECT artifact inside the solved subgames, an attacker for the
  exploitability summary (evaluate the saved net against the subject with
  ``league_eval``).

Both modes anchor early-street behaviour to the --start artifact's own
play at the scripted preflop/flop prelude nodes, and re-measure the
anchored-subgame metrics before and after distillation as the built-in
success check (written to ``<save>.result.json``).

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.distill_nash --mode nash \\
        --start data/policy_6max_es7.npz --combo-stride 4 \\
        --iterations 1500 --steps 6000 --save OUT.npz
    python -m montecarlo_tpu_torch.scripts.distill_nash --mode br \\
        --subject data/policy_6max_es9.npz \\
        --start data/policy_6max_es9.npz --save OUT.npz

``INIT`` is ``init_params(torch.Generator().manual_seed(0))``, whose
weights differ from the JAX script's ``jax.random.key(0)`` draw.
"""

from __future__ import annotations

import argparse
import json
import time

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.models.distill import (
    distill,
    prelude_examples,
    stack_examples,
    turn_river_examples,
)
from montecarlo_tpu_torch.models.policy_net import load_params, save_params
from montecarlo_tpu_torch.models.turn_solver import (
    best_response_strategy,
    best_response_values,
    exploitability_gap,
    mix_strategies,
    net_turn_river_strategy,
    solve_turn_river,
    strategy_values,
)
from montecarlo_tpu_torch.scripts.river_gap import subject_params
from montecarlo_tpu_torch.scripts.turn_gap import BOARDS, artifact_game

BB = 10.0


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["nash", "br"], default="nash")
    ap.add_argument("--subject", default=None,
                    help="artifact to best-respond to (br mode)")
    ap.add_argument("--start", default="INIT",
                    help="init params + early-street anchor source")
    ap.add_argument("--boards", nargs="+", default=list(BOARDS))
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--progress-every", type=int, default=200)
    ap.add_argument("--combo-stride", type=int, default=1,
                    help="subsample the 1128-combo hero/villain range by "
                         "this stride; targets become the equilibrium of "
                         "the strided-range game")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--anchor-weight", type=float, default=1.0)
    ap.add_argument("--l2-init", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", required=True,
                    help="output artifact (not in data/: its files are the "
                         "reference)")
    return ap


def main(argv=None, device=None):
    """Build the examples, distill, save the artifact and the JAX script's
    ``.result.json``; return ``(params, result)``."""
    args = parser().parse_args(argv)
    if args.mode == "br" and not args.subject:
        raise SystemExit("--mode br needs --subject")
    dev = resolve(device)

    params0 = subject_params(args.start)
    subject = load_params(args.subject) if args.subject else None

    per_board = {}   # board -> (game, combos, turn_states, river_states, ..)
    data_sets, anchor_sets = [], []
    t0 = time.perf_counter()

    def mark(stage):
        print(json.dumps({"stage": stage,
                          "elapsed_s": round(time.perf_counter() - t0, 1)}),
              flush=True)

    for bname in args.boards:
        game, combos, turn_states, river_states, prelude = artifact_game(
            BOARDS[bname], args.combo_stride, dev, with_prelude=True)
        mark(f"{bname}: game built")
        per_board[bname] = (game, combos, turn_states, river_states)

        if args.mode == "nash":
            targets = solve_turn_river(
                game, iterations=args.iterations,
                progress_every=args.progress_every,
                log=lambda d: print(json.dumps({"board": bname, **d}),
                                    flush=True))
            prof_p1 = prof_p2 = targets
            per_board[bname] += (targets,)
        else:
            sub_strat = net_turn_river_strategy(
                subject, turn_states, river_states, combos)
            targets = best_response_strategy(game, sub_strat)
            # training mass where the attacker-vs-subject matchup plays
            prof_p1 = mix_strategies(targets, sub_strat)
            prof_p2 = mix_strategies(sub_strat, targets)
            per_board[bname] += (targets, sub_strat)

        mark(f"{bname}: targets ready")
        sets = turn_river_examples(game, combos, turn_states,
                                   river_states, targets, prof_p1,
                                   prof_p2)
        mark(f"{bname}: examples assembled")
        # street balance: the river rows must not drown the turn rows —
        # equalize total street mass per board
        wt = sum(float(s.weight.sum()) for s in sets[:4])
        wr = sum(float(s.weight.sum()) for s in sets[4:])
        sets = [s._replace(weight=s.weight * (wr / max(wt, 1e-9)))
                if i < 4 else s for i, s in enumerate(sets)]
        data_sets += sets
        anchor_sets += prelude_examples(params0, prelude, combos)
        print(json.dumps({"board": bname, "examples_built": True,
                          "elapsed_s": round(time.perf_counter() - t0, 1)}),
              flush=True)

    data = stack_examples(data_sets)
    anchor = stack_examples(anchor_sets)
    print(json.dumps({"dataset_rows": int(data.feats.shape[0]),
                      "anchor_rows": int(anchor.feats.shape[0])}),
          flush=True)

    params = distill(params0, data, anchor=anchor, steps=args.steps,
                     batch=args.batch, lr=args.lr,
                     anchor_weight=args.anchor_weight,
                     l2_init=args.l2_init, seed=args.seed,
                     log=lambda d: print(json.dumps(d), flush=True))
    save_params(args.save, params)

    # ---- built-in success check: anchored-subgame metrics ----
    result = {"mode": args.mode, "start": args.start,
              "subject": args.subject, "iterations": args.iterations,
              "steps": args.steps, "dataset_rows": int(data.feats.shape[0]),
              "boards": {}}
    for bname, entry in per_board.items():
        game, combos, turn_states, river_states = entry[:4]
        strat_new = net_turn_river_strategy(params, turn_states,
                                            river_states, combos)
        strat_old = net_turn_river_strategy(params0, turn_states,
                                            river_states, combos)
        row = {}
        if args.mode == "nash":
            row["gap_bb_start"] = round(
                exploitability_gap(game, strat_old) / BB, 4)
            row["gap_bb_distilled"] = round(
                exploitability_gap(game, strat_new) / BB, 4)
            row["gap_bb_solver"] = round(
                exploitability_gap(game, entry[4]) / BB, 4)
        else:
            sub_strat = entry[5]
            br1, _ = best_response_values(game, sub_strat)
            ev_exact = br1 - game.pot / 2.0
            ev_new, _ = strategy_values(
                game, mix_strategies(strat_new, sub_strat))
            ev_old, _ = strategy_values(
                game, mix_strategies(strat_old, sub_strat))
            row["exact_br_edge_bb"] = round(ev_exact / BB, 4)
            row["distilled_edge_bb"] = round(
                (ev_new - game.pot / 2.0) / BB, 4)
            row["start_edge_bb"] = round(
                (ev_old - game.pot / 2.0) / BB, 4)
            row["captured_frac"] = round(
                (ev_new - game.pot / 2.0) / max(ev_exact, 1e-9), 4)
        result["boards"][bname] = row
        print(json.dumps({"board": bname, **row}), flush=True)

    result["elapsed_s"] = round(time.perf_counter() - t0, 1)
    with open(args.save + ".result.json", "w") as f:
        json.dump(result, f, indent=1)
    print(f"saved {args.save} (+.result.json)")
    return params, result


if __name__ == "__main__":
    main()
