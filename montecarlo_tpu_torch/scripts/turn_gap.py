"""Two-street Nash-gap meter: artifacts vs the exact TURN+RIVER solve.

The port of ``scripts/turn_gap.py``. Solves the HU turn+river subgame
exactly (``models/turn_solver.py``: CFR+ across the river chance node, all
C(48, 2) combos x every river card, the no-raise tree at the nets' own
measured menu sizes) and measures each policy artifact's exploitability
inside it. Gap = br1 + br2 - pot in bb per subgame hand; the solver's own
gap is the convergence control.

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.turn_gap --save OUT.json \\
        [--iterations 1000] [--combo-stride 1] \\
        [--subjects es3=data/policy_6max_es3.npz ...]

``INIT`` is ``init_params(torch.Generator().manual_seed(0))``, whose
weights differ from the JAX script's ``jax.random.key(0)`` draw.
``main(argv, matmul="tpu_bf16")`` extracts the subjects' strategies as
``river_gap.main`` does under that keyword.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.models.turn_solver import (
    TurnRiverStrategy,
    best_response_values,
    exploitability_gap,
    make_turn_river_game,
    net_turn_river_strategy,
    solve_turn_river,
    strategy_values,
    turn_combos,
    turn_river_node_states,
)
from montecarlo_tpu_torch.scripts.river_gap import subject_params

BB = 10.0
BOARDS = {
    # dry king-high (the river_gap board minus its river)
    "Ks8h5d2c": [make_card(2, 13), make_card(0, 8), make_card(1, 5),
                 make_card(3, 2)],
    # wet, paired, flushy
    "9h8h7s9d": [make_card(0, 9), make_card(0, 8), make_card(2, 7),
                 make_card(1, 9)],
}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--boards", nargs="+", default=list(BOARDS))
    ap.add_argument("--subjects", nargs="+", default=[
        "es3=data/policy_6max_es3.npz",
        "es2=data/policy_6max_es2.npz",
        "reinforce=data/policy_6max_200.npz",
        "hu=data/policy_hu_300.npz",
        "untrained=INIT",
    ])
    ap.add_argument("--save", required=True,
                    help="output JSON (not in data/: its files are the "
                         "reference)")
    ap.add_argument("--combo-stride", type=int, default=1,
                    help="subsample the 1128-combo range (gaps are then "
                         "measured inside the strided-range game and "
                         "comparable only to same-stride runs)")
    return ap


def artifact_game(board4, stride: int, device, with_prelude=False):
    """The no-raise artifact game on ``board4`` at ``stride`` with its
    node states: (game, combos, turn_states, river_states[, prelude])."""
    rivers = [c for c in range(52) if c not in [int(x) for x in board4]]
    nodes = turn_river_node_states(board4, rivers=rivers,
                                   with_prelude=with_prelude, device=device)
    sizes = nodes[2]
    sub = turn_combos(board4)[::stride] if stride > 1 else None
    game, combos = make_turn_river_game(
        board4, combos=sub, pot=sizes["pot"], bet=sizes["bet"],
        river_bets=sizes["river_bets"], turn_raise=False, river_raise=False,
        device=device)
    return (game, combos) + nodes[:2] + nodes[3:]


def subject_row(game, nash, strat):
    """The JAX script's row of one extracted strategy (without its
    seconds)."""
    br1, br2 = best_response_values(game, strat)
    net_p1 = TurnRiverStrategy(
        strat.t0, nash.t1, strat.t2, nash.t3, strat.t4,
        strat.s0, nash.s1, strat.s2, nash.s3, strat.s4)
    net_p2 = TurnRiverStrategy(
        nash.t0, strat.t1, nash.t2, strat.t3, nash.t4,
        nash.s0, strat.s1, nash.s2, strat.s3, nash.s4)
    evn1, _ = strategy_values(game, net_p1)
    _, evn2 = strategy_values(game, net_p2)
    return {
        "gap_bb": round((br1 + br2 - game.pot) / BB, 4),
        "br_vs_net_p1_bb": round((game.pot - br2) / BB, 4),
        "br_vs_net_p2_bb": round((game.pot - br1) / BB, 4),
        "net_p1_vs_nash_bb": round(evn1 / BB, 4),
        "net_p2_vs_nash_bb": round(evn2 / BB, 4),
    }


def main(argv=None, device=None, matmul="f32"):
    """Solve each board, measure every subject (its strategy extracted
    with ``matmul``); save (after each row, as the JAX script does) and
    return the JAX script's result."""
    args = parser().parse_args(argv)
    dev = resolve(device)

    def synced():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    out = {"iterations": args.iterations,
           "combo_stride": args.combo_stride, "boards": {}}

    def save():
        with open(args.save, "w") as f:
            json.dump(out, f, indent=1)

    for bname in args.boards:
        t0 = synced()
        game, combos, turn_states, river_states = artifact_game(
            BOARDS[bname], args.combo_stride, dev)
        nash = solve_turn_river(
            game, iterations=args.iterations, progress_every=200,
            log=lambda d: print(json.dumps({"board": bname, **d}),
                                flush=True))
        ev1, ev2 = strategy_values(game, nash)
        solver_gap = exploitability_gap(game, nash)
        row = {
            "sizes": {"pot": game.pot, "bet": game.bet,
                      "river_bets": list(game.river_bets)},
            "combos": int(len(combos)),
            "rivers": int(game.keys.shape[0]),
            "solver_gap_bb": round(solver_gap / BB, 4),
            "nash_ev_p1_bb": round(ev1 / BB, 4),
            "nash_ev_p2_bb": round(ev2 / BB, 4),
            "solve_seconds": round(synced() - t0, 1),
            "subjects": {},
        }
        out["boards"][bname] = row
        print(json.dumps({"board": bname,
                          **{k: v for k, v in row.items()
                             if k != "subjects"}}), flush=True)
        save()

        for spec in args.subjects:
            name, path = spec.split("=", 1)
            t1 = synced()
            strat = net_turn_river_strategy(subject_params(path),
                                            turn_states, river_states,
                                            combos, matmul)
            srow = subject_row(game, nash, strat)
            srow["eval_seconds"] = round(synced() - t1, 1)
            row["subjects"][name] = srow
            print(json.dumps({"board": bname, "subject": name, **srow}),
                  flush=True)
            save()

    print(f"saved {args.save}")
    return out


if __name__ == "__main__":
    main()
