"""Nash-gap meter: trained artifacts vs the exact river subgame solution.

The port of ``scripts/river_gap.py``. Solves the HU river subgame
(``models/river_solver.py``: CFR+ over all C(47, 2) combos, uniform
ranges, the net's own pot-raise sizes) and measures each policy
artifact's exploitability inside it: extract the net's strategy at every
decision node for every combo, then compute the best response against it.
Gap = br1 + br2 - pot, in big blinds per hand of subgame reached; the
solver's own gap is the convergence control.

Run from the repository root (the card):
    python -m montecarlo_tpu_torch.scripts.river_gap --save OUT.json \\
        [--iterations 6000] [--subjects es3=data/policy_6max_es3.npz ...]

``INIT`` as a subject's path is ``init_params(torch.Generator()
.manual_seed(0))``, whose weights differ from the JAX script's
``jax.random.key(0)`` draw.

``main(argv, matmul="tpu_bf16")`` extracts the subjects' strategies with
``policy_net.policy_logits``' emulation of the TPU's bfloat16 matmul
inputs, under which the JAX package scored ``data/river_gap.json``; the
default is exact float32. It is a keyword of ``main`` only: the options
stay the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.models.policy_net import init_params, load_params
from montecarlo_tpu_torch.models.river_solver import (
    RiverStrategy,
    best_response_values,
    exploitability_gap,
    make_river_game,
    net_river_strategy,
    river_node_states,
    solve_cfr_plus,
    strategy_values,
)

BB = 10.0
BOARDS = {
    # dry king-high
    "Ks8h5d2cQs": [make_card(2, 13), make_card(0, 8), make_card(1, 5),
                   make_card(3, 2), make_card(2, 12)],
    # wet, paired, flushy
    "9h8h7s9dJh": [make_card(0, 9), make_card(0, 8), make_card(2, 7),
                   make_card(1, 9), make_card(0, 11)],
}


def subject_params(path):
    """An artifact's params, or the port's seed-0 random net for INIT."""
    return (init_params(torch.Generator().manual_seed(0)) if path == "INIT"
            else load_params(path))


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=6000)
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
    return ap


def subject_row(game, nash, strat):
    """The JAX script's row of one extracted strategy: its gap, the best
    responses' edges and its head-to-head against the equilibrium."""
    br1, br2 = best_response_values(game, strat)
    net_p1 = RiverStrategy(strat.s0, nash.s1, strat.s2, nash.s3, strat.s4)
    net_p2 = RiverStrategy(nash.s0, strat.s1, nash.s2, strat.s3, nash.s4)
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
    """Solve both boards, measure every subject (its strategy extracted
    with ``matmul``), save and return the JAX script's result."""
    args = parser().parse_args(argv)
    dev = resolve(device)

    def synced():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    out = {"iterations": args.iterations, "boards": {}}
    for bname, board in BOARDS.items():
        t0 = synced()
        states, sizes = river_node_states(board, device=dev)
        game, hc, vc = make_river_game(
            board, pot=sizes["pot"], bet=sizes["bet"],
            raise_=sizes["raise_"], device=dev)
        nash = solve_cfr_plus(game, iterations=args.iterations)
        ev1, ev2 = strategy_values(game, nash)
        solver_gap = exploitability_gap(game, nash)
        row = {
            "sizes": sizes, "combos": len(hc),
            "solver_gap_bb": round(solver_gap / BB, 4),
            "nash_ev_p1_bb": round(ev1 / BB, 4),
            "nash_ev_p2_bb": round(ev2 / BB, 4),
            "solve_seconds": round(synced() - t0, 1),
            "subjects": {},
        }
        print(json.dumps({"board": bname,
                          **{k: v for k, v in row.items()
                             if k != "subjects"}}), flush=True)

        for spec in args.subjects:
            name, path = spec.split("=", 1)
            strat = net_river_strategy(subject_params(path), states, hc, vc,
                                       matmul)
            srow = subject_row(game, nash, strat)
            row["subjects"][name] = srow
            print(json.dumps({"board": bname, "subject": name, **srow}),
                  flush=True)
        out["boards"][bname] = row

    with open(args.save, "w") as f:
        json.dump(out, f, indent=1)
    print(f"saved {args.save}")
    return out


if __name__ == "__main__":
    main()
