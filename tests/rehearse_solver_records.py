"""Recompute the solver records of ``data/`` with the JAX package on the CPU.

The port's solvers are held on the card against these records
(``chip_smoke.py`` path j). A record row that the JAX package itself does
not reproduce in a mode is not gated in that mode; this script finds those
rows.

    python tests/rehearse_solver_records.py --out OUT.json \\
        [--parts river turn stride4 br] [--matmul f32|tpu_bf16] \\
        [--base BASE.json]

Modes (``--matmul``):
- ``f32`` (the default): ``policy_logits`` as the JAX package computes it
  on the CPU, exact float32 products;
- ``tpu_bf16``: ``policy_logits`` as XLA computes it on the TPU at its
  default precision, each of the three products' two inputs rounded to
  bfloat16 (the features, each hidden activation, ``w1``, ``w2``, ``w3``)
  and multiplied and accumulated in float32, the biases added in float32.
  The script patches ``montecarlo_tpu.models.policy_net.policy_logits``
  (which the solvers import when they extract a strategy) and
  ``montecarlo_tpu.models.distill.policy_logits`` in its own process; no
  file of the package changes.

Parts:
- ``river``: ``scripts/river_gap.py``'s two 6000-iteration solves and
  every subject row of ``data/river_gap.json``;
- ``turn``: the subject rows of ``data/turn_gap.json`` that need no solve
  (``gap_bb``, ``br_vs_net_p1_bb``, ``br_vs_net_p2_bb``) at stride 1;
- ``stride4``: the same rows of ``data/turn_gap_stride4.json``, and the
  start and distilled gaps of ``data/policy_6max_distill.npz.result.json``,
  and ``gap_bb_start_softened``: the start softened as
  ``scripts/train_es_kernel.py`` softens one, ``w3`` and ``b3`` divided by
  the 20 of the ``{"softened": 20.0}`` that heads ``logs/distill_nash.log``;
- ``br``: the dataset rows of ``scripts/distill_nash.py --mode br`` against
  es9 and es7 at strides 1 to 4, and the exact best-response edges at the
  stride whose rows equal the record's.

Each part prints one JSON line a row, the record beside it, and the
output file holds them all. With ``--base``, the output is BASE's rows
with this run's merged in, each by its part, board, subject and stride:
in ``f32`` a row's keys replace its match's, in ``tpu_bf16`` its values
become its match's ``"tpu_bf16"`` block. The committed
``tests/rehearse_solver_records.json`` is both modes (about an hour each
on four cores; the parts can run apart and merge in turn):

    python tests/rehearse_solver_records.py --out f32.json
    python tests/rehearse_solver_records.py --matmul tpu_bf16 \\
        --base f32.json --out tests/rehearse_solver_records.json
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from montecarlo_tpu.cards import make_card  # noqa: E402
from montecarlo_tpu.models import distill as jdistill  # noqa: E402
from montecarlo_tpu.models import policy_net as jpn  # noqa: E402
from montecarlo_tpu.models import river_solver as rs  # noqa: E402
from montecarlo_tpu.models import turn_solver as ts  # noqa: E402
from montecarlo_tpu.models.distill import (  # noqa: E402
    stack_examples, turn_river_examples,
)
from montecarlo_tpu.models.policy_net import (  # noqa: E402
    init_params, load_params,
)

BB = 10.0
RIVER_BOARDS = {
    "Ks8h5d2cQs": [make_card(2, 13), make_card(0, 8), make_card(1, 5),
                   make_card(3, 2), make_card(2, 12)],
    "9h8h7s9dJh": [make_card(0, 9), make_card(0, 8), make_card(2, 7),
                   make_card(1, 9), make_card(0, 11)],
}
TURN_BOARDS = {name[:8]: cards[:4] for name, cards in RIVER_BOARDS.items()}
SUBJECTS = {f"es{i}": f"data/policy_6max_es{i}.npz" for i in range(2, 10)}
SUBJECTS.update(distill="data/policy_6max_distill.npz",
                reinforce="data/policy_6max_200.npz", untrained="INIT")
SOFTEN = 20.0  # logs/distill_nash.log:1, the distillation's start
ROW_ID = ("part", "board", "subject", "stride")
NOT_VALUES = ROW_ID + ("record", "seconds", "tpu_bf16")


def tpu_bf16_logits(params, feats):
    """``policy_logits`` as XLA computes it on the TPU at its default
    precision: each product's inputs rounded to bfloat16, the products
    and their sums float32, the biases added in float32."""
    def bf16(x):
        return jnp.asarray(x, jnp.float32).astype(jnp.bfloat16) \
            .astype(jnp.float32)

    hi = jax.lax.Precision.HIGHEST
    h = jax.nn.relu(jnp.matmul(bf16(feats), bf16(params.w1), precision=hi)
                    + params.b1)
    h = jax.nn.relu(jnp.matmul(bf16(h), bf16(params.w2), precision=hi)
                    + params.b2)
    return jnp.matmul(bf16(h), bf16(params.w3), precision=hi) + params.b3


def use_matmul(mode):
    """Make the JAX solvers' strategy extraction (and distill's losses)
    compute ``policy_logits`` in ``mode`` in this process."""
    if mode == "tpu_bf16":
        jpn.policy_logits = tpu_bf16_logits
        jdistill.policy_logits = tpu_bf16_logits


def softened(params, divisor=SOFTEN):
    """``scripts/train_es_kernel.py``'s softened start: ``w3`` and ``b3``
    divided by ``divisor``."""
    return params._replace(w3=params.w3 / divisor, b3=params.b3 / divisor)


def params_of(path):
    return init_params(jax.random.key(0)) if path == "INIT" \
        else load_params(os.path.join(ROOT, path))


def record(name):
    with open(os.path.join(ROOT, "data", name)) as f:
        return json.load(f)


def turn_game(board4, stride):
    rivers = [c for c in range(52) if c not in [int(x) for x in board4]]
    turn_states, river_states, sizes = ts.turn_river_node_states(
        board4, rivers=rivers)
    sub = ts.turn_combos(board4)[::stride] if stride > 1 else None
    game, combos = ts.make_turn_river_game(
        board4, combos=sub, pot=sizes["pot"], bet=sizes["bet"],
        river_bets=sizes["river_bets"], turn_raise=False, river_raise=False)
    return game, combos, turn_states, river_states


def river_part(emit):
    rec = record("river_gap.json")
    for bname, board in RIVER_BOARDS.items():
        t0 = time.perf_counter()
        states, sizes = rs.river_node_states(board)
        game, hc, vc = rs.make_river_game(
            board, pot=sizes["pot"], bet=sizes["bet"],
            raise_=sizes["raise_"])
        nash = rs.solve_cfr_plus(game, iterations=rec["iterations"])
        ev1, _ = rs.strategy_values(game, nash)
        row = rec["boards"][bname]
        emit({"part": "river", "board": bname,
              "solver_gap_bb": round(rs.exploitability_gap(game, nash) / BB,
                                     4),
              "nash_ev_p1_bb": round(ev1 / BB, 4),
              "record": {k: row[k] for k in ("solver_gap_bb",
                                             "nash_ev_p1_bb")},
              "seconds": round(time.perf_counter() - t0, 1)})
        for name in row["subjects"]:
            strat = rs.net_river_strategy(params_of(SUBJECTS[name]), states,
                                          hc, vc)
            br1, br2 = rs.best_response_values(game, strat)
            net_p1 = rs.RiverStrategy(strat.s0, nash.s1, strat.s2, nash.s3,
                                      strat.s4)
            net_p2 = rs.RiverStrategy(nash.s0, strat.s1, nash.s2, strat.s3,
                                      nash.s4)
            emit({"part": "river", "board": bname, "subject": name,
                  "gap_bb": round((br1 + br2 - game.pot) / BB, 4),
                  "br_vs_net_p1_bb": round((game.pot - br2) / BB, 4),
                  "br_vs_net_p2_bb": round((game.pot - br1) / BB, 4),
                  "net_p1_vs_nash_bb": round(
                      rs.strategy_values(game, net_p1)[0] / BB, 4),
                  "net_p2_vs_nash_bb": round(
                      rs.strategy_values(game, net_p2)[1] / BB, 4),
                  "record": row["subjects"][name]})


def turn_rows(emit, part, rec, stride):
    for bname, board4 in TURN_BOARDS.items():
        game, combos, tstates, rstates = turn_game(board4, stride)
        row = rec["boards"][bname]
        for name in row["subjects"]:
            strat = ts.net_turn_river_strategy(
                params_of(SUBJECTS[name]), tstates, rstates, combos)
            br1, br2 = ts.best_response_values(game, strat)
            emit({"part": part, "board": bname, "subject": name,
                  "gap_bb": round((br1 + br2 - game.pot) / BB, 4),
                  "br_vs_net_p1_bb": round((game.pot - br2) / BB, 4),
                  "br_vs_net_p2_bb": round((game.pot - br1) / BB, 4),
                  "record": {k: row["subjects"][name][k] for k in
                             ("gap_bb", "br_vs_net_p1_bb",
                              "br_vs_net_p2_bb")}})


def turn_part(emit):
    turn_rows(emit, "turn", record("turn_gap.json"), 1)


def stride4_part(emit):
    rec = record("turn_gap_stride4.json")
    turn_rows(emit, "stride4", rec, rec["combo_stride"])
    dis = record("policy_6max_distill.npz.result.json")
    starts = (("gap_bb_start", params_of(dis["start"])),
              ("gap_bb_distilled", params_of("data/policy_6max_distill.npz")),
              ("gap_bb_start_softened", softened(params_of(dis["start"]))))
    for bname, board4 in TURN_BOARDS.items():
        game, combos, tstates, rstates = turn_game(board4, 4)
        gaps = {k: round(ts.exploitability_gap(
            game, ts.net_turn_river_strategy(params, tstates, rstates,
                                             combos)) / BB, 4)
            for k, params in starts}
        emit({"part": "stride4", "board": bname, "distill_result": gaps,
              "record": {k: dis["boards"][bname][k]
                         for k in ("gap_bb_start", "gap_bb_distilled")}})


def br_part(emit):
    for name in ("es9", "es7"):
        rec = record(f"br_solver_vs_{name}.npz.result.json")
        subject = params_of(rec["subject"])
        for stride in (1, 2, 3, 4):
            sets, edges = [], {}
            for bname, board4 in TURN_BOARDS.items():
                game, combos, tstates, rstates = turn_game(board4, stride)
                sub = ts.net_turn_river_strategy(subject, tstates, rstates,
                                                 combos)
                br = ts.best_response_strategy(game, sub)
                board_sets = turn_river_examples(
                    game, combos, tstates, rstates, br,
                    ts.mix_strategies(br, sub), ts.mix_strategies(sub, br))
                wt = sum(float(np.asarray(s.weight).sum())
                         for s in board_sets[:4])
                wr = sum(float(np.asarray(s.weight).sum())
                         for s in board_sets[4:])
                sets += [s._replace(weight=s.weight * (wr / max(wt, 1e-9)))
                         if i < 4 else s for i, s in enumerate(board_sets)]
                br1, _ = ts.best_response_values(game, sub)
                edges[bname] = round((br1 - game.pot / 2.0) / BB, 4)
            rows = int(stack_examples(sets).feats.shape[0])
            emit({"part": "br", "subject": name, "stride": stride,
                  "dataset_rows": rows, "exact_br_edge_bb": edges,
                  "record": {"dataset_rows": rec["dataset_rows"],
                             "exact_br_edge_bb": {
                                 b: r["exact_br_edge_bb"]
                                 for b, r in rec["boards"].items()}}})
            if rows == rec["dataset_rows"]:
                break


PARTS = {"river": river_part, "turn": turn_part, "stride4": stride4_part,
         "br": br_part}


def row_id(row):
    return tuple(row.get(k) for k in ROW_ID)


def merged(base, rows, mode):
    """``base``'s rows with ``rows`` merged in by part, board, subject and
    stride: in ``f32`` a row's keys replace its match's, in ``tpu_bf16``
    its values become its match's ``"tpu_bf16"`` block. A row without a
    match is left out."""
    out = [dict(r) for r in base]
    index = {row_id(r): r for r in out}
    for row in rows:
        match = index.get(row_id(row))
        if match is None:
            continue
        if mode == "f32":
            match.update(row)
        else:
            match[mode] = {k: v for k, v in row.items()
                           if k not in NOT_VALUES}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--parts", nargs="+", default=list(PARTS),
                    choices=list(PARTS))
    ap.add_argument("--matmul", choices=("f32", "tpu_bf16"), default="f32",
                    help="how policy_logits multiplies (see above)")
    ap.add_argument("--base", help="an earlier output to merge this run's "
                                   "rows into")
    args = ap.parse_args()
    use_matmul(args.matmul)
    base = None
    if args.base:
        with open(args.base) as f:
            base = json.load(f)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)
        if base is not None and row_id(row) not in map(row_id, base):
            print("no base row to merge this row into; left out",
                  file=sys.stderr)
        with open(args.out, "w") as f:
            json.dump(merged(base, rows, args.matmul) if base is not None
                      else rows, f, indent=1)

    for part in args.parts:
        PARTS[part](emit)


if __name__ == "__main__":
    main()
