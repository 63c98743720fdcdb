"""Decompose the plain engine's perpetual-table step on the card: the port
of ``scripts/bench_step_parts.py``.

Runs ``--steps`` steps of the plain engine (``engine/{state,step,
street}.py``, the default layers street form) on ``--tables`` six-max
tables of ``init_state(seed)`` (``--L`` / ``--PL`` layers), a body per
kind, as the JAX script's scan does:

- ``base``: ``clamp_action`` of ``random_policy`` + ``step_action``;
- ``settle`` / ``deal`` / ``both``: base plus ``settle_showdown`` and/or
  ``next_hand`` on every table, kept only where ``time < 0`` (never), so
  the work runs and the state is base's;
- ``table``: ``step_table`` (settle and deal where a hand ended);
- ``const_action``: base with every action 0 (no policy words);
- ``policy_only``: the policy, and the clock the only field stepped;
- ``carry_only``: the policy, and every field of the state bumped by a
  data-dependent 0 (the carry with no step);
- ``no_merge``, ``no_update``, ``no_append``, ``no_stage``: base with
  ``merge_bets``, ``update_bets``, ``append_layers`` or
  ``stage_transition`` the identity. They are patched where the engine
  reads them: ``engine/street.py`` for the first two (the JAX script
  patched them on ``engine/step.py``, which never reads them, so its two
  ablations timed the engine with nothing removed), ``engine/step.py``
  for the others; ``_restore`` puts them back after every run.

The policy draws from Philox sub-stream ``SUB_PERPETUAL`` (the JAX
script's threefry keys have no counterpart here; ``--prng``, which picked
the JAX PRNG implementation, is refused). Each kind is a warm-up and the
best of ``--runs`` (CUDA events; the host clock on the CPU), every run
from the same seed, ``init_state`` included as in the JAX script. Prints
one JSON line a kind. Ablations change what the engine computes:
measurement only. Nothing is written unless ``--save OUT.json``.

    python -m montecarlo_tpu_torch.scripts.bench_step_parts
        [--tables N] [--steps S] [--kinds base,settle,...] [--L 12]
        [--PL 24] [--runs R] [--save OUT.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine import step as step_mod
from montecarlo_tpu_torch.engine import street as street_mod
from montecarlo_tpu_torch.engine.state import (
    TableConfig,
    _select_tree,
    _tree_map,
    init_state,
    next_hand,
)
from montecarlo_tpu_torch.engine.step import (
    clamp_action,
    settle_showdown,
    step_action,
    step_table,
)
from montecarlo_tpu_torch.rollout.policy import (
    SUB_PERPETUAL,
    at_step,
    policy_key,
    random_policy,
)
from montecarlo_tpu_torch.scripts._timing import best_ms, device_name

I32 = torch.int32
KINDS = ("base", "settle", "deal", "both", "table", "const_action",
         "policy_only", "carry_only")
ABLATIONS = ("no_merge", "no_update", "no_append", "no_stage")
# ablation -> (the module that reads the name, the name, its identity)
PATCHES = {
    "no_merge": (street_mod, "merge_bets", lambda layers: layers),
    "no_update": (street_mod, "update_bets",
                  lambda layers, amt, seat: layers),
    "no_append": (step_mod, "append_layers", lambda dst, src: dst),
    "no_stage": (step_mod, "stage_transition",
                 lambda st, rules="reference": st),
}
SEED = 0
RUNS = 3


def _ablate(which):
    """Patch ``which``'s name where the engine reads it; returns what to
    give ``_restore``."""
    mod, name, stub = PATCHES[which]
    saved = {(mod, name): getattr(mod, name)}
    setattr(mod, name, stub)
    return saved


def _restore(saved):
    for (mod, name), fn in saved.items():
        setattr(mod, name, fn)


def _touch(state, bump):
    """Every field of ``state`` but the key changed by ``bump`` (int32 [T],
    0 in fact): ints plus it, bools xor (bump > 1)."""
    def touch(x):
        b = bump.view(-1, *[1] * (x.dim() - 1))
        if x.dtype == torch.bool:
            return x ^ (b > 1)
        return x + b.to(x.dtype)

    return state._replace(**{f: _tree_map(touch, getattr(state, f))
                             for f in state._fields if f != "key"})


def make_scan(kind, cfg, n_steps):
    """``run(seed, n_tables, device)`` -> the final state of ``n_steps``
    steps of ``kind``'s body (a kind of ``KINDS``)."""
    if kind not in KINDS:
        raise ValueError(f"kind={kind!r}: expected one of {KINDS} or an "
                         f"ablation of {ABLATIONS}")
    rules = cfg.rules

    def run(seed, n_tables, device):
        st = init_state(seed, cfg, n_tables, device)
        key = policy_key(seed, n_tables, SUB_PERPETUAL, device)
        sr = torch.zeros_like(st.stage)
        for i in range(n_steps):
            if kind == "const_action":  # engine only, no policy words
                action = clamp_action(st, torch.zeros_like(st.stage))
            else:
                action = clamp_action(st, random_policy(at_step(key, i), st,
                                                        sr))
            if kind == "policy_only":   # policy words only, no engine
                nxt = st._replace(time=st.time + (action >= -1).to(I32))
            elif kind == "carry_only":  # the whole state carried, no math
                nxt = _touch(st, (action >= -1).to(I32))
            else:
                nxt = step_action(st, action, rules=rules)
            never = nxt.time < 0  # data-dependent, always false
            if kind in ("settle", "both"):
                nxt = _select_tree(never, settle_showdown(nxt, rules=rules),
                                   nxt)
            if kind in ("deal", "both"):
                nxt = _select_tree(never, next_hand(nxt, rules=rules), nxt)
            if kind == "table":
                nxt = step_table(st, action, rules=rules)
            sr = torch.where(nxt.stage != st.stage, 0,
                             sr + ((action > 0) & ~st.hand_over).to(I32))
            st = nxt
        return st

    return run


def run_kind(kind, cfg, n_tables, n_steps, device=None, runs: int = RUNS,
             seed: int = SEED):
    """One kind (or ablation): a warm-up and the best of ``runs``, the
    patch undone after. Prints its JSON line; returns (line, the final
    state)."""
    dev = resolve(device)
    ablation = kind if kind in ABLATIONS else None
    run = make_scan("base" if ablation else kind, cfg, n_steps)
    saved = _ablate(ablation) if ablation else {}
    try:
        final, ms = best_ms(lambda: run(seed, n_tables, dev), dev, runs)
    finally:
        _restore(saved)
    rate = n_tables * n_steps / (ms / 1e3)
    line = {"kind": kind, "table_steps_per_sec": rate,
            "ns_per_table_step": 1e9 / rate, "seconds": ms / 1e3,
            "tables": n_tables, "steps": n_steps,
            "device": device_name(dev)}
    print(json.dumps(line), flush=True)
    return line, final


def main(argv=None, device=None) -> dict:
    """Every kind named; returns {kind: its JSON line}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--kinds", type=str,
                    default="base,settle,deal,both,table")
    ap.add_argument("--prng", type=str, default="")
    ap.add_argument("--L", type=int, default=12)
    ap.add_argument("--PL", type=int, default=24)
    ap.add_argument("--runs", type=int, default=RUNS)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    if args.prng:
        ap.error(f"--prng {args.prng}: the port draws from Philox alone "
                 f"(ops/philox.py); there is no PRNG implementation to pick")
    kinds = [k for k in args.kinds.split(",") if k]
    for k in kinds:
        if k not in KINDS + ABLATIONS:
            ap.error(f"kind {k!r}: expected one of {KINDS + ABLATIONS}")
    cfg = TableConfig(num_seats=6, max_layers=args.L,
                      max_pot_layers=args.PL)
    print(json.dumps({"L": args.L, "PL": args.PL}), flush=True)
    out = {k: run_kind(k, cfg, args.tables, args.steps, args.device,
                       args.runs)[0] for k in kinds}
    if args.save:
        with open(args.save, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
