"""A/B the cheap hands/s levers on the plain perpetual program: the port of
``scripts/exp_hands_levers.py``.

Variants (2^20 six-max tables x 128 actions, random policy, reference
rules, the plain engine's default layers street form):

- ``base L8/PL16 body1``: 8 street and 16 pot layers, one action a loop
  body (``bench.py``'s shape);
- ``caps6 L6/PL12 body1``: 6 and 12 layers (the audited zero-overflow
  envelope);
- ``body2 L8/PL16``: two actions a loop body;
- ``caps6+body2``: both.

In JAX the body was a ``scan`` body, and two actions a body halved the
carry's round trips through memory. Eager PyTorch has no scan carry: every
action is its own kernels on the same tensors either way, so ``body2`` is
the same work in a loop of two actions, and its time is reported as it
falls (it gives ``base``'s final state). Each run asserts that the
overflow latch stayed clear, so a cap too tight fails loudly. Each variant
is a warm-up and the best of ``--runs`` (CUDA events; the host clock on
the CPU), every run from the same seed, ``init_state`` included. Prints
one JSON line a variant. Nothing is written unless ``--save OUT.json``.

    python -m montecarlo_tpu_torch.scripts.exp_hands_levers
        [--tables N] [--steps S] [--runs R] [--save OUT.json]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig, init_state
from montecarlo_tpu_torch.engine.step import clamp_action, step_table
from montecarlo_tpu_torch.rollout.policy import (
    SUB_PERPETUAL,
    at_step,
    policy_key,
    random_policy,
)
from montecarlo_tpu_torch.scripts._timing import best_ms, device_name

I32 = torch.int32
N_TABLES = 1 << 20
N_STEPS = 128  # total actions per table (body2 loops N_STEPS // 2 times)
SEED = 0
RUNS = 3
VARIANTS = (("base L8/PL16 body1", 8, 1), ("caps6 L6/PL12 body1", 6, 1),
            ("body2 L8/PL16", 8, 2), ("caps6+body2", 6, 2))


def perpetual(seed, cfg, n_steps: int, actions_per_body: int = 1,
              n_tables: int = N_TABLES, device=None):
    """``n_steps`` actions of ``clamp_action`` + ``step_table`` on every
    table of ``init_state(seed)``, ``actions_per_body`` to a loop body;
    policy words on ``SUB_PERPETUAL``. Returns the final states."""
    if n_steps % actions_per_body:
        raise ValueError(f"{n_steps} steps in bodies of {actions_per_body}")
    dev = resolve(device)
    st = init_state(seed, cfg, n_tables, dev)
    key = policy_key(seed, n_tables, SUB_PERPETUAL, dev)
    street_raises = torch.zeros_like(st.stage)

    def one_action(st, street_raises, i):
        action = clamp_action(st, random_policy(at_step(key, i), st,
                                                street_raises))
        nxt = step_table(st, action, rules=cfg.rules)
        applied = (action > 0) & ~st.hand_over
        street_raises = torch.where(
            (nxt.stage != st.stage) | (nxt.hand_idx != st.hand_idx), 0,
            street_raises + applied.to(I32))
        return nxt, street_raises

    for it in range(n_steps // actions_per_body):
        for j in range(actions_per_body):
            st, street_raises = one_action(st, street_raises,
                                           it * actions_per_body + j)
    return st


def run(name, cfg, actions_per_body, n_tables: int = N_TABLES,
        n_steps: int = N_STEPS, device=None, runs: int = RUNS):
    """One variant: a warm-up and the best of ``runs``; asserts no table
    overflowed. Prints its JSON line; returns (line, the final states)."""
    dev = resolve(device)
    final, ms = best_ms(lambda: perpetual(SEED, cfg, n_steps,
                                          actions_per_body, n_tables, dev),
                        dev, runs)
    hands = int(final.hand_idx.sum())
    ovf = int((final.bets.overflow | final.pots.overflow).sum())
    assert ovf == 0, f"{name}: {ovf} overflowed tables"
    dt = ms / 1e3
    line = {"variant": name, "hands_per_sec": hands / dt,
            "ns_per_table_step": dt / (n_tables * n_steps) * 1e9,
            "seconds": dt, "hands": hands, "overflowed": ovf,
            "tables": n_tables, "steps": n_steps,
            "device": device_name(dev)}
    print(json.dumps(line), flush=True)
    return line, final


def main(argv=None, device=None) -> dict:
    """The four variants; returns {variant: its JSON line}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tables", type=int, default=N_TABLES)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--runs", type=int, default=RUNS)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    out = {}
    for name, L, body in VARIANTS:
        cfg = TableConfig(num_seats=6, max_layers=L, max_pot_layers=2 * L)
        out[name] = run(name, cfg, body, args.tables, args.steps,
                        args.device, args.runs)[0]
    if args.save:
        with open(args.save, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
