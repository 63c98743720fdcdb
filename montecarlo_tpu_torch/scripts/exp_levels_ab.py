"""A/B the levels street form against the literal layer algebra on the
plain perpetual program (2^20 six-max tables, reference rules, L=8/PL=16):
the port of ``scripts/exp_levels_ab.py``.

``rollout/selfplay.play_hands_perpetual`` runs ``--steps`` steps on
``--tables`` tables under each ``bets_impl``, from the same seed: one
warm-up, then the best of ``--runs`` timed with CUDA events (the host
clock on the CPU), ``init_state`` included. It asserts no overflow and
equal hand counts (the forms are trajectory-equal), prints one JSON line
a variant with ``hands_per_sec`` and ``ns_per_table_step``, then
``{"hands_equal": true}``. Nothing is written.

    python -m montecarlo_tpu_torch.scripts.exp_levels_ab [--device cpu]
        [--tables N] [--steps S] [--runs R]
"""

from __future__ import annotations

import argparse
import json

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.rollout.selfplay import play_hands_perpetual
from montecarlo_tpu_torch.scripts._timing import best_ms

N_TABLES = 1 << 20
N_STEPS = 128
RUNS = 3
SEED = 0


def run(name, cfg, device=None, n_tables: int = N_TABLES,
        n_steps: int = N_STEPS, runs: int = RUNS):
    """One variant: a warm-up and the best of ``runs`` (every run from
    ``SEED``, so each ends in the same state). Returns (its JSON line as a
    dict, the final states)."""
    dev = resolve(device)
    (final, hands), ms = best_ms(lambda: play_hands_perpetual(
        SEED, cfg, n_tables, n_steps, device=dev), dev, runs)
    hands, best = int(hands), ms / 1e3
    overflow = int((final.bets.overflow | final.pots.overflow).sum())
    assert overflow == 0, (name, overflow)
    line = {"variant": name, "hands_per_sec": hands / best,
            "ns_per_table_step": best / (n_tables * n_steps) * 1e9,
            "hands": hands, "seconds": best, "tables": n_tables,
            "steps": n_steps, "device": str(dev)}
    print(json.dumps(line), flush=True)
    return line, final


def main(argv=None, device=None) -> dict:
    """Both variants; returns {"layers": (line, final), "levels": ...}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=device)
    ap.add_argument("--tables", type=int, default=N_TABLES)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--runs", type=int, default=RUNS)
    args = ap.parse_args(argv)
    base = dict(num_seats=6, max_layers=8, max_pot_layers=16)
    out = {impl: run(impl, TableConfig(bets_impl=impl, **base), args.device,
                     args.tables, args.steps, args.runs)
           for impl in ("layers", "levels")}
    h_layers, h_levels = (out[k][0]["hands"] for k in ("layers", "levels"))
    # the same seed and trajectory-equal forms: the same hands
    assert h_layers == h_levels, (h_layers, h_levels)
    print(json.dumps({"hands_equal": True}), flush=True)
    return out


if __name__ == "__main__":
    main()
