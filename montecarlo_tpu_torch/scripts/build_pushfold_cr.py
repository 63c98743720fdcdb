"""Build the card-removal-correct exact push/fold artifacts on the card.

The port of ``scripts/build_pushfold_cr.py``:

1. ``pushfold_eq169_cr.npz``: the [169, 169] class equity matrix whose
   entry (a, b) is hero-a's exact all-in equity averaged over every
   disjoint (hero combo, villain combo) pair (one hero representative per
   class, all 1326 villain combos, all C(48, 5) boards), and the
   conditional pair counts (``models/pushfold.matchup_equity_matrix_cr``);
2. ``pushfold_ranges_cr.json``: the Nash jam/call ranges for 3-20 bb from
   ``solve_push_fold_cr``.

Both go to ``--out`` (never to ``data/``, whose artifacts are the
reference). The last line of the output is a JSON object with the build's
seconds, the 10 bb fractions, the card's name and power limit, and the
largest difference from the committed ``data/pushfold_eq169_cr.npz``.

Run from the repository root:
    python -m montecarlo_tpu_torch.scripts.build_pushfold_cr --out DIR
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from montecarlo_tpu_torch.device import cuda_device
from montecarlo_tpu_torch.models.pushfold import (
    matchup_equity_matrix_cr,
    solve_push_fold_cr,
)

DATA = Path(__file__).resolve().parents[2] / "data"
STACKS_BB = (3, 4, 5, 6, 8, 10, 12, 15, 20)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, type=Path,
                    help="directory for the .npz and .json (not data/)")
    args = ap.parse_args(argv)
    out = args.out.resolve()
    if out == DATA.resolve():
        ap.error("--out must not be data/: its artifacts are the reference")
    dev = cuda_device()
    out.mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    eq, n_pairs = matchup_equity_matrix_cr(elem_budget=1 << 27,
                                           progress=True, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    np.savez_compressed(out / "pushfold_eq169_cr.npz", equity=eq,
                        n_pairs=n_pairs)
    print(f"CR matrix built in {dt:.1f} s", file=sys.stderr)

    ranges = {}
    for s in STACKS_BB:
        sol = solve_push_fold_cr(eq, n_pairs, stack_bb=float(s))
        ranges[str(s)] = {
            "jam": sol.jam_range(),
            "call": sol.call_range(),
            "jam_fraction": sol.jam_fraction,
            "call_fraction": sol.call_fraction,
        }
        print(f"{s:>3}bb jam {sol.jam_fraction:.4f} "
              f"call {sol.call_fraction:.4f}: {' '.join(sol.jam_range())}",
              file=sys.stderr)
    with open(out / "pushfold_ranges_cr.json", "w") as f:
        json.dump({"stacks_bb": ranges,
                   "source": "matchup_equity_matrix_cr (exact, "
                             "card-removal-correct)"}, f, indent=1)

    result = {"built": True, "seconds": dt,
              "jam10": ranges["10"]["jam_fraction"],
              "call10": ranges["10"]["call_fraction"],
              "card": _card()}
    ref = DATA / "pushfold_eq169_cr.npz"
    if ref.exists():
        with np.load(ref) as d:
            result["max_abs_diff_equity"] = float(
                np.abs(eq - d["equity"]).max())
            result["equal_n_pairs"] = bool(
                np.array_equal(n_pairs, d["n_pairs"]))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
