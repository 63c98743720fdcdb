"""A/B K1's sampler, suit-mask and key choices on the card: the port of
``scripts/bench_kernel_variants.py``.

Each variant of ``ops/cuda_k1_variants.py`` (the JAX script's
``VARIANTS``, names and order kept) is its own nvcc build of
``csrc/probe_k1.cu`` (all started at once), timed on AKs vs QQ preflop at
``--n`` rollouts (2^29, the script's), a warm-up and the best of
``--runs`` (CUDA events), every run from the same seed so that the
variants that compute the same function count alike (and a variant's
runs alike: ``runs_agree``). ``--tiles`` takes launch shapes
``THREADSxWAVES`` (threads a block: 128, 256, 512 or 1024; waves of
resident blocks; K1's own is 256x16), where the JAX flag took TPU tiles
``RxC``, and times ``--tile_variant`` at each (its tile build, which
alone holds the block sizes other than 256). Prints one JSON line a run
(Grollouts/s, the equity and its standard error, seconds, wins and ties,
the launch's blocks, nvcc's seconds and, at 256 threads, ptxas's report),
then one line with the classes of variants that must count alike
(``EQUAL_CLASSES``, a variant's tiles with it) and whether they do; the
exit code is 1 unless every class and every variant's runs agree.
Variants change what the kernel computes: measurement only. Nothing is
written unless ``--save OUT.json``.

    python -m montecarlo_tpu_torch.scripts.bench_kernel_variants
        [--n N] [--variants a,b] [--tiles 512x16,1024x16]
        [--tile_variant current] [--runs R] [--save OUT.json]
        [--device cpu]

On the CPU (``--device cpu``) the plain versions run on the host clock.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_k1_variants as kv
from montecarlo_tpu_torch.scripts._timing import best_ms, device_name

SEED = 1
RUNS = 3
TILE_VARIANT = "current"
HERO = (make_card(0, 14), make_card(0, 13))
VILLAIN = (make_card(1, 12), make_card(2, 12))


def run_variant(name, n, tile=None, device=None, runs: int = RUNS,
                seed: int = SEED):
    """``name`` at ``n`` rollouts and ``tile`` (threads, waves; K1's when
    None): a warm-up and the best of ``runs``, the counts of every run
    kept (``runs_agree``: all equal). Prints and returns its JSON line."""
    dev = resolve(device)
    tile = tile or kv.TILE
    dead, hm, vm = cq._hand_masks(list(HERO), list(VILLAIN), (), dev)
    build = {}
    if dev.type == "cuda":
        b = kv.variant_build(name, tile[0])
        blocks, per_sm = kv.variant_grid(name, n, tile)
        build = {"blocks": blocks, "blocks_per_sm": per_sm,
                 "nvcc_s": b.seconds,
                 **(b.ptxas if tile[0] == kv.TILE[0] else {})}
    outs = []

    def call():
        outs.append(kv.variant_counts(name, seed, dead, hm, vm, n,
                                      tile=tile))
        return outs[-1]

    counts, ms = best_ms(call, dev, runs)
    w, t = counts.tolist()
    eq = (w + 0.5 * t) / n
    var = max((w + 0.25 * t) / n - eq * eq, 0.0)
    line = {"variant": name, "tile": f"{tile[0]}x{tile[1]}",
            "grollouts_per_s": n / (ms / 1e3) / 1e9, "eq": eq,
            "stderr": math.sqrt(var / n), "seconds": ms / 1e3, "ms": ms,
            "wins": w, "ties": t, "n": n,
            "runs_agree": all(torch.equal(o, counts) for o in outs),
            **build,
            "device": device_name(dev)}
    print(json.dumps(line), flush=True)
    return line


def equal_classes(results):
    """Each class of ``EQUAL_CLASSES`` among ``results`` (label -> line),
    a variant's tiles with it: (labels, their counts agree) for each class
    with two or more runs."""
    out = []
    for cls in kv.EQUAL_CLASSES:
        labels = [k for k, r in results.items() if r["variant"] in cls]
        if len(labels) > 1:
            counts = {(results[k]["wins"], results[k]["ties"])
                      for k in labels}
            out.append((labels, len(counts) == 1))
    return out


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 29)
    ap.add_argument("--variants", type=str, default=",".join(kv.VARIANTS))
    ap.add_argument("--tiles", type=str, default="")
    ap.add_argument("--tile_variant", type=str, default=TILE_VARIANT)
    ap.add_argument("--runs", type=int, default=RUNS)
    ap.add_argument("--save", default=None)
    ap.add_argument("--device", default=None)
    return ap


def main(argv=None, device=None) -> dict:
    """Every variant named, then ``--tile_variant`` at every tile; returns
    {"runs": label -> line, "classes": [(labels, agree), ...]}."""
    args = parser().parse_args(argv)
    dev = resolve(args.device or device)
    names = [v for v in args.variants.split(",") if v]
    tiles = [kv.parse_tile(t) for t in args.tiles.split(",") if t]
    if dev.type == "cuda":  # the builds this process has not made, at once
        todo = sorted(v for v in set(names)
                      | ({args.tile_variant} if kv.TILE in tiles else set())
                      if not _build.probe_built("k1", v))
        tile_todo = [args.tile_variant] if any(
            t[0] != kv.TILE[0] for t in tiles) and not _build.probe_built(
            "k1", args.tile_variant, tiles=True) else []
        if todo or tile_todo:
            _build.build_probes("k1", todo, tiles=tile_todo)
    results = {}
    for name in names:
        results[name] = run_variant(name, args.n, None, dev, args.runs)
    for tile in tiles:
        results[f"{args.tile_variant} tile={tile[0]}x{tile[1]}"] = \
            run_variant(args.tile_variant, args.n, tile, dev, args.runs)
    classes = equal_classes(results)
    print(json.dumps({"equal_classes": [c for c, _ in classes],
                      "classes_agree": all(ok for _, ok in classes),
                      "runs_agree": all(r["runs_agree"]
                                        for r in results.values())}),
          flush=True)
    out = {"runs": results, "classes": classes}
    if args.save:
        with open(args.save, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    res = main()
    sys.exit(0 if all(ok for _, ok in res["classes"]) and all(
        r["runs_agree"] for r in res["runs"].values()) else 1)
