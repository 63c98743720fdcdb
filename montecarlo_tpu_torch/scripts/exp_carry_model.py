"""What a word carried through the engine's step loop costs on the card.

The port of ``scripts/exp_carry_model.py``. A kernel whose body only adds 1
to each of a table's R int32 words for 512 steps, over the script's
``[1024, R, 8, 128]`` blocks (2^20 tables), with the words in registers
(``array``, swept over R), in the thread's local memory (``dict``, the
engine's struct form) and in global memory (``ref``, no carry); see
``ops/cuda_carry.py``. It prices the local-memory frames that ptxas gives
the engine kernels.

Run on a machine with a card:

    python -m montecarlo_tpu_torch.scripts.exp_carry_model

One JSON line per form and R (``array_R16`` ... ``dict_R141`` ...
``ref_R166``: ns per table-step, best of 3, CUDA events), then
``{"ns_per_table_step": {...}, "device": ...}``. ``main(device="cpu")``
runs the plain version and times it on the host clock. ``sass_check()``
reads the built kernels' step loops (``cuobjdump -sass``), to show that the
compiler kept every add.
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_carry as cc
from montecarlo_tpu_torch.scripts._timing import best_ms, device_name

TILE = cc.TILE
N_BLOCKS = 1024
N_STEPS = 512


def time_call(form: str, x: torch.Tensor, n_steps: int = N_STEPS):
    """(ns per table-step, best of 3; the output of the first launch) of
    ``n_steps`` steps of ``form`` on ``x``."""
    out, ms = best_ms(lambda: cc.carry(form, x, n_steps), x.device)
    n_tables = x.shape[0] * TILE[0] * TILE[1]
    return ms * 1e6 / (n_tables * n_steps), out


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def sass_loops(sass: str) -> dict:
    """The loops of each kernel in ``cuobjdump -sass`` output: for every
    backward branch, the instructions from its target to it, with the
    integer adds (IADD3, VIADD, IMAD.IADD, ...; by opcode in
    ``add_opcodes``), the local and global loads and stores among them, and
    every instruction by opcode (``opcodes``, its modifiers dropped).
    Returns {kernel: [loop, ...]}, innermost loops first."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = chunk.split("\n", 1)
        code = [(int(a, 16), re.sub(r"^@!?P\w+\s+", "", text))
                for a, text in _SASS_LINE.findall(body)]
        loops = []
        for addr, text in code:
            m = _BRANCH.search(text)
            if not m or int(m.group(1), 16) >= addr:
                continue
            ops = [t.split()[0] for a, t in code
                   if int(m.group(1), 16) <= a <= addr]
            adds = [o for o in ops
                    if o.startswith(("IADD", "VIADD", "IMAD.IADD"))]
            bases = [o.split(".")[0] for o in ops]
            count = {"instructions": len(ops), "adds": len(adds),
                     "add_opcodes": {o: adds.count(o)
                                     for o in sorted(set(adds))},
                     "opcodes": {o: bases.count(o)
                                 for o in sorted(set(bases))}}
            for mem in ("LDL", "STL", "LDG", "STG"):
                count[mem.lower()] = sum(o.startswith(mem) for o in ops)
            loops.append(count)
        out[name.strip()] = sorted(loops, key=lambda c: c["instructions"])
    return out


def sass_check() -> dict:
    """``sass_loops`` of the carry probe library (built if needed), read
    with the toolkit's ``cuobjdump``: shows whether each kernel's step
    loop still holds its R adds (and, for ``ref``, its loads and stores),
    that is, whether the compiler folded the loop."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.carry_library_path())],
                          capture_output=True, text=True, check=True).stdout
    return sass_loops(sass)


def main(device=None, n_blocks: int = N_BLOCKS, n_steps: int = N_STEPS):
    """Every form at each of its R from zeros, as the script; returns the
    ns per table-step by key."""
    dev = resolve(device)
    results = {}
    for form in cc.FORMS:
        for R in cc.R_OF[form]:
            x = torch.zeros((n_blocks, R) + TILE, dtype=torch.int32,
                            device=dev)
            key = f"{form}_R{R}"
            results[key] = time_call(form, x, n_steps)[0]
            print(json.dumps({key: results[key]}), flush=True)
    print(json.dumps({"ns_per_table_step": results,
                      "device": device_name(dev)}))
    return results


if __name__ == "__main__":
    main()
