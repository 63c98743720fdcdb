"""The carry probe on the card: what a word carried through the step loop
costs, in registers, in local memory and in global memory.

The counterpart of ``scripts/exp_carry_model.py``'s three Pallas kernels
(``carry_array`` :46, ``carry_dict`` :63, ``ref_resident`` :82): a table's
R int32 words go through ``n_steps`` steps that add 1 to every word, on the
script's layout ``[n_blocks, R, 8, 128]`` (1024 tables per block). The
kernels (``csrc/probe_carry.cu``, one library of their own) run one thread
per table and differ only in where the words live:

- ``array``: a private array reached by compile-time indices (registers);
- ``dict``: the engine's form, a struct of R rows walked with a run-time
  index (the thread's local memory);
- ``ref``: no carry, the words loaded and stored in global memory each
  step.

The plain version is ``state + n_steps`` in wrapping int32 arithmetic. The
wrapper runs it for a CPU tensor and launches the kernel (or raises) for a
CUDA tensor; ``LAUNCHES`` counts the launches per form and R.
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.ops import _build

I32 = torch.int32
I64 = torch.int64
TILE = (8, 128)
FORMS = ("array", "dict", "ref")
# The word counts each form is built for (csrc/probe_carry.cuh): the
# script's 16, 36, 70 and 141, the engine's F at P = 6 (143 reference, 160
# standard, 166 tournament), and for the array form 192..256, where the
# registers run out (255 a thread).
R_ARRAY = (16, 36, 70, 141, 143, 160, 166, 192, 224, 248, 256)
R_ROWS = (141, 143, 160, 166)
R_OF = {"array": R_ARRAY, "dict": R_ROWS, "ref": R_ROWS}
LAUNCHES = {f"carry_{form}_R{R}": 0 for form in FORMS for R in R_OF[form]}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _carry_plain(state: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Every word plus ``n_steps``, wrapping at int32."""
    wide = state.to(I64) + n_steps
    return (((wide + (1 << 31)) % (1 << 32)) - (1 << 31)).to(I32)


def carry(form: str, state: torch.Tensor, n_steps: int) -> torch.Tensor:
    """``n_steps`` steps of +1 on every word of ``state`` (int32 [n_blocks,
    R, 8, 128]) in placement ``form``; returns a new tensor."""
    if form not in FORMS:
        raise ValueError(f"form={form!r}: expected one of {FORMS}")
    if state.dim() != 4 or tuple(state.shape[2:]) != TILE \
            or state.dtype != I32:
        raise ValueError(f"state must be int32 [n_blocks, R, 8, 128], got "
                         f"{state.dtype} {tuple(state.shape)}")
    R = state.shape[1]
    if R not in R_OF[form]:
        raise ValueError(f"R={R}: the {form} form is built for "
                         f"{R_OF[form]}")
    if not 0 <= n_steps < 1 << 31:
        raise ValueError(f"n_steps={n_steps}: expected 0..2^31 - 1")
    if state.shape[0] * TILE[0] * TILE[1] >= 1 << 31:
        raise ValueError(f"{state.shape[0]} blocks: the kernels index "
                         f"tables with int32")
    if state.device.type == "cpu":
        return _carry_plain(state, n_steps)
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    src = state.contiguous()
    out = torch.empty_like(src)
    _build.check(_build.carry_library().mc_probe_carry(
        FORMS.index(form), R, src.data_ptr(), out.data_ptr(), state.shape[0],
        n_steps, _build.stream_ptr(state.device)), "mc_probe_carry")
    LAUNCHES[f"carry_{form}_R{R}"] += 1
    return out
