"""The stage probe on the card: the whole-step engine body, one stage per
build.

The counterpart of ``scripts/debug_kernel_compile.py:27``
``compile_variant`` and its stages ``v_carry`` (:65), ``v_policy`` (:71),
``v_street`` (:78), ``v_deal`` (:94), ``v_settle`` (:103) and ``v_full``
(:127): the packed engine state (reference rules) through ``n_steps``
applications of one stage.

- ``carry``: ``hand_ct += 1``;
- ``policy``: the random policy on two words, ``street_raises += raw > 0``;
- ``street``: the street algebra on the policy's action (update on a
  raise, merge on a fold, nothing on a call), the overflow latch ORed;
- ``deal``: 2P + 5 cards into the holes and the board;
- ``settle``: every pot row's showdown payout added to the stacks (the
  pots are not cleared);
- ``full``: ``_engine_step`` at DEFER = 1, a policy draw and a deal every
  step, then the betting step and the settle pass.

The kernel (``csrc/probe_stages.cu``) is compiled once per stage into a
library of its own (``_build.build_probe``), so each stage's nvcc seconds
and ptxas report belong to it alone. Its words come from Philox stream
(seed, table, 0, 65537) or are injected. The plain versions ``v_*`` compose
the plain engine functions of ``ops/cuda_engine.py``; the wrapper runs them
for a CPU tensor and launches the stage's kernel (or raises) for a CUDA
tensor. ``LAUNCHES`` counts the launches per stage.
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops.cuda_equity import _sample_cards
from montecarlo_tpu_torch.ops.philox import stream_words, words_as_i32

I32 = torch.int32
I64 = torch.int64
STAGES = _build.STAGES
# The Philox sub-stream of the probe (csrc/probe_stages.cuh:MC_SUB_PROBE).
SUB_PROBE = 65537
LAUNCHES = {f"stage_{s}": 0 for s in STAGES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def words_per_step(stage: str, P: int) -> int:
    """Words a stage draws per step: (u, amt_bits) for the policy, 2P + 5
    for a deal."""
    return {"carry": 0, "policy": 2, "street": 2, "deal": 2 * P + 5,
            "settle": 0, "full": 2 * P + 7}[stage]


def stage_words_shape(stage: str, n_tables: int, P: int, n_steps: int):
    """Shape of a launch's injected words: [n_steps, W, n_tables]."""
    return (n_steps, words_per_step(stage, P), n_tables)


def stage_words(seed: int, n_tables: int, stage: str, P: int, step: int,
                device):
    """The kernel's Philox words of ``step``: int64 [W, n_tables]; table t
    draws from stream (seed, t, 0, SUB_PROBE)."""
    W = words_per_step(stage, P)
    t = torch.arange(n_tables, dtype=I64, device=device)
    if W == 0:
        return torch.zeros((0, n_tables), dtype=I64, device=device)
    return stream_words(seed, t, 0, SUB_PROBE, step * W, W)


# ---------------------------------------------------------------------------
# Plain versions: the script's stage bodies on the plain state [rows, T]
# ---------------------------------------------------------------------------

def v_carry(st, words, P, sb, bb):
    return {**st, "hand_ct": st["hand_ct"] + 1}


def v_policy(st, words, P, sb, bb):
    raw = ce._policy(st, words[0], words[1], P)
    return {**st, "street_raises": st["street_raises"] + (raw > 0).to(I32)}


def v_street(st, words, P, sb, bb):
    raw = ce._policy(st, words[0], words[1], P)
    total = st["lvl"].amax(0)
    up_lvl, up_ln, ovf = ce._street_update(st["lvl"], st["ln"],
                                           raw.clamp(min=0) + total, raw > 0)
    mg_lvl, mg_ln = ce._street_merge(st["lvl"], st["ln"], st["contrib"],
                                     raw < 0)
    fold = (raw < 0)[None]
    return {**st, "lvl": torch.where(fold, mg_lvl, up_lvl),
            "ln": torch.where(fold, mg_ln, up_ln),
            "overflow": st["overflow"] | ovf.to(I32)}


def v_deal(st, words, P, sb, bb):
    cards = torch.stack(_sample_cards(words, []))
    return {**st, "hole0": cards[:P], "hole1": cards[P:2 * P],
            "board": cards[2 * P:]}


def v_settle(st, words, P, sb, bb):
    n_lvl = st["lvl"].shape[0]
    T = st["stage"].shape[0]
    pots = [st[k].reshape(4, n_lvl, T) for k in ("pot_amt", "pot_set",
                                                  "pot_n")]
    payout = ce._settle_payout(st, *pots, st["in_hand"], P)
    return {**st, "stacks": st["stacks"] + payout}


def v_full(st, words, P, sb, bb):
    raw = ce._policy(st, words[0], words[1], P)
    cards = torch.stack(_sample_cards(words[2:], []))
    return ce._settle_pass(ce._step_nosettle(st, raw, P), cards, P, sb, bb)


BODIES = {"carry": v_carry, "policy": v_policy, "street": v_street,
          "deal": v_deal, "settle": v_settle, "full": v_full}


def _run_stage_plain(stage, state, words_of, P, n_steps, sb, bb):
    """``n_steps`` applications of stage ``stage`` to the packed state, the
    words of step i from ``words_of(i)`` (int64 [W, T])."""
    layout, _ = ce._field_layout(P)
    st = ce._unpack(ce._to_rows(state), layout)
    st = ce.plain_loop(st, lambda st, words: BODIES[stage](
        st, words, P, sb, bb), lambda i: (words_of(i),), n_steps)
    return ce._to_blocks(ce._pack(st, layout))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def stage_library(stage: str, P: int = 6, fresh: bool = False):
    """The ``_build.ProbeBuild`` of ``stage`` at seat count P: built (nvcc,
    afresh) on the first call or when ``fresh``, else the build made
    before in this process."""
    return _build.probe_library("stage", stage, P, fresh)


def run_stage(stage: str, seed: int, state, P: int, n_steps: int, sb: int,
              bb: int, words=None):
    """``n_steps`` applications of ``stage`` to the packed reference-rules
    state ``state`` ([n_blocks, F, 8, 128] int32); returns the new state.
    Words come from Philox keyed by (``seed``, table), the same on the CPU
    and on the card, or from ``words`` (int64 in [0, 2^32), shape
    ``stage_words_shape``)."""
    if stage not in STAGES:
        raise ValueError(f"stage={stage!r}: expected one of {STAGES}")
    ce._check_config(P, "reference")
    ce._check_state(state, P, "reference")
    T = state.shape[0] * ce.TABLES_PER_BLOCK
    shape = stage_words_shape(stage, T, P, n_steps)
    if words is not None and (tuple(words.shape) != shape
                              or words.device != state.device):
        raise ValueError(f"words must be {shape} on {state.device}")
    if state.device.type == "cpu":
        if words is None:
            return _run_stage_plain(stage, state, lambda i: stage_words(
                seed, T, stage, P, i, state.device), P, n_steps, sb, bb)
        return _run_stage_plain(stage, state, lambda i: words[i], P, n_steps,
                                sb, bb)
    lib = stage_library(stage, P).lib
    out = state.clone()
    w32 = None if words is None or shape[1] == 0 else \
        words_as_i32(words).contiguous()
    _build.check(lib.mc_probe_stage(
        out.data_ptr(), int(seed), None if w32 is None else w32.data_ptr(),
        state.shape[0], P, n_steps, sb, bb, ce.FOLD_P_BITS, ce.RAISE_P_BITS,
        _build.stream_ptr(state.device)), "mc_probe_stage")
    LAUNCHES[f"stage_{stage}"] += 1
    return out
