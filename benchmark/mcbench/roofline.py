"""The yardstick of the roofline shares: peaks and operation counts,
frozen here so that a change to the kernels cannot move them.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
HBM 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s counting an FMA
as two, so one rounded multiply or add a lane and clock is 33.5 T/s.
Integer operations issue to the INT32 lanes and to the FP32 lanes (IMAD,
VIADD), so their peak is also one a lane and clock, 33.5 T/s.

``OPS``: lower counts of the operations one unit of work needs, counted in
the port's device code when this benchmark was defined (integer
operations unless marked float): a Philox4x32-10 block (10 rounds of two
wide multiplies, two three-way XORs, two key additions); one 7-card hand
key (multiplicity masks, two run scans, the flush mask, the payload); one
betting step (head scan, clamp, street algebra, membership); the 24
features of a decision; the MLP 24-64-64-4's products and sums in float32,
each rounded once. Where a kernel's steps depend on the data, a hand
counts one betting step, the least every hand needs.
"""

from __future__ import annotations

import math
import sys

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
INT_OPS_PER_S = 33.5e12

OPS = {"philox_block": 60, "hand_key": 60, "step": 100, "features": 100,
       "mlp_f32": 2 * (24 * 64 + 64 * 64 + 64 * 4)}


def least_seconds(n_bytes: float, int_ops: float, f32_ops: float = 0.0):
    """(seconds, what binds): the least time the card needs for the work,
    its bytes at the memory rate or its operations at their peak."""
    t = {"bytes": n_bytes / HBM_BYTES_PER_S,
         "operations": max(int_ops / INT_OPS_PER_S, f32_ops / F32_OPS_PER_S)}
    by = max(t, key=t.get)
    return t[by], by


def philox_blocks(n_words: int) -> int:
    return math.ceil(n_words / 4)


def rollout_ops(n_draw: int, n_keys: int = 2) -> int:
    """Integer operations of one equity rollout: the Philox blocks of its
    ``n_draw`` words and ``n_keys`` hand keys."""
    return philox_blocks(n_draw) * OPS["philox_block"] \
        + n_keys * OPS["hand_key"]


def engine_launch_words(P: int, n_slots: int, words_per_slot: int,
                        defer: int = 16) -> int:
    """Words a table draws in one engine launch of ``n_slots`` slots:
    per iteration of ``defer`` slots, ``words_per_slot`` a slot and the
    2P + 5 of the next deal (one slot an iteration where ``n_slots`` is
    not a multiple of ``defer``)."""
    d = defer if n_slots % defer == 0 else 1
    return n_slots // d * (words_per_slot * d + 2 * P + 5)


def engine_ops(hands: int, tables: int, launches, P: int,
               words_per_slot: int, decisions: int = 0):
    """(integer ops, float ops) of engine launches over ``tables`` tables
    (``launches``: the slots of each launch) that ended ``hands`` hands
    and made ``decisions`` net decisions: a betting step and P hand keys a
    hand, every table's Philox blocks, the features and the MLP a
    decision."""
    blocks = sum(philox_blocks(engine_launch_words(P, n, words_per_slot))
                 for n in launches)
    int_ops = (hands * OPS["step"] + tables * blocks * OPS["philox_block"]
               + hands * P * OPS["hand_key"]
               + decisions * OPS["features"])
    return int_ops, decisions * OPS["mlp_f32"]


def share_pct(name: str, n_bytes: float, int_ops: float, f32_ops: float,
              kernel_s: float):
    """The roofline share of a kernel's summed time ``kernel_s`` in %, or
    None without kernel time; what binds goes to standard error."""
    if kernel_s <= 0:
        return None
    least, by = least_seconds(n_bytes, int_ops, f32_ops)
    print(f"{name}: least {least * 1e3:.6f} ms by {by} of "
          f"{kernel_s * 1e3:.6f} ms kernel time", file=sys.stderr)
    return 100.0 * least / kernel_s


def launches_of(traffic: dict) -> list:
    """The slots of each launch of an engine request."""
    n, per = int(traffic["slots"]), int(traffic["slots_per_launch"])
    return [min(per, n - d) for d in range(0, n, per)]
