"""Decision-point features for the policy net, in two forms.

The counterpart of ``montecarlo_tpu/models/features.py`` (feature order
and normalisations, ``NUM_FEATURES``):
- ``features``: the form the engine kernels use,
  ``montecarlo_tpu/ops/pallas_engine.py:_features`` (:1008) and
  ``_masked_suit_masks`` (:990), on the unpacked ``[rows, T]`` dict of
  ``ops/cuda_engine._unpack`` (tables on the last axis); the device form
  is ``csrc/net.cuh:mc_features``;
- ``state_features``: the JAX ``state_features`` (:40) on the table
  engine's ``TableState`` (``engine/``), tables on the leading axis.
Both take the same divisions and suit masks, so they give the same bits
on the same table.

Every quotient is one correctly rounded float32 division by a 0-dim
tensor on the operand's device. A Python-number divisor would let
PyTorch's CUDA path multiply by a rounded reciprocal instead, and the
features would then differ in the last bit from the kernel's
(``__fdiv_rn``).
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.engine.step import head_info
from montecarlo_tpu_torch.engine.street import _pick as _take, bets_needed, \
    bets_total
from montecarlo_tpu_torch.handval import CAT_SHIFT
from montecarlo_tpu_torch.ops.cuda_engine import _mask_bits, _pick
from montecarlo_tpu_torch.ops.evaluator import eval_masks_impl

I32 = torch.int32
F32 = torch.float32

NUM_FEATURES = 24


def _div(x, d):
    """float32 ``x / d``, correctly rounded on every device."""
    if isinstance(d, torch.Tensor):
        return x / d
    return x / torch.full((), float(d), dtype=F32, device=x.device)


def masked_suit_masks(cards, valids):
    """Four suit masks over (card, valid) pairs of equal-shaped int32
    tensors; a card whose flag is False adds nothing."""
    masks = [torch.zeros_like(cards[0]) for _ in range(4)]
    for card, valid in zip(cards, valids):
        suit = (card * 5) >> 6  # == card // 13 for 0 <= card < 64
        bit = torch.where(valid, torch.ones_like(card) << (card - 13 * suit
                                                           + 2), 0)
        masks = [m | torch.where(suit == s, bit, 0)
                 for s, m in enumerate(masks)]
    return masks


def features(st, head, P: int, bb: int, evaluate=eval_masks_impl):
    """The 24 features of the acting seat ``head`` (hand-order position)
    of every table: float32 [NUM_FEATURES, T]. ``evaluate``: the made-hand
    key of the four suit masks (the K6 split stubs it)."""
    total = st["lvl"].amax(0)
    pot = total + st["pot_amt"].sum(0, dtype=I32)
    needed = total - _pick(st["contrib"], head)
    stack = _pick(st["stacks"], head)
    stage = st["stage"]
    n_comm = torch.where(stage == 0, 0, torch.where(
        stage == 1, 3, torch.where(stage == 2, 4, 5))).to(I32)

    hole0 = _pick(st["hole0"], head)
    hole1 = _pick(st["hole1"], head)
    true_ = torch.ones_like(stage, dtype=torch.bool)
    valids = [true_, true_] + [i < n_comm for i in range(5)]
    key = evaluate(*masked_suit_masks(
        [hole0, hole1] + [st["board"][i] for i in range(5)], valids))
    category = _div((key >> CAT_SHIFT).to(F32), 8.0)
    top_rank = _div(((key >> 16) & 0xF).to(F32), 14.0)

    r0 = _div((2 + hole0 % 13).to(F32), 14.0)
    r1 = _div((2 + hole1 % 13).to(F32), 14.0)
    suited = (((hole0 * 5) >> 6) == ((hole1 * 5) >> 6)).to(F32)
    paired = (hole0 % 13 == hole1 % 13).to(F32)

    n_in = _mask_bits(st["in_hand"], P).sum(0, dtype=I32)
    n_act = _mask_bits(st["to_act"], P).sum(0, dtype=I32)
    pot_f = pot.to(F32)
    needed_f = needed.to(F32)
    one = torch.ones_like(pot_f)

    sr = st["street_raises"]
    has_aggr = sr > 0
    rel_raiser = torch.where(
        has_aggr, _div(((st["last_raiser"] - head) % P).to(F32), P), 0.0)

    return torch.stack([
        (stage == 0).to(F32), (stage == 1).to(F32),
        (stage == 2).to(F32), (stage == 3).to(F32),
        _div(n_comm.to(F32), 5.0),
        _div(pot_f, 100.0 * P),
        _div(needed_f, 100.0),
        _div(stack.to(F32), 100.0),
        (needed == 0).to(F32),
        _div(n_in.to(F32), P),
        _div(n_act.to(F32), P),
        _div(head.to(F32), P),
        _div(pot_f, torch.maximum(needed_f + pot_f, one)),
        _div(_div(needed_f, bb), 10.0),
        category, top_rank, r0, r1, suited, paired,
        _div(sr.to(F32), 4.0),
        has_aggr.to(F32),
        rel_raiser,
        (sr >= 2).to(F32),
    ])


def state_features(state) -> torch.Tensor:
    """float32 [T, NUM_FEATURES]: the features of each table's head seat
    (hand-order position) on a ``TableState``."""
    P = state.num_seats
    seat, _, _ = head_info(state)
    live = (torch.arange(state.pots.capacity, device=seat.device)[None]
            < state.pots.count[:, None])
    pot = bets_total(state.bets) + torch.where(live, state.pots.amt, 0) \
        .sum(1, dtype=I32)
    needed = bets_needed(state.bets, seat)
    stack = _take(state.stacks, seat)
    bb = state.big_blind.clamp(min=1)
    stage = state.stage

    hole0 = _take(state.hole[:, :, 0], seat)
    hole1 = _take(state.hole[:, :, 1], seat)
    true_ = torch.ones_like(stage, dtype=torch.bool)
    valids = [true_, true_] + [i < state.n_community for i in range(5)]
    key = eval_masks_impl(*masked_suit_masks(
        [hole0, hole1] + [state.community[:, i] for i in range(5)], valids))
    category = _div((key >> CAT_SHIFT).to(F32), 8.0)
    top_rank = _div(((key >> 16) & 0xF).to(F32), 14.0)

    r0 = _div((2 + hole0 % 13).to(F32), 14.0)
    r1 = _div((2 + hole1 % 13).to(F32), 14.0)
    suited = (((hole0 * 5) >> 6) == ((hole1 * 5) >> 6)).to(F32)
    paired = (hole0 % 13 == hole1 % 13).to(F32)

    n_in = state.in_hand.sum(1, dtype=I32)
    n_act = state.to_act.sum(1, dtype=I32)
    pot_f = pot.to(F32)
    needed_f = needed.to(F32)
    one = torch.ones_like(pot_f)

    sr = state.street_raises
    has_aggr = sr > 0
    rel_raiser = torch.where(
        has_aggr, _div(((state.last_raiser - seat) % P).to(F32), P), 0.0)

    return torch.stack([
        (stage == 0).to(F32), (stage == 1).to(F32),
        (stage == 2).to(F32), (stage == 3).to(F32),
        _div(state.n_community.to(F32), 5.0),
        _div(pot_f, 100.0 * P),
        _div(needed_f, 100.0),
        _div(stack.to(F32), 100.0),
        (needed == 0).to(F32),
        _div(n_in.to(F32), P),
        _div(n_act.to(F32), P),
        _div(seat.to(F32), P),
        _div(pot_f, torch.maximum(needed_f + pot_f, one)),
        _div(_div(needed_f, bb.to(F32)), 10.0),
        category, top_rank, r0, r1, suited, paired,
        _div(sr.to(F32), 4.0),
        has_aggr.to(F32),
        rel_raiser,
        (sr >= 2).to(F32),
    ], dim=1)
