"""Policy-net evaluation inside the betting engine: kernels K5 and K6.

The counterpart of ``montecarlo_tpu/ops/pallas_engine.py:986-1547`` (the
single-net form; the banked league form and the population grid are not
ported yet). Both kernels run the engine of ``ops/cuda_engine.py`` on its
packed state, one thread per table, with the policy net's weights in
shared memory:

- K5 (``csrc/net.cu:mc_net_det_kernel``, ``run_net_det``; TPU:
  ``_make_net_kernel(mode="det")`` via ``run_net_det``): every seat plays
  the net by argmax, deals come from an injected per-hand stash, and every
  step settles — the bit-exact anchor;
- K6 (``mc_net_eval_kernel``, ``run_net_eval``; TPU: ``_make_net_kernel``
  prng mode via ``run_net_eval``): seats in ``net_seats`` play the net
  with a Gumbel-argmax pick, the others the random policy, with deferred
  settlement and, by default, every hand from full stacks.

A decision is ``_net_action``: the 24 features of ``models/features.py``,
the MLP of ``models/policy_net.py`` summed in the kernel's order, fold
masked when nothing is owed, and the menu fold / call / 2bb / max(pot +
needed, 2bb). The plain versions below compute the kernels' functions on
``[rows, tables]`` tensors; a wrapper runs them for CPU tensors only and
launches the kernel (or raises) for CUDA tensors. ``LAUNCHES`` counts
kernel launches.

K6's words: per table and iteration of ``defer`` slots, six words per
slot — ``u`` and ``amt_bits`` of the random policy, then four Gumbel words,
drawn whether or not the seat plays the net — then the 2P+5 deal words
(``net_words_shape``). Table t reads them from Philox stream (seed, t, 0,
0), or from injected words.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.models.features import NUM_FEATURES, features
from montecarlo_tpu_torch.models.policy_net import (
    HIDDEN,
    NUM_ACTIONS,
    MLPParams,
    policy_logits,
)
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops.cuda_equity import _sample_cards
from montecarlo_tpu_torch.ops.philox import stream_words, words_as_i32

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32

# The flat weight buffer of the kernels: w1 [24, 64], b1, w2 [64, 64], b2,
# w3 [64, 4], b3, each row-major in the JAX layout ([in, out]).
WEIGHT_SHAPES = ((NUM_FEATURES, HIDDEN), (HIDDEN,), (HIDDEN, HIDDEN),
                 (HIDDEN,), (HIDDEN, NUM_ACTIONS), (NUM_ACTIONS,))
NUM_WEIGHTS = sum(int(np.prod(s)) for s in WEIGHT_SHAPES)  # 6020
SLOT_WORDS = 2 + NUM_ACTIONS  # random policy (u, amt_bits) + Gumbel
PROBE_ROWS = NUM_FEATURES + 2 * NUM_ACTIONS
FOLD_MASK = -1e9

LAUNCHES = {f"net_{mode}_{rules}": 0
            for mode in ("det", "eval") for rules in ce.RULES}
LAUNCHES["net_probe"] = 0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def net_weights(params: MLPParams, device=None) -> torch.Tensor:
    """An ``MLPParams`` -> the kernels' flat float32 [NUM_WEIGHTS] on
    ``device`` (the card when None)."""
    for name, leaf, shape in zip(MLPParams._fields, params, WEIGHT_SHAPES):
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(leaf.shape)}, expected "
                             f"{shape}")
    return torch.cat([torch.as_tensor(x, dtype=F32).reshape(-1)
                      for x in params]).to(resolve(device))


def _params_of(weights: torch.Tensor) -> MLPParams:
    leaves, off = [], 0
    for shape in WEIGHT_SHAPES:
        n = int(np.prod(shape))
        leaves.append(weights[off:off + n].view(shape))
        off += n
    return MLPParams(*leaves)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _gumbel_pick(logits, bits):
    """Categorical pick over the leading axis by Gumbel argmax on explicit
    words (int64 in [0, 2^32), [4, T]): u = (bits >> 8) 2^-24,
    g = -log(-log(max(u, 1e-12))), the first index attaining the max."""
    u = (bits >> 8).to(F32) * 2.0 ** -24
    return _argmax_pick(logits - torch.log(-torch.log(u.clamp(min=1e-12))))


def _argmax_pick(logits):
    """First index attaining the max over the leading axis."""
    n = logits.shape[0]
    rows = torch.arange(n, dtype=I32, device=logits.device).view(-1, 1)
    return torch.where(logits == logits.amax(0), rows, n).amin(0)


def _masked_logits(st, head, P, bb, params):
    """(features [24, T], logits [4, T] with fold masked when nothing is
    owed)."""
    feats = features(st, head, P, bb)
    logits = policy_logits(params, feats.T).T
    needed = st["lvl"].amax(0) - ce._pick(st["contrib"], head)
    mask = torch.where(needed == 0, FOLD_MASK, 0.0).to(F32)
    return feats, torch.cat([logits[:1] + mask[None], logits[1:]])


def _net_action(st, head, P, bb, params, bits=None):
    """The net's raw action per table: argmax (``bits`` None) or Gumbel
    pick on ``bits``, mapped to fold / call / 2bb / max(pot + needed,
    2bb)."""
    _, logits = _masked_logits(st, head, P, bb, params)
    idx = _argmax_pick(logits) if bits is None else \
        _gumbel_pick(logits, bits)
    total = st["lvl"].amax(0)
    needed = total - ce._pick(st["contrib"], head)
    pot = total + st["pot_amt"].sum(0, dtype=I32)
    small = 2 * bb
    pot_raise = torch.clamp(pot + needed, min=small)
    return torch.where(idx == 0, -1, torch.where(
        idx == 1, 0, torch.where(idx == 2, small, pot_raise))).to(I32)


def _run_net_det_plain(state, cards, weights, P, n_steps, sb, bb, rules):
    """Plain version of K5."""
    layout, _ = ce._field_layout(P, rules)
    st = ce._unpack(ce._to_rows(state), layout)
    stash = ce._stash_rows(cards)
    params = _params_of(weights)
    for _ in range(n_steps):
        deal = ce._stash_deal(stash, st["hand_ct"])
        head, _, _ = ce._head_info(st, P)
        raw = _net_action(st, head, P, bb, params)
        st = ce._step_nosettle(st, raw, P, rules)
        st = ce._settle_pass(st, deal, P, sb, bb, rules)
    return ce._to_blocks(ce._pack(st, layout))


def net_words_shape(n_tables: int, P: int, n_steps: int):
    """Shape of K6's words: [n_steps / defer, 6 defer + 2P + 5, n_tables].
    Per table and iteration: for each of the ``defer`` slots, u and
    amt_bits of the random policy and four Gumbel words (rows 6k .. 6k+5),
    then the 2P+5 deal words; the Philox stream (seed, t, 0, 0) yields
    them in this order, iteration after iteration."""
    defer = ce._defer_for(n_steps)
    return (n_steps // defer, SLOT_WORDS * defer + 2 * P + 5, n_tables)


def net_words(seed: int, n_tables: int, P: int, n_steps: int, it: int,
              device):
    """K6's Philox words for iteration ``it``: int64 [W, n_tables], row
    ``it`` of ``net_words_shape``."""
    W = net_words_shape(n_tables, P, n_steps)[1]
    return ce.table_words(seed, n_tables, it * W, W, device)


def _net_eval_plain(state, words_of, weights, P, n_steps, sb, bb, ss, rules,
                    net_seats, reset_stacks, tally=None):
    """K6's iterations on the words ``words_of(it)`` of each iteration.
    ``tally`` (a dict) gets the count of net decisions under
    "net_decisions", for the operation count of a bound."""
    layout, _ = ce._field_layout(P, rules)
    st = ce._unpack(ce._to_rows(state), layout)
    params = _params_of(weights)
    defer = ce._defer_for(n_steps)
    for it in range(n_steps // defer):
        words = words_of(it)
        for k in range(defer):
            w = words[SLOT_WORDS * k:SLOT_WORDS * (k + 1)]
            raw = ce._policy(st, w[0], w[1], P)
            head, _, exists = ce._head_info(st, P)
            seat = (st["button"] + head) % P
            use_net = ((torch.full_like(seat, net_seats) >> seat) & 1) != 0
            n_net = int((use_net & exists).sum())
            if tally is not None:
                tally["net_decisions"] = tally.get("net_decisions", 0) + n_net
            if n_net:
                raw = torch.where(use_net, _net_action(
                    st, head, P, bb, params, w[2:]), raw)
            st = ce._step_nosettle(st, raw, P, rules)
        deal = torch.stack(_sample_cards(words[SLOT_WORDS * defer:], []))
        st = ce._settle_pass(st, deal, P, sb, bb, rules, ss, reset_stacks)
    return ce._to_blocks(ce._pack(st, layout))


def _run_net_eval_plain(state, words, weights, P, n_steps, sb, bb, ss, rules,
                        net_seats, reset_stacks):
    """Plain version of K6 on explicit words (shape ``net_words_shape``)."""
    return _net_eval_plain(state, lambda it: words[it], weights, P, n_steps,
                           sb, bb, ss, rules, net_seats, reset_stacks)


def _run_net_eval_plain_philox(seed, state, weights, P, n_steps, sb, bb, ss,
                               rules, net_seats, reset_stacks, tally=None):
    """Plain version of K6's Philox mode: the state the kernel returns for
    ``seed``."""
    T = state.shape[0] * ce.TABLES_PER_BLOCK
    return _net_eval_plain(state, lambda it: net_words(
        seed, T, P, n_steps, it, state.device), weights, P, n_steps, sb, bb,
        ss, rules, net_seats, reset_stacks, tally)


def _net_probe_plain(state, words, weights, P, bb, rules):
    """Plain version of the probe: per table, the features, the masked
    logits and the Gumbel scores (logits + g on ``words`` [4, T]) of the
    acting seat, float32 [PROBE_ROWS, T]."""
    layout, _ = ce._field_layout(P, rules)
    st = ce._unpack(ce._to_rows(state), layout)
    head, _, _ = ce._head_info(st, P)
    feats, logits = _masked_logits(st, head, P, bb, _params_of(weights))
    u = (words >> 8).to(F32) * 2.0 ** -24
    z = logits - torch.log(-torch.log(u.clamp(min=1e-12)))
    return torch.cat([feats, logits, z])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(state, weights, P, rules):
    ce._check_config(P, rules)
    ce._check_state(state, P, rules)
    if weights.dtype != F32 or tuple(weights.shape) != (NUM_WEIGHTS,) \
            or weights.device != state.device \
            or not weights.is_contiguous():
        raise ValueError(f"weights must be contiguous float32 "
                         f"[{NUM_WEIGHTS}] on {state.device}, got "
                         f"{weights.dtype} {tuple(weights.shape)} on "
                         f"{weights.device}")


def run_net_det(state, cards, weights, P: int, n_steps: int, sb: int,
                bb: int, rules: str):
    """K5: ``n_steps`` fused steps in which every seat plays the net by
    argmax; hand h > 0 is dealt from ``cards`` [n_blocks, hmax, 2P+5, 8,
    128] row min(h, hmax - 1), and stacks carry over from hand to hand.
    Returns the new state."""
    _check(state, weights, P, rules)
    ce._check_stash(cards, state, P)
    if state.device.type == "cpu":
        return _run_net_det_plain(state, cards.to(I32), weights, P, n_steps,
                                  sb, bb, rules)
    lib = _build.library(P)
    out = state.clone()
    crd = cards.to(I32).contiguous()
    _build.check(lib.mc_net_det(
        out.data_ptr(), crd.data_ptr(), weights.data_ptr(), state.shape[0],
        P, ce.RULES.index(rules), n_steps, cards.shape[1], sb, bb,
        _build.stream_ptr(state.device)), "mc_net_det")
    LAUNCHES[f"net_det_{rules}"] += 1
    return out


def run_net_eval(seed: int, state, weights, P: int, n_steps: int, sb: int,
                 bb: int, ss: int, rules: str, net_seats: int,
                 reset_stacks: bool = True, words=None):
    """K6: ``n_steps`` betting slots; seats whose bit is set in
    ``net_seats`` play the net (Gumbel pick), the others the random
    policy. Words from Philox keyed by (``seed``, table), or ``words``
    (int64 in [0, 2^32), shape ``net_words_shape``). Returns the new
    state."""
    _check(state, weights, P, rules)
    if not 0 <= net_seats < 1 << P:
        raise ValueError(f"net_seats={net_seats}: not a mask of {P} seats")
    shape = net_words_shape(state.shape[0] * ce.TABLES_PER_BLOCK, P, n_steps)
    if words is not None and (tuple(words.shape) != shape
                              or words.device != state.device):
        raise ValueError(f"words must be {shape} on {state.device}")
    if state.device.type == "cpu":
        if words is None:
            return _run_net_eval_plain_philox(seed, state, weights, P,
                                              n_steps, sb, bb, ss, rules,
                                              net_seats, reset_stacks)
        return _run_net_eval_plain(state, words, weights, P, n_steps, sb, bb,
                                   ss, rules, net_seats, reset_stacks)
    lib = _build.library(P)
    out = state.clone()
    w32 = None if words is None else words_as_i32(words).contiguous()
    _build.check(lib.mc_net_eval(
        out.data_ptr(), int(seed), None if w32 is None else w32.data_ptr(),
        weights.data_ptr(), state.shape[0], P, ce.RULES.index(rules),
        n_steps, ce._defer_for(n_steps), sb, bb, ss, net_seats,
        int(reset_stacks), ce.FOLD_P_BITS, ce.RAISE_P_BITS,
        _build.stream_ptr(state.device)), "mc_net_eval")
    LAUNCHES[f"net_eval_{rules}"] += 1
    return out


def net_probe(state, words, weights, P: int, bb: int, rules: str):
    """The per-table float path of one decision, for checks: features,
    masked logits and Gumbel scores on ``words`` (int64 [4, T]) of every
    table's acting seat, float32 [PROBE_ROWS, T]. The ``mc_net_probe``
    kernel for CUDA tensors (not on any main path)."""
    _check(state, weights, P, rules)
    T = state.shape[0] * ce.TABLES_PER_BLOCK
    if tuple(words.shape) != (NUM_ACTIONS, T) or words.device != state.device:
        raise ValueError(f"words must be [{NUM_ACTIONS}, {T}] on "
                         f"{state.device}")
    if state.device.type == "cpu":
        return _net_probe_plain(state, words, weights, P, bb, rules)
    out = torch.empty((PROBE_ROWS, T), dtype=F32, device=state.device)
    w32 = words_as_i32(words).contiguous()
    _build.check(_build.library(P).mc_net_probe(
        state.data_ptr(), w32.data_ptr(), weights.data_ptr(), out.data_ptr(),
        state.shape[0], P, ce.RULES.index(rules), bb,
        _build.stream_ptr(state.device)), "mc_net_probe")
    LAUNCHES["net_probe"] += 1
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def initial_packed_state(seed: int, cfg, n_tables: int, device=None):
    """First-hand packed state from ``ce.first_deal`` (Philox, the same on
    every device) on ``device`` (the card when None)."""
    return ce.pack_state(cfg, ce.first_deal(seed, n_tables, cfg.num_seats,
                                            device))


def deal_stash(seed: int, n_tables: int, P: int, hmax: int, device=None):
    """A per-hand deal stash for K5, [n_blocks, hmax, 2P+5, 8, 128], on
    ``device`` (the card when None): row h of table t is drawn like an
    in-kernel deal from Philox stream (seed, t, h, 2), which no kernel
    draws from."""
    t = torch.arange(n_tables, dtype=I64, device=resolve(device))
    rows = [torch.stack(_sample_cards(
        stream_words(seed, t, h, 2, 0, 2 * P + 5), [])) for h in range(hmax)]
    stash = torch.stack(rows)  # [hmax, 2P+5, T]
    return stash.reshape(hmax, 2 * P + 5, -1, *ce.TILE) \
        .permute(2, 0, 1, 3, 4).contiguous()


def seat_meters(state, cfg):
    """(bb_per_hand [P], stderr [P], hands): mean settled chips per hand
    of each stable seat in big blinds, with a per-table-clustered standard
    error (``pallas_engine.selfplay_net_eval_kernel``'s meters)."""
    P, bb = cfg.num_seats, cfg.big_blind
    hands_t = ce.unpack_field(state, cfg, "hand_ct").cpu().numpy() \
        .astype(np.float64)
    hands = hands_t.sum()
    means, errs = [], []
    for k in range(P):
        d = ce.unpack_field(state, cfg, "seat_delta", k).cpu().numpy() \
            .astype(np.float64)
        means.append(d.sum() / max(hands, 1) / bb)
        per_table = d / np.maximum(hands_t, 1) / bb
        errs.append(per_table.std(ddof=1) / np.sqrt(len(per_table)))
    return np.array(means), np.array(errs), int(hands)


def selfplay_net_eval_kernel(seed: int, cfg, params: MLPParams,
                             net_seats: int, n_tables: int, n_steps: int,
                             steps_per_launch: int = 256, state0=None,
                             device=None):
    """Seat-pinned policy-net evaluation: seats whose bit is set in
    ``net_seats`` play the net, the rest the random policy; every hand
    starts from full stacks, and per-seat settled deltas accumulate in
    the state. It runs on ``device``: the card when None, or the device
    of ``state0``, a first state that skips the first deal.

    Returns ``(bb_per_hand[P], stderr[P], hands)``."""
    P = cfg.num_seats
    if state0 is None:
        state = initial_packed_state(seed, cfg, n_tables, device)
    elif device is not None \
            and state0.device.type != torch.device(device).type:
        raise ValueError(f"state0 on {state0.device}, device={device}")
    else:
        state = state0
    weights = net_weights(params, state.device)
    done = 0
    while done < n_steps:
        chunk = min(steps_per_launch, n_steps - done)
        state = run_net_eval((seed + done * 7919) & 0x7FFFFFFF, state,
                             weights, P, chunk, cfg.small_blind,
                             cfg.big_blind, cfg.starting_stack, cfg.rules,
                             net_seats)
        done += chunk
    return seat_meters(state, cfg)
