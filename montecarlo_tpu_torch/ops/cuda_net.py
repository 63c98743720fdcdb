"""Policy-net evaluation inside the betting engine: kernels K5 and K6, and
K6's banked (B7) and population (B8) forms.

The counterpart of ``montecarlo_tpu/ops/pallas_engine.py:986-1668``. The
kernels run the engine of ``ops/cuda_engine.py`` on its packed state, one
thread per table, with the policy nets' weights in shared memory:

- K5 (``csrc/net.cu:mc_net_det_kernel``, ``run_net_det``; TPU:
  ``_make_net_kernel(mode="det")`` via ``run_net_det``): every seat plays
  the net of its bank by argmax, deals come from an injected per-hand
  stash, and every step settles — the bit-exact anchor;
- K6 (``mc_net_eval_kernel``; TPU: ``_make_net_kernel`` prng mode): seats
  in ``net_seats`` play a net with a Gumbel-argmax pick, the others the
  random policy, with deferred settlement and, by default, every hand from
  full stacks. Three wrappers: ``run_net_eval`` (one net),
  ``run_net_league`` (B7: B banks, seat k plays bank ``seat_to_bank[k]``)
  and ``run_net_eval_pop`` (B8: C candidates in one launch, each with its
  own banks, on common random numbers).

Banks lie side by side, a flat float32 ``[B, NUM_WEIGHTS]``, each row the
layout of ``net_weights``. The TPU joins them into one block-diagonal MLP B
times wider (``_stack_weights_league``); its extra terms are exact zeros,
so running the acting seat's bank alone gives the same logits.

A decision is ``_net_action``: the 24 features of ``models/features.py``,
the acting bank's MLP of ``models/policy_net.py`` summed in the kernel's
order, fold masked when nothing is owed, and the menu fold / call / 2bb /
max(pot + needed, 2bb). The plain versions below compute the kernels'
functions on ``[rows, tables]`` tensors; a wrapper runs them for CPU
tensors only and launches the kernel (or raises) for CUDA tensors.
``LAUNCHES`` counts kernel launches by form.

K6's words: per table and iteration of ``defer`` slots, six words per
slot — ``u`` and ``amt_bits`` of the random policy, then four Gumbel words,
drawn whether or not the seat plays the net — then the 2P+5 deal words
(``net_words_shape``). Table t reads them from Philox stream (seed, t, 0,
0), or from injected words; in a population launch table t of every
candidate reads the same words.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.models.features import NUM_FEATURES, features
from montecarlo_tpu_torch.models.policy_net import (
    HIDDEN,
    NUM_ACTIONS,
    MLPParams,
)
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops.cuda_equity import _sample_cards
from montecarlo_tpu_torch.ops.philox import stream_words, words_as_i32
from montecarlo_tpu_torch.utils.profiling import span

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

# Banks a launch may carry, and those a block holds in shared memory: 7 x
# 24,080 bytes of weights beside the block phase's staging rows (46,368
# bytes, csrc/net.cuh) fill most of the 227 KB (232,448 bytes) a block may
# use, and the kernels read banks 7 and 8 from global memory.
MAX_BANKS = 9
SHARED_BANKS = 7
# Candidates of a population launch: the grid's y dimension.
MAX_CANDIDATES = 65535
# Launch counts by form: K5 with one net or with banks; K6 with one net
# (``eval``), banks (``league``, B7), candidates (``pop``, B8) or both.
FORMS = ("det", "det_banked", "eval", "league", "pop", "league_pop")
# The rule sets of the net kernels, as of the JAX net entry points:
# tournament rules are the engine's alone.
RULES = ("reference", "standard")
LAUNCHES = {f"net_{form}_{rules}": 0 for form in FORMS for rules in RULES}
LAUNCHES["net_probe"] = 0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def net_weights(params: MLPParams, device=None) -> torch.Tensor:
    """An ``MLPParams`` -> the kernels' flat float32 [NUM_WEIGHTS] on
    ``device`` (the card when None). The kernels assume the hidden width
    ``HIDDEN`` (64): any other raises ``ValueError``."""
    width = tuple(params.w1.shape)[-1]
    if width != HIDDEN:
        raise ValueError(f"hidden width {width}: the net kernels take "
                         f"{HIDDEN}")
    for name, leaf, shape in zip(MLPParams._fields, params, WEIGHT_SHAPES):
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(leaf.shape)}, expected "
                             f"{shape}")
    return torch.cat([torch.as_tensor(x, dtype=F32).reshape(-1)
                      for x in params]).to(resolve(device))


def bank_weights(params_banks, device=None) -> torch.Tensor:
    """B ``MLPParams`` -> the banked weights, float32 [B, NUM_WEIGHTS] on
    ``device`` (the card when None); row b is ``net_weights`` of bank b."""
    with span("weights"):
        return torch.stack([net_weights(p, device) for p in params_banks])


def pop_weights(params_list, device=None, opponent=None) -> torch.Tensor:
    """C candidates -> a population launch's weights [C, B, NUM_WEIGHTS] on
    ``device`` (the card when None): B = 1 (``_stack_weights``), or B = 2
    with ``opponent`` as every candidate's bank 1."""
    dev = resolve(device)
    opp = [] if opponent is None else [net_weights(opponent, dev)]
    return torch.stack([torch.stack([net_weights(p, dev), *opp])
                        for p in params_list])


def _params_of(weights: torch.Tensor) -> MLPParams:
    """Flat weights [..., NUM_WEIGHTS] -> ``MLPParams`` views, each leaf
    with the same leading axes."""
    leaves, off = [], 0
    lead = weights.shape[:-1]
    for shape in WEIGHT_SHAPES:
        n = int(np.prod(shape))
        leaves.append(weights[..., off:off + n].reshape(*lead, *shape))
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


def _grid_logits(x, weights):
    """``policy_logits`` of C nets at once, each product and sum in its
    order: features [C, T, 24] and weights [C, NUM_WEIGHTS] -> logits
    [C, T, 4]."""
    def dense(x, w, b):
        acc = b[:, None].expand(*x.shape[:2], w.shape[2])
        for i in range(w.shape[1]):
            acc = acc + x[:, :, i, None] * w[:, None, i]
        return acc

    p = _params_of(weights)
    h = torch.relu(dense(x, p.w1, p.b1))
    h = torch.relu(dense(h, p.w2, p.b2))
    return dense(h, p.w3, p.b3)


def _bank_logits(feats, weights, bank):
    """Logits [4, C*T] of features [24, C*T]: the C*T tables are C
    candidates' T tables in turn, candidate c plays the banks
    ``weights[c]`` [B, NUM_WEIGHTS], table j the bank ``bank[j]``."""
    C, B = weights.shape[:2]
    x = feats.reshape(NUM_FEATURES, C, -1).permute(1, 2, 0)
    bank = bank.reshape(C, -1, 1)
    logits = _grid_logits(x, weights[:, 0])
    for b in range(1, B):
        logits = torch.where(bank == b, _grid_logits(x, weights[:, b]),
                             logits)
    return logits.permute(2, 0, 1).reshape(NUM_ACTIONS, -1)


def _masked_logits(st, head, P, bb, weights, seat_to_bank=None,
                   feats=None):
    """(features [24, T], logits [4, T] of each table's acting bank with
    fold masked when nothing is owed). ``weights``: [C, B, NUM_WEIGHTS]
    for C candidates' tables in turn, banks [B, NUM_WEIGHTS] or one net's
    [NUM_WEIGHTS]. ``feats``: given features in place of ``features``'
    (the K6 split's)."""
    if weights.dim() < 3:
        weights = weights.reshape(1, -1, NUM_WEIGHTS)
    seat = (st["button"] + head) % P
    if seat_to_bank is None:
        bank = torch.zeros_like(seat, dtype=I32)
    else:  # a tuple, or (in a captured loop) a tensor on the device
        bank = torch.as_tensor(seat_to_bank, dtype=I32,
                               device=seat.device)[seat.long()]
    if feats is None:
        feats = features(st, head, P, bb)
    logits = _bank_logits(feats, weights, bank)
    needed = st["lvl"].amax(0) - ce._pick(st["contrib"], head)
    mask = torch.where(needed == 0, FOLD_MASK, 0.0).to(F32)
    return feats, torch.cat([logits[:1] + mask[None], logits[1:]])


def _net_action(st, head, P, bb, weights, seat_to_bank=None, bits=None,
                feats=None):
    """The net's raw action per table: argmax (``bits`` None) or Gumbel
    pick on ``bits`` of the acting seat's bank, mapped to fold / call / 2bb
    / max(pot + needed, 2bb); ``feats`` as ``_masked_logits``."""
    _, logits = _masked_logits(st, head, P, bb, weights, seat_to_bank,
                               feats)
    idx = _argmax_pick(logits) if bits is None else \
        _gumbel_pick(logits, bits)
    total = st["lvl"].amax(0)
    needed = total - ce._pick(st["contrib"], head)
    pot = total + st["pot_amt"].sum(0, dtype=I32)
    small = 2 * bb
    pot_raise = torch.clamp(pot + needed, min=small)
    return torch.where(idx == 0, -1, torch.where(
        idx == 1, 0, torch.where(idx == 2, small, pot_raise))).to(I32)


def _bank_map(seat_to_bank, device):
    """``seat_to_bank`` as an int32 tensor on ``device`` (None stays
    None), made once before a plain version's loop."""
    return None if seat_to_bank is None else torch.tensor(
        seat_to_bank, dtype=I32, device=device)


def _run_net_det_plain(state, cards, weights, P, n_steps, sb, bb, rules,
                       seat_to_bank=None):
    """Plain version of K5; ``weights`` one net's [NUM_WEIGHTS] or banks
    [B, NUM_WEIGHTS] with ``seat_to_bank``."""
    layout, _ = ce._field_layout(P, rules)
    st = ce._unpack(ce._to_rows(state), layout)
    stash = ce._stash_rows(cards)
    stb = _bank_map(seat_to_bank, state.device)

    def step(st):
        deal = ce._stash_deal(stash, st["hand_ct"])
        head, _, _ = ce._head_info(st, P)
        raw = _net_action(st, head, P, bb, weights, stb)
        st = ce._step_nosettle(st, raw, P, rules)
        return ce._settle_pass(st, deal, P, sb, bb, rules)

    st = ce.plain_loop(st, step, lambda i: (), n_steps)
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


def _grid(state, weights):
    """A K6 launch's inputs as (state [C, n_blocks, F, 8, 128], weights
    [C, B, NUM_WEIGHTS]): one net ([n_blocks, ...] and [NUM_WEIGHTS]),
    banks ([n_blocks, ...] and [B, NUM_WEIGHTS]) or a population (both
    with the candidate axis)."""
    if state.dim() == 4:
        return state[None], weights.reshape(1, -1, NUM_WEIGHTS)
    return state, weights


def _net_eval_plain(state, words_of, weights, P, n_steps, sb, bb, ss, rules,
                    net_seats, reset_stacks, seat_to_bank=None,
                    decisions=None):
    """K6's iterations on the words ``words_of(it)`` [W, T] of each
    iteration, which every candidate's table t reads. ``decisions`` (an
    int64 [1] tensor) gets the count of net decisions added. In an eager
    loop a slot with no net decision skips the net (one read to the host
    a slot); a replayed one (``ce.replays``) computes the net on every
    table and takes it where a net seat acts."""
    grid, weights = _grid(state, weights)
    C, nb = grid.shape[:2]
    layout, _ = ce._field_layout(P, rules)
    st = ce._unpack(ce._to_rows(grid.reshape(C * nb, *grid.shape[2:])),
                    layout)
    defer = ce._defer_for(n_steps)
    stb = _bank_map(seat_to_bank, state.device)
    skip = not ce.replays(st, n_steps // defer)

    def iteration(st, words):
        for k in range(defer):
            w = words[SLOT_WORDS * k:SLOT_WORDS * (k + 1)]
            raw = ce._policy(st, w[0], w[1], P)
            head, _, exists = ce._head_info(st, P)
            seat = (st["button"] + head) % P
            use_net = ((torch.full_like(seat, net_seats) >> seat) & 1) != 0
            n_net = (use_net & exists).sum()
            if decisions is not None:
                decisions.add_(n_net)
            if not skip or int(n_net):
                raw = torch.where(use_net, _net_action(
                    st, head, P, bb, weights, stb, w[2:]), raw)
            st = ce._step_nosettle(st, raw, P, rules)
        deal = torch.stack(_sample_cards(words[SLOT_WORDS * defer:], []))
        return ce._settle_pass(st, deal, P, sb, bb, rules, ss, reset_stacks)

    st = ce.plain_loop(st, iteration, lambda it: (
        words_of(it).repeat(1, C),), n_steps // defer)
    return ce._to_blocks(ce._pack(st, layout)).reshape(state.shape)


def _run_net_eval_plain(state, words, weights, P, n_steps, sb, bb, ss, rules,
                        net_seats, reset_stacks, seat_to_bank=None):
    """Plain version of K6 (every form) on explicit words (shape
    ``net_words_shape`` of one candidate's tables)."""
    return _net_eval_plain(state, lambda it: words[it], weights, P, n_steps,
                           sb, bb, ss, rules, net_seats, reset_stacks,
                           seat_to_bank)


def _run_net_eval_plain_philox(seed, state, weights, P, n_steps, sb, bb, ss,
                               rules, net_seats, reset_stacks,
                               seat_to_bank=None, decisions=None):
    """Plain version of K6's Philox mode (every form): the state the kernel
    returns for ``seed``."""
    T = state.shape[-4] * ce.TABLES_PER_BLOCK
    return _net_eval_plain(state, lambda it: net_words(
        seed, T, P, n_steps, it, state.device), weights, P, n_steps, sb, bb,
        ss, rules, net_seats, reset_stacks, seat_to_bank, decisions)


def _net_probe_plain(state, words, weights, P, bb, rules):
    """Plain version of the probe: per table, the features, the masked
    logits and the Gumbel scores (logits + g on ``words`` [4, T]) of the
    acting seat, float32 [PROBE_ROWS, T]."""
    layout, _ = ce._field_layout(P, rules)
    st = ce._unpack(ce._to_rows(state), layout)
    head, _, _ = ce._head_info(st, P)
    feats, logits = _masked_logits(st, head, P, bb, weights)
    u = (words >> 8).to(F32) * 2.0 ** -24
    z = logits - torch.log(-torch.log(u.clamp(min=1e-12)))
    return torch.cat([feats, logits, z])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(state, weights, P, rules, lead=()):
    """``state`` a packed state (with a leading candidate axis when
    ``lead`` has two entries) and ``weights`` float32 [*lead,
    NUM_WEIGHTS] beside it."""
    if rules not in RULES:
        raise ValueError(f"rules={rules!r}: the net kernels take {RULES}")
    ce._check_config(P, rules)
    ce._check_state(state[0] if len(lead) == 2 else state, P, rules)
    want = (*lead, NUM_WEIGHTS)
    if weights.dtype != F32 or tuple(weights.shape) != want \
            or weights.device != state.device \
            or not weights.is_contiguous():
        raise ValueError(f"weights must be contiguous float32 {list(want)} "
                         f"on {state.device}, got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")


def _banks(seat_to_bank, P, n_banks):
    """(seat_to_bank as a tuple, packed four bits a seat for the kernel),
    after checking it maps each of the P seats to one of ``n_banks``."""
    if not 1 <= n_banks <= MAX_BANKS:
        raise ValueError(f"{n_banks} banks: a launch takes at most "
                         f"{MAX_BANKS}")
    stb = (0,) * P if seat_to_bank is None else \
        tuple(int(b) for b in seat_to_bank)
    if len(stb) != P or not all(0 <= b < n_banks for b in stb):
        raise ValueError(f"seat_to_bank={seat_to_bank}: expected {P} banks "
                         f"in [0, {n_banks})")
    return stb, sum(b << 4 * k for k, b in enumerate(stb))


def run_net_det(state, cards, weights, P: int, n_steps: int, sb: int,
                bb: int, rules: str, seat_to_bank=None):
    """K5: ``n_steps`` fused steps in which every seat plays the net by
    argmax; hand h > 0 is dealt from ``cards`` [n_blocks, hmax, 2P+5, 8,
    128] row min(h, hmax - 1), and stacks carry over from hand to hand.
    ``weights``: one net [NUM_WEIGHTS], or banks [B, NUM_WEIGHTS] of which
    seat k plays ``seat_to_bank[k]``. Returns the new state."""
    banked = weights.dim() == 2
    _check(state, weights, P, rules, weights.shape[:1] if banked else ())
    stb, bank_map = _banks(seat_to_bank, P, len(weights) if banked else 1)
    ce._check_stash(cards, state, P)
    if state.device.type == "cpu":
        return _run_net_det_plain(state, cards.to(I32), weights, P, n_steps,
                                  sb, bb, rules, stb)
    lib = _build.library(P)
    out = state.clone()
    crd = cards.to(I32).contiguous()
    _build.check(lib.mc_net_det(
        out.data_ptr(), crd.data_ptr(), weights.data_ptr(), state.shape[0],
        P, RULES.index(rules), n_steps, cards.shape[1], sb, bb,
        len(weights) if banked else 1, bank_map,
        _build.stream_ptr(state.device)), "mc_net_det")
    LAUNCHES[f"net_{'det_banked' if banked else 'det'}_{rules}"] += 1
    return out


def _launch_eval(form, seed, state, weights, P, n_steps, sb, bb, ss, rules,
                 net_seats, reset_stacks, seat_to_bank, words, decisions):
    """K6 in the form ``form`` of ``FORMS`` on checked inputs (see
    ``_grid`` for the shapes): the plain version for CPU tensors, else the
    kernel. ``decisions``: an int64 [1] tensor on the state's device to
    which the launch adds its count of net decisions."""
    with span(f"launch.net_{form}_{rules}"):
        grid, w3 = _grid(state, weights)
        C, nb = grid.shape[:2]
        T = nb * ce.TABLES_PER_BLOCK
        if not 0 <= net_seats < 1 << P:
            raise ValueError(f"net_seats={net_seats}: not a mask of {P} seats")
        stb, bank_map = _banks(seat_to_bank, P, w3.shape[1])
        shape = net_words_shape(T, P, n_steps)
        if words is not None and (tuple(words.shape) != shape
                                  or words.device != state.device):
            raise ValueError(f"words must be {shape} on {state.device}")
        if decisions is not None and (decisions.dtype != I64
                                      or tuple(decisions.shape) != (1,)
                                      or decisions.device != state.device):
            raise ValueError(f"decisions must be int64 [1] on {state.device}")
        if state.device.type == "cpu":
            return _net_eval_plain(
                state, (lambda it: words[it]) if words is not None else
                (lambda it: net_words(seed, T, P, n_steps, it, state.device)),
                weights, P, n_steps, sb, bb, ss, rules, net_seats,
                reset_stacks, stb, decisions)
        lib = _build.library(P)
        out = state.clone(memory_format=torch.contiguous_format)
        w32 = None if words is None else words_as_i32(words).contiguous()
        _build.check(lib.mc_net_eval(
            out.data_ptr(), int(seed), None if w32 is None else w32.data_ptr(),
            weights.data_ptr(), C, nb, P, RULES.index(rules), n_steps,
            ce._defer_for(n_steps), sb, bb, ss, net_seats, int(reset_stacks),
            ce.FOLD_P_BITS, ce.RAISE_P_BITS, w3.shape[1], bank_map,
            None if decisions is None else decisions.data_ptr(),
            _build.stream_ptr(state.device)), "mc_net_eval")
        LAUNCHES[f"net_{form}_{rules}"] += 1
        return out


def run_net_eval(seed: int, state, weights, P: int, n_steps: int, sb: int,
                 bb: int, ss: int, rules: str, net_seats: int,
                 reset_stacks: bool = True, words=None, decisions=None):
    """K6: ``n_steps`` betting slots; seats whose bit is set in
    ``net_seats`` play the net ``weights`` [NUM_WEIGHTS] (Gumbel pick), the
    others the random policy. Words from Philox keyed by (``seed``,
    table), or ``words`` (int64 in [0, 2^32), shape ``net_words_shape``).
    ``decisions``: see ``_launch_eval``. Returns the new state."""
    _check(state, weights, P, rules)
    return _launch_eval("eval", seed, state, weights, P, n_steps, sb, bb, ss,
                        rules, net_seats, reset_stacks, None, words,
                        decisions)


def run_net_league(seed: int, state, weights, P: int, n_steps: int, sb: int,
                   bb: int, ss: int, rules: str, net_seats: int,
                   seat_to_bank, reset_stacks: bool = True, words=None,
                   decisions=None):
    """B7: K6 with banks ``weights`` [B, NUM_WEIGHTS]; a seat in
    ``net_seats`` plays bank ``seat_to_bank[seat]`` (a tuple of P ints in
    [0, B)), the others the random policy. Otherwise as
    ``run_net_eval``."""
    _check(state, weights, P, rules, weights.shape[:1])
    return _launch_eval("league", seed, state, weights, P, n_steps, sb, bb,
                        ss, rules, net_seats, reset_stacks, seat_to_bank,
                        words, decisions)


def run_net_eval_pop(seed: int, state, weights, P: int, n_steps: int,
                     sb: int, bb: int, ss: int, rules: str, net_seats: int,
                     seat_to_bank=None, reset_stacks: bool = True,
                     words=None, decisions=None):
    """B8: C candidates in one launch. ``state``: [C, n_blocks, F, 8,
    128]; ``weights``: [C, B, NUM_WEIGHTS], candidate c's banks
    (B = 1, or B > 1 with ``seat_to_bank``). Table t of every candidate
    reads the words of table t, from Philox stream (``seed``, t) or
    ``words``: every candidate plays the same deals and random-seat draws
    (common random numbers), and candidate c's result equals a
    ``run_net_eval``/``run_net_league`` launch with its weights. Returns
    the new state."""
    if state.dim() != 5 or weights.dim() != 3:
        raise ValueError(f"state must be [C, n_blocks, F, 8, 128] and "
                         f"weights [C, B, {NUM_WEIGHTS}], got "
                         f"{tuple(state.shape)} and {tuple(weights.shape)}")
    C, T = state.shape[0], state.shape[1] * ce.TABLES_PER_BLOCK
    if not 1 <= C <= MAX_CANDIDATES:
        raise ValueError(f"{C} candidates: a launch takes 1..{MAX_CANDIDATES}")
    if C * T >= 1 << 31:
        raise ValueError(f"{C} candidates x {T} tables: the kernels index "
                         f"tables with int32")
    _check(state, weights, P, rules, weights.shape[:2])
    if weights.shape[0] != state.shape[0]:
        raise ValueError(f"{weights.shape[0]} candidates' weights for "
                         f"{state.shape[0]} candidates' states")
    form = "pop" if weights.shape[1] == 1 else "league_pop"
    return _launch_eval(form, seed, state, weights, P, n_steps, sb, bb, ss,
                        rules, net_seats, reset_stacks, seat_to_bank, words,
                        decisions)


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
        state.shape[0], P, RULES.index(rules), bb,
        _build.stream_ptr(state.device)), "mc_net_probe")
    LAUNCHES["net_probe"] += 1
    return out


# The net kernels, as ``net_occupancy`` names them (C entry order).
KERNELS = ("det", "eval", "probe")


def net_occupancy(kernel: str, P: int, rules: str, n_banks: int = 1):
    """(dynamic shared bytes per block, blocks an SM holds) of a launch of
    the net kernel ``kernel`` (one of ``KERNELS``: K5, K6, the probe, which
    takes one net) with ``n_banks`` banks, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports it on the
    current card. Needs a card."""
    if kernel not in KERNELS or rules not in RULES:
        raise ValueError(f"kernel={kernel!r}, rules={rules!r}: expected "
                         f"{KERNELS} and {RULES}")
    _banks(None, P, n_banks)
    out = (ctypes.c_int * 2)()
    _build.check(_build.library(P).mc_net_occupancy(
        KERNELS.index(kernel), P, RULES.index(rules), n_banks, out),
        "mc_net_occupancy")
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def initial_packed_state(seed: int, cfg, n_tables: int, device=None):
    """First-hand packed state from ``ce.first_state`` (Philox, the same on
    every device) on ``device`` (the card when None)."""
    return ce.first_state(seed, cfg, n_tables, device)


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


def _meters(hands_t, deltas, bb):
    """(bb_per_hand [P], stderr [P], hands) from the per-table hand counts
    [T] and settled seat deltas [P, T] (float64 numpy): mean settled chips
    per hand of each stable seat in big blinds, with a per-table-clustered
    standard error (``pallas_engine.selfplay_net_eval_kernel``'s meters)."""
    hands = hands_t.sum()
    means, errs = [], []
    for d in deltas:
        means.append(d.sum() / max(hands, 1) / bb)
        per_table = d / np.maximum(hands_t, 1) / bb
        errs.append(per_table.std(ddof=1) / np.sqrt(len(per_table)))
    return np.array(means), np.array(errs), int(hands)


def _meter_rows(cfg):
    """The packed rows of the meters: the hand counter, then the P seat
    deltas."""
    layout, _ = ce._field_layout(cfg.num_seats, cfg.rules)
    return [layout["hand_ct"][0]] + [layout["seat_delta"][0] + k
                                     for k in range(cfg.num_seats)]


def seat_meters(state, cfg):
    """(bb_per_hand[P], stderr[P], hands) of a packed state."""
    means, errs, hands = pop_meters(state[None], cfg)
    return means[0], errs[0], int(hands[0])


def pop_meters(state, cfg):
    """Per-candidate meters of a population state [C, n_blocks, F, 8, 128]
    (``pallas_engine._pop_meters``): (bb_per_hand [C, P], stderr [C, P],
    hands [C]). Only the hand counter and the P seat-delta rows go to the
    host; the arithmetic is ``seat_meters``'."""
    with span("meters.read"):
        rows = torch.tensor(_meter_rows(cfg), device=state.device)
        host = state.index_select(2, rows).cpu().numpy()
    with span("meters.stats"):
        host = host.astype(np.float64)
        C, _, n_rows = host.shape[:3]
        # [C, n_blocks, P + 1, 8, 128] -> per candidate [P + 1, tables]
        host = host.transpose(0, 2, 1, 3, 4).reshape(C, n_rows, -1)
        out = [_meters(c[0], c[1:], cfg.big_blind) for c in host]
    return (np.array([m for m, _, _ in out]), np.array([e for _, e, _ in out]),
            np.array([h for _, _, h in out], np.int64))


def _first_state(seed, cfg, n_tables, state0, device):
    """The first state of an entry point: ``state0`` (on ``device`` when
    one is given), else the first deal of ``seed`` on ``device``."""
    if state0 is None:
        return initial_packed_state(seed, cfg, n_tables, device)
    if device is not None and state0.device.type != torch.device(device).type:
        raise ValueError(f"state0 on {state0.device}, device={device}")
    return state0


def _chunks(launch, seed, state, n_steps, steps_per_launch):
    """``launch(launch_seed, state, chunk)`` over ``n_steps`` slots in
    chunks of ``steps_per_launch``; launch seeds (seed + done 7919) &
    0x7FFFFFFF, as the JAX package keys them."""
    done = 0
    while done < n_steps:
        chunk = min(steps_per_launch, n_steps - done)
        state = launch((seed + done * 7919) & 0x7FFFFFFF, state, chunk)
        done += chunk
    return state


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
    state = _first_state(seed, cfg, n_tables, state0, device)
    weights = net_weights(params, state.device)
    return seat_meters(_chunks(lambda s, st, n: run_net_eval(
        s, st, weights, cfg.num_seats, n, cfg.small_blind, cfg.big_blind,
        cfg.starting_stack, cfg.rules, net_seats), seed, state, n_steps,
        steps_per_launch), cfg)


def selfplay_net_league(seed: int, cfg, params_banks, seat_to_bank,
                        n_tables: int, n_steps: int, net_seats: int = -1,
                        steps_per_launch: int = 256, state0=None,
                        device=None):
    """Head-to-head (B7): seat k plays net ``params_banks[seat_to_bank[k]]``
    when it is in ``net_seats`` (-1: every seat), the random policy
    otherwise. The button rotates, so every net plays every position.
    Device and ``state0`` as ``selfplay_net_eval_kernel``.

    Returns ``(bb_per_hand[P], stderr[P], hands)``."""
    P = cfg.num_seats
    state = _first_state(seed, cfg, n_tables, state0, device)
    weights = bank_weights(params_banks, state.device)
    seats = (1 << P) - 1 if net_seats == -1 else net_seats
    return seat_meters(_chunks(lambda s, st, n: run_net_league(
        s, st, weights, P, n, cfg.small_blind, cfg.big_blind,
        cfg.starting_stack, cfg.rules, seats, seat_to_bank), seed, state,
        n_steps, steps_per_launch), cfg)


def _selfplay_pop(seed, cfg, weights, net_seats, seat_to_bank, n_tables,
                  n_steps, steps_per_launch, state0, device):
    state = _first_state(seed, cfg, n_tables, state0, device)
    # every candidate starts from the first state; the broadcast is made
    # contiguous once, because the kernel writes a whole state per launch
    state = state[None].expand(len(weights), *state.shape).contiguous()
    weights = weights.to(state.device)
    return pop_meters(_chunks(lambda s, st, n: run_net_eval_pop(
        s, st, weights, cfg.num_seats, n, cfg.small_blind, cfg.big_blind,
        cfg.starting_stack, cfg.rules, net_seats, seat_to_bank), seed, state,
        n_steps, steps_per_launch), cfg)


def selfplay_net_eval_pop(seed: int, cfg, params_list, net_seats: int,
                          n_tables: int, n_steps: int,
                          steps_per_launch: int = 256, state0=None,
                          device=None):
    """A population of nets in one launch per chunk (B8): the result of
    ``selfplay_net_eval_kernel`` run once per candidate with the same
    seed (common random numbers), with one launch for all of them.

    Returns ``(bb_per_hand[C, P], stderr[C, P], hands[C])``."""
    dev = resolve(device) if state0 is None else state0.device
    return _selfplay_pop(seed, cfg, pop_weights(params_list, dev), net_seats,
                         None, n_tables, n_steps, steps_per_launch, state0,
                         device)


def selfplay_net_league_pop(seed: int, cfg, cand_list, opponent,
                            n_tables: int, n_steps: int, seat_to_bank=None,
                            net_seats: int = -1, steps_per_launch: int = 256,
                            state0=None, device=None):
    """League fitness for a population (B8 with B = 2): candidate c plays
    bank 0 at its mapped seats against the fixed ``opponent`` (bank 1), in
    one launch per chunk on common random numbers. The default map puts
    the candidate at seat 0 and the opponent at seats 1..P-1.

    Returns ``(bb_per_hand[C, P], stderr[C, P], hands[C])``."""
    P = cfg.num_seats
    stb = (0,) + (1,) * (P - 1) if seat_to_bank is None else seat_to_bank
    dev = resolve(device) if state0 is None else state0.device
    return _selfplay_pop(seed, cfg, pop_weights(cand_list, dev, opponent),
                         (1 << P) - 1 if net_seats == -1 else net_seats, stb,
                         n_tables, n_steps, steps_per_launch, state0, device)
