"""The K6 split on the card: K6 with one piece of the net decision stubbed.

The counterpart of ``scripts/exp_net_split.py:70-95``, which times the JAX
net-eval kernel (``pallas_engine.py:1272``, K6) with one module-level
piece of its body monkeypatched at a time. The variants (``VARIANTS``):

- ``full``: K6 itself;
- ``stub_gumbel``: the pick is the argmax of the masked logits
  (``_gumbel_pick`` -> the first index of the max);
- ``stub_feat_eval``: the features' hand key is the first suit-mask word
  of the hole cards and the revealed board (``eval_masks_impl`` -> m0);
- ``stub_features``: every feature 0 (``_features`` -> zeros; the script
  returns 20, which predates the four raise features: the MLP now reads
  24);
- ``stub_net``: a net seat always checks or calls (``_net_action`` -> 0).

``stub_features`` and ``stub_feat_eval`` run copies of the staging and
the features (``probe_net.cuh``); the control ``feat_copy`` runs those
copies with nothing stubbed and returns K6's state. A stub's saving is
taken against its baseline (``BASELINES``), so that it prices the stub
and not the copies' code shape.

A stub draws no words for what it removes, as the JAX stubs draw none: a
slot reads ``slot_words`` words, an iteration ``split_words_shape``'s.
One net, standard rules (the script's); each variant changes what the
kernel computes, so the split prices K6's pieces and lies on no main path.

The kernel (``csrc/probe_net.cu``) is compiled once per variant into a
library of its own (``_build.probe_library("net_split", variant)``), on
Philox stream (seed, table, 0, 0) as K6, so that ``full`` and the control
return K6's state. The plain versions compose ``ops/cuda_net.py``'s plain
K6 (``_net_eval_plain``'s loop) with the same piece replaced (the
control's is ``full``'s); the wrapper
runs them for a CPU tensor and launches the variant's kernel (or raises)
for a CUDA tensor. ``LAUNCHES`` counts the launches per variant.
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.models.features import NUM_FEATURES, features
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.ops.cuda_equity import _sample_cards
from montecarlo_tpu_torch.ops.philox import words_as_i32

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
VARIANTS = _build.NET_SPLITS
CONTROLS = ("feat_copy",)
BASELINES = {"stub_features": "feat_copy", "stub_feat_eval": "feat_copy"}
LAUNCHES = {f"net_split_{v}": 0 for v in VARIANTS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}: expected one of {VARIANTS}")


def slot_words(variant: str) -> int:
    """Words a slot draws: u, amt_bits and four Gumbel words; the first two
    alone under ``stub_gumbel`` and ``stub_net``."""
    return 2 if variant in ("stub_gumbel", "stub_net") else cn.SLOT_WORDS


def split_words_shape(variant: str, n_tables: int, P: int, n_steps: int):
    """Shape of a launch's words: [n_steps / defer, slot_words * defer +
    2P + 5, n_tables], in the order the variant draws them."""
    defer = ce._defer_for(n_steps)
    return (n_steps // defer, slot_words(variant) * defer + 2 * P + 5,
            n_tables)


def split_words(seed: int, n_tables: int, variant: str, P: int,
                n_steps: int, it: int, device):
    """The kernel's Philox words of iteration ``it``: int64 [W, n_tables];
    table t draws from stream (seed, t, 0, 0), as K6."""
    W = split_words_shape(variant, n_tables, P, n_steps)[1]
    return ce.table_words(seed, n_tables, it * W, W, device)


# ---------------------------------------------------------------------------
# Plain versions: K6's plain iterations with the variant's piece replaced
# ---------------------------------------------------------------------------

def _first_word(m0, m1, m2, m3):
    return m0


def _net_raw(variant, st, head, P, bb, weights, bits):
    """The net's raw action per table under ``variant``."""
    if variant == "stub_net":
        return torch.zeros_like(st["stage"])
    feats = None
    if variant == "stub_features":
        feats = torch.zeros((NUM_FEATURES, st["stage"].shape[0]), dtype=F32,
                            device=st["stage"].device)
    elif variant == "stub_feat_eval":
        feats = features(st, head, P, bb, evaluate=_first_word)
    return cn._net_action(st, head, P, bb, weights,
                          bits=None if variant == "stub_gumbel" else bits,
                          feats=feats)


def _split_iteration(variant, st, words, weights, P, defer, sb, bb, ss,
                     net_seats, reset_stacks, decisions):
    """One iteration of K6 (``cn._net_eval_plain``'s: ``defer`` slots, then
    a settle pass; one net, standard rules) under ``variant`` on the state
    fields ``st`` and the iteration's words [W, T]; returns the new fields
    and adds the net decisions to ``decisions`` (an int64 [1] tensor, or
    None). The net's action is computed on every table and taken where a
    net seat acts, with no read to the host."""
    sw = slot_words(variant)
    for k in range(defer):
        w = words[sw * k:sw * (k + 1)]
        raw = ce._policy(st, w[0], w[1], P)
        head, _, exists = ce._head_info(st, P)
        seat = (st["button"] + head) % P
        use_net = ((torch.full_like(seat, net_seats) >> seat) & 1) != 0
        if decisions is not None:
            decisions += (use_net & exists).sum()
        raw = torch.where(use_net, _net_raw(variant, st, head, P, bb,
                                            weights, w[2:]), raw)
        st = ce._step_nosettle(st, raw, P, "standard")
    deal = torch.stack(_sample_cards(words[sw * defer:], []))
    return ce._settle_pass(st, deal, P, sb, bb, "standard", ss, reset_stacks)


def _split_plain(variant, state, words_of, weights, P, n_steps, sb, bb, ss,
                 net_seats, reset_stacks=True, decisions=None):
    """K6's iterations (``cn._net_eval_plain``, one net, standard rules)
    under ``variant`` on the words ``words_of(it)`` [W, T] of each
    iteration. ``decisions`` (an int64 [1] tensor) gets the count of net
    decisions added."""
    layout, _ = ce._field_layout(P, "standard")
    st = ce._unpack(ce._to_rows(state), layout)
    defer = ce._defer_for(n_steps)
    st = ce.plain_loop(st, lambda st, words: _split_iteration(
        variant, st, words, weights, P, defer, sb, bb, ss, net_seats,
        reset_stacks, decisions), lambda it: (words_of(it),),
        n_steps // defer)
    return ce._to_blocks(ce._pack(st, layout))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def run_net_split(variant: str, seed: int, state, weights, P: int,
                  n_steps: int, sb: int, bb: int, ss: int, net_seats: int,
                  reset_stacks: bool = True, words=None, decisions=None):
    """``n_steps`` slots of K6 under ``variant`` (one net ``weights``
    [NUM_WEIGHTS] at the seats of ``net_seats``, standard rules) on the
    packed state ``state``; returns the new state. Words from Philox keyed
    by (``seed``, table), or ``words`` (int64 in [0, 2^32), shape
    ``split_words_shape``). ``decisions``: an int64 [1] tensor on the
    state's device to which the launch adds its count of net decisions."""
    _check_variant(variant)
    cn._check(state, weights, P, "standard")
    T = state.shape[0] * ce.TABLES_PER_BLOCK
    if not 0 <= net_seats < 1 << P:
        raise ValueError(f"net_seats={net_seats}: not a mask of {P} seats")
    shape = split_words_shape(variant, T, P, n_steps)
    if words is not None and (tuple(words.shape) != shape
                              or words.device != state.device):
        raise ValueError(f"words must be {shape} on {state.device}")
    if decisions is not None and (decisions.dtype != I64
                                  or tuple(decisions.shape) != (1,)
                                  or decisions.device != state.device):
        raise ValueError(f"decisions must be int64 [1] on {state.device}")
    if state.device.type == "cpu":
        return _split_plain(
            variant, state, (lambda it: words[it]) if words is not None else
            (lambda it: split_words(seed, T, variant, P, n_steps, it,
                                    state.device)),
            weights, P, n_steps, sb, bb, ss, net_seats, reset_stacks,
            decisions)
    lib = _build.probe_library("net_split", variant, P).lib
    out = state.clone()
    w32 = None if words is None else words_as_i32(words).contiguous()
    _build.check(lib.mc_probe_net_split(
        out.data_ptr(), int(seed), None if w32 is None else w32.data_ptr(),
        weights.data_ptr(), state.shape[0], P, cn.RULES.index("standard"),
        n_steps, ce._defer_for(n_steps), sb, bb, ss, net_seats,
        int(reset_stacks), ce.FOLD_P_BITS, ce.RAISE_P_BITS, 1, 0,
        None if decisions is None else decisions.data_ptr(),
        _build.stream_ptr(state.device)), "mc_probe_net_split")
    LAUNCHES[f"net_split_{variant}"] += 1
    return out
