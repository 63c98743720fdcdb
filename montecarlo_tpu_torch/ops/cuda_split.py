"""The K4 split on the card: K4 with one piece of its step stubbed.

The counterpart of ``scripts/exp_step_split.py:75-117``, which times the
JAX engine kernel (``pallas_engine.py:798``, K4) with one module-level
piece of its body monkeypatched at a time. The variants (``VARIANTS``):

- ``full``: K4 itself;
- ``stub_settle``: no showdown payout (``_settle_payout`` = 0);
- ``stub_eval``: each seat's hand value the first suit-mask word of its
  seven cards (``eval_masks_cmp_impl`` -> m0);
- ``stub_deal``: the next hand's cards all 0 (``_sample_cards`` -> 0);
- ``stub_policy``: every action a check or call (``_policy_prng`` -> 0);
- ``stub_street``: the street update and merge the identity.

Three stubs run a copy of the piece that holds them (``probe_split.cuh``:
the settle pass for ``stub_settle`` and ``stub_eval``, the betting step
for ``stub_street``). The controls run those copies with nothing stubbed
and return K4's state: ``settle_copy`` and ``street_copy``. A stub's
saving is taken against its baseline (``BASELINES``), so that it prices
the stub and not the copy's code shape.

A stub draws no words for what it removes, as the JAX stubs draw none:
an iteration of ``defer`` slots reads ``split_words_shape``'s words.
Reference rules only, as the script's. Each variant changes what the
kernel computes: the split prices K4's pieces and lies on no main path.

The kernel (``csrc/probe_split.cu``) is compiled once per variant into a
library of its own (``_build.probe_library("split", variant)``), from
Philox stream (seed, table, 0, 0) as K4, so that ``full`` and the
controls return K4's state. The plain versions compose
``ops/cuda_engine.py``'s plain K4 (``_prng_plain``'s loop) with the same
piece replaced (the controls' are ``full``'s); the wrapper runs
them for a CPU tensor and launches the variant's kernel (or raises) for a
CUDA tensor. ``LAUNCHES`` counts the launches per variant.
"""

from __future__ import annotations

import functools

import torch

from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops.cuda_equity import _sample_cards

I32 = torch.int32
VARIANTS = _build.SPLITS
CONTROLS = ("settle_copy", "street_copy")
BASELINES = {"stub_settle": "settle_copy", "stub_eval": "settle_copy",
             "stub_street": "street_copy"}
LAUNCHES = {f"split_{v}": 0 for v in VARIANTS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}: expected one of {VARIANTS}")


def slot_words(variant: str) -> int:
    """Words a betting slot draws: u and amt_bits, none under
    ``stub_policy``."""
    return 0 if variant == "stub_policy" else 2


def deal_words(variant: str, P: int) -> int:
    """Words a deal draws: 2P + 5, none under ``stub_deal``."""
    return 0 if variant == "stub_deal" else 2 * P + 5


def split_words_shape(variant: str, n_tables: int, P: int, n_steps: int):
    """Shape of a launch's words: [n_steps / defer, slot_words * defer +
    deal_words, n_tables], in the order the variant draws them."""
    defer = ce._defer_for(n_steps)
    return (n_steps // defer, slot_words(variant) * defer
            + deal_words(variant, P), n_tables)


def split_words(seed: int, n_tables: int, variant: str, P: int,
                n_steps: int, it: int, device):
    """The kernel's Philox words of iteration ``it``: int64 [W, n_tables];
    table t draws from stream (seed, t, 0, 0), as K4."""
    W = split_words_shape(variant, n_tables, P, n_steps)[1]
    return ce.table_words(seed, n_tables, it * W, W, device)


# ---------------------------------------------------------------------------
# Plain versions: K4's plain iterations with the variant's piece replaced
# ---------------------------------------------------------------------------

def _no_payout(st, pots_amt, pots_set, pots_n, in_hand, P):
    return torch.zeros_like(st["stacks"])


def _first_word(m0, m1, m2, m3):
    return m0


def _no_update(lvl, ln, amount, do):
    return lvl, ln, torch.zeros_like(do)


def _no_merge(lvl, ln, contrib, do):
    return lvl, ln


def _split_iteration(variant, st, words, P, defer, sb, bb):
    """One iteration of K4 (``ce._prng_plain``'s: ``defer`` betting slots,
    then a settle pass, reference rules) under ``variant`` on the state
    fields ``st`` and the iteration's words [W, T]; returns the new
    fields."""
    sw = slot_words(variant)
    street = {"update": _no_update, "merge": _no_merge} \
        if variant == "stub_street" else {}
    payout = {"stub_settle": _no_payout,
              "stub_eval": functools.partial(ce._settle_payout,
                                             evaluate=_first_word)}.get(
        variant, ce._settle_payout)
    for k in range(defer):
        raw = torch.zeros_like(st["stage"]) if variant == "stub_policy" \
            else ce._policy(st, words[sw * k], words[sw * k + 1], P)
        st = ce._step_nosettle(st, raw, P, **street)
    if variant == "stub_deal":
        deal = torch.zeros((2 * P + 5, st["stage"].shape[0]), dtype=I32,
                           device=st["stage"].device)
    else:
        deal = torch.stack(_sample_cards(words[sw * defer:], []))
    return ce._settle_pass(st, deal, P, sb, bb, payout=payout)


def _split_plain(variant, state, words_of, P, n_steps, sb, bb):
    """K4's iterations (``ce._prng_plain``, reference rules) under
    ``variant`` on the words ``words_of(it)`` [W, T] of each iteration."""
    layout, _ = ce._field_layout(P)
    st = ce._unpack(ce._to_rows(state), layout)
    defer = ce._defer_for(n_steps)
    st = ce.plain_loop(st, lambda st, words: _split_iteration(
        variant, st, words, P, defer, sb, bb), lambda it: (words_of(it),),
        n_steps // defer)
    return ce._to_blocks(ce._pack(st, layout))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def run_split(variant: str, seed: int, state, P: int, n_steps: int, sb: int,
              bb: int, words=None):
    """``n_steps`` betting slots of K4 under ``variant`` on the packed
    reference-rules state ``state`` ([n_blocks, F, 8, 128] int32); returns
    the new state. Words come from Philox keyed by (``seed``, table), the
    same on the CPU and on the card; ``words`` (int64 in [0, 2^32), shape
    ``split_words_shape``) feeds the plain version alone."""
    _check_variant(variant)
    ce._check_config(P, "reference")
    ce._check_state(state, P, "reference")
    T = state.shape[0] * ce.TABLES_PER_BLOCK
    shape = split_words_shape(variant, T, P, n_steps)
    if state.device.type == "cpu":
        if words is None:
            return _split_plain(variant, state, lambda it: split_words(
                seed, T, variant, P, n_steps, it, state.device), P, n_steps,
                sb, bb)
        if tuple(words.shape) != shape or words.device != state.device:
            raise ValueError(f"words must be {shape} on {state.device}")
        return _split_plain(variant, state, lambda it: words[it], P, n_steps,
                            sb, bb)
    if words is not None:
        raise ValueError("the split kernels draw Philox words only")
    lib = _build.probe_library("split", variant, P).lib
    out = state.clone()
    _build.check(lib.mc_probe_split(
        out.data_ptr(), int(seed), state.shape[0], P, n_steps,
        ce._defer_for(n_steps), sb, bb, ce.FOLD_P_BITS, ce.RAISE_P_BITS,
        _build.stream_ptr(state.device)), "mc_probe_split")
    LAUNCHES[f"split_{variant}"] += 1
    return out
