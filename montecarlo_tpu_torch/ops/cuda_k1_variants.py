"""K1's variants on the card (B-6): K1 with its sampler, its suit masks or
its hand key swapped.

The counterpart of ``scripts/bench_kernel_variants.py:30-175``, which
monkeypatches ``pallas_equity``'s ``_uniform_draws``, ``_masks_of``,
``eval_masks_cmp_impl`` and ``TILE`` and times ``equity_vs_hand_pallas``
(K1's ``pallas_call``, ``pallas_equity.py:164``) again. ``VARIANTS`` keeps
the script's names and order; each composes (``SPEC``):

- a sampler: ``mod`` (draw t is word t mod D = live - t, K1's rule and
  ``_uniform_draws``'), ``ms16`` (``(x * D) >> 32`` from 16-bit halves),
  ``two_noreject`` (one word a pair of draws) or ``fallback_word`` (a
  shared fallback word, drawn first, for the words in the biased top
  range);
- suit masks: ``table`` (K1's deck table) or ``packed`` (the script's
  arithmetic form, the shift past the dead cards and ``(card * 5) >> 6``);
- a hand key: ``rank7`` (K1's), ``ref`` (the packed reference key),
  ``none`` (each side's suit-0 mask) or ``one`` (the hero's comparison
  key, the villain's suit-0 mask).

A variant reads ``n_words(variant)`` words a rollout, from K1's Philox
stream (seed, r mod 2^32, r >> 32, 0) in the JAX draw order
(``variant_words``), or injected words of shape ``[n_words, n]``. The
plain versions (``_variant_counts_plain``) are functions of those words
(int64 in [0, 2^32)); the wrapper ``variant_counts`` runs them for a CPU
tensor and launches the variant's kernel (``csrc/probe_k1.cu``, compiled
once per variant by ``_build.probe_library("k1", variant)``) or raises for
a CUDA tensor. Preflop only (NDRAW = 5), the script's AKs vs QQ.

The TPU's ``--tiles RxC`` resized a program; on the card a launch is
``THREADSxWAVES``: threads a block (256, K1's, in every build; 128, 512
or 1024 from the variant's tile build, ``_build.probe_library("k1",
variant, tiles=True)``) and waves of resident blocks (``TILE``, K1's 256
x 16, is the default). A rollout's words depend on its index alone, so
every tile gives the same counts. ``LAUNCHES`` counts the
launches per variant.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops.cuda_equity import (
    CPU_CHUNK,
    _shift_past,
    equity_words,
)
from montecarlo_tpu_torch.ops.evaluator import (
    eval_masks_cmp_impl,
    eval_masks_impl,
    suit_masks_from_cards,
)
from montecarlo_tpu_torch.ops.philox import words_as_i32

I32 = torch.int32
I64 = torch.int64

VARIANTS = _build.K1_VARIANTS
# (sampler, masks, key) of each variant (bench_kernel_variants.py:118-134)
SPEC = {
    "current": ("mod", "table", "rank7"),
    "ms16": ("ms16", "table", "rank7"),
    "ms16_packed": ("ms16", "packed", "rank7"),
    "old_packed": ("mod", "packed", "rank7"),
    "ms16_noeval": ("ms16", "table", "none"),
    "old_sampler": ("mod", "table", "rank7"),
    "two_noreject": ("two_noreject", "table", "rank7"),
    "fallback_word": ("fallback_word", "table", "rank7"),
    "ref_eval": ("mod", "table", "ref"),
    "old_sampler_ref_eval": ("mod", "table", "ref"),
    "no_eval": ("mod", "table", "none"),
    "one_eval": ("mod", "table", "one"),
}
# The variants whose counts equal another's on the same rollouts: the same
# draws and keys in the same order (the mask form does not change a mask).
EQUAL_CLASSES = (("current", "old_sampler", "old_packed", "ref_eval",
                  "old_sampler_ref_eval"), ("ms16", "ms16_packed"))
# The variants that compute hand-vs-hand equity: every key real, and a
# sampler whose bias is far below Monte Carlo noise.
EXACT_CLASS = EQUAL_CLASSES[0] + EQUAL_CLASSES[1] + ("two_noreject",
                                                     "fallback_word")
NDRAW = 5
N_DEAD = 4
THREAD_CHOICES = (128, 256, 512, 1024)
TILE = (256, 16)   # K1's MC_THREADS and MC_EQUITY_WAVES
LAUNCHES = {f"k1_{v}": 0 for v in VARIANTS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}: expected one of {VARIANTS}")


def parse_tile(tile: str) -> tuple:
    """``"THREADSxWAVES"`` -> (threads, waves); threads one of
    ``THREAD_CHOICES``, waves >= 1."""
    threads, waves = (int(x) for x in tile.split("x"))
    if threads not in THREAD_CHOICES or waves < 1:
        raise ValueError(f"tile {tile!r}: threads one of {THREAD_CHOICES}, "
                         f"waves >= 1")
    return threads, waves


def n_words(variant: str) -> int:
    """Words a rollout of ``variant`` reads: 5, 3 (``two_noreject``) or 6
    (``fallback_word``)."""
    _check_variant(variant)
    sampler = SPEC[variant][0]
    return {"two_noreject": (NDRAW + 1) // 2,
            "fallback_word": NDRAW + 1}.get(sampler, NDRAW)


def variant_words(variant: str, seed: int, start: int, m: int, device):
    """The kernel's Philox words of ``variant`` for rollouts ``start ..
    start + m - 1``: int64 [n_words, m], the first words of K1's stream
    (seed, r mod 2^32, r >> 32, 0)."""
    return equity_words(seed, n_words(variant), start, m, device)


def ms16(x, n: int):
    """``(x * n) >> 32`` as the script computes it from 16-bit halves
    (``sampler_ms16``): ``(xh n + ((xl n) >> 16)) >> 16``."""
    return ((x >> 16) * n + (((x & 0xFFFF) * n) >> 16)) >> 16


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _draws(sampler: str, words, n_live: int):
    """The NDRAW draws (int64, draw t in [0, n_live - t)) of ``words``
    [n_words, n] under ``sampler``, in the script's word order."""
    out = []
    for t in range(NDRAW):
        D = n_live - t
        if sampler == "mod":
            out.append(words[t] % D)
        elif sampler == "ms16":
            out.append(ms16(words[t], D))
        elif sampler == "two_noreject":
            x = words[t // 2]
            out.append(x % D if t % 2 == 0 else (x // (D + 1)) % D)
        else:
            thresh = ((1 << 32) // D) * D
            x = words[t + 1]
            out.append(torch.where(x < thresh, x % D, words[0] % D))
    return out


def _slots(draws):
    """Each draw's live index: rank-shifted past the earlier draws, which
    bubble insertion keeps ascending (``_sample_cards``)."""
    sorted_chosen, slots = [], []
    for d in draws:
        x = d.to(I32)
        for c in sorted_chosen:
            x = x + (x >= c).to(I32)
        new_sorted, carry = [], x
        for c in sorted_chosen:
            new_sorted.append(torch.minimum(carry, c))
            carry = torch.maximum(carry, c)
        new_sorted.append(carry)
        sorted_chosen = new_sorted
        slots.append(x)
    return slots


def _masks_packed(cards):
    """The script's ``masks_packed``: two suits a plane, then the four
    15-bit masks."""
    pa = torch.zeros_like(cards[0])
    pb = torch.zeros_like(cards[0])
    for card in cards:
        suit = (card * 5) >> 6
        bit = torch.ones_like(card) << ((card - 13 * suit + 2)
                                        | ((suit & 1) << 4))
        hi = suit > 1
        pa = pa | torch.where(hi, 0, bit)
        pb = pb | torch.where(hi, bit, 0)
    mask15 = (1 << 15) - 1
    return [pa & mask15, (pa >> 16) & mask15, pb & mask15,
            (pb >> 16) & mask15]


def _key(key: str, masks, first: bool):
    if key == "rank7" or (key == "one" and first):
        return eval_masks_cmp_impl(*masks)  # rank7's order, cmp's values
    if key == "ref":
        return eval_masks_impl(*masks)
    return masks[0]


def _variant_counts_plain(variant, words, dead, hero_masks, villain_masks):
    """(wins, ties) of ``variant`` on explicit words: int64 [2] on the
    words' device. ``words``: int64 [n_words(variant), n]; ``dead``: the 4
    ascending dead cards (python ints); ``*_masks``: four ints a side."""
    sampler, form, key = SPEC[variant]
    dead = [int(d) for d in dead]
    if tuple(words.shape[:1]) != (n_words(variant),):
        raise ValueError(f"{variant}: {n_words(variant)} words a rollout, "
                         f"got {words.shape[0]}")
    cards = [_shift_past(s, dead)
             for s in _slots(_draws(sampler, words, 52 - len(dead)))]
    bm = (_masks_packed(cards) if form == "packed"
          else suit_masks_from_cards(torch.stack(cards, dim=-1)))
    vh = _key(key, [m | int(h) for m, h in zip(bm, hero_masks)], True)
    vv = _key(key, [m | int(v) for m, v in zip(bm, villain_masks)], False)
    return torch.stack([(vh > vv).sum(dtype=I64), (vh == vv).sum(dtype=I64)])


def _variant_counts_plain_philox(variant, seed, dead, hero_masks,
                                 villain_masks, n_rollouts, device,
                                 chunk=CPU_CHUNK):
    """Plain version of ``variant``'s Philox mode on ``device``: the (wins,
    ties) the kernel returns for ``seed``, in chunks of ``chunk``
    rollouts."""
    total = torch.zeros(2, dtype=I64, device=device)
    for start in range(0, n_rollouts, chunk):
        m = min(chunk, n_rollouts - start)
        total += _variant_counts_plain(
            variant, variant_words(variant, seed, start, m, device), dead,
            hero_masks, villain_masks)
    return total


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _params(dead, hero_masks, villain_masks):
    return [int(x) for x in dead.tolist() + hero_masks.tolist()
            + villain_masks.tolist()]


def variant_build(variant: str, threads: int):
    """The build that launches ``variant`` at ``threads`` a block: the
    variant's own at K1's 256, else its tile build (made on first use)."""
    return _build.probe_library("k1", variant,
                                tiles=threads != TILE[0])


def variant_grid(variant: str, n_rollouts: int, tile=TILE,
                 inject: bool = False):
    """The launch ``variant_counts`` makes on the current card: (blocks,
    the kernel's blocks an SM). Needs a card and builds the variant."""
    threads, waves = tile
    out = (ctypes.c_int * 2)()
    _build.check(variant_build(variant, threads).lib.mc_probe_k1_grid(
        int(n_rollouts), threads, waves, int(inject), out),
        "mc_probe_k1_grid")
    return out[0], out[1]


def variant_counts(variant: str, seed: int, dead: torch.Tensor,
                   hero_masks: torch.Tensor, villain_masks: torch.Tensor,
                   n_rollouts: int, words=None, tile=TILE):
    """(wins, ties) of ``variant`` as an int64 tensor [2] on ``dead``'s
    device, over ``n_rollouts`` preflop rollouts (``dead``: int32 [4], the
    holes ascending; ``*_masks``: int32 [4]). ``words`` (optional): int64
    [n_words(variant), n_rollouts] injected words; without them the words
    are Philox's for ``seed`` (the same on the CPU and on the card).
    ``tile``: the card's (threads, waves); the counts do not depend on
    it, and injected words take 256 threads a block."""
    _check_variant(variant)
    if dead.shape[0] != N_DEAD:
        raise ValueError(f"{dead.shape[0]} dead cards: the variants run "
                         f"preflop ({N_DEAD})")
    threads, waves = tile
    if threads not in THREAD_CHOICES or waves < 1:
        raise ValueError(f"tile {tile}: threads one of {THREAD_CHOICES}, "
                         f"waves >= 1")
    dev = dead.device
    if words is not None:
        shape = (n_words(variant), n_rollouts)
        if tuple(words.shape) != shape or words.device != dev:
            raise ValueError(f"words must be {shape} on {dev}")
        if threads != 256:
            raise ValueError("injected words take 256 threads a block")
    params = _params(dead, hero_masks, villain_masks)
    if dev.type == "cuda":
        lib = variant_build(variant, threads).lib
        out = torch.zeros(2, dtype=I64, device=dev)
        w32 = None if words is None else words_as_i32(words).contiguous()
        c_params = (_build.I_ * len(params))(*params)
        grid = (ctypes.c_int * 2)()
        _build.check(lib.mc_probe_k1(
            int(seed), c_params, N_DEAD, int(n_rollouts),
            None if w32 is None else w32.data_ptr(), threads, waves, grid,
            out.data_ptr(), _build.stream_ptr(dev)), "mc_probe_k1")
        LAUNCHES[f"k1_{variant}"] += 1
        return out
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    d, hm, vm = params[:N_DEAD], params[N_DEAD:N_DEAD + 4], params[N_DEAD + 4:]
    if words is not None:
        return _variant_counts_plain(variant, words, d, hm, vm)
    return _variant_counts_plain_philox(variant, seed, d, hm, vm, n_rollouts,
                                        dev)
