"""Equity rollouts on the card: kernels K1, K2 and B3 and their plain
versions.

The counterpart of ``montecarlo_tpu/ops/pallas_equity.py``. Kernel K1
(``csrc/equity.cu:mc_equity_kernel``) replaces ``_make_equity_kernel``
(hand vs hand on a board of 0, 3 or 4 known cards); K2
(``mc_sweep_kernel``) replaces ``_sweep_kernel`` (per hero hand vs a random
villain); B3 (``csrc/multiway.cu:mc_multiway_kernel``) replaces
``_make_multiway_kernel`` (N hands in one pot, ties split as integer
shares scaled by lcm(1..N)).
Each draws one u32 word per card and takes it modulo the live-card count,
as the TPU kernels do, so a kernel and its plain version compute the same
function of the words.

Words: the plain versions take them explicitly, as int64 tensors in
[0, 2^32) of shape ``[n_draw, n]`` (K1, B3) or ``[7, H, n]`` (K2). The
kernels draw them from Philox4x32-10 (``csrc/philox.cuh``), or read
injected words of the same shape. ``equity_words`` / ``sweep_words`` /
``multiway_words`` compute the kernels' Philox words in plain PyTorch
(``ops/philox.py``), so for a given ``seed`` the CPU wrappers and the
kernels return the same counts, and the ``_*_plain_philox`` functions hold
a kernel's Philox mode against its plain version at any size.

B3 sums its shares in 64 bits (32-bit per thread, the grid sized so that
they cannot overflow), so any rollout count is one launch; the TPU splits
its launches at int32's limit and keys each with its own seed, so B3 and
``equity_multiway_pallas`` agree in distribution, not draw for draw.

A wrapper runs the plain version only for CPU tensors; for a CUDA tensor
it launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops.evaluator import (
    eval_masks_cmp_impl,
    suit_masks_from_cards,
)
from montecarlo_tpu_torch.ops.philox import MASK, stream_words, words_as_i32
from montecarlo_tpu_torch.utils.profiling import span

I32 = torch.int32
I64 = torch.int64

# Rollouts per chunk of a plain version, by default (bounds the word
# tensors).
CPU_CHUNK = 1 << 18

# Hands in one multiway pot: lcm(1..13) x 16,384 rollouts overflows the
# TPU kernel's int32 shares in one program, so 12 is the JAX package's
# limit as well (csrc/equity.cuh:MC_MAX_HANDS).
MAX_MULTIWAY_HANDS = 12
# The Philox sub-stream of multiway rollouts, which K1 (0) and K2 (hand
# h + 1 <= 65535) never use (csrc/equity.cuh:MC_SUB_MULTIWAY).
MULTIWAY_SUB = 1 << 16

LAUNCHES = {"equity": 0, "sweep": 0, "multiway": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def random_words(generator: torch.Generator, shape, device=None):
    """Uniform u32 words as int64 in [0, 2^32) on ``device`` (the card when
    None; ``generator`` must live there)."""
    return torch.randint(0, 1 << 32, shape, dtype=I64, generator=generator,
                         device=resolve(device))


def equity_words(seed: int, n_draw: int, start: int, m: int, device):
    """K1's Philox words for rollouts ``start .. start + m - 1``: int64
    [n_draw, m]. Rollout r draws from stream (seed, r mod 2^32, r >> 32,
    0)."""
    r = torch.arange(start, start + m, dtype=I64, device=device)
    return stream_words(seed, r & MASK, r >> 32, 0, 0, n_draw)


def sweep_words(seed: int, H: int, start: int, m: int, device):
    """K2's Philox words for rollouts ``start .. start + m - 1`` of each of
    ``H`` hands: int64 [7, H, m]. Rollout r of hand h draws from stream
    (seed, r mod 2^32, r >> 32, h + 1)."""
    r = torch.arange(start, start + m, dtype=I64, device=device)[None]
    h = torch.arange(H, dtype=I64, device=device)[:, None]
    return stream_words(seed, r & MASK, r >> 32, h + 1, 0, 7)


def multiway_words(seed: int, n_draw: int, start: int, m: int, device):
    """B3's Philox words for rollouts ``start .. start + m - 1``: int64
    [n_draw, m]. Rollout r draws from stream (seed, r mod 2^32, r >> 32,
    ``MULTIWAY_SUB``)."""
    r = torch.arange(start, start + m, dtype=I64, device=device)
    if n_draw == 0:  # the whole board is known
        return torch.zeros((0, m), dtype=I64, device=device)
    return stream_words(seed, r & MASK, r >> 32, MULTIWAY_SUB, 0, n_draw)


def multiway_scale(n_hands: int) -> int:
    """lcm(1..N): the shares of one rollout's pot."""
    return math.lcm(*range(1, n_hands + 1))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _distinct_slots(words, n_avail: int):
    """k distinct slots in [0, ``n_avail``) per rollout, in draw order
    (``rollout/equity.py:sample_distinct``'s ordered draws): draw t is
    word t modulo ``n_avail - t``, rank-shifted past the earlier draws,
    which bubble insertion keeps ascending.

    ``words``: int64 [k, ...]. Returns a list of k int32 tensors."""
    sorted_chosen, slots = [], []
    for t in range(words.shape[0]):
        x = (words[t] % (n_avail - t)).to(I32)
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


def _shift_past(slots, dead):
    """Live-deck slots to card ids: rank-shift ``slots`` past the ascending
    ``dead`` cards (the order-preserving bijection onto the complement).
    Each dead card is a python int or a tensor broadcasting against
    ``slots`` (per-row dead cards)."""
    for d in dead:
        slots = slots + (slots >= d).to(slots.dtype)
    return slots


def _sample_cards(words, dead):
    """k distinct live cards per rollout (``pallas_equity._sample_cards``).

    ``words``: int64 [k, ...]; ``dead``: the ascending dead cards (see
    ``_shift_past``). Returns a list of k int32 card tensors."""
    return [_shift_past(s, dead)
            for s in _distinct_slots(words, 52 - len(dead))]


def _masks_of(cards):
    """Four suit masks of a list of card tensors (same shape)."""
    return suit_masks_from_cards(torch.stack(cards, dim=-1))


def _equity_counts_plain(words, dead, hero_masks, villain_masks):
    """(wins, ties) of K1 on explicit words.

    ``words``: int64 [5 - (D - 4), n]; ``dead``: D ascending dead cards
    (python ints); ``*_masks``: four ints per side, known board included.
    Returns an int64 tensor [2] on the words' device."""
    dead = [int(d) for d in dead]
    bm = _masks_of(_sample_cards(words, dead))
    vh = eval_masks_cmp_impl(*[m | int(h) for m, h in zip(bm, hero_masks)])
    vv = eval_masks_cmp_impl(*[m | int(v) for m, v in zip(bm, villain_masks)])
    return torch.stack([(vh > vv).sum(dtype=I64), (vh == vv).sum(dtype=I64)])


def _sweep_counts_plain(words, dead, hero_masks):
    """Per-hand (wins, ties) of K2 on explicit words.

    ``words``: int64 [7, H, n]; ``dead``: int32 [H, 2] ascending holes;
    ``hero_masks``: int32 [H, 4]. Returns int64 [2, H]."""
    cards = _sample_cards(words, [dead[:, j:j + 1]
                                  for j in range(dead.shape[1])])
    vm = _masks_of(cards[:2])
    bm = _masks_of(cards[2:])
    vh = eval_masks_cmp_impl(*[b | hero_masks[:, s:s + 1]
                               for s, b in enumerate(bm)])
    vv = eval_masks_cmp_impl(*[b | v for b, v in zip(bm, vm)])
    return torch.stack([(vh > vv).sum(dim=1, dtype=I64),
                        (vh == vv).sum(dim=1, dtype=I64)])


def _multiway_shares_plain(words, dead, hand_masks):
    """B3's shares on explicit words: int64 [N] on the words' device.

    ``words``: int64 [5 - K, n]; ``dead``: the 2N + K ascending dead cards
    (python ints); ``hand_masks``: N rows of four ints, the known board
    included. Each rollout adds lcm(1..N) / (number of winners) to each
    winner's share."""
    dead = [int(d) for d in dead]
    n = words.shape[1]
    if words.shape[0]:
        bm = _masks_of(_sample_cards(words, dead))
    else:  # the whole board is known
        bm = [torch.zeros(n, dtype=I32, device=words.device)] * 4
    values = torch.stack([
        eval_masks_cmp_impl(*[m | int(h) for m, h in zip(bm, masks)])
        for masks in hand_masks])                           # [N, n]
    winners = values == values.amax(0)
    share = multiway_scale(len(hand_masks)) // winners.sum(0, dtype=I64)
    return torch.where(winners, share, 0).sum(1, dtype=I64)


def _multiway_shares_plain_philox(seed, dead, hand_masks, n_rollouts,
                                  device, chunk=CPU_CHUNK):
    """Plain version of B3's Philox mode on ``device``: the shares the
    kernel returns for ``seed``, in chunks of ``chunk`` rollouts."""
    n_draw = 5 - (len(dead) - 2 * len(hand_masks))
    total = torch.zeros(len(hand_masks), dtype=I64, device=device)
    for start in range(0, n_rollouts, chunk):
        m = min(chunk, n_rollouts - start)
        total += _multiway_shares_plain(
            multiway_words(seed, n_draw, start, m, device), dead, hand_masks)
    return total


def _equity_counts_plain_philox(seed, dead, hero_masks, villain_masks,
                                n_rollouts, device, chunk=CPU_CHUNK):
    """Plain version of K1's Philox mode on ``device``: the (wins, ties)
    the kernel returns for ``seed``, in chunks of ``chunk`` rollouts."""
    n_draw = 9 - len(dead)
    total = torch.zeros(2, dtype=I64, device=device)
    for start in range(0, n_rollouts, chunk):
        m = min(chunk, n_rollouts - start)
        total += _equity_counts_plain(
            equity_words(seed, n_draw, start, m, device), dead, hero_masks,
            villain_masks)
    return total


def _sweep_counts_plain_philox(seed, dead, hero_masks, n_per_hand,
                               chunk=CPU_CHUNK):
    """Plain version of K2's Philox mode on ``dead``'s device: the per-hand
    (wins, ties) the kernel returns for ``seed``, in chunks of about
    ``chunk`` rollouts over all hands."""
    H = dead.shape[0]
    total = torch.zeros((2, H), dtype=I64, device=dead.device)
    step = max(1, chunk // H)
    for start in range(0, n_per_hand, step):
        m = min(step, n_per_hand - start)
        total += _sweep_counts_plain(
            sweep_words(seed, H, start, m, dead.device), dead, hero_masks)
    return total


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_words(words, shape, device):
    if tuple(words.shape) != tuple(shape):
        raise ValueError(f"words shape {tuple(words.shape)} != {shape}")
    if words.device != device:
        raise ValueError(f"words on {words.device}, expected {device}")


def equity_counts(seed: int, dead: torch.Tensor, hero_masks: torch.Tensor,
                  villain_masks: torch.Tensor, n_rollouts: int, words=None):
    """(wins, ties) as an int64 tensor [2] on ``dead``'s device, over
    ``n_rollouts`` rollouts drawing ``9 - D`` board cards each.

    ``dead``: int32 [D] ascending dead cards, D in {4, 7, 8} (holes plus
    known board, whose masks must already be OR-ed into ``*_masks``);
    ``*_masks``: int32 [4]. ``words`` (optional): int64 [9 - D, n_rollouts]
    injected words; without them the words are Philox's for ``seed``
    (the same on the CPU and on the card)."""
    n_dead = dead.shape[0]
    n_draw = 9 - n_dead
    if n_dead not in (4, 7, 8):
        raise ValueError(f"{n_dead} dead cards: expected 4, 7 or 8")
    dev = dead.device
    if words is not None:
        _check_words(words, (n_draw, n_rollouts), dev)
    params = [int(x) for x in dead.tolist() + hero_masks.tolist()
              + villain_masks.tolist()]
    if dev.type == "cuda":
        lib = _build.library()
        out = torch.zeros(2, dtype=I64, device=dev)
        w32 = None if words is None else words_as_i32(words).contiguous()
        c_params = (_build.I_ * len(params))(*params)
        _build.check(lib.mc_equity_counts(
            int(seed), c_params, n_dead, int(n_rollouts),
            None if w32 is None else w32.data_ptr(), out.data_ptr(),
            _build.stream_ptr(dev)), "mc_equity_counts")
        LAUNCHES["equity"] += 1
        return out
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    d, hm, vm = params[:n_dead], params[n_dead:n_dead + 4], params[n_dead + 4:]
    if words is not None:
        return _equity_counts_plain(words, d, hm, vm)
    return _equity_counts_plain_philox(seed, d, hm, vm, n_rollouts, dev)


def _multiway_masks(hands, board, device):
    """(dead [2N + K] ascending, hand masks [N, 4] with the board OR-ed
    in), int32 on ``device``."""
    hands = torch.as_tensor(hands, dtype=I32).reshape(-1, 2)
    board = torch.as_tensor(board, dtype=I32).reshape(-1)
    dead = torch.sort(torch.cat([hands.reshape(-1), board])).values
    bmask = (suit_masks_from_cards(board) if board.numel()
             else [torch.zeros((), dtype=I32)] * 4)
    hm = torch.stack([m | b for m, b in
                      zip(suit_masks_from_cards(hands), bmask)], dim=1)
    return dead.to(device), hm.to(device)


def _hand_masks(hero, villain, board, device):
    """(dead ascending, hero masks [4], villain masks [4]) on ``device``,
    the board's masks OR-ed into both."""
    dead, hm = _multiway_masks(torch.stack([
        torch.as_tensor(h, dtype=I32).reshape(2) for h in (hero, villain)]),
        board, device)
    return dead, hm[0], hm[1]


def equity_vs_hand_counts(seed: int, hero, villain, n_rollouts: int,
                          board=(), device=None):
    """Hand-vs-hand counters without a host sync: ``(counts, n)`` with
    ``counts`` the int64 [2] (wins, ties) tensor on ``device`` (the card
    when None)."""
    dead, hm, vm = _hand_masks(hero, villain, board, resolve(device))
    return equity_counts(seed, dead, hm, vm, n_rollouts), n_rollouts


def equity_vs_hand_kernel(seed: int, hero, villain, n_rollouts: int,
                          board=(), device=None):
    """Hand-vs-hand equity on an optional known board (0, 3 or 4 cards):
    ``(wins, ties, n)`` as ints (``equity_vs_hand_pallas``)."""
    counts, n = equity_vs_hand_counts(seed, hero, villain, n_rollouts,
                                      board, device)
    w, t = counts.tolist()
    return w, t, n


def sweep_grid(H: int, n_per_hand: int, inject: bool = False):
    """K2's launch for ``H`` hands of ``n_per_hand`` rollouts on the current
    card: (blocks a hand, blocks an SM of the instantiation, Philox or
    injected words). The blocks a hand are ``MC_EQUITY_WAVES`` waves of
    resident blocks over all hands (``csrc/equity.cuh:mc_rollout_grid``).
    Needs a card."""
    out = (ctypes.c_int * 2)()
    _build.check(_build.library().mc_sweep_grid(H, int(n_per_hand),
                                                int(inject), out),
                 "mc_sweep_grid")
    return out[0], out[1]


def sweep_counts(seed: int, dead: torch.Tensor, hero_masks: torch.Tensor,
                 n_per_hand: int, words=None):
    """Per-hand (wins, ties) as int64 [2, H] on ``dead``'s device, over
    ``n_per_hand`` rollouts of each hero hand vs a random villain.

    ``dead``: int32 [H, 2] each hero's two distinct holes, ascending;
    ``hero_masks``: int32 [H, 4], their suit masks (the kernel ranks
    exactly 7 cards a hand). ``words`` (optional): int64 [7, H,
    n_per_hand]; without them the words are Philox's for ``seed``."""
    with span("launch.sweep"):
        H = dead.shape[0]
        dev = dead.device
        if words is not None:
            _check_words(words, (7, H, n_per_hand), dev)
        if dev.type == "cuda":
            lib = _build.library()
            dead_c = dead.to(I32).contiguous()
            masks_c = hero_masks.to(I32).contiguous()
            out = torch.zeros((2, H), dtype=I64, device=dev)
            w32 = None if words is None else words_as_i32(words).contiguous()
            _build.check(lib.mc_sweep_counts(
                int(seed), dead_c.data_ptr(), masks_c.data_ptr(), H,
                int(n_per_hand), None if w32 is None else w32.data_ptr(),
                out.data_ptr(), _build.stream_ptr(dev)), "mc_sweep_counts")
            LAUNCHES["sweep"] += 1
            return out
        if dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        if words is not None:
            return _sweep_counts_plain(words, dead, hero_masks)
        return _sweep_counts_plain_philox(seed, dead, hero_masks, n_per_hand)


def equity_sweep_kernel(seed: int, heroes, n_per_hand: int, device=None):
    """Equity vs a random villain for [H, 2] hero hands in one launch, on
    ``device`` (the card when None).

    Returns (equity float64 numpy [H], rollouts per hand)."""
    with span("sweep.masks"):
        device = resolve(device)
        heroes = torch.as_tensor(heroes, dtype=I32).reshape(-1, 2)
        dead = torch.sort(heroes, dim=1).values
        hm = torch.stack(suit_masks_from_cards(heroes), dim=1)
        dead, hm = dead.to(device), hm.to(device)
    counts = sweep_counts(seed, dead, hm, n_per_hand)
    with span("sweep.read"):
        w, t = counts.cpu().numpy().astype(np.float64)
        return (w + 0.5 * t) / n_per_hand, n_per_hand


def multiway_shares(seed: int, dead: torch.Tensor, hand_masks: torch.Tensor,
                    n_rollouts: int, words=None):
    """B3's shares as int64 [N] on ``dead``'s device, over ``n_rollouts``
    rollouts drawing ``5 - K`` board cards each; they sum to lcm(1..N) x
    ``n_rollouts``.

    ``dead``: int32 [2N + K] ascending dead cards (holes plus known board);
    ``hand_masks``: int32 [N, 4], the known board's masks OR-ed in;
    2 <= N <= 12 and 0 <= K <= 5. ``words`` (optional): int64 [5 - K,
    n_rollouts] injected words; without them the words are Philox's for
    ``seed`` (the same on the CPU and on the card)."""
    N, n_dead = hand_masks.shape[0], dead.shape[0]
    K = n_dead - 2 * N
    if not 2 <= N <= MAX_MULTIWAY_HANDS:
        raise ValueError(f"{N} hands: expected 2..{MAX_MULTIWAY_HANDS}")
    if not 0 <= K <= 5 or n_dead > 52:
        raise ValueError(f"{n_dead} dead cards for {N} hands: expected "
                         f"2N + K with 0 <= K <= 5")
    dev = dead.device
    if words is not None:
        _check_words(words, (5 - K, n_rollouts), dev)
    dead_l = [int(x) for x in dead.tolist()]
    masks_l = [[int(x) for x in row] for row in hand_masks.tolist()]
    if dev.type == "cuda":
        lib = _build.library()
        out = torch.zeros(N, dtype=I64, device=dev)
        w32 = None if words is None else words_as_i32(words).contiguous()
        c_dead = (_build.I_ * n_dead)(*dead_l)
        c_masks = (_build.I_ * (4 * N))(*[x for row in masks_l for x in row])
        _build.check(lib.mc_multiway_shares(
            int(seed), c_dead, n_dead, c_masks, N, int(n_rollouts),
            None if w32 is None or w32.numel() == 0 else w32.data_ptr(),
            out.data_ptr(), _build.stream_ptr(dev)), "mc_multiway_shares")
        LAUNCHES["multiway"] += 1
        return out
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    if words is not None:
        return _multiway_shares_plain(words, dead_l, masks_l)
    return _multiway_shares_plain_philox(seed, dead_l, masks_l, n_rollouts,
                                         dev)


def equity_multiway_kernel(seed: int, hands, n_rollouts: int, board=(),
                           device=None):
    """Multiway equity of N hands ([N, 2] cards) against each other on an
    optional known ``board``, ties split exactly, in one B3 launch on
    ``device`` (the card when None) (``equity_multiway_pallas``).

    Returns (equity float64 numpy [N], rollouts)."""
    dead, hm = _multiway_masks(hands, board, resolve(device))
    shares = multiway_shares(seed, dead, hm, n_rollouts)
    scale = multiway_scale(hm.shape[0])
    return shares.cpu().numpy().astype(np.float64) / (scale * n_rollouts), \
        n_rollouts
