"""Monte Carlo and exact equity (the user-facing rollout API).

The counterpart of ``montecarlo_tpu/rollout/equity.py``. ``equity_vs_hand``,
``equity_vs_random`` and ``equity_multiway`` run the rollout kernels K1, K2
and B3 on the card, or their plain versions when the caller passes
``device="cpu"`` (``ops/cuda_equity.py``). The rest is plain PyTorch on
``device`` (the card when None), as the JAX package's forms are XLA:
``sample_distinct`` and ``equity_vs_range`` draw from Philox
(``ops/philox.py``) on sub-streams of their own, so a seed gives the same
draws on every device; ``equity_exact``, ``equity_exact_range_vs_range``
and ``equity_exact_vs_range`` enumerate every board completion with the
packed-key evaluator and count in int64.

The JAX entry points take a ``jax.random`` key and round ``n_rollouts`` up
to whole batches; these take ``seed: int`` and return exactly
``n_rollouts``. ``sample_distinct`` draws slot t as a word modulo
``n_avail - t``, as the kernels do (a bias below n_avail / 2^32), where
JAX draws ``jax.random.randint``.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from montecarlo_tpu_torch.cards import NUM_CARDS, make_card
from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.ops import cuda_equity
from montecarlo_tpu_torch.ops.evaluator import (
    eval_masks_impl,
    suit_masks_from_cards,
)
from montecarlo_tpu_torch.ops.philox import MASK, stream_words

I32 = torch.int32
I64 = torch.int64

# The Philox sub-streams of ``sample_distinct`` (and the boards of
# ``equity_vs_range``) and of ``equity_vs_range``'s villain draws, which no
# kernel and no other wrapper uses (ops/philox.py lists them all). Rollout
# r draws from stream (seed, r mod 2^32, r >> 32, sub).
DISTINCT_SUB = 65538
RANGE_SUB = 65539


class EquityResult(NamedTuple):
    wins: int
    ties: int
    losses: int
    n: int

    @property
    def p_win(self) -> float:
        return self.wins / self.n

    @property
    def equity(self) -> float:
        """Win probability counting ties as half (standard equity)."""
        return (self.wins + 0.5 * self.ties) / self.n

    @property
    def stderr(self) -> float:
        p = self.equity
        return float(np.sqrt(max(p * (1.0 - p), 1e-12) / self.n))

    @property
    def ci95(self) -> Tuple[float, float]:
        p, se = self.equity, self.stderr
        return (p - 1.96 * se, p + 1.96 * se)


def _check_disjoint(*card_groups):
    """Cards passed to the equity APIs must be distinct ids in [0, 52):
    an overlap would corrupt the dead-card shift mapping."""
    flat = [int(c) for g in card_groups for c in np.asarray(g).reshape(-1)]
    if len(flat) != len(set(flat)):
        raise ValueError(f"cards are not disjoint: {sorted(flat)}")
    if any(c < 0 or c > 51 for c in flat):
        raise ValueError(f"card ids out of range: {sorted(flat)}")


def complement(dead) -> torch.Tensor:
    """Ascending card ids not in ``dead`` (shape [52 - len(dead)])."""
    dead = torch.as_tensor(dead, dtype=torch.int64).reshape(-1)
    is_dead = torch.zeros(NUM_CARDS, dtype=torch.bool)
    is_dead[dead] = True
    return torch.nonzero(~is_dead).reshape(-1).to(I32)


def _rollout_words(seed: int, sub: int, k: int, r: torch.Tensor):
    """Words 0 .. k - 1 of rollouts ``r`` (int64, any shape) on Philox
    sub-stream ``sub``: int64 [k, *r.shape]."""
    return stream_words(seed, r & MASK, r >> 32, sub, 0, k)


def _distinct(seed: int, n_avail: int, k: int, r: torch.Tensor):
    """``sample_distinct``'s k slots of rollouts ``r``: a list of k int32
    tensors shaped like ``r``."""
    return cuda_equity._distinct_slots(
        _rollout_words(seed, DISTINCT_SUB, k, r), n_avail)


def sample_distinct(seed: int, n_avail: int, k: int, batch: int,
                    device=None) -> torch.Tensor:
    """[batch, k] distinct uniform indices in [0, n_avail), int32 on
    ``device`` (the card when None).

    Ordered-draw construction: the i-th draw is uniform over the remaining
    ``n_avail - i`` values and rank-shifted past the earlier draws in
    ascending order, a bijection onto the complement, so each row is a
    uniform k-subset in draw order. Row r draws from Philox stream (seed,
    r mod 2^32, r >> 32, ``DISTINCT_SUB``), the same on every device."""
    if not 1 <= k <= n_avail:
        raise ValueError(f"k={k} distinct draws from n_avail={n_avail}")
    r = torch.arange(batch, dtype=I64, device=resolve(device))
    return torch.stack(_distinct(seed, n_avail, k, r), dim=1)


def slots_to_cards(slots, dead_sorted):
    """Map live-deck slot indices to card ids by rank-shifting past the
    ascending dead cards (the order-preserving bijection onto the
    complement)."""
    dead = torch.as_tensor(dead_sorted).reshape(-1).tolist()
    return cuda_equity._shift_past(torch.as_tensor(slots), dead)


def _result(counts, n):
    w, t = (int(x) for x in counts.tolist())
    return EquityResult(wins=w, ties=t, losses=n - w - t, n=n)


def equity_vs_hand(seed: int, hero: Sequence[int], villain: Sequence[int],
                   n_rollouts: int, board: Sequence[int] = (),
                   device=None) -> EquityResult:
    """Hero hole cards vs exact villain hole cards, optionally on a known
    partial ``board`` (flop or flop+turn): K1 on the card (``device``
    None or CUDA), its plain version for ``device="cpu"``."""
    _check_disjoint(hero, villain, board)
    counts, n = cuda_equity.equity_vs_hand_counts(
        seed, hero, villain, n_rollouts, board, device)
    return _result(counts, n)


def equity_vs_random(seed: int, hero: Sequence[int], n_rollouts: int,
                     device=None) -> EquityResult:
    """Hero hole cards vs a uniformly random villain: K2 with one hand (on
    the card unless ``device="cpu"``)."""
    _check_disjoint(hero)
    device = resolve(device)
    heroes = torch.as_tensor(hero, dtype=I32).reshape(1, 2)
    dead = torch.sort(heroes, dim=1).values
    hm = torch.stack(suit_masks_from_cards(heroes), dim=1)
    counts = cuda_equity.sweep_counts(seed, dead.to(device), hm.to(device),
                                      n_rollouts)
    return _result(counts[:, 0], n_rollouts)


def equity_multiway(seed: int, hands, n_rollouts: int,
                    board: Sequence[int] = (), device=None):
    """Equity of N specified hands ([N, 2] cards, 2 <= N <= 12) against
    each other, ties split fractionally, optionally on a partial board:
    B3 on the card (``device`` None or CUDA), its plain version for
    ``device="cpu"``. Returns (equity float64 numpy [N], n)."""
    _check_disjoint(hands, board)
    return cuda_equity.equity_multiway_kernel(seed, hands, n_rollouts, board,
                                              device)


def expand_range(labels: Sequence[str]) -> np.ndarray:
    """Expand canonical hand labels ('AA', 'AKs', 'T9o', ...) to all combos.

    Returns an [R, 2] int32 array of hole-card pairs: 6 combos per pair,
    4 per suited label, 12 per offsuit label.
    """
    names = "23456789TJQKA"
    combos = []
    for label in labels:
        r1, r2 = names.index(label[0]) + 2, names.index(label[1]) + 2
        kind = label[2:] or ("pair" if r1 == r2 else None)
        if r1 == r2:
            for s1 in range(4):
                for s2 in range(s1 + 1, 4):
                    combos.append((make_card(s1, r1), make_card(s2, r1)))
        elif kind == "s":
            for s in range(4):
                combos.append((make_card(s, r1), make_card(s, r2)))
        elif kind == "o":
            for s1 in range(4):
                for s2 in range(4):
                    if s1 != s2:
                        combos.append((make_card(s1, r1), make_card(s2, r2)))
        else:
            raise ValueError(f"bad hand label {label!r}")
    return np.array(combos, dtype=np.int32)


def _vs_range_counts(seed, hero, combos, cdf, start: int, m: int):
    """(wins, ties) int64 [2] of rollouts ``start .. start + m - 1`` of
    hero (int32 [2]) against a villain combo of ``combos`` (int32 [R, 2])
    drawn by inverse CDF (``cdf``: float32 [R]), on ``hero``'s device."""
    r = torch.arange(start, start + m, dtype=I64, device=hero.device)
    # the villain: u in [0, 1) from the word's top 24 bits, its index the
    # count of cdf entries below u (JAX: sum(u > cdf))
    u = (_rollout_words(seed, RANGE_SUB, 1, r)[0] >> 8).to(torch.float32) \
        * 2.0 ** -24
    idx = torch.searchsorted(cdf, u).clamp(max=combos.shape[0] - 1)
    villain = combos[idx]                                    # [m, 2]
    dead = torch.sort(torch.cat([hero.expand(m, 2), villain], dim=1),
                      dim=1).values                          # per rollout
    # sample_distinct(seed, 48, 5, ...)'s boards, past the four dead cards
    board = cuda_equity._sample_cards(
        _rollout_words(seed, DISTINCT_SUB, 5, r), dead.unbind(1))
    bm = suit_masks_from_cards(torch.stack(board, dim=1))
    hm = suit_masks_from_cards(hero)
    vh = eval_masks_impl(*[b | h for b, h in zip(bm, hm)])
    vv = eval_masks_impl(*[b | v for b, v in
                           zip(bm, suit_masks_from_cards(villain))])
    return torch.stack([(vh > vv).sum(dtype=I64), (vh == vv).sum(dtype=I64)])


def equity_vs_range(seed: int, hero: Sequence[int], villain_range,
                    n_rollouts: int, weights=None, batch_size: int = 1 << 20,
                    device=None) -> EquityResult:
    """Hero vs a (weighted) villain range, on ``device`` (the card when
    None).

    ``villain_range``: [R, 2] combos (see ``expand_range``); combos
    colliding with the hero's cards are dropped (weights renormalize).
    Each rollout draws its villain by inverse CDF (Philox sub-stream
    ``RANGE_SUB``) and its board as ``sample_distinct(seed, 48, 5, ...)``
    past the four dead cards, in batches of ``batch_size`` rollouts.
    """
    _check_disjoint(hero)
    device = resolve(device)
    hero_np = np.asarray(hero, np.int32)
    combos = np.asarray(villain_range, np.int32).reshape(-1, 2)
    w = np.ones(combos.shape[0]) if weights is None \
        else np.asarray(weights, float)
    keep = ~np.isin(combos, hero_np).any(axis=1)
    combos, w = combos[keep], w[keep]
    if combos.size == 0:
        raise ValueError("villain range is empty after removing hero cards")
    cdf = np.cumsum(w) / np.sum(w)

    hero_t = torch.from_numpy(hero_np).to(device)
    combos_t = torch.from_numpy(combos).to(device)
    cdf_t = torch.from_numpy(cdf.astype(np.float32)).to(device)
    counts = torch.zeros(2, dtype=I64, device=device)
    for start in range(0, n_rollouts, batch_size):
        counts += _vs_range_counts(seed, hero_t, combos_t, cdf_t, start,
                                   min(batch_size, n_rollouts - start))
    return _result(counts, n_rollouts)


def equity_exact(hero: Sequence[int], villain: Sequence[int],
                 board: Sequence[int] = (), chunk: int = 1 << 18,
                 device=None) -> EquityResult:
    """EXACT hand-vs-hand equity by enumerating every remaining board
    completion: C(48,5) = 1,712,304 preflop, C(45,2) = 990 on a flop, 44
    on a turn. The plain evaluator runs on ``device`` (the card when
    None)."""
    _check_disjoint(hero, villain, board)
    device = resolve(device)
    fixed = np.asarray(board, np.int32).reshape(-1)
    K = fixed.shape[0]
    live = complement(np.concatenate([np.asarray(hero, np.int64).ravel(),
                                      np.asarray(villain, np.int64).ravel(),
                                      fixed])).numpy()
    slots = np.fromiter(
        itertools.chain.from_iterable(
            itertools.combinations(range(live.shape[0]), 5 - K)),
        dtype=np.int32).reshape(-1, 5 - K)
    boards = live[slots]
    if K:
        boards = np.concatenate(
            [np.tile(fixed, (boards.shape[0], 1)), boards], axis=1)
    hm = suit_masks_from_cards(torch.as_tensor(hero, dtype=I32).reshape(-1))
    vm = suit_masks_from_cards(torch.as_tensor(villain, dtype=I32).reshape(-1))
    hm = [m.to(device) for m in hm]
    vm = [m.to(device) for m in vm]
    wins = ties = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(0, boards.shape[0], chunk):
        bm = suit_masks_from_cards(
            torch.from_numpy(boards[i:i + chunk]).to(device))
        vh = eval_masks_impl(*[m | h for m, h in zip(bm, hm)])
        vv = eval_masks_impl(*[m | v for m, v in zip(bm, vm)])
        wins = wins + (vh > vv).sum()
        ties = ties + (vh == vv).sum()
    n = boards.shape[0]
    return _result(torch.stack([wins, ties]), n)


class RangeEquityResult(NamedTuple):
    """Exact weighted range-vs-range equity (no Monte Carlo error).

    ``equity`` is hero's share counting ties as half, averaged over combo
    pairs with card-removal-correct weights (overlapping pairs excluded).
    ``pair_equity[H, V]`` / ``pair_weight[H, V]`` expose the per-combo-pair
    breakdown (weight 0 where combos collide); ``n_boards`` is the exact
    number of board completions enumerated per pair.
    """
    equity: float
    pair_equity: np.ndarray   # [H, V] float64 (NaN where weight == 0)
    pair_weight: np.ndarray   # [H, V] float64
    n_boards: int


# A key below every hand's (a hero combo that meets the board) and one
# above every hand's (a villain combo that does): such a pair counts as
# neither a win nor a tie.
_KEY_NONE_LO = -1
_KEY_NONE_HI = 1 << 30


def _range_keys(bm, masks, valid, none_key):
    """Packed keys [B, N] of N combos' suit masks (4 x [N]) on B boards'
    (4 x [B]), ``none_key`` where a combo shares a card with the board or
    the board is padding (``valid`` False)."""
    b_ = [m[:, None] for m in bm]
    c_ = [m[None, :] for m in masks]
    overlap = torch.zeros((), dtype=I32, device=bm[0].device)
    for b, c in zip(b_, c_):
        overlap = overlap | (b & c)
    keys = eval_masks_impl(*[b | c for b, c in zip(b_, c_)])
    ok = (overlap == 0) & valid[:, None]
    return torch.where(ok, keys, none_key)


def _range_pair_counts(boards, valid, hmasks, vmasks, chunk: int):
    """Per-combo-pair (wins, ties), int64 [H, V] each on the boards'
    device, over ``boards`` [N, 5] (``valid`` [N] False on padding): the
    keys of every (board, combo), then [chunk, H, V] comparisons a step.

    A (combo, board) pairing is valid when their suit masks do not
    intersect; every pair thus sees the same exact C(48 - K, 5 - K) live
    completions."""
    bm = suit_masks_from_cards(boards)
    kh = _range_keys(bm, hmasks, valid, _KEY_NONE_LO)          # [N, H]
    kv = _range_keys(bm, vmasks, valid, _KEY_NONE_HI)          # [N, V]
    wins = torch.zeros((kh.shape[1], kv.shape[1]), dtype=I64,
                       device=boards.device)
    ties = torch.zeros_like(wins)
    for i in range(0, boards.shape[0], chunk):
        a = kh[i:i + chunk, :, None]
        b = kv[i:i + chunk, None, :]
        wins += (a > b).sum(0, dtype=I64)
        ties += (a == b).sum(0, dtype=I64)
    return wins, ties


def _enumerate_boards(fixed: np.ndarray, elem_budget: int, hv: int):
    """All 5-card completions of ``fixed`` from the full remaining deck,
    padded and reshaped for the chunked sweep.

    Returns (boards [C, B, 5], valid [C, B]) numpy arrays with
    ``B * hv <= elem_budget`` bounding the broadcast tensor per step.
    """
    K = fixed.shape[0]
    live = np.array(sorted(set(range(NUM_CARDS)) - set(fixed.tolist())),
                    dtype=np.int32)
    draws = np.fromiter(
        itertools.chain.from_iterable(
            itertools.combinations(range(live.shape[0]), 5 - K)),
        dtype=np.int32).reshape(-1, 5 - K)
    boards = live[draws]
    if K:
        boards = np.concatenate(
            [np.tile(fixed, (boards.shape[0], 1)), boards], axis=1)
    n = boards.shape[0]
    chunk = max(256, min(n, elem_budget // max(hv, 1)))
    pad = (-n) % chunk
    if pad:
        boards = np.concatenate([boards, np.tile(boards[:1], (pad, 1))])
    valid = np.arange(boards.shape[0]) < n
    C = boards.shape[0] // chunk
    return (boards.reshape(C, chunk, 5), valid.reshape(C, chunk))


def equity_exact_range_vs_range(
    hero_range,
    villain_range,
    hero_weights=None,
    villain_weights=None,
    board: Sequence[int] = (),
    elem_budget: int = 1 << 24,
    progress=None,
    device=None,
) -> RangeEquityResult:
    """EXACT weighted range-vs-range equity by combo-pair enumeration, on
    ``device`` (the card when None).

    For every (hero combo, villain combo) pair that shares no card (and
    collides with neither the fixed ``board``), every remaining board
    completion is enumerated and both 7-card hands ranked: one shared
    sweep of C(52 - K, 5 - K) boards x H x V comparisons, per-pair validity
    a suit-mask intersection. Pair weights are ``w_h * w_v`` (weights per
    combo, default 1), zeroed for colliding pairs; the aggregate equity
    renormalizes over surviving pairs. ``progress`` (optional) is called
    with the boards done after each group of chunks.
    """
    device = resolve(device)
    hero_range = np.asarray(hero_range, np.int32).reshape(-1, 2)
    villain_range = np.asarray(villain_range, np.int32).reshape(-1, 2)
    fixed = np.asarray(board, np.int32).reshape(-1)
    _check_disjoint(fixed)
    K = fixed.shape[0]
    H, V = hero_range.shape[0], villain_range.shape[0]
    wh = (np.ones(H) if hero_weights is None
          else np.asarray(hero_weights, np.float64))
    wv = (np.ones(V) if villain_weights is None
          else np.asarray(villain_weights, np.float64))
    assert wh.shape == (H,) and wv.shape == (V,)

    # Pair weights: zero where combos collide with each other or the board.
    fx = set(fixed.tolist())
    ok_h = np.array([not (set(h) & fx) for h in hero_range.tolist()])
    ok_v = np.array([not (set(v) & fx) for v in villain_range.tolist()])
    disjoint = np.array(
        [[not (set(h) & set(v)) for v in villain_range.tolist()]
         for h in hero_range.tolist()])
    weight = (wh[:, None] * wv[None, :]) * disjoint \
        * ok_h[:, None] * ok_v[None, :]
    if not np.any(weight > 0):
        raise ValueError("no disjoint combo pairs between the ranges")

    hmasks = suit_masks_from_cards(torch.from_numpy(hero_range).to(device))
    vmasks = suit_masks_from_cards(
        torch.from_numpy(villain_range).to(device))
    boards3d, valid2d = _enumerate_boards(fixed, elem_budget, H * V)
    C, B = valid2d.shape
    boards = torch.from_numpy(boards3d.reshape(-1, 5)).to(device)
    valid = torch.from_numpy(valid2d.reshape(-1)).to(device)

    wins = np.zeros((H, V), np.int64)
    ties = np.zeros((H, V), np.int64)
    done = 0
    # the keys of a group of chunks at a time: about 2^25 of them
    group = B * max(1, (1 << 25) // (B * (H + V)))
    for g in range(0, C * B, group):
        w, t = _range_pair_counts(boards[g:g + group], valid[g:g + group],
                                  hmasks, vmasks, B)
        wins += w.cpu().numpy()
        ties += t.cpu().numpy()
        done += int(valid2d.reshape(-1)[g:g + group].sum())
        if progress is not None:
            progress(done)

    n_boards = math.comb(52 - K - 4, 5 - K)  # same for every disjoint pair
    with np.errstate(invalid="ignore"):
        pair_eq = np.where(weight > 0,
                           (wins + 0.5 * ties) / n_boards, np.nan)
    total_w = weight.sum()
    equity = float(np.nansum(pair_eq * weight) / total_w)
    return RangeEquityResult(equity=equity, pair_equity=pair_eq,
                             pair_weight=weight, n_boards=n_boards)


def equity_exact_vs_range(
    hero: Sequence[int],
    villain_range,
    villain_weights=None,
    board: Sequence[int] = (),
    device=None,
) -> RangeEquityResult:
    """EXACT hero-hand-vs-weighted-range equity (card-removal-correct):
    ``equity_exact_range_vs_range`` with a single hero combo."""
    hero = np.asarray(hero, np.int32).reshape(1, 2)
    _check_disjoint(hero, board)
    return equity_exact_range_vs_range(
        hero, villain_range, None, villain_weights, board=board,
        device=device)


def canonical_hands():
    """The 169 canonical starting hands as (label, (card, card)).

    Pairs use hearts+diamonds; suited uses both hearts; offsuit uses
    hearts+diamonds. Order: pairs, then suited, then offsuit, high-first.
    """
    names = "23456789TJQKA"
    out = []
    for i in range(12, -1, -1):
        r = i + 2
        out.append((f"{names[i]}{names[i]}",
                    (make_card(0, r), make_card(1, r))))
    for suited, tag in ((True, "s"), (False, "o")):
        for hi in range(12, 0, -1):
            for lo in range(hi - 1, -1, -1):
                r1, r2 = hi + 2, lo + 2
                out.append((f"{names[hi]}{names[lo]}{tag}",
                            (make_card(0, r1),
                             make_card(0 if suited else 1, r2))))
    assert len(out) == 169
    return out
