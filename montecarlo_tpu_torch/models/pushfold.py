"""Heads-up push/fold Nash solver on the equity engine.

The counterpart of ``montecarlo_tpu/models/pushfold.py``. The small blind
jams its whole stack or folds; the big blind calls or folds. The 169 x 169
all-in matchup equity matrix comes from the rollout API
(``rollout/equity.py``), and the equilibrium from damped best-response
iteration (fictitious play).

Three matrix backends, in plain PyTorch on ``device`` (the card when None;
the JAX package computes them with XLA, not Pallas):
- ``matchup_equity_matrix`` (Monte Carlo, single representatives, boards
  from ``sample_distinct``);
- ``matchup_equity_matrix_exact`` (every matchup enumerated over all
  C(48, 5) boards, int64 scores);
- ``matchup_equity_matrix_cr`` + ``matchup_pair_counts``
  (card-removal-correct: one hero representative per class against every
  one of the villain's 1326 combos over every board, through
  ``equity_exact_range_vs_range``). ``solve_push_fold_cr`` consumes these.

The representatives, the combos, the pair counts and the solvers are the
JAX module's numpy code, copied.
"""

from __future__ import annotations

import itertools
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.ops.cuda_equity import _shift_past
from montecarlo_tpu_torch.ops.evaluator import (
    eval_masks_impl,
    suit_masks_from_cards,
)
from montecarlo_tpu_torch.rollout.equity import (
    _distinct,
    canonical_hands,
    equity_exact_range_vs_range,
)

I32 = torch.int32
I64 = torch.int64


def _representatives():
    """(labels, hero_combos [169,2], villain_combos [169,2], weights[169])."""
    names = "23456789TJQKA"
    labels, hero, villain, w = [], [], [], []
    for label, _ in canonical_hands():
        r1 = names.index(label[0]) + 2
        r2 = names.index(label[1]) + 2
        labels.append(label)
        if r1 == r2:
            hero.append((make_card(0, r1), make_card(1, r1)))      # h,d
            villain.append((make_card(2, r1), make_card(3, r1)))   # s,c
            w.append(6)
        elif label.endswith("s"):
            hero.append((make_card(0, r1), make_card(0, r2)))      # hearts
            villain.append((make_card(2, r1), make_card(2, r2)))   # spades
            w.append(4)
        else:
            hero.append((make_card(0, r1), make_card(1, r2)))      # h,d
            villain.append((make_card(2, r1), make_card(3, r2)))   # s,c
            w.append(12)
    return (labels, np.array(hero, np.int32), np.array(villain, np.int32),
            np.array(w, np.float64))


def _matchups():
    """(hero [169 * 169, 2], villain [169 * 169, 2]): pair p is hero class
    p // 169 against villain class p % 169."""
    _, hero, villain, _ = _representatives()
    hh = np.repeat(np.arange(169), 169)
    vv = np.tile(np.arange(169), 169)
    return hero[hh], villain[vv]


def _pair_masks(heroes, villains, device):
    """(dead [G, 4] ascending, hero masks, villain masks: 4 x [G, 1]) of
    [G, 2] hero and villain holes, int32 on ``device``."""
    h = torch.as_tensor(heroes, dtype=I32).to(device)
    v = torch.as_tensor(villains, dtype=I32).to(device)
    dead = torch.sort(torch.cat([h, v], dim=1), dim=1).values
    hm = [m[:, None] for m in suit_masks_from_cards(h)]
    vm = [m[:, None] for m in suit_masks_from_cards(v)]
    return dead, hm, vm


def _scores(cards, dead, hm, vm):
    """2 * wins + ties per pair, int64 [G], over boards ``cards`` (a list
    of five int32 [G, B] slot tensors into each pair's 48 live cards)."""
    board = [_shift_past(card, dead.split(1, dim=1)) for card in cards]
    bm = suit_masks_from_cards(torch.stack(board, dim=-1))
    vh = eval_masks_impl(*[m | h for m, h in zip(bm, hm)])
    vv = eval_masks_impl(*[m | v for m, v in zip(bm, vm)])
    return 2 * (vh > vv).sum(1, dtype=I64) + (vh == vv).sum(1, dtype=I64)


def matchup_equity_matrix(seed: int, n_per: int = 1 << 15,
                          m_chunk: int = 2048, device=None) -> np.ndarray:
    """[169, 169] hero-row-vs-villain-column all-in equity matrix, by
    ``n_per`` Monte Carlo boards a matchup on ``device`` (the card when
    None), ``m_chunk`` matchups at a time.

    Matchup p takes rollouts p * n_per .. (p + 1) * n_per - 1 of
    ``sample_distinct(seed, 48, 5, ...)`` as its boards. Known difference
    by design: JAX sums win + tie / 2 per matchup in float32 and divides
    on the host; this counts 2 * wins + ties in int64 and divides once in
    float64, so its entries are exact fractions of the draws."""
    device = resolve(device)
    heroes, villains = _matchups()
    M = heroes.shape[0]
    batch = min(n_per, 1 << 13)
    out = np.empty((M,), np.float64)
    for i in range(0, M, m_chunk):
        dead, hm, vm = _pair_masks(heroes[i:i + m_chunk],
                                   villains[i:i + m_chunk], device)
        p = torch.arange(i, i + dead.shape[0], dtype=I64, device=device)
        total = torch.zeros(dead.shape[0], dtype=I64, device=device)
        for s in range(0, n_per, batch):
            r = p[:, None] * n_per + torch.arange(
                s, min(s + batch, n_per), dtype=I64, device=device)
            total += _scores(_distinct(seed, 48, 5, r), dead, hm, vm)
        out[i:i + m_chunk] = total.cpu().numpy() / (2.0 * n_per)
    return out.reshape(169, 169)


def _all_board_slots() -> np.ndarray:
    """All C(48,5) = 1,712,304 board slot quintuples (int8 [M, 5])."""
    return np.fromiter(
        itertools.chain.from_iterable(itertools.combinations(range(48), 5)),
        dtype=np.int8).reshape(-1, 5)


def _pair_exact_scores(dead, hm, vm, board_slots, board_chunk: int):
    """2 * wins + ties over enumerated boards, int64 [G] on ``dead``'s
    device.

    ``dead``: int32 [G, 4] ascending; ``hm``/``vm``: 4 x [G, 1] suit masks;
    ``board_slots``: [N, 5] slot indices into the 48-card live deck on the
    same device, ``board_chunk`` of them a step (pair-independent: the
    dead-card shift maps slots to each pair's cards)."""
    total = torch.zeros(dead.shape[0], dtype=I64, device=dead.device)
    for s in range(0, board_slots.shape[0], board_chunk):
        slots = board_slots[s:s + board_chunk].to(I32)
        cards = [slots[None, :, j].expand(dead.shape[0], -1)
                 for j in range(5)]
        total += _scores(cards, dead, hm, vm)
    return total


def _exact_rows(rows, m_chunk: int = 64, board_chunk: int = 1 << 17,
                device=None) -> np.ndarray:
    """Rows ``rows`` (hero classes) of ``matchup_equity_matrix_exact``:
    float64 [len(rows), 169]."""
    device = resolve(device)
    heroes, villains = _matchups()
    sel = (np.asarray(rows, np.int64)[:, None] * 169
           + np.arange(169)).reshape(-1)
    heroes, villains = heroes[sel], villains[sel]
    boards = torch.from_numpy(_all_board_slots()).to(device)
    n_boards = boards.shape[0]
    scores = np.zeros((sel.shape[0],), np.int64)
    for g in range(0, sel.shape[0], m_chunk):
        dead, hm, vm = _pair_masks(heroes[g:g + m_chunk],
                                   villains[g:g + m_chunk], device)
        scores[g:g + m_chunk] = _pair_exact_scores(
            dead, hm, vm, boards, board_chunk).cpu().numpy()
    return (scores / (2.0 * n_boards)).reshape(-1, 169)


def matchup_equity_matrix_exact(m_chunk: int = 64,
                                board_chunk: int = 1 << 17,
                                device=None) -> np.ndarray:
    """EXACT [169, 169] all-in equity matrix: every matchup enumerated over
    all C(48,5) boards (no Monte Carlo noise) on ``device`` (the card when
    None), ``m_chunk`` matchups x ``board_chunk`` boards a step. The
    scores are int64, and equal JAX's (which pads the boards to whole
    chunks and subtracts the padding's scores; this takes a short last
    chunk)."""
    return _exact_rows(range(169), m_chunk, board_chunk, device)


def _all_combos():
    """All 1326 hole combos with their canonical-class index.

    Returns (combos [1326, 2] int32, cls [1326] int32 indexing the 169
    canonical hands in ``canonical_hands()`` order).
    """
    labels = [l for l, _ in canonical_hands()]
    idx = {l: i for i, l in enumerate(labels)}
    names = "23456789TJQKA"
    combos, cls = [], []
    for c1 in range(52):
        for c2 in range(c1 + 1, 52):
            s1, r1 = c1 // 13, 2 + c1 % 13
            s2, r2 = c2 // 13, 2 + c2 % 13
            if r1 < r2:
                (s1, r1), (s2, r2) = (s2, r2), (s1, r1)
            if r1 == r2:
                label = names[r1 - 2] * 2
            else:
                label = (names[r1 - 2] + names[r2 - 2]
                         + ("s" if s1 == s2 else "o"))
            combos.append((make_card(s1, r1), make_card(s2, r2)))
            cls.append(idx[label])
    return np.array(combos, np.int32), np.array(cls, np.int32)


def matchup_pair_counts() -> np.ndarray:
    """[169, 169] card-removal-correct pair counts:
    ``n_pairs[a, b] = combos(a) * #(villain combos of class b disjoint from
    one fixed hero-a combo)`` — by suit symmetry the inner count is the
    same for every hero-a combo, so this equals the number of (hero combo,
    villain combo) deals of classes (a, b). Rows sum to
    ``combos(a) * C(50, 2) = combos(a) * 1225``.
    """
    _, hero_reps, _, w = _representatives()
    combos, cls = _all_combos()
    n = np.zeros((169, 169), np.int64)
    for a in range(169):
        rep = set(hero_reps[a].tolist())
        disj = ~np.array([bool(rep & set(c)) for c in combos.tolist()])
        np.add.at(n[a], cls[disj], 1)
    return n * w[:, None].astype(np.int64)


def _class_equity(res, cls) -> np.ndarray:
    """Class-aggregate a [H, 1326] ``RangeEquityResult`` into [H, 169]
    hero-vs-class equities, with equal weight per surviving combo pair
    (``pair_weight`` is 1 where disjoint, 0 otherwise)."""
    w = res.pair_weight
    pe = np.where(w > 0, res.pair_equity, 0.0)
    eq = np.zeros((w.shape[0], 169), np.float64)
    cnt = np.zeros((w.shape[0], 169), np.float64)
    for b in range(169):
        sel = cls == b
        eq[:, b] = (pe[:, sel] * w[:, sel]).sum(axis=1)
        cnt[:, b] = w[:, sel].sum(axis=1)
    return eq / np.maximum(cnt, 1e-12)


def matchup_equity_matrix_cr(elem_budget: int = 1 << 27,
                             progress: bool = False, device=None):
    """Card-removal-correct EXACT [169, 169] class equity matrix, on
    ``device`` (the card when None).

    For each hero class one representative combo (WLOG: the villain side
    enumerates all 1326 combos, so suit relabeling maps any hero combo onto
    the representative) is matched against every disjoint villain combo
    over every C(48, 5) board. Entry [a, b] is hero-a's equity averaged
    over villain-b combos with true conditional weights.

    Returns (eq_cr [169, 169] float64, n_pairs [169, 169] int64).
    """
    device = resolve(device)
    _, hero_reps, _, _ = _representatives()
    combos, cls = _all_combos()
    t0 = time.perf_counter()

    def _log(done):
        if progress:
            print(f"  boards {done:,} ({time.perf_counter() - t0:.0f}s)",
                  file=sys.stderr, flush=True)

    res = equity_exact_range_vs_range(hero_reps, combos,
                                      elem_budget=elem_budget,
                                      progress=_log, device=device)
    return _class_equity(res, cls), matchup_pair_counts()


class PushFoldSolution(NamedTuple):
    labels: list
    jam: np.ndarray         # [169] SB jam probability
    call: np.ndarray        # [169] BB call-vs-jam probability
    stack_bb: float

    def jam_range(self, threshold: float = 0.5):
        return [l for l, p in zip(self.labels, self.jam) if p > threshold]

    def call_range(self, threshold: float = 0.5):
        return [l for l, p in zip(self.labels, self.call) if p > threshold]

    @property
    def jam_fraction(self) -> float:
        _, _, _, w = _representatives()
        return float((self.jam * w).sum() / w.sum())

    @property
    def call_fraction(self) -> float:
        _, _, _, w = _representatives()
        return float((self.call * w).sum() / w.sum())


def solve_push_fold(eq: np.ndarray, stack_bb: float,
                    iters: int = 2000, damping: float = 0.05
                    ) -> PushFoldSolution:
    """Fictitious play on the jam/call game at ``stack_bb`` effective
    stacks (blinds 0.5/1; stacks include the posted blinds).

    SB folds: -0.5. SB jams: +1 if BB folds; 2S*eq - S if called.
    BB facing a jam: fold -1; call 2S*eq' - S.
    """
    labels, _, _, w = _representatives()
    w = w / w.sum()
    S = float(stack_bb)

    jam = np.full(169, 0.5)
    call = np.full(169, 0.5)
    for _ in range(iters):
        # BB best response to jam: call iff EV(call) > EV(fold) = -1.
        jam_w = w * jam
        jam_mass = jam_w.sum()
        if jam_mass > 0:
            # eq.T[v, h]: villain(BB) equity vs hero hand h = 1 - eq[h, v].
            ev_call = ((1.0 - eq) * jam_w[:, None]).sum(axis=0) / jam_mass
            br_call = (2 * S * ev_call - S > -1.0).astype(float)
        else:
            br_call = np.zeros(169)
        # SB best response to call: jam iff EV(jam) > EV(fold) = -0.5.
        ev_jam = ((1 - call[None, :]) * 1.0
                  + call[None, :] * (2 * S * eq - S)) @ w
        br_jam = (ev_jam > -0.5).astype(float)
        jam = (1 - damping) * jam + damping * br_jam
        call = (1 - damping) * call + damping * br_call
    return PushFoldSolution(labels=labels, jam=jam, call=call, stack_bb=S)


def solve_push_fold_cr(eq_cr: np.ndarray, n_pairs: np.ndarray,
                       stack_bb: float, iters: int = 2000,
                       damping: float = 0.05) -> PushFoldSolution:
    """Fictitious play with card-removal-correct combo weighting.

    ``eq_cr``/``n_pairs`` from ``matchup_equity_matrix_cr`` (or the
    committed ``data/pushfold_eq169_cr.npz``). Where ``solve_push_fold``
    weights opposing classes by unconditional combo counts, here the
    opponent-class distribution conditions on the player's own two cards:
    ``P(villain class b | hero class a) = n_pairs[a, b] / (combos(a)*1225)``
    and Bayes inverts through the same pair counts for the caller.
    """
    labels, _, _, _ = _representatives()
    S = float(stack_bb)
    # P(BB class b | SB class a): conditional on SB's two cards removed.
    p_b_given_a = n_pairs / n_pairs.sum(axis=1, keepdims=True)

    jam = np.full(169, 0.5)
    call = np.full(169, 0.5)
    for _ in range(iters):
        # BB best response: P(SB class a | BB class b, SB jams) ∝
        # jam[a] * n_pairs[a, b] (n_pairs is the joint deal count).
        post = jam[:, None] * n_pairs  # [a, b]
        mass = post.sum(axis=0)
        ev_call = np.where(
            mass > 0,
            (2 * S * ((1.0 - eq_cr) * post).sum(axis=0) / np.maximum(mass, 1e-300)) - S,
            -np.inf)
        br_call = (ev_call > -1.0).astype(float)
        # SB best response under conditional villain-class weights.
        ev_jam = (p_b_given_a
                  * ((1 - call[None, :]) * 1.0
                     + call[None, :] * (2 * S * eq_cr - S))).sum(axis=1)
        br_jam = (ev_jam > -0.5).astype(float)
        jam = (1 - damping) * jam + damping * br_jam
        call = (1 - damping) * call + damping * br_call
    return PushFoldSolution(labels=labels, jam=jam, call=call, stack_bb=S)
