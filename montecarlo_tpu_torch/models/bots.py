"""Handcrafted deterministic baseline bots, packed as policy-net weights.

The counterpart of ``montecarlo_tpu/models/bots.py``. Each bot is an
``MLPParams`` of float32 tensors whose forward pass
(``models/policy_net.py:policy_logits``, and the net kernels'
``csrc/net.cuh:mc_mlp_rows``) produces logits with a dominant gap that
implements a fixed decision rule. Any path that takes a net (net
evaluation, the banked league kernel, a population's opponent bank) plays a
bot with no code of its own.

Construction notes
------------------
Action menu (policy_net.py): 0 = fold, 1 = check/call, 2 = min-raise (2bb),
3 = pot-raise. The fold logit is masked to -1e9 when nothing is owed, so
"always fold" degenerates to check-when-free.

The threshold bots compute one linear score ``s = v . feats`` and route it
through the ReLU layers as a *rectified pair*: hidden unit 0 carries
``relu(s - t)`` and unit 1 carries ``relu(t - s)`` (b1 = -/+ t), and the
output layer scales them by ``gain`` onto the hi/lo action logits, with
all other logits at -300. ``gain`` = 200 makes the Gumbel sample
deterministic outside a ~2.5/gain band around the threshold (inside it the
bot plays a mix, still a fixed strategy).

The rectified pair, and ``ladder_bot``'s input-range guard, were designed
against the TPU's matmuls, which round their inputs to bf16: an affine
offset ``h = s + C`` would feed the next layer a value whose bf16 ulp
erases small score terms, while the pair keeps the carried values near
zero. The port computes in exact float32 (the kernels round each product
and sum once), where the same constructions decide the same way; the
tests hold every bot's arrays equal to the JAX package's and its decisions
to its rule.

Feature indices (models/features.py): 14 = made-hand category / 8, 16/17
= hole ranks / 14, 18 = suited, 19 = paired.
"""

from __future__ import annotations

import numpy as np

from montecarlo_tpu_torch.models.features import NUM_FEATURES
from montecarlo_tpu_torch.models.policy_net import (
    HIDDEN,
    NUM_ACTIONS,
    MLPParams,
    params_from_numpy,
)


def _zeros() -> dict:
    return dict(
        w1=np.zeros((NUM_FEATURES, HIDDEN), np.float32),
        b1=np.zeros((HIDDEN,), np.float32),
        w2=np.zeros((HIDDEN, HIDDEN), np.float32),
        b2=np.zeros((HIDDEN,), np.float32),
        w3=np.zeros((HIDDEN, NUM_ACTIONS), np.float32),
        b3=np.zeros((NUM_ACTIONS,), np.float32),
    )


def _params(d: dict) -> MLPParams:
    return params_from_numpy([d[k] for k in MLPParams._fields])


def action_bot(action: int, strength: float = 100.0) -> MLPParams:
    """Always play menu index ``action`` (modulo the free-fold mask)."""
    if not 0 <= action < NUM_ACTIONS:
        raise ValueError(f"action={action}: expected 0..{NUM_ACTIONS - 1}")
    d = _zeros()
    d["b3"][action] = strength
    return _params(d)


def vector_bot(score_vec, threshold: float, hi: int, lo: int,
               gain: float = 200.0) -> MLPParams:
    """Play ``hi`` when ``score_vec . feats > threshold``, else ``lo``.

    ``score_vec`` is a length-``NUM_FEATURES`` weight vector (any linear
    rule over the policy features)."""
    if hi == lo or not (0 <= hi < NUM_ACTIONS and 0 <= lo < NUM_ACTIONS):
        raise ValueError(f"hi={hi}, lo={lo}: two distinct actions expected")
    score_vec = np.asarray(score_vec, np.float32)
    if score_vec.shape != (NUM_FEATURES,):
        raise ValueError(f"score_vec: shape {score_vec.shape}, expected "
                         f"({NUM_FEATURES},)")
    d = _zeros()
    d["w1"][:, 0] = score_vec
    d["w1"][:, 1] = -score_vec
    d["b1"][0] = -threshold   # h1[0] = relu(s - t)
    d["b1"][1] = threshold    # h1[1] = relu(t - s)
    d["w2"][0, 0] = 1.0
    d["w2"][1, 1] = 1.0
    d["w3"][0, hi] = gain     # logits[hi] = gain * relu(s - t)
    d["w3"][1, lo] = gain     # logits[lo] = gain * relu(t - s)
    d["b3"][:] = -300.0
    d["b3"][hi] = 0.0
    d["b3"][lo] = 0.0
    return _params(d)


def ladder_bot(score1, t1: float, score2, t2: float,
               top: int, mid: int, bot: int,
               slope: float = 4.0, cap: float = 0.25) -> MLPParams:
    """Three-way decision ladder: play ``top`` when ``score1.feats > t1``,
    else ``mid`` when ``score2.feats > t2``, else ``bot``.

    Each rule is a rectified capped ramp built from a relu pair,
    ``u = relu(slope*(s-t)) - relu(slope*(s-t) - cap)`` = min(relu(.),
    cap), scaled onto its action logit with separated gains (120/60 over a
    constant 30 on ``bot``), so rule 1 dominates rule 2, which dominates
    the fallback once a ramp saturates. The transition band has width
    cap/slope in score units, where the bot plays a mix.

    Safe input range, kept from the JAX package: the pair difference was
    sized for bf16 matmul inputs, accurate while |slope*(s-t)| <= 32, so a
    rule whose worst case (features |f| <= 2) leaves that range is refused;
    normalize (score, threshold) jointly first (the rule s > t is invariant
    under joint scaling)."""
    acts = (top, mid, bot)
    if len(set(acts)) != 3 or not all(0 <= a < NUM_ACTIONS for a in acts):
        raise ValueError(f"top, mid, bot = {acts}: three distinct actions "
                         f"expected")
    d = _zeros()
    for vec, t in ((score1, t1), (score2, t2)):
        vals = (vec.values() if isinstance(vec, dict) else vec)
        smax = 2.0 * float(np.sum(np.abs(np.asarray(list(vals),
                                                    np.float64)))) + abs(t)
        assert slope * smax <= 32.0 + 1e-6, (
            f"ladder rule leaves the bf16-safe range "
            f"(slope*|s-t| bound {slope * smax:.1f} > 32); normalize "
            f"(score, threshold) jointly first — see docstring")
    for k, (vec, t) in enumerate(((score1, t1), (score2, t2))):
        v = np.zeros((NUM_FEATURES,), np.float32)
        items = vec.items() if isinstance(vec, dict) else enumerate(vec)
        for i, w in items:
            v[int(i)] = w
        d["w1"][:, 2 * k] = slope * v
        d["w1"][:, 2 * k + 1] = slope * v
        d["b1"][2 * k] = -slope * t
        d["b1"][2 * k + 1] = -slope * t - cap
    for k in range(4):
        d["w2"][k, k] = 1.0
    for k, (act, gain) in enumerate(((top, 120.0), (mid, 60.0))):
        d["w3"][2 * k, act] = gain / cap
        d["w3"][2 * k + 1, act] = -gain / cap
    d["b3"][:] = -300.0
    d["b3"][top] = 0.0
    d["b3"][mid] = 0.0
    d["b3"][bot] = 30.0
    return _params(d)


def threshold_bot(score: dict[int, float], threshold: float,
                  hi: int, lo: int, gain: float = 200.0) -> MLPParams:
    """Play ``hi`` when ``sum(score[i] * feats[i]) > threshold``, else ``lo``.

    ``score`` maps feature indices to weights; ``hi``/``lo`` are menu
    indices. Other actions get logit -300 (never played).
    """
    vec = np.zeros((NUM_FEATURES,), np.float32)
    for i, w in score.items():
        vec[i] = w
    return vector_bot(vec, threshold, hi, lo, gain)


# Hole-strength score: 0.5*(r0 + r1) + 0.35*paired + 0.08*suited, with
# ranks normalized /14. AA=1.35, QQ=1.21, 88=1.06, 77=0.99, AKs=1.04,
# AKo=0.96, AQs=1.01.
_HOLE = {16: 0.5, 17: 0.5, 19: 0.35, 18: 0.08}
# Made-hand score: category/8 (0=high card, 1/8=pair, 2/8=two pair...).
_MADE = {14: 1.0}
_PAIRPLUS = 0.0625  # between high card (0) and pair (0.125)


def panel() -> dict[str, MLPParams]:
    """The fixed probe panel of static rule bots."""
    return {
        # pure actions
        "foldbot": action_bot(0),        # folds to any bet, checks free
        "callbot": action_bot(1),        # calling station
        "minraisebot": action_bot(2),    # min-raise every turn
        "potraisebot": action_bot(3),    # pot-raise/jam every turn
        # preflop-strength jam-or-fold (postflop: same hole score)
        "jam_tight": threshold_bot(_HOLE, 1.00, hi=3, lo=0),   # ~88+/AQs+/AKo
        "jam_loose": threshold_bot(_HOLE, 0.85, hi=3, lo=0),
        # fit-or-fold on made-hand category
        "fof_call": threshold_bot(_MADE, _PAIRPLUS, hi=1, lo=0),
        "fof_raise": threshold_bot(_MADE, _PAIRPLUS, hi=3, lo=1),
        # three-way ladders (raise strong / call medium / fold weak)
        "nit_ladder": ladder_bot(_HOLE, 1.15, _HOLE, 0.95,
                                 top=3, mid=1, bot=0),
        "made_ladder": ladder_bot(_MADE, 3 * _PAIRPLUS, _MADE, _PAIRPLUS,
                                  top=3, mid=1, bot=0),
    }
