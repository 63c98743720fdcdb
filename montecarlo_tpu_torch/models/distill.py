"""Distill solver strategies into policy nets at anchored subgame states.
The port of ``montecarlo_tpu/models/distill.py``.

- **Nash distillation**: supervised targets are the CFR+ average strategy
  of the exact turn+river subgame solve (``models/turn_solver.py``) at
  every decision node the artifact game reaches, mapped back onto the
  net's 4-action menu through the correspondence the Nash-gap meter uses
  in reverse (``net_turn_river_strategy``: check = call-menu, bet =
  pot-raise).
- **Solver-BR distillation**: targets are the one-hot best response to a
  SUBJECT artifact inside the solved subgame (``best_response_strategy``),
  an attacker family independent of the rule bots and REINFORCE.

Early-street behaviour is preserved with a self-anchor: the start params'
own action distributions at the scripted preflop/flop prelude nodes are
replayed as targets, so distillation cannot silently wreck the streets the
solver says nothing about.

Features come from the port's ``state_features`` on batches of tables
whose head hole is swapped per combo; the loss is the masked
cross-entropy of the net's logits as matrix products (float32, TF32 off)
under autograd, and the optimizer ``torch.optim.Adam(lr)`` (optax's
``adam(lr)`` defaults). Everything runs
on the device of the states and example tensors it is given.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from montecarlo_tpu_torch.engine.step import head_info
from montecarlo_tpu_torch.engine.street import bets_needed
from montecarlo_tpu_torch.models.features import state_features
from montecarlo_tpu_torch.models.policy_net import (
    FOLD_MASK,
    NUM_ACTIONS,
    MLPParams,
    fold_masked,
    policy_logits,
)
from montecarlo_tpu_torch.models.river_solver import _swap_head
from montecarlo_tpu_torch.models.turn_solver import (
    TurnRiverGame,
    TurnRiverStrategy,
    _avg_turn_reaches,
    require_full_f32,
)

F32 = torch.float32

# no-raise artifact-game lines with real engine states (brc unreachable)
_LINES = ("cc", "xbc", "bc")


class ExampleSet(NamedTuple):
    """A batch of supervised examples for the policy net."""
    feats: torch.Tensor        # [N, NUM_FEATURES]
    target: torch.Tensor       # [N, NUM_ACTIONS] rows sum to 1
    fold_masked: torch.Tensor  # [N] bool: nothing owed -> fold logit masked
    weight: torch.Tensor       # [N] >= 0 relative example weights


@torch.no_grad()
def _feats_batch(state, head_pos: int, combos) -> torch.Tensor:
    """[T x C, NUM_FEATURES] features of each of ``state``'s T tables with
    the head's hole swapped per combo (table-major)."""
    return state_features(_swap_head(state, head_pos, combos))


def _node_feats(state, head_pos: int, combos) -> Tuple[torch.Tensor, bool]:
    """Features for every (table, combo) at one node, and whether the node
    is free to check (fold masked): table 0's public state decides, as in
    ``net_turn_river_strategy``'s extraction."""
    feats = _feats_batch(state, head_pos, combos)
    p, _, _ = head_info(state)
    free = bool(bets_needed(state.bets, p)[0] == 0)
    return feats, free


def _free_target(dist2) -> torch.Tensor:
    """Tree {check, bet} -> menu [fold, call, raise2bb, raisepot]. The
    tree's bet IS the pot-raise (menu index 3)."""
    z = torch.zeros_like(dist2[..., 0])
    return torch.stack([z, dist2[..., 0], z, dist2[..., 1]], -1)


def _owed_target(dist) -> torch.Tensor:
    """Tree {fold, call[, raise]} -> menu columns; raise mass (zero in the
    no-raise artifact game) goes to the pot-raise column."""
    z = torch.zeros_like(dist[..., 0])
    r = dist[..., 2] if dist.shape[-1] == 3 else z
    return torch.stack([dist[..., 0], dist[..., 1], z, r], -1)


def _opp_avg(mask0, x) -> torch.Tensor:
    """Opponent-range average of a per-combo quantity: for hero combo j,
    the mean over valid opponent combos i of x[i]. [..., C] -> [..., C]."""
    require_full_f32()
    tot = mask0.sum(0)
    return (x @ mask0) / torch.where(tot > 0, tot, 1.0)


@torch.no_grad()
def turn_river_examples(game: TurnRiverGame, combos,
                        turn_states: Dict, river_states: Dict,
                        targets: TurnRiverStrategy,
                        prof_p1: TurnRiverStrategy,
                        prof_p2: TurnRiverStrategy) -> List[ExampleSet]:
    """Supervised examples at every reachable node of the no-raise
    artifact game: 4 turn sets, then 4 river sets for each of the 3
    lines (rows river-major).

    ``targets`` supplies the action distributions to imitate;
    ``prof_p1``/``prof_p2`` the reach profile that weights P1-owned /
    P2-owned nodes. Example weight = own reach x opponent-range-average
    reach x river validity."""
    mask0 = game.mask0
    C = mask0.shape[0]
    ones = torch.ones(C, dtype=F32, device=mask0.device)
    out: List[ExampleSet] = []

    def emit(state, head_pos, dist, w):
        feats, free = _node_feats(state, head_pos, combos)
        dist = dist.reshape(-1, dist.shape[-1])
        tgt = _free_target(dist) if free else _owed_target(dist)
        out.append(ExampleSet(
            feats, tgt,
            torch.full((feats.shape[0],), free, device=feats.device),
            w.reshape(-1).to(F32)))

    # ---- turn nodes ----
    t0_1, t1_1 = prof_p1.t0, prof_p1.t1           # P1-owned weighting
    t0_2 = prof_p2.t0                             # P2-owned weighting
    emit(turn_states["n0"], 0, targets.t0, ones)
    emit(turn_states["n1"], 1, targets.t1, _opp_avg(mask0, t0_2[:, 0]))
    emit(turn_states["n2"], 0, targets.t2,
         t0_1[:, 0] * _opp_avg(mask0, t1_1[:, 1]))
    emit(turn_states["n3"], 1, targets.t3, _opp_avg(mask0, t0_2[:, 1]))

    # ---- river nodes, per line and river card ----
    rho1_1, rho2_1 = _avg_turn_reaches(prof_p1)
    rho1_2, rho2_2 = _avg_turn_reaches(prof_p2)
    valid = 1.0 - game.has_r                      # [Rn, C]
    for L, lname in enumerate(_LINES):
        ns = river_states[lname]
        s0_1, s1_1 = prof_p1.s0[L], prof_p1.s1[L]     # [Rn, C, A]
        s0_2 = prof_p2.s0[L]
        emit(ns["n0"], 0, targets.s0[L],
             valid * rho1_1[L][None, :]
             * _opp_avg(mask0, valid * rho2_1[L][None, :]))
        emit(ns["n1"], 1, targets.s1[L],
             valid * rho2_2[L][None, :]
             * _opp_avg(mask0, valid * rho1_2[L][None, :] * s0_2[:, :, 0]))
        emit(ns["n2"], 0, targets.s2[L],
             valid * rho1_1[L][None, :] * s0_1[:, :, 0]
             * _opp_avg(mask0, valid * rho2_1[L][None, :] * s1_1[:, :, 1]))
        emit(ns["n3"], 1, targets.s3[L],
             valid * rho2_2[L][None, :]
             * _opp_avg(mask0, valid * rho1_2[L][None, :] * s0_2[:, :, 1]))
    return out


@torch.no_grad()
def prelude_examples(params0: MLPParams, prelude_states: Dict,
                     combos) -> List[ExampleSet]:
    """Self-anchor: the START params' own masked action distributions at
    the scripted preflop/flop prelude nodes become targets, so the
    distilled net keeps its early-street behaviour."""
    out = []
    for state in prelude_states.values():
        head_pos = int(head_info(state)[0][0])
        feats, free = _node_feats(state, head_pos, combos)
        params = MLPParams(*(torch.as_tensor(x).to(feats.device, F32)
                             for x in params0))
        logits = policy_logits(params, feats)
        n = feats.shape[0]
        fm = torch.full((n,), free, device=feats.device)
        tgt = torch.softmax(fold_masked(logits, fm), dim=-1)
        out.append(ExampleSet(feats, tgt, fm,
                              torch.ones(n, dtype=F32, device=feats.device)))
    return out


def stack_examples(sets: List[ExampleSet], min_weight: float = 1e-6
                   ) -> ExampleSet:
    """Concatenate, drop zero-weight rows, normalize to mean weight 1 (in
    numpy, as the JAX module does), on the first set's device."""
    dev = sets[0].feats.device

    def cat(i):
        return np.concatenate([s[i].detach().cpu().numpy() for s in sets])

    feats, tgt, fm, w = (cat(i) for i in range(4))
    keep = w > min_weight
    feats, tgt, fm, w = feats[keep], tgt[keep], fm[keep], w[keep]
    w = w / max(w.mean(), 1e-12)
    return ExampleSet(*(torch.as_tensor(x, device=dev)
                        for x in (feats, tgt, fm, w)))


def _train_logits(params: MLPParams, feats) -> torch.Tensor:
    """``policy_logits`` as matrix products, the JAX module's form: the
    same function up to float summation order, in a few launches. The
    ordered sums of ``policy_logits`` (the net kernels' order) take about
    5,000 launches a training step under autograd, 50 ms a step on an
    H100."""
    h = torch.relu(feats @ params.w1 + params.b1)
    h = torch.relu(h @ params.w2 + params.b2)
    return h @ params.w3 + params.b3


def _masked_ce(params: MLPParams, ex: ExampleSet, idx) -> torch.Tensor:
    """Weighted cross-entropy of the masked softmax against the targets
    on the rows ``idx``; a zero target contributes nothing (and no
    gradient) even where its log-probability is -1e9."""
    feats, tgt = ex.feats[idx], ex.target[idx]
    fm, w = ex.fold_masked[idx], ex.weight[idx]
    logits = _train_logits(params, feats)
    fold = torch.arange(NUM_ACTIONS, device=logits.device) == 0
    logits = logits + torch.where(fm[:, None] & fold[None, :], FOLD_MASK,
                                  0.0)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -(tgt * torch.where(tgt > 0, logp, 0.0)).sum(-1)
    return (w * ce).sum() / w.sum()


def distill(params0: MLPParams, data: ExampleSet,
            anchor: ExampleSet = None, steps: int = 2000,
            batch: int = 8192, lr: float = 3e-4,
            anchor_weight: float = 1.0, l2_init: float = 1e-4,
            seed: int = 0, log=None, log_every: int = 200) -> MLPParams:
    """Adam on weighted masked cross-entropy to the solver targets, plus
    the prelude self-anchor and an L2 leash to the start params, on the
    device of ``data``. Minibatches are index slices of a reshuffled
    permutation drawn from ``np.random.default_rng(seed)`` exactly as the
    JAX module draws them, so both see the same rows. Returns the params
    on that device."""
    require_full_f32()
    dev = data.feats.device
    start = [torch.as_tensor(x).to(dev, F32) for x in params0]
    leaves = [x.clone().requires_grad_(True) for x in start]
    opt = torch.optim.Adam(leaves, lr=lr)

    n = data.feats.shape[0]
    an = anchor.feats.shape[0] if anchor is not None else 1
    abatch = min(batch, an)
    rng = np.random.default_rng(seed)
    perm, pos = rng.permutation(n), 0
    for t in range(steps):
        if pos + batch > n:
            perm, pos = rng.permutation(n), 0
        idx = torch.as_tensor(perm[pos:pos + batch], device=dev)
        pos += batch
        aidx = torch.as_tensor(rng.integers(0, an, size=abatch), device=dev)
        params = MLPParams(*leaves)
        loss = _masked_ce(params, data, idx)
        if anchor is not None:
            loss = loss + anchor_weight * _masked_ce(params, anchor, aidx)
        leash = sum(((p - q) ** 2).sum() for p, q in zip(leaves, start))
        loss = loss + l2_init * leash
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log and (t % log_every == 0 or t == steps - 1):
            log({"step": t, "loss": round(float(loss.detach()), 5)})
    return MLPParams(*(x.detach().clone() for x in leaves))
