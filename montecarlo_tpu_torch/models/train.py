"""REINFORCE self-play training for the policy network:
``montecarlo_tpu/models/train.py`` on the port's table engine.

The game is the engine's (integers, not differentiable); the
score-function estimator needs gradients of the learner's action
log-probs only, which flow through the MLP. So an update runs in two
parts:

1. collection, under ``torch.no_grad()``: ``max_steps`` steps of
   ``step_action`` on every table (tables on the leading axis, the early
   stop of ``rollout/selfplay.play_one_hand``), the learner's pick by
   Gumbel-max on its masked logits (``net_policy``'s pick), then
   ``settle_showdown`` on the tables whose hand is over. Every step where
   the learner acts records its features, its free-fold flag, its pick
   and its table (``Records``);
2. the loss: one differentiable ``policy_logits`` over the recorded rows,
   ``log_softmax`` at the picked index, summed per table (the JAX
   module's per-step sum), weighted by advantage-normalized rewards.

Rewards are chip deltas in big blinds, ``stacks[learner] - start`` with
the blinds the learner posted added back to ``start``, read unsettled on
a table whose hand is not over after ``max_steps``, as the JAX module
reads them. The advantage divides by the population standard deviation
(``jnp.std``; ``correction=0`` here). The optimizer is
``torch.optim.Adam(lr)``: optax's ``adam(lr)`` defaults (b1 0.9, b2
0.999, eps 1e-8 outside the square root), the same update up to
rounding. ``policy_logits`` sums in a fixed order with no matmul, so
TF32 never enters.

Random words (``rollout/policy.PolicyKey``): update i of a run seeded
``seed`` plays on seed ``fold_seed(seed, 1000 + i)`` (JAX's
``fold_in(key, 1000 + i)``): its decks are ``init_state``'s of that seed,
and at step s table t's learner draws from Philox stream (seed', t, s,
``SUB_TRAIN`` + 1) and its opponent from sub-stream ``SUB_TRAIN`` + 2
(``fold_in(key, 0)`` and ``fold_in(key, 1)``). The entry points run on
``device``: the card when None, ``"cpu"`` for the CPU.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.state import (
    TableConfig,
    _select_tree,
    init_state,
)
from montecarlo_tpu_torch.engine.step import (
    _put,
    _take,
    clamp_action,
    head_info,
    settle_showdown,
    step_action,
)
from montecarlo_tpu_torch.engine.street import _pick, bets_needed
from montecarlo_tpu_torch.models.features import NUM_FEATURES, state_features
from montecarlo_tpu_torch.models.policy_net import (
    MLPParams,
    action_from_index,
    fold_masked,
    gumbel_pick,
    init_params,
    policy_logits,
)
from montecarlo_tpu_torch.ops.philox import MASK, stream_words
from montecarlo_tpu_torch.rollout.policy import (
    PolicyKey,
    at_step,
    fold_in,
    policy_key,
    random_policy,
)
from montecarlo_tpu_torch.rollout.selfplay import STOP_EVERY, _subset

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

# Philox sub-streams: the policy words of an update's tables (beside
# rollout/policy.SUB_HANDS etc.; the learner takes + 1, the opponent + 2),
# and the seed derivation of fold_seed (the next id after ops/philox.py's
# 65540).
SUB_TRAIN = 0x7EA1 << 16
SUB_FOLD_SEED = 65541


def fold_seed(seed: int, data: int) -> int:
    """A 32-bit seed derived from (``seed``, ``data``), as JAX's
    ``fold_in(key, data)``: word 0 of Philox stream (seed, data, 0,
    ``SUB_FOLD_SEED``)."""
    lo = torch.tensor([int(data) & MASK], dtype=I64)
    return int(stream_words(int(seed) & MASK, lo, 0, SUB_FOLD_SEED, 0, 1)[0, 0])


class Records(NamedTuple):
    """The learner's decisions of a batch, one row each."""

    feats: torch.Tensor  # float32 [N, NUM_FEATURES]
    free: torch.Tensor   # bool [N]: nothing owed, the fold masked
    idx: torch.Tensor    # int64 [N]: the menu index picked
    table: torch.Tensor  # int64 [N]: the row's table
    step: torch.Tensor   # int64 [N]: the row's step (one row a table-step)


def _play_hand_collect(params: MLPParams, state, key: PolicyKey,
                       learner_pos: torch.Tensor, opponent: Callable,
                       max_steps: int, rules: str):
    """Play one hand on every table, the learner at position
    ``learner_pos[t]`` (int32 [T]) and ``opponent`` elsewhere.

    Returns ``(reward float32 [T], Records, overflowed bool [T])``: the
    learner's chip delta, its decisions, and the tables whose bet or pot
    layers overflowed their capacity. No gradient is recorded (the
    caller's loss recomputes the log-probs from the records,
    ``log_prob_sums``)."""
    dev = state.stacks.device
    blinds = torch.where(learner_pos == 0, state.small_blind,
                         torch.where(learner_pos == 1, state.big_blind, 0))
    start = _pick(state.stacks, learner_pos) + blinds
    learner_key, opp_key = fold_in(key, 0), fold_in(key, 1)
    street_raises = torch.zeros_like(state.stage)
    rows = []
    with torch.no_grad():
        params = MLPParams(*(x.detach().to(dev, F32) for x in params))
        for first in range(0, max_steps, STOP_EVERY):
            live = (~state.hand_over).nonzero()[:, 0]
            if not live.numel():
                break
            sub, raises = _take(state, live), street_raises[live]
            pos = learner_pos[live]
            lkey, okey = _subset(learner_key, live), _subset(opp_key, live)
            for i in range(first, min(first + STOP_EVERY, max_steps)):
                seat, _, exists = head_info(sub)
                is_learner = (seat == pos) & exists & ~sub.hand_over
                feats = state_features(sub)
                free = bets_needed(sub.bets, seat) == 0
                logits = fold_masked(policy_logits(params, feats), free)
                idx = gumbel_pick(at_step(lkey, i), logits)
                action = torch.where(
                    is_learner, action_from_index(idx, sub),
                    torch.as_tensor(opponent(at_step(okey, i), sub, raises),
                                    device=dev).to(I32))
                action = clamp_action(sub, action)
                nxt = step_action(sub, action, rules=rules)
                applied = (action > 0) & ~sub.hand_over
                raises = torch.where(nxt.stage != sub.stage, 0,
                                     raises + applied.to(I32))
                sel = is_learner.nonzero()[:, 0]
                rows.append((feats[sel], free[sel], idx[sel].to(I64),
                             live[sel], torch.full_like(sel, i)))
                sub = nxt
            state = _put(state, live, sub)
            street_raises = street_raises.index_copy(0, live, raises)
        state = _select_tree(state.hand_over,
                             settle_showdown(state, rules=rules), state)
    reward = (_pick(state.stacks, learner_pos) - start).to(F32)
    if rows:
        rec = Records(*(torch.cat(c) for c in zip(*rows)))
    else:
        none = torch.zeros(0, dtype=I64, device=dev)
        rec = Records(torch.zeros((0, NUM_FEATURES), dtype=F32, device=dev),
                      torch.zeros(0, dtype=torch.bool, device=dev), none,
                      none, none)
    overflowed = state.bets.overflow | state.pots.overflow
    return reward, rec, overflowed


def log_prob_sums(params: MLPParams, rec: Records,
                  n_tables: int) -> torch.Tensor:
    """Each table's sum of the learner's log-probs of its picks, float32
    [n_tables], differentiable in ``params``. The rows go to a dense
    [steps, tables] grid (one row a cell) summed over the steps, so the
    card sums in a fixed order (an ``index_add`` of many rows a table
    would sum in the order its atomics land)."""
    logits = fold_masked(policy_logits(params, rec.feats), rec.free)
    logp = torch.log_softmax(logits, dim=1).gather(1, rec.idx[:, None])[:, 0]
    steps = int(rec.step.max()) + 1 if rec.step.numel() else 1
    grid = torch.zeros((steps, n_tables), dtype=F32, device=logp.device)
    return grid.index_put((rec.step, rec.table), logp).sum(0)


def reinforce_loss(params: MLPParams, rec: Records,
                   rewards_bb: torch.Tensor) -> torch.Tensor:
    """``-mean(adv * log-prob sums)``, ``adv`` the rewards normalized by
    their mean and population standard deviation (+ 1e-6)."""
    lps = log_prob_sums(params, rec, rewards_bb.shape[0])
    adv = (rewards_bb - rewards_bb.mean()) / (
        rewards_bb.std(correction=0) + 1e-6)
    return -(adv * lps).mean()


class TrainResult(NamedTuple):
    params: MLPParams
    mean_reward_bb: torch.Tensor  # float32 [steps] learner bb/hand per update


def make_update_step(cfg: TableConfig, opponent: Callable = random_policy,
                     tables: int = 2048, lr: float = 3e-3,
                     max_steps: int = 48, device=None):
    """``(opt_init, update)``: ``opt_init(params)`` makes the Adam optimizer
    (its parameters on ``device``, the card when None), and
    ``update(params, opt, seed)`` plays ``tables`` fresh hands of
    ``init_state(seed)`` and applies one advantage-normalized REINFORCE
    step, returning ``(params, opt, mean reward in bb, tables whose
    layers overflowed)``. Any
    ``opt_init``'s optimizer serves any ``update`` of the same ``lr``, so
    updates against different opponents may share one Adam state."""
    dev = resolve(device)
    bb = float(cfg.big_blind)

    def opt_init(params: MLPParams) -> torch.optim.Adam:
        leaves = [x.detach().to(dev, F32).clone().requires_grad_(True)
                  for x in params]
        return torch.optim.Adam(leaves, lr=lr)

    def update(params: MLPParams, opt: torch.optim.Adam, seed: int):
        leaves = opt.param_groups[0]["params"]
        with torch.no_grad():
            for leaf, x in zip(leaves, params):
                leaf.copy_(x)
        st = init_state(seed, cfg, tables, dev)
        learner_pos = (torch.arange(tables, device=dev)
                       % cfg.num_seats).to(I32)
        rewards, rec, overflowed = _play_hand_collect(
            MLPParams(*leaves), st, policy_key(seed, tables, SUB_TRAIN, dev),
            learner_pos, opponent, max_steps, cfg.rules)
        rewards_bb = rewards / bb
        loss = reinforce_loss(MLPParams(*leaves), rec, rewards_bb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        out = MLPParams(*(leaf.detach().clone() for leaf in leaves))
        return out, opt, float(rewards_bb.mean()), int(overflowed.sum())

    return opt_init, update


def train_policy(seed: int,
                 cfg: TableConfig = TableConfig(num_seats=2,
                                                rules="standard"),
                 opponent: Callable = random_policy, tables: int = 2048,
                 steps: int = 100, lr: float = 3e-3, max_steps: int = 48,
                 device=None) -> TrainResult:
    """REINFORCE loop: the net of ``init_params`` (a generator seeded
    ``seed``) plays ``tables`` fresh hands a update against ``opponent``
    (the learner's position rotating across the batch) and ascends the
    advantage-weighted log-likelihood; update i on ``fold_seed(seed,
    1000 + i)``."""
    params = init_params(torch.Generator().manual_seed(seed))
    opt_init, update = make_update_step(cfg, opponent, tables, lr,
                                        max_steps, device)
    opt = opt_init(params)
    history = []
    for i in range(steps):
        params, opt, mean_r, _ = update(params, opt,
                                        fold_seed(seed, 1000 + i))
        history.append(mean_r)
    return TrainResult(params=params,
                       mean_reward_bb=torch.tensor(history, dtype=F32))
