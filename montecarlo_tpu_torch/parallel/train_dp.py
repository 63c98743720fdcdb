"""Data-parallel REINFORCE over the ranks: the port of
``montecarlo_tpu/parallel/train_dp.py``.

The recipe of the JAX module: the (tiny) policy parameters are
replicated, the self-play tables are sharded over the ranks, each rank
computes the score-function gradient of its tables, and the gradients are
summed over the ranks (``all_reduce``, then / W), so every rank takes the
same Adam step and the parameters stay equal on every rank.

Rank r plays tables r T .. (r + 1) T - 1 of the step's seed
(``init_state`` and the policy words by global table index, with
``models/train``'s sub-stream ``SUB_TRAIN``), the learner at position
(local index) mod P as in JAX (``train_dp.py:48``); a rollout is
``models/train._play_hand_collect``. The advantage is JAX's:
``(r - g) rsqrt(v + 1e-6)``, with g the mean over the ranks of each
rank's mean reward and v the mean over the ranks of each rank's mean
squared deviation from g (``train_dp.py:66-69``), not
``train.reinforce_loss``'s ``std + 1e-6``.
"""

from __future__ import annotations

from typing import Callable

import torch

from montecarlo_tpu_torch.engine.state import TableConfig, init_state
from montecarlo_tpu_torch.models.policy_net import MLPParams
from montecarlo_tpu_torch.models.train import (
    SUB_TRAIN,
    _play_hand_collect,
    log_prob_sums,
)
from montecarlo_tpu_torch.parallel.mesh import Mesh, all_reduce
from montecarlo_tpu_torch.rollout.policy import policy_key, random_policy

F32 = torch.float32
I32 = torch.int32


def dp_loss(lps: torch.Tensor, rewards_bb: torch.Tensor, g_mean,
            g_var) -> torch.Tensor:
    """The rank's loss ``-mean(adv * lps)`` with the advantage normalized
    by the all-rank mean ``g_mean`` and variance ``g_var``
    (``train_dp.py:63-70``)."""
    adv = (rewards_bb - g_mean) * torch.rsqrt(g_var + 1e-6)
    return -(adv * lps).mean()


def make_dp_train_step(mesh: Mesh, cfg: TableConfig,
                       opponent: Callable = random_policy,
                       tables_per_device: int = 256, lr: float = 3e-3,
                       max_steps: int = 48):
    """``(opt_init, step)``: ``opt_init(params)`` makes the Adam optimizer
    (``models/train``'s: optax's ``adam(lr)`` defaults) on the mesh's
    device, and ``step(params, opt, seed)`` plays the rank's tables of
    seed ``seed`` and applies one advantage-normalized REINFORCE update
    with the gradients averaged over the ranks. Returns ``(params, opt,
    mean_r)``: the new parameters (equal on every rank), the optimizer,
    and the mean reward in big blinds over every rank's tables."""
    dev = mesh.device
    T = tables_per_device
    first = mesh.rank * T
    bb = float(cfg.big_blind)

    def opt_init(params: MLPParams) -> torch.optim.Adam:
        leaves = [x.detach().to(dev, F32).clone().requires_grad_(True)
                  for x in params]
        return torch.optim.Adam(leaves, lr=lr)

    def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
        return all_reduce(mesh, x.detach().reshape(1).clone())[0] \
            / mesh.size

    def step(params: MLPParams, opt: torch.optim.Adam, seed: int):
        leaves = opt.param_groups[0]["params"]
        with torch.no_grad():
            for leaf, x in zip(leaves, params):
                leaf.copy_(x)
        st = init_state(seed, cfg, T, dev, first)
        learner_pos = (torch.arange(T, device=dev) % cfg.num_seats).to(I32)
        rewards, rec, _ = _play_hand_collect(
            MLPParams(*leaves), st, policy_key(seed, T, SUB_TRAIN, dev,
                                               first),
            learner_pos, opponent, max_steps, cfg.rules)
        rewards_bb = rewards / bb
        g_mean = mean_over_ranks(rewards_bb.mean())
        g_var = mean_over_ranks(((rewards_bb - g_mean) ** 2).mean())
        loss = dp_loss(log_prob_sums(MLPParams(*leaves), rec, T),
                       rewards_bb, g_mean, g_var)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(x) if g is None else g)
                          .reshape(-1) for x, g in zip(leaves, grads)])
        flat = all_reduce(mesh, flat) / mesh.size
        for leaf, g in zip(leaves, flat.split([x.numel() for x in leaves])):
            leaf.grad = g.view_as(leaf)
        opt.step()
        out = MLPParams(*(leaf.detach().clone() for leaf in leaves))
        return out, opt, float(g_mean)

    return opt_init, step
