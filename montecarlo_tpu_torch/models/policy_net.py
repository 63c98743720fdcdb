"""Policy network: a 24-64-64-4 ReLU MLP over the decision features.

The counterpart of ``montecarlo_tpu/models/policy_net.py``. Parameters
keep the JAX layout (``w`` is [in, out]), so artifacts and JAX parameters
carry across unchanged. The menu is fold / call / raise 2bb / raise pot.

``policy_logits`` sums in one fixed order, bias first and then the
products of input 0, 1, ... each rounded once (no fused multiply-add).
The net kernels (``csrc/net.cuh:mc_mlp_rows``) sum in the same order
with ``__fmul_rn``/``__fadd_rn``, so the kernel and this function give the
same logits bit for bit. JAX's matmul sums in another order: the two
agree within float32 rounding, not bit for bit.

``net_policy`` plays the net on the table engine (``engine/``) as a
``rollout/policy`` policy: ``state_features`` -> ``policy_logits`` -> the
fold masked where nothing is owed -> a categorical pick (Gumbel-max on the
key's Philox words, as K6 picks) or, with ``greedy``, the argmax (K5's
rule) -> ``action_from_index``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from montecarlo_tpu_torch.engine.step import head_info
from montecarlo_tpu_torch.engine.street import bets_needed, bets_total
from montecarlo_tpu_torch.models.features import NUM_FEATURES, state_features

F32 = torch.float32
I32 = torch.int32
FOLD_MASK = -1e9  # added to the fold logit when nothing is owed

NUM_ACTIONS = 4  # fold, call/check, raise 2bb, raise pot
HIDDEN = 64


class MLPParams(NamedTuple):
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor


def init_params(generator: torch.Generator, hidden: int = HIDDEN) -> MLPParams:
    """He-normal weights and zero biases of a 24-``hidden``-``hidden``-4
    net, drawn from ``generator`` (the JAX ``init_params`` scheme; the
    values differ from JAX's). The net kernels take ``hidden`` = 64 only
    (``ops/cuda_net.net_weights`` refuses other widths); ``policy_logits``
    takes any."""
    def dense(n_in, n_out):
        w = torch.randn((n_in, n_out), generator=generator, dtype=F32)
        return w * math.sqrt(2.0 / n_in), torch.zeros(n_out, dtype=F32)

    w1, b1 = dense(NUM_FEATURES, hidden)
    w2, b2 = dense(hidden, hidden)
    w3, b3 = dense(hidden, NUM_ACTIONS)
    return MLPParams(w1, b1, w2, b2, w3, b3)


def params_from_numpy(leaves) -> MLPParams:
    """Six arrays in ``MLPParams`` order (for example the leaves of a JAX
    ``MLPParams`` as numpy) -> float32 CPU tensors."""
    return MLPParams(*(torch.tensor(np.asarray(x, np.float32))
                       for x in leaves))


def load_params(path) -> MLPParams:
    """Load a ``.npz`` artifact (``p_0`` .. ``p_5``). Artifacts of the
    older 20-feature set load with ``w1`` zero-padded to NUM_FEATURES
    rows: features are only ever appended, and a zero row adds nothing."""
    with np.load(path) as data:
        leaves = [data[f"p_{i}"] for i in range(len(MLPParams._fields))]
    w1 = leaves[0]
    if w1.shape[0] < NUM_FEATURES:
        pad = np.zeros((NUM_FEATURES - w1.shape[0], w1.shape[1]), w1.dtype)
        leaves[0] = np.concatenate([w1, pad], axis=0)
    return params_from_numpy(leaves)


def save_params(path, params: MLPParams) -> None:
    """Write an ``.npz`` artifact (``p_0`` .. ``p_5``), as the JAX
    ``save_params`` does; ``load_params`` reads it back."""
    np.savez_compressed(path, **{f"p_{i}": x.detach().cpu().numpy()
                                 for i, x in enumerate(params)})


def _dense(x, w, b):
    """[..., n_in] -> [..., n_out]: b + x_0 w_0 + x_1 w_1 + ..., in order."""
    acc = b.expand(*x.shape[:-1], w.shape[1])
    for i in range(w.shape[0]):
        acc = acc + x[..., i, None] * w[i]
    return acc


def policy_logits(params: MLPParams, feats) -> torch.Tensor:
    """[..., NUM_FEATURES] -> [..., NUM_ACTIONS] float32 logits."""
    h = torch.relu(_dense(feats, params.w1, params.b1))
    h = torch.relu(_dense(h, params.w2, params.b2))
    return _dense(h, params.w3, params.b3)


class PolicyNet(nn.Module):
    """The policy MLP as a module; ``forward`` is ``policy_logits``."""

    def __init__(self, params: MLPParams):
        super().__init__()
        for name, value in params._asdict().items():
            self.register_parameter(name, nn.Parameter(value.to(F32)))

    def params(self) -> MLPParams:
        return MLPParams(*(getattr(self, n) for n in MLPParams._fields))

    def forward(self, feats):
        return policy_logits(self.params(), feats)


def action_from_index(idx, state) -> torch.Tensor:
    """Menu index int [T] -> the engine action int32 [T] (``action.clj``
    encoding): fold, call, raise 2bb, raise max(pot + needed, 2bb)."""
    seat, _, _ = head_info(state)
    live = (torch.arange(state.pots.capacity, device=seat.device)[None]
            < state.pots.count[:, None])
    pot = bets_total(state.bets) + torch.where(live, state.pots.amt, 0) \
        .sum(1, dtype=I32)
    needed = bets_needed(state.bets, seat)
    small = 2 * state.big_blind
    pot_raise = torch.maximum(pot + needed, small)
    idx = torch.as_tensor(idx, device=seat.device)
    return torch.where(idx == 0, -1, torch.where(
        idx == 1, 0, torch.where(idx == 2, small, pot_raise))).to(I32)


def first_max(x: torch.Tensor) -> torch.Tensor:
    """The first index attaining the max of each row of ``x`` [T, n]."""
    cols = torch.arange(x.shape[1], dtype=I32, device=x.device)[None]
    return torch.where(x == x.amax(1, keepdim=True), cols,
                       x.shape[1]).amin(1)


def fold_masked(logits: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Logits [N, NUM_ACTIONS] with ``FOLD_MASK`` added to the fold where
    ``free`` (bool [N]: nothing owed, so a fold is a wasted check)."""
    mask = torch.where(free, FOLD_MASK, 0.0).to(F32)
    return torch.cat([logits[:, :1] + mask[:, None], logits[:, 1:]], dim=1)


def masked_logits(logits: torch.Tensor, state) -> torch.Tensor:
    """``fold_masked`` where each table's head owes nothing."""
    seat, _, _ = head_info(state)
    return fold_masked(logits, bets_needed(state.bets, seat) == 0)


def gumbel_pick(key, logits: torch.Tensor) -> torch.Tensor:
    """A categorical pick of each row of ``logits`` [T, NUM_ACTIONS] by
    Gumbel-max on the key's four words (u = (word >> 8) 2^-24,
    g = -log(-log(max(u, 1e-12))), K6's pick)."""
    u = (key.words(NUM_ACTIONS).T >> 8).to(F32) * 2.0 ** -24
    return first_max(logits - torch.log(-torch.log(u.clamp(min=1e-12))))


def net_policy(params: MLPParams, greedy: bool = False):
    """``params`` as a policy ``(key, state, street_raises) -> action``
    (``rollout/policy.py``): ``masked_logits``, then ``gumbel_pick`` or,
    with ``greedy``, the first argmax (K5's)."""
    on_device = {}

    def policy(key, state, street_raises):
        del street_raises
        feats = state_features(state)
        dev = feats.device
        if dev not in on_device:
            on_device[dev] = MLPParams(*(x.to(dev, F32) for x in params))
        logits = masked_logits(policy_logits(on_device[dev], feats), state)
        idx = first_max(logits) if greedy else gumbel_pick(key, logits)
        return action_from_index(idx, state)

    return policy
