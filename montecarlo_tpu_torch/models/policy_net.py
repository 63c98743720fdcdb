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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from montecarlo_tpu_torch.models.features import NUM_FEATURES

F32 = torch.float32

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
