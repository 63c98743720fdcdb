"""Fold-preservation leash for ES training: ``montecarlo_tpu/models/leash.py``
on the port's parameters.

The leash reshapes ES fitness to

    bb/hand + lambda * mean(clip(log P(fold), CLIP_LOG_P))

over a FIXED batch of facing-a-bet states where the distilled net's
argmax is fold (``scripts/make_fold_anchor.py``), so that the never-fold
defection costs fitness (``scripts/train_es_kernel.py --fold-anchor``).

Host-side numpy, as in the JAX package: the leash is scored per ES
candidate between kernel launches. The parameter leaves may be tensors on
any device; each call pulls them to the host once (``.detach().cpu()``),
and from there the arithmetic is the JAX module's numpy float32, so the
two packages score the same leaves bit for bit.
"""

import numpy as np

# Clip for log P(fold): below e^-8 ~ 3e-4 the net has defected anyway
# and an unbounded log would let one -inf state dominate the mean.
CLIP_LOG_P = -8.0


def to_host(x) -> np.ndarray:
    """A parameter leaf (tensor or array) as a C-ordered host numpy array.
    The order matters: numpy's matmul takes another summation path for a
    transposed operand (``load_params`` keeps an artifact's Fortran-ordered
    leaf as a transposed view), and a JAX array reaches numpy C-ordered."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x)


def anchor_log_pfold(params, feats, clip=CLIP_LOG_P):
    """Mean clipped log P(fold) of ``params`` over anchor features.

    ``feats``: float32 [N, NUM_FEATURES] decision-state features
    (``models/features.py`` layout) at anchored fold states.
    ``params``: an ``MLPParams`` (w1, b1, w2, b2, w3, b3)."""
    w1, b1, w2, b2, w3, b3 = (to_host(x) for x in params)
    h = np.maximum(feats @ w1 + b1, 0.0)
    h = np.maximum(h @ w2 + b2, 0.0)
    lg = h @ w3 + b3
    z = lg - lg.max(axis=1, keepdims=True)
    logp = z[:, 0] - np.log(np.exp(z).sum(axis=1))
    return float(np.maximum(logp, clip).mean())


def load_anchor(path):
    """Load a fold-anchor .npz (``scripts/make_fold_anchor.py``) -> feats."""
    anc = np.load(path)
    return np.asarray(anc["feats"], np.float32)


def make_anchor_score(path, clip=CLIP_LOG_P):
    """Bind an anchor file into a per-candidate scoring closure."""
    feats = load_anchor(path)

    def score(params):
        return anchor_log_pfold(params, feats, clip)

    return score, feats
