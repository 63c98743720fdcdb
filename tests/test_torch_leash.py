"""The fold leash (``montecarlo_tpu_torch/models/leash.py``) against the
JAX package's ``models/leash.py``.

- The four cases of ``tests/test_leash.py`` on the port (the numpy
  forward equals ``policy_logits`` + log-softmax within 1e-5, the clip
  floor, the selection flip at lambda 0.25, the anchor file round trip).
- On the committed ``data/fold_anchor.npz``: ``anchor_log_pfold`` of es8,
  es9 and distill with torch leaves equals JAX's on the same leaves
  exactly (tolerance 0: both are numpy float32 from the host arrays).
"""

import numpy as np
import pytest
import torch

from montecarlo_tpu.models import leash as jleash
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu_torch.models.features import NUM_FEATURES
from montecarlo_tpu_torch.models.leash import (
    CLIP_LOG_P,
    anchor_log_pfold,
    load_anchor,
    make_anchor_score,
)
from montecarlo_tpu_torch.models.policy_net import (
    MLPParams,
    init_params,
    load_params,
    policy_logits,
)

torch.set_num_threads(1)


def _random_feats(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, NUM_FEATURES)).astype(np.float32)


def test_matches_policy_logits_log_softmax():
    params = init_params(torch.Generator().manual_seed(7))
    feats = _random_feats(7, 257)
    got = anchor_log_pfold(params, feats)
    lg = policy_logits(params, torch.from_numpy(feats))
    logp_fold = torch.log_softmax(lg, dim=-1)[:, 0]
    want = float(torch.clamp(logp_fold, min=CLIP_LOG_P).mean())
    assert abs(got - want) < 1e-5


def _bias_only_params(b3):
    """A zero-weight net whose logits are exactly b3 at every state."""
    hidden = 8
    z = np.zeros
    return MLPParams(*(torch.tensor(x) for x in (
        z((NUM_FEATURES, hidden), np.float32), z((hidden,), np.float32),
        z((hidden, hidden), np.float32), z((hidden,), np.float32),
        z((hidden, 4), np.float32), np.asarray(b3, np.float32))))


def test_clip_floor_on_buried_fold_logit():
    feats = _random_feats(3, 64)
    assert anchor_log_pfold(_bias_only_params([-100.0, 0, 0, 0]),
                            feats) == CLIP_LOG_P
    assert anchor_log_pfold(_bias_only_params([100.0, 0, 0, 0]),
                            feats) > -1e-3


def test_leashed_fitness_flips_selection():
    feats = _random_feats(5, 64)
    lam = 0.25
    defector_bb, folder_bb = 1.13, 0.0
    defector = _bias_only_params([-50.0, 1.0, 0.0, 0.0])
    folder = _bias_only_params([2.0, 0.0, 0.0, 0.0])
    defector_fit = defector_bb + lam * anchor_log_pfold(defector, feats)
    folder_fit = folder_bb + lam * anchor_log_pfold(folder, feats)
    assert defector_bb > folder_bb
    assert folder_fit > defector_fit
    assert lam * -CLIP_LOG_P == 2.0


def test_make_anchor_score_roundtrip(tmp_path):
    feats = _random_feats(11, 32)
    path = tmp_path / "anchor.npz"
    np.savez(path, feats=feats, p_fold_ref=np.full((32,), 0.9))
    loaded = load_anchor(str(path))
    assert loaded.dtype == np.float32
    np.testing.assert_array_equal(loaded, feats)
    score, feats_out = make_anchor_score(str(path))
    params = init_params(torch.Generator().manual_seed(12))
    assert score(params) == anchor_log_pfold(params, feats)
    assert feats_out.shape == (32, NUM_FEATURES)


@pytest.mark.parametrize("name", ["es8", "es9", "distill"])
def test_anchor_score_on_the_committed_anchor_equals_jax(name):
    path = f"data/policy_6max_{name}.npz"
    ours = load_params(path)
    theirs = jpn.load_params(path)
    feats = load_anchor("data/fold_anchor.npz")
    assert feats.shape == (11406, NUM_FEATURES)
    got = anchor_log_pfold(ours, feats)
    assert got == jleash.anchor_log_pfold(theirs, feats)
    assert got == jleash.anchor_log_pfold(
        jpn.MLPParams(*(x.numpy() for x in ours)), feats)
    assert CLIP_LOG_P == jleash.CLIP_LOG_P
