"""The port's CMA-ES (``montecarlo_tpu_torch/models/cma.py``) and the
``opt_bot`` helpers built on it, against the JAX package.

- ``CMAES``: the same seed and fitness give the JAX copy's state exactly
  (tolerance 0) over 20 generations: the asked points, ``mean``,
  ``sigma`` and ``C``. Both are numpy float64 on the same formulas.
- Every case of ``tests/test_cma.py`` on the port: convergence on the
  sphere, Rosenbrock and a noisy sphere, the bounds, ``opt_bot``'s family
  dispatch and ``_norm_rule``, and the ``optbot:`` spec of
  ``train_es_kernel.resolve_opponent``; ``make_bot`` builds the JAX
  package's arrays exactly (pair and ladder families, and a vector of the
  older 20-feature set, zero-padded).
"""

import json

import numpy as np
import pytest
import torch

from montecarlo_tpu.models.cma import CMAES as JCMAES
from montecarlo_tpu_torch.models.cma import CMAES
from montecarlo_tpu_torch.models.features import NUM_FEATURES
from montecarlo_tpu_torch.models.policy_net import policy_logits
from montecarlo_tpu_torch.scripts import opt_bot
from montecarlo_tpu_torch.scripts.train_es_kernel import resolve_opponent

torch.set_num_threads(1)


def _logits(params, feats):
    return policy_logits(params, torch.as_tensor(feats, dtype=torch.float32))


@pytest.mark.parametrize("dim,bounded", [(3, False), (21, True)])
def test_cma_equals_jax_copy_exactly(dim, bounded):
    rng = np.random.default_rng(dim)
    target = rng.uniform(-1, 1, dim)
    kw = dict(lower=np.full(dim, -0.8), upper=np.full(dim, 0.8)) \
        if bounded else {}
    ours = CMAES(np.zeros(dim), sigma0=0.5, popsize=12, seed=5, **kw)
    theirs = JCMAES(np.zeros(dim), sigma0=0.5, popsize=12, seed=5, **kw)
    for _ in range(20):
        x, y = ours.ask(), theirs.ask()
        np.testing.assert_array_equal(x, y)
        f = -np.sum((x - target[None]) ** 2, axis=1)
        ours.tell(f)
        theirs.tell(f)
        np.testing.assert_array_equal(ours.mean, theirs.mean)
        assert ours.sigma == theirs.sigma
        np.testing.assert_array_equal(ours.C, theirs.C)
    assert ours.gen == theirs.gen == 20


def test_cma_sphere():
    target = np.array([1.5, -2.0, 0.5, 3.0, -1.0, 0.0, 2.5, -0.5])
    es = CMAES(np.zeros(8), sigma0=1.0, popsize=16, seed=3)
    for _ in range(120):
        x = es.ask()
        es.tell(-np.sum((x - target[None]) ** 2, axis=1))
    assert np.allclose(es.mean, target, atol=1e-2)


def test_cma_rosenbrock_2d():
    es = CMAES([-1.0, 1.0], sigma0=0.5, popsize=12, seed=1)
    for _ in range(300):
        x = es.ask()
        es.tell(-(100.0 * (x[:, 1] - x[:, 0] ** 2) ** 2 + (1 - x[:, 0]) ** 2))
    assert np.allclose(es.mean, [1.0, 1.0], atol=5e-2)


def test_cma_bounds_respected():
    lo, hi = np.full(4, -0.5), np.full(4, 0.5)
    es = CMAES(np.zeros(4), sigma0=1.0, popsize=10, seed=0, lower=lo,
               upper=hi)
    for _ in range(20):
        x = es.ask()
        assert np.all(x >= lo[None] - 1e-12)
        assert np.all(x <= hi[None] + 1e-12)
        es.tell(-np.sum(x ** 2, axis=1))


def test_cma_noisy_fitness_still_improves():
    rng = np.random.default_rng(0)
    target = np.array([1.0, 2.0, -1.0])
    es = CMAES(np.zeros(3), sigma0=0.8, popsize=20, seed=7)
    for _ in range(150):
        x = es.ask()
        f = -np.sum((x - target[None]) ** 2, axis=1)
        es.tell(f + 0.05 * rng.standard_normal(len(f)))
    assert np.sum((es.mean - target) ** 2) < 0.05


def test_opt_bot_family_dispatch():
    """2-field specs route to vector_bot, 3-field specs to ladder_bot; the
    ladder warm start plays nit_ladder's decisions."""
    from montecarlo_tpu_torch.models.bots import _HOLE, ladder_bot

    assert opt_bot.spec_dim((3, 0)) == NUM_FEATURES + 1
    assert opt_bot.spec_dim((3, 1, 0)) == 2 * (NUM_FEATURES + 1)
    got = opt_bot.make_bot(opt_bot._LADDER_X0, (3, 1, 0))
    want = ladder_bot(_HOLE, 1.15, _HOLE, 0.95, top=3, mid=1, bot=0)
    feats = np.random.default_rng(5).random((64, NUM_FEATURES))
    assert torch.equal(_logits(got, feats).argmax(-1),
                       _logits(want, feats).argmax(-1))


def test_opt_bot_norm_rule_keeps_decisions_in_safe_range():
    rng = np.random.default_rng(9)
    nf = NUM_FEATURES
    x = rng.uniform(-3, 3, opt_bot.spec_dim((3, 1, 0)))
    b = opt_bot.make_bot(x, (3, 1, 0))  # must not trip the range guard
    v, t = opt_bot._norm_rule(x[:nf], float(x[nf]))
    assert 2.0 * np.abs(v).sum() + abs(t) <= 4.0 + 1e-6
    f = rng.random((256, nf))
    assert np.array_equal(f @ x[:nf] - x[nf] > 0, f @ v - t > 0)
    assert set(np.unique(_logits(b, f).argmax(-1).numpy())) <= {0, 1, 3}


@pytest.mark.parametrize("acts,n", [((3, 0), NUM_FEATURES + 1),
                                    ((3, 1, 0), 2 * (NUM_FEATURES + 1)),
                                    ((1, 0), 21), ((3, 1, 0), 42)])
def test_make_bot_equals_jax(acts, n):
    """The same vector builds the JAX package's arrays exactly; a vector
    of the older 20-feature set is zero-padded as JAX pads it."""
    import importlib

    jopt = importlib.import_module("scripts.opt_bot")
    x = np.random.default_rng(n).uniform(-2, 2, n)
    ours, theirs = opt_bot.make_bot(x, acts), jopt.make_bot(x, acts)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert opt_bot._JAM_X0.tolist() == jopt._JAM_X0.tolist()
    assert opt_bot.pair_key(acts) == 1000 * len(acts) + sum(
        13 ** i * a for i, a in enumerate(acts))


def test_resolve_opponent_optbot_spec(tmp_path):
    """'optbot:' rebuilds the CMA attacker from an opt_bot JSON (best_pair
    by default, an explicit dash pair, the @lone geometry)."""
    rng = np.random.default_rng(3)
    x_pair = rng.uniform(-1, 1, opt_bot.spec_dim((3, 0))).round(4)
    x_trip = rng.uniform(-1, 1, opt_bot.spec_dim((3, 1, 0))).round(4)
    doc = {"subjects": {"es4": {
        "artifact": "data/policy_6max_es4.npz", "best_pair": "3:1:0",
        "per_pair": {"3:0": {"x": list(x_pair)},
                     "3:1:0": {"x": list(x_trip)}}}}}
    path = tmp_path / "opt.json"
    path.write_text(json.dumps(doc))
    feats = rng.random((32, NUM_FEATURES))

    def acts_of(params):
        return _logits(params, feats).argmax(-1)

    tag, params, geom = resolve_opponent(f"optbot:{path}:es4")
    assert geom == "five"
    assert torch.equal(acts_of(params),
                       acts_of(opt_bot.make_bot(x_trip, (3, 1, 0))))
    tag, params, geom = resolve_opponent(f"optbot:{path}:es4:3-0@lone")
    assert geom == "lone"
    assert torch.equal(acts_of(params),
                       acts_of(opt_bot.make_bot(x_pair, (3, 0))))
    tag, params, geom = resolve_opponent("random@lone")
    assert params is None and geom == "lone"
