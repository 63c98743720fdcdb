"""REINFORCE (``montecarlo_tpu_torch/models/train.py``) against the JAX
package's ``models/train.py``.

- Chains: the same first states (JAX ``init_state``s carried across with
  ``state_from_numpy``) played by a near-deterministic learner (a panel
  bot, whose logit margins make the categorical pick its argmax) against
  deterministic opponents (the calling station, ``tight_policy`` with
  fold probability 1, a policy that hashes the state) at 2, 3 and 6
  seats, including ``train_br``'s capacities (max_layers 8,
  max_pot_layers 16): the rewards equal JAX ``_play_hand_collect``'s
  exactly, and the per-table log-prob sums recomputed from the records
  (``log_prob_sums``) are within 1e-5 of its per-step sums.
- Loss and gradient on fixed records: ``reinforce_loss`` and its autograd
  gradient against ``jax.value_and_grad`` of the same formula built from
  JAX's ``policy_logits`` and ``jax.nn.log_softmax`` (``jnp.std``, the
  population standard deviation), within 1e-5 relative (atol 1e-5 of the
  largest gradient entry): the two sum in different orders.
- Adam: three ``torch.optim.Adam`` steps on fixed gradients against
  ``optax.adam``'s, within 1e-6 relative.
- The reward distribution: an untrained net against ``random_policy`` at
  2048 heads-up tables, the mean reward within 4 sigma of JAX's on its
  own draws.
- The JAX tests ``test_reinforce_one_step_runs`` and (slow, as in JAX)
  ``test_reinforce_improves_vs_calling_station`` on the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from montecarlo_tpu.models import bots as jbots
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.models import train as jtrain
from montecarlo_tpu.rollout import policy as jpol
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.models import bots as tbots
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.models import train as tt
from montecarlo_tpu_torch.models.features import NUM_FEATURES
from montecarlo_tpu_torch.rollout import policy as tpol
from montecarlo_tpu_torch.rollout.selfplay import hand_action_bound
from test_torch_selfplay import jax_hash, port_hash
from test_torch_step import jax_cfg, jax_init, jax_numpy, port_cfg

torch.set_num_threads(1)

T = 48

OPPONENTS = {
    "call": (jpol.always_call, tpol.always_call),
    "tight": (functools.partial(jpol.tight_policy, fold_prob=1.0),
              functools.partial(tpol.tight_policy, fold_prob=1.0)),
    "hash": (jax_hash, port_hash),
}


def _jax_params(params):
    return jpn.MLPParams(*(jnp.asarray(x.detach().numpy()) for x in params))


@functools.lru_cache(maxsize=None)
def _jax_collect(learner, opponent, max_steps):
    params = jbots.panel()[learner]
    return jax.jit(jax.vmap(lambda st, k, pos: jtrain._play_hand_collect(
        params, st, k, pos, OPPONENTS[opponent][0], max_steps, "standard")))


@pytest.mark.parametrize("P,learner,opponent,layers", [
    (2, "callbot", "call", None),
    (3, "potraisebot", "tight", None),
    (6, "fof_call", "hash", (8, 16)),
    (6, "potraisebot", "call", (8, 16)),
])
def test_collection_chain_equals_jax(P, learner, opponent, layers):
    kw = {} if layers is None else dict(max_layers=layers[0],
                                        max_pot_layers=layers[1])
    jcfg, pcfg = jax_cfg(P, "standard", **kw), port_cfg(P, "standard", **kw)
    steps = hand_action_bound(pcfg)
    js = jax_init(jcfg, T, seed=20 + P)
    pos = np.arange(T, dtype=np.int32) % P
    jr, jlp = _jax_collect(learner, opponent, steps)(
        js, jax.random.split(jax.random.key(P), T), jnp.asarray(pos))
    st = tstate.state_from_numpy(jax_numpy(js), seed=3,
                                 device="cpu")
    params = tbots.panel()[learner]
    reward, rec, over = tt._play_hand_collect(
        params, st, tpol.policy_key(3, T, tt.SUB_TRAIN, "cpu"),
        torch.from_numpy(pos), OPPONENTS[opponent][1], steps, "standard")
    np.testing.assert_array_equal(reward.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tt.log_prob_sums(params, rec, T).numpy(),
                               np.asarray(jlp), rtol=0, atol=1e-5)
    assert rec.feats.shape[1] == NUM_FEATURES and len(rec.table) > T // 2
    assert not bool(over.any())
    assert float(np.abs(np.asarray(jr)).sum()) > 0


def _fixed_records(seed, n=300, tables=40):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, NUM_FEATURES)).astype(np.float32)
    free = rng.random(n) < 0.4
    idx = np.where(free, rng.integers(1, 4, n), rng.integers(0, 4, n))
    # one row a (step, table) cell, as a collection makes them
    cell = rng.choice(tables * 24, n, replace=False)
    step, table = cell // tables, cell % tables
    rewards = rng.integers(-100, 101, tables).astype(np.float32) / 10.0
    return feats, free, idx, table, step, rewards


def _jax_loss(params, feats, free, idx, table, rewards, tables):
    logits = jpn.policy_logits(params, feats)
    logits = logits.at[:, 0].add(jnp.where(free, -1e9, 0.0))
    logp = jax.nn.log_softmax(logits)[jnp.arange(len(idx)), idx]
    lps = jnp.zeros(tables, jnp.float32).at[table].add(logp)
    adv = (rewards - jnp.mean(rewards)) / (jnp.std(rewards) + 1e-6)
    return -jnp.mean(adv * lps)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradient_equal_jax(seed):
    feats, free, idx, table, step, rewards = _fixed_records(seed)
    params = tpn.init_params(torch.Generator().manual_seed(seed))
    leaves = [x.clone().requires_grad_(True) for x in params]
    rec = tt.Records(torch.from_numpy(feats), torch.from_numpy(free),
                     torch.from_numpy(idx), torch.from_numpy(table),
                     torch.from_numpy(step))
    loss = tt.reinforce_loss(tpn.MLPParams(*leaves), rec,
                             torch.from_numpy(rewards))
    loss.backward()
    want, grads = jax.value_and_grad(_jax_loss)(
        _jax_params(params), feats, free, idx, table, rewards,
        len(rewards))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for name, leaf, g in zip(tpn.MLPParams._fields, leaves, grads):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)


def test_adam_steps_equal_optax():
    rng = np.random.default_rng(4)
    params = tpn.init_params(torch.Generator().manual_seed(4))
    leaves = [x.clone().requires_grad_(True) for x in params]
    opt = torch.optim.Adam(leaves, lr=3e-3)
    jopt = optax.adam(3e-3)
    jp = _jax_params(params)
    state = jopt.init(jp)
    for _ in range(3):
        grads = [rng.standard_normal(x.shape).astype(np.float32)
                 for x in params]
        for leaf, g in zip(leaves, grads):
            leaf.grad = torch.from_numpy(g)
        opt.step()
        updates, state = jopt.update(
            jpn.MLPParams(*(jnp.asarray(g) for g in grads)), state)
        jp = optax.apply_updates(jp, updates)
        for leaf, want in zip(leaves, jp):
            np.testing.assert_allclose(leaf.detach().numpy(),
                                       np.asarray(want), rtol=1e-6,
                                       atol=1e-7)


def test_untrained_reward_against_random_within_4_sigma_of_jax():
    n, P = 2048, 2
    params = tpn.init_params(torch.Generator().manual_seed(8))
    jparams = _jax_params(params)
    pcfg, jcfg = port_cfg(P, "standard"), jax_cfg(P, "standard")
    pos = np.arange(n, dtype=np.int32) % P
    js = jax_init(jcfg, n, seed=8)
    jr, _ = jax.jit(jax.vmap(lambda st, k, p: jtrain._play_hand_collect(
        jparams, st, k, p, jpol.random_policy, 48, "standard")))(
        js, jax.random.split(jax.random.key(9), n), jnp.asarray(pos))
    st = tstate.init_state(8, pcfg, n, "cpu")
    reward, _, _ = tt._play_hand_collect(
        params, st, tpol.policy_key(8, n, tt.SUB_TRAIN, "cpu"),
        torch.from_numpy(pos), tpol.random_policy, 48, "standard")
    a, b = reward.numpy() / 10.0, np.asarray(jr) / 10.0
    z = (a.mean() - b.mean()) / np.sqrt(a.var(ddof=1) / n
                                        + b.var(ddof=1) / n)
    assert abs(z) < 4, (a.mean(), b.mean(), z)
    assert a.std() > 0.5


def test_fold_seed_is_a_stable_32_bit_derivation():
    seeds = {tt.fold_seed(3, 1000 + i) for i in range(64)}
    assert len(seeds) == 64 and all(0 <= s < 2 ** 32 for s in seeds)
    assert tt.fold_seed(3, 1000) == tt.fold_seed(3, 1000)
    assert tt.fold_seed(3, 1000) != tt.fold_seed(4, 1000)


def test_reinforce_one_step_runs():
    cfg = port_cfg(2, "standard")
    out = tt.train_policy(4, cfg=cfg, opponent=tpol.always_call, tables=64,
                          steps=2, lr=1e-3, max_steps=24, device="cpu")
    assert np.isfinite(out.mean_reward_bb.numpy()).all()
    assert out.mean_reward_bb.shape == (2,)


@pytest.mark.slow
def test_reinforce_improves_vs_calling_station():
    cfg = port_cfg(2, "standard")
    out = tt.train_policy(3, cfg=cfg, opponent=tpol.always_call, tables=512,
                          steps=60, lr=5e-3, device="cpu")
    hist = out.mean_reward_bb.numpy()
    assert np.all(np.isfinite(hist))
    assert hist[-15:].mean() > hist[:15].mean() + 0.05, (
        hist[:15].mean(), hist[-15:].mean())
