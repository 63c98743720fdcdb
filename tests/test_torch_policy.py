"""The port's betting policies (``montecarlo_tpu_torch/rollout/policy.py``)
against the JAX module.

States are reached by play on an injected stream (``test_torch_step.
run_both``: the JAX and the port engine equal at every step) and the
policies run on both. Where a policy draws nothing its action equals
JAX's: the calling station, the tight policy's owe/no-owe branch (fold
chance 0 or 1), the random policy's fold and raise branches and its raise
cap (fold chance 1; raise chance 1), and their combinations by position
and by seat. The random draws are Philox words in the port and threefry
in JAX: their frequencies are held to their probabilities within 4 sigma,
and a table's draws do not depend on how many tables are played.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.rollout import policy as jpol
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine.step import head_info
from montecarlo_tpu_torch.engine.street import bets_needed
from montecarlo_tpu_torch.ops.philox import stream_words
from montecarlo_tpu_torch.rollout import policy as tpol
from test_torch_step import jax_cfg, port_cfg, run_both

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = 64


@functools.lru_cache(maxsize=None)
def played(P, rules):
    """(JAX state, port state, street raises) pairs along a trajectory."""
    out = []

    def keep(i, js, ts):
        if i % 5 == 4:
            raises = np.asarray(ts.street_raises)
            out.append((js, ts, raises))

    run_both(P, rules, T, 40, 12, 50 + P, jax_cfg(P, rules),
             port_cfg(P, rules), keep)
    return out


def jax_actions(policy, js, raises):
    keys = jax.random.split(jax.random.key(1), T)
    return np.asarray(jax.vmap(policy)(keys, js, jnp.asarray(raises)))


def port_actions(policy, ts, raises, seed=1):
    key = tpol.policy_key(seed, T, tpol.SUB_HANDS, "cpu")
    return policy(key, ts, torch.from_numpy(raises)).numpy()


DETERMINISTIC = {
    "always_call": (jpol.always_call, tpol.always_call),
    "tight_folds": (functools.partial(jpol.tight_policy, fold_prob=1.0),
                    functools.partial(tpol.tight_policy, fold_prob=1.0)),
    "tight_calls": (functools.partial(jpol.tight_policy, fold_prob=0.0),
                    functools.partial(tpol.tight_policy, fold_prob=0.0)),
    "random_folds": (functools.partial(jpol.random_policy, fold_prob=1.0),
                     functools.partial(tpol.random_policy, fold_prob=1.0)),
    "random_raise_cap": (
        functools.partial(jpol.random_policy, fold_prob=0.0, raise_prob=1.0,
                          max_raise=1),
        functools.partial(tpol.random_policy, fold_prob=0.0, raise_prob=1.0,
                          max_raise=1)),
}


@pytest.mark.parametrize("rules", ["reference", "standard"])
@pytest.mark.parametrize("P", [2, 6])
@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_branches_equal_jax(name, P, rules):
    jp, tp = DETERMINISTIC[name]
    seen = set()
    for js, ts, raises in played(P, rules):
        want = jax_actions(jp, js, raises)
        np.testing.assert_array_equal(port_actions(tp, ts, raises), want)
        seen |= set(want.tolist())
    expect = {"always_call": {0}, "tight_folds": {-1, 0},
              "tight_calls": {0}, "random_folds": {-1, 0},
              "random_raise_cap": {0, 1}}[name]
    assert seen == expect, seen  # both branches met


@pytest.mark.parametrize("combine", ["seat_policies", "pinned_seat_policies"])
def test_combinations_equal_jax(combine):
    """Per-position and per-seat combinations of deterministic policies:
    each table's head plays its own policy."""
    names = ["always_call", "tight_folds", "random_raise_cap",
             "random_folds", "tight_calls", "always_call"]
    jc = getattr(jpol, combine)([DETERMINISTIC[n][0] for n in names])
    tc = getattr(tpol, combine)([DETERMINISTIC[n][1] for n in names])
    for js, ts, raises in played(6, "standard"):
        np.testing.assert_array_equal(port_actions(tc, ts, raises),
                                      jax_actions(jc, js, raises))


def test_random_policy_frequencies_within_4_sigma():
    """Fold, call and raise shares where the head owes, the check share
    where it does not, and each raise amount, against 0.15 / 0.55 / 0.30
    and 0.30 / 20: |z| < 4 each, over 64 steps of 4,096 first states."""
    n_tables, n_steps = 4096, 64
    cfg = port_cfg(6, "standard")
    st = tstate.init_state(3, cfg, n_tables, "cpu")
    # the big blind's option: a state where the head owes nothing
    free = st._replace(cursor=torch.ones_like(st.cursor))
    raises = torch.zeros(n_tables, dtype=torch.int32)
    key = tpol.policy_key(3, n_tables, tpol.SUB_HANDS, "cpu")
    owed = np.concatenate([tpol.random_policy(tpol.at_step(key, i), st,
                                              raises).numpy()
                           for i in range(n_steps)])
    checks = np.concatenate([tpol.random_policy(tpol.at_step(key, i), free,
                                                raises).numpy()
                             for i in range(n_steps)])
    assert bool((bets_needed(st.bets, head_info(st)[0]) > 0).all())
    assert not bool(bets_needed(free.bets, head_info(free)[0]).any())

    def z(hits, p):
        n = hits.size
        return (hits.sum() - n * p) / np.sqrt(n * p * (1 - p))

    zs = [z(owed == -1, 0.15), z(owed == 0, 0.55), z(owed > 0, 0.30),
          z(checks == 0, 0.70), z(checks > 0, 0.30)]
    zs += [z(owed == a, 0.30 / 20) for a in range(1, 21)]
    assert max(abs(x) for x in zs) < 4, zs
    assert not (checks < 0).any() and owed.max() == 20 and owed.min() == -1


def test_random_policy_capped_raises_are_calls():
    cfg = port_cfg(6, "reference")
    st = tstate.init_state(4, cfg, 2048, "cpu")
    key = tpol.policy_key(4, 2048, tpol.SUB_HANDS, "cpu")
    capped = tpol.random_policy(key, st, torch.full((2048,), 2,
                                                    dtype=torch.int32))
    free = tpol.random_policy(key, st, torch.zeros(2048, dtype=torch.int32))
    assert not bool((capped > 0).any()) and bool((free > 0).any())
    # the cap turns exactly the raises into calls
    assert torch.equal(capped, torch.where(free > 0, 0, free))


def test_draws_do_not_depend_on_the_table_count():
    """Table t draws from its own stream: the first tables' actions at T
    tables equal those at 2T, and policy j of a combination draws from
    its own sub-stream."""
    cfg = port_cfg(6, "standard")
    big = tstate.init_state(6, cfg, 2 * T, "cpu")
    small = tstate.init_state(6, cfg, T, "cpu")
    raises = torch.zeros(2 * T, dtype=torch.int32)
    for i in range(4):
        a = tpol.random_policy(tpol.at_step(tpol.policy_key(
            6, 2 * T, tpol.SUB_PERPETUAL, "cpu"), i), big, raises)
        b = tpol.random_policy(tpol.at_step(tpol.policy_key(
            6, T, tpol.SUB_PERPETUAL, "cpu"), i), small, raises[:T])
        assert torch.equal(a[:T], b)
    key = tpol.policy_key(6, T, tpol.SUB_HANDS, "cpu")
    w0 = tpol.fold_in(key, 0).words(2)
    w1 = tpol.fold_in(key, 1).words(2)
    assert not torch.equal(w0, w1)
    t = torch.arange(T, dtype=torch.int64)
    assert torch.equal(w1, stream_words(6, t, 0, tpol.SUB_HANDS + 2, 0, 2))
    taken = {0, 1, 2, 65536, 65537, 65538, 65539, 65540}
    for sub in (tpol.SUB_HANDS, tpol.SUB_PERPETUAL, tpol.SUB_TOURNAMENT):
        assert sub > max(taken) and sub < 2 ** 32
