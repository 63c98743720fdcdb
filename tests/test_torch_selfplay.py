"""The port's self-play (``montecarlo_tpu_torch/rollout/selfplay.py``)
against the JAX module, bit for bit, under deterministic policies.

Policies that draw nothing give the same actions in both frameworks: the
calling station, a policy that hashes the state (written identically for
JAX and for the port below, at most two raises a street) and rule bots
played by argmax (``net_policy(..., greedy=True)``; their logit margins
are far above float32 rounding, so the argmax agrees with JAX's matmul
logits). The port deals Philox decks (``engine/state.shuffled_decks``);
the JAX side gets the same decks injected with ``redeal``. Then
``play_one_hand`` equals JAX's field by field, and ``play_hands`` and
``play_tournament`` equal a JAX chain of ``play_one_hand`` + ``next_hand``
+ ``redeal`` driven here, deltas and bust records included: tolerance 0,
every output an integer. Tournament chains are in
``test_torch_selfplay_chains.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import step as jstep
from montecarlo_tpu.engine.street import bets_needed as jbets_needed
from montecarlo_tpu.models import bots as jbots
from montecarlo_tpu.models import features as jfeat
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.rollout import selfplay as jsp
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine import step as tstep
from montecarlo_tpu_torch.engine.street import _pick
from montecarlo_tpu_torch.models import bots as tbots
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.rollout import policy as tpol
from montecarlo_tpu_torch.rollout import selfplay as tsp
from test_torch_step import (
    assert_states_equal,
    jax_cfg,
    jax_fns,
    jax_init,
    jax_numpy,
    jax_select,
    port_cfg,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

I32 = torch.int32
T = 48


def jax_hash(key, st, street_raises):
    """A deterministic policy of the state (one JAX table)."""
    del key
    P = st.stacks.shape[0]
    pos, _, _ = jstep.head_info(st)
    h0 = jnp.sum(jnp.where(jnp.arange(P) == pos, st.hole[:, 0], 0))
    h = (h0 * 7 + st.time * 13 + st.stage * 5 + jnp.sum(st.stacks)
         + pos * 3) % 10
    a = jnp.where(h < 2, -1, jnp.where(h < 7, 0, 1 + h0 % 20))
    return jnp.where((a > 0) & (street_raises >= 2), 0, a).astype(jnp.int32)


def port_hash(key, st, street_raises):
    """``jax_hash`` on the port's tables."""
    del key
    pos, _, _ = tstep.head_info(st)
    h0 = _pick(st.hole[:, :, 0], pos)
    h = torch.remainder(h0 * 7 + st.time * 13 + st.stage * 5
                        + st.stacks.sum(1, dtype=I32) + pos * 3, 10)
    a = torch.where(h < 2, -1, torch.where(h < 7, 0, 1 + h0 % 20))
    return torch.where((a > 0) & (street_raises >= 2), 0, a).to(I32)


def jax_bot(params):
    """A net played by argmax on the JAX engine (the pipeline of
    ``tests/test_pallas_engine.py:xla_net_det_reference``)."""
    def policy(key, st, street_raises):
        del key, street_raises
        logits = jpn.policy_logits(params, jfeat.state_features(st))
        pos, _, _ = jstep.head_info(st)
        free = jbets_needed(st.bets, pos) == 0
        logits = logits.at[0].add(jnp.where(free, -1e9, 0.0))
        return jpn.action_from_index(jnp.argmax(logits), st)
    return policy


def policies(name):
    """(JAX policy, port policy) by name."""
    if name == "hash":
        return jax_hash, port_hash
    if name == "call":
        return ((lambda k, s, r: jnp.int32(0)), tpol.always_call)
    return (jax_bot(jbots.panel()[name]),
            tpn.net_policy(tbots.panel()[name], greedy=True))


@functools.lru_cache(maxsize=None)
def jax_hand(P, rules, name, steps):
    """JAX ``play_one_hand`` over a leading table axis, jitted once."""
    return jax.jit(jax.vmap(functools.partial(
        jsp.play_one_hand, policy=policies(name)[0], max_steps=steps,
        rules=rules)))


def port_decks(seed, T, hand_idx):
    """The decks the port deals for hand ``hand_idx`` (int [T])."""
    return tstate.shuffled_decks(tstate.table_keys(seed, T, "cpu"),
                                 torch.tensor(np.array(hand_idx)))


def jax_first(jcfg, seed, T, rules):
    """JAX's first state with the port's first decks injected."""
    _, _, redeal, _, _ = jax_fns(rules)
    return redeal(jax_init(jcfg, T), jnp.asarray(
        port_decks(seed, T, np.zeros(T, np.int32)).numpy()))


def jax_next(js, seed, rules):
    """JAX ``next_hand``, then the port's decks on every table that was
    dealt (a frozen table keeps its cards)."""
    _, _, redeal, next_hand, _ = jax_fns(rules)
    js = next_hand(js)
    dealt = ~np.asarray(js.hand_over)
    deck = jnp.asarray(port_decks(seed, len(dealt), js.hand_idx).numpy())
    return jax_select(dealt, redeal(js, deck), js)


def jax_keys(T):
    return jax.random.split(jax.random.key(0), T)


@pytest.mark.parametrize("rules", ["reference", "standard", "tournament"])
@pytest.mark.parametrize("P", [2, 3, 6])
def test_play_one_hand_equals_jax(P, rules):
    seed = 100 + P
    kw = dict(starting_stack=40 if rules == "tournament" else 100)
    jcfg, pcfg = jax_cfg(P, rules, **kw), port_cfg(P, rules, **kw)
    steps = tsp.hand_action_bound(pcfg)
    assert steps == jsp.hand_action_bound(jcfg)
    js = jax_first(jcfg, seed, T, rules)
    ts = tstate.init_state(seed, pcfg, T, "cpu")
    assert_states_equal(jax_numpy(js), ts, "first")
    js = jax_hand(P, rules, "hash", steps)(js, jax_keys(T))
    key = tpol.policy_key(seed, T, tpol.SUB_HANDS, "cpu")
    ts = tsp.play_one_hand(ts, key, port_hash, steps, rules)
    assert_states_equal(jax_numpy(js), ts, "after the hand")
    assert bool(ts.hand_over.all())
    assert int(ts.time.max()) > 2 * P  # hands of several actions


@pytest.mark.parametrize("P,rules,name", [
    (2, "reference", "call"), (6, "standard", "call"),
    (6, "standard", "jam_tight"), (3, "reference", "fof_raise"),
    (6, "tournament", "fof_call")])
def test_play_one_hand_scripted_and_bot_policies_equal_jax(P, rules, name):
    seed = 7 * P
    jcfg, pcfg = jax_cfg(P, rules), port_cfg(P, rules)
    steps = tsp.hand_action_bound(pcfg)
    js = jax_hand(P, rules, name, steps)(jax_first(jcfg, seed, T, rules),
                                         jax_keys(T))
    ts = tsp.play_one_hand(tstate.init_state(seed, pcfg, T, "cpu"),
                           tpol.policy_key(seed, T, tpol.SUB_HANDS, "cpu"),
                           policies(name)[1], steps, rules)
    assert_states_equal(jax_numpy(js), ts, name)
    assert bool(ts.hand_over.all())


@pytest.mark.parametrize("rules", ["reference", "standard"])
@pytest.mark.parametrize("P", [2, 3, 6])
def test_play_hands_chain_equals_jax(P, rules):
    """``play_hands`` over four hands equals the JAX chain, deltas by
    position included."""
    seed, hands = 200 + P, 4
    jcfg, pcfg = jax_cfg(P, rules), port_cfg(P, rules)
    steps = tsp.hand_action_bound(pcfg)
    final, deltas = tsp.play_hands(seed, pcfg, T, num_hands=hands,
                                   policy=port_hash, collect_deltas=True,
                                   device="cpu")
    hand = jax_hand(P, rules, "hash", steps)
    js = jax_first(jcfg, seed, T, rules)
    want = []
    for i in range(hands):
        if i:
            pre = np.roll(np.asarray(js.stacks), -1, axis=1)
            js = jax_next(js, seed, rules)
        else:
            pre = np.full((T, P), pcfg.starting_stack)
        js = hand(js, jax_keys(T))
        want.append(np.asarray(js.stacks) - pre)
    assert_states_equal(jax_numpy(js), final, "final")
    np.testing.assert_array_equal(deltas.numpy(), np.stack(want, axis=1))
    assert deltas.shape == (T, hands, P) and bool(deltas.any())
