"""The net on the port's table engine against the JAX package and K5's
plain version.

- ``models/features.state_features`` is bit-equal to
  ``jax.vmap(state_features)`` (run op by op, see ``j_features``) every
  fourth step of injected-stream trajectories (``test_torch_step.
  run_both``) and of the port's random self-play (carried to JAX field by
  field), and equals the packed form
  ``features`` on the same tables (K3's plain version beside
  ``replay_injected`` on one stream).
- ``action_from_index`` equals JAX's for every menu index at every step.
Tolerance 0 throughout: features are compared as float32 bits.
``replay_net_det`` is held in ``test_torch_net_replay.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import bets as jbets
from montecarlo_tpu.engine import state as jstate
from montecarlo_tpu.engine import street as jstreet
from montecarlo_tpu.models import features as jfeat
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu_torch.engine import replay
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine import step as tstep
from montecarlo_tpu_torch.models import features as tfe
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.rollout import policy as tpol
from test_torch_step import (
    _k3_stream,
    jax_cfg,
    k3_cfg,
    port_cfg,
    run_both,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = 64
# Op by op, as the JAX function is written: under jit XLA turns a division
# by a constant into a product with the constant's rounded reciprocal,
# which can differ in the last bit; the kernels and both port forms divide.
j_features = jax.vmap(jfeat.state_features)
j_action = jax.jit(jax.vmap(jpn.action_from_index))


def to_jax(ts):
    """A port state as a batched JAX ``TableState``, its street in the
    port's form; the key is a placeholder, which no function here reads."""
    st = tstate.state_to_numpy(ts)
    fields = {name: getattr(st, name) for name in tstate.TableState._fields}
    kind = jstreet.Street if hasattr(st.bets, "level") else jbets.Layers
    fields["bets"] = kind(*st.bets)
    fields["pots"] = jbets.Layers(*st.pots)
    fields["key"] = np.zeros((ts.n_tables, 2), np.uint32)
    return jstate.TableState(**{k: jnp.asarray(v) for k, v in fields.items()
                                if not isinstance(v, tuple)},
                             bets=fields["bets"], pots=fields["pots"])


def assert_bits_equal(got, want, what):
    got = got.numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape == (got.shape[0], tfe.NUM_FEATURES)
    for i in range(tfe.NUM_FEATURES):
        np.testing.assert_array_equal(got[:, i].view(np.int32),
                                      want[:, i].view(np.int32),
                                      err_msg=f"{what}: feature {i}")


@pytest.mark.parametrize("rules", ["reference", "standard", "tournament"])
@pytest.mark.parametrize("P", [2, 6])
def test_state_features_bit_equal_to_jax_on_trajectories(P, rules):
    kw = dict(starting_stack=40 if rules == "tournament" else 100)
    stages = set()

    def check(i, js, ts):
        if i % 4 == 3:
            assert_bits_equal(tfe.state_features(ts), j_features(js),
                              f"step {i}")
        for idx in range(4):
            np.testing.assert_array_equal(
                tpn.action_from_index(torch.full((T,), idx), ts).numpy(),
                np.asarray(j_action(jnp.full(T, idx), js)))
        stages.update(ts.stage.tolist())

    run_both(P, rules, T, 40, 12, 60 + P, jax_cfg(P, rules, **kw),
             port_cfg(P, rules, **kw), check)
    assert stages == {0, 1, 2, 3}


def test_state_features_bit_equal_to_jax_on_random_self_play():
    """The port's random policy drives the port's engine; every state is
    carried to JAX (``to_jax``) and featurised there."""
    cfg = port_cfg(6, "standard")
    st = tstate.init_state(17, cfg, 256, "cpu")
    key = tpol.policy_key(17, 256, tpol.SUB_PERPETUAL, "cpu")
    raises = torch.zeros(256, dtype=torch.int32)
    for i in range(48):
        if i % 4 == 3:
            assert_bits_equal(tfe.state_features(st),
                              j_features(to_jax(st)), f"step {i}")
        action = tstep.clamp_action(st, tpol.random_policy(
            tpol.at_step(key, i), st, raises))
        nxt = tstep.step_table(st, action, rules="standard")
        raises = torch.where((nxt.stage != st.stage)
                             | (nxt.hand_idx != st.hand_idx), 0,
                             raises + (action > 0).to(torch.int32))
        st = nxt
    assert int(st.hand_idx.sum()) > 256


@pytest.mark.parametrize("rules", ["reference", "standard"])
def test_state_features_equal_the_packed_form(rules):
    """K3's plain version and the engine on one injected stream: on every
    table within capacity the packed ``features`` of K3's output and
    ``state_features`` of the replay are the same bits."""
    P, n = 6, ce.TABLES_PER_BLOCK
    cfg = k3_cfg(P, rules)
    for n_steps in (5, 23):
        actions, cards = _k3_stream(70 + n_steps, P, n, n_steps, 12)
        first = torch.from_numpy(cards[:, 0])
        out = ce.run_perpetual_det(
            ce.pack_state(cfg, first),
            torch.from_numpy(actions.reshape(n_steps, *ce.TILE)[None]),
            torch.from_numpy(cards.transpose(1, 2, 0).reshape(
                12, 2 * P + 5, *ce.TILE)[None]), P, n_steps, 5, 10,
            rules=rules)
        st0 = tstate.redeal(tstate.init_state(0, cfg, n, "cpu"),
                            replay.decks_from_deals(first))
        rep = replay.replay_injected(cfg, st0, torch.from_numpy(actions),
                                     torch.from_numpy(cards))
        clean = ~replay.against_k3(out, cfg, rep).k3_overflow
        layout, _ = ce._field_layout(P, rules)
        packed = ce._unpack(ce._to_rows(out), layout)
        head, _, _ = ce._head_info(packed, P)
        want = tfe.features(packed, head, P, 10).T
        got = tfe.state_features(rep.state)
        assert float(clean.float().mean()) > 0.9
        assert_bits_equal(got[clean], want[clean].numpy(), f"{n_steps}")


def test_save_params_round_trip_and_jax_loads_it(tmp_path):
    """``save_params`` writes the JAX artifact layout: the port and the
    JAX ``load_params`` read back the same leaves."""
    params = tpn.load_params("data/policy_6max_es3.npz")
    path = tmp_path / "net.npz"
    tpn.save_params(path, params)
    for got, theirs, want in zip(tpn.load_params(path),
                                 jpn.load_params(str(path)), params):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(np.asarray(theirs), want.numpy())
