"""``engine/replay.replay_net_det``, the net pipeline on the port's table
engine, against K5's plain version and the JAX net pipeline.

- Rule bots by argmax: ``replay_net_det`` equals K5's plain version
  (``ops/cuda_net.run_net_det`` on CPU tensors) at one block, single net
  and banks, through ``against_k5``: every compared field on every table
  within capacity, the overflow sets equal;
- it equals the JAX pipeline ``tests/test_pallas_engine.py:
  xla_net_det_reference`` on the same decks, every field of the state.
Tolerance 0: every compared output is an integer.
"""

import functools

import numpy as np
import pytest
import torch

from montecarlo_tpu.models import bots as jbots
from montecarlo_tpu_torch.engine import replay
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.models import bots as tbots
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_net as cn
from test_pallas_engine import xla_net_det_reference
from test_torch_step import (
    assert_states_equal,
    jax_cfg,
    jax_numpy,
    k3_cfg,
    port_cfg,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = 64


def stash_and_decks(seed, n_tables, P, hmax):
    """K5's deal stash and the same deals as engine decks [T, hmax, 52]."""
    stash = cn.deal_stash(seed, n_tables, P, hmax, "cpu")
    rows = ce._stash_rows(stash).permute(2, 0, 1)  # [T, hmax, 2P+5]
    decks = replay.decks_from_deals(rows.reshape(-1, 2 * P + 5))
    return stash, decks.reshape(n_tables, hmax, 52)


@pytest.mark.parametrize("banked", [False, True])
def test_replay_net_det_equals_k5_plain(banked):
    """K5 (single net: fof_raise at every seat; banks: jam_tight at seat 0,
    fof_call elsewhere) on its deal stash against ``replay_net_det`` from
    the same first state: every compared field on every table within
    capacity, the overflow sets equal."""
    P, n, n_steps, hmax = 6, ce.TABLES_PER_BLOCK, 24, 12
    cfg = k3_cfg(P, "standard")
    panel = tbots.panel()
    stash, decks = stash_and_decks(5, n, P, hmax)
    if banked:
        banks, stb = [panel["jam_tight"], panel["fof_call"]], \
            (0,) + (1,) * (P - 1)
        weights = cn.bank_weights(banks, "cpu")
    else:
        banks, stb = [panel["fof_raise"]], None
        weights = cn.net_weights(banks[0], "cpu")
    packed = ce.pack_state(cfg, ce._stash_rows(stash)[0].T)
    out = cn.run_net_det(packed, stash, weights, P, n_steps, 5, 10,
                         "standard", stb)
    st0 = tstate.redeal(tstate.init_state(0, cfg, n, "cpu"), decks[:, 0])
    assert replay.against_pack_state(packed, cfg, st0) == []
    rep = replay.replay_net_det(cfg, st0, banks, stb, decks, n_steps)
    agree = replay.against_k5(out, cfg, rep)
    assert torch.equal(agree.k3_overflow, rep.overflow), "overflow sets"
    for name, bad in agree.mismatch.items():
        assert not bool(bad.any()), f"{name}: table {int(bad.nonzero()[0])}"
    assert int(rep.hand_ct.sum()) > n
    assert int(rep.hand_ct.max()) < hmax - 1  # the stash covers every hand


def test_against_k5_refuses_tournament_rules():
    cfg = k3_cfg(6, "tournament")
    with pytest.raises(ValueError):
        replay.against_k5(None, cfg, None)


@functools.lru_cache(maxsize=None)
def _jax_reference(n_steps, hmax):
    P = 6
    rng = np.random.default_rng(44)
    decks = np.argsort(rng.random((T, hmax, 52)), axis=-1).astype(np.int32)
    bots = jbots.panel()
    by_seat = [bots["jam_tight"]] + [bots["fof_call"]] * (P - 1)
    ref, done = xla_net_det_reference(jax_cfg(P, "standard"), by_seat, decks,
                                      n_steps, hmax)
    return decks, ref, done


def test_replay_net_det_equals_the_jax_net_pipeline():
    P, n_steps, hmax = 6, 32, 16
    decks, ref, done = _jax_reference(n_steps, hmax)
    panel = tbots.panel()
    cfg = port_cfg(P, "standard")
    st0 = tstate.redeal(tstate.init_state(0, cfg, T, "cpu"),
                        torch.from_numpy(decks[:, 0]))
    rep = replay.replay_net_det(cfg, st0, [panel["jam_tight"],
                                           panel["fof_call"]],
                                (0,) + (1,) * (P - 1),
                                torch.from_numpy(decks), n_steps)
    assert_states_equal(jax_numpy(ref), rep.state, "net pipeline")
    np.testing.assert_array_equal(rep.hand_ct.numpy(), np.asarray(done))
    assert int(rep.hand_ct.sum()) > T
