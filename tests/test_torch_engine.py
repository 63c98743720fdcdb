"""The port's betting engine (K3/K4 plain versions) against the JAX engine.

Det mode: ``_run_det_plain`` must equal the JAX kernel
``run_perpetual_det(..., interpret=True)`` over the whole packed state,
overflowed tables included, on the injected streams of
``tests/test_pallas_engine.py``.

PRNG mode: the JAX kernel draws from the TPU's PRNG, which has no CPU
lowering, so the JAX side is the kernel body's own composition
(``_policy_prng``, ``_step_nosettle`` x DEFER, ``_sample_cards``,
``_settle_pass``) with ``pltpu`` replaced by a stub whose
``prng_random_bits`` returns injected words in the kernel's draw order;
``_run_prng_plain`` gets the same words.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu.ops import pallas_engine as jpe
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import cuda_engine as ce

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = ce.TABLES_PER_BLOCK


def _streams(seed, P, n_steps, hmax):
    """Raw actions (folds 20%, calls 72%, raises 8%, pre-clamp) and
    per-hand deals, as in tests/test_pallas_engine.py."""
    rng = np.random.default_rng(seed)
    u = rng.random((n_steps, T))
    actions = np.where(u < 0.20, -1,
                       np.where(u < 0.92, 0,
                                rng.integers(1, 21, (n_steps, T))))
    cards = np.argsort(rng.random((T, hmax, 52)), axis=-1)[..., :2 * P + 5]
    return actions.astype(np.int32), cards.astype(np.int32)


@pytest.mark.parametrize("P", [2, 6, 9])
def test_field_layout_and_pack_state_match_jax(P):
    for rules in ("reference", "standard", "tournament"):
        assert ce._field_layout(P, rules) == jpe._field_layout(P, rules)
    rng = np.random.default_rng(P)
    first = np.argsort(rng.random((2 * T, 52)), axis=1)[:, :2 * P + 5]
    want = np.asarray(jpe.pack_state(JaxTableConfig(num_seats=P),
                                     first.astype(np.int32)))
    got = ce.pack_state(TableConfig(num_seats=P), torch.from_numpy(first))
    np.testing.assert_array_equal(ce.state_to_numpy(got), want)
    np.testing.assert_array_equal(
        ce.state_to_numpy(ce.state_from_numpy(want)), want)


@pytest.mark.parametrize("P,seed,n_steps,hmax", [
    (6, 11, 48, 12), (6, 29, 48, 12), (2, 17, 32, 14)])
def test_det_plain_matches_jax_kernel(P, seed, n_steps, hmax):
    actions, cards = _streams(seed, P, n_steps, hmax)
    packed = jpe.pack_state(JaxTableConfig(num_seats=P), cards[:, 0])
    act_in = actions.reshape(n_steps, *ce.TILE)[None]
    cards_in = cards.transpose(1, 2, 0).reshape(hmax, 2 * P + 5,
                                                *ce.TILE)[None]
    want = np.asarray(jpe.run_perpetual_det(
        packed, jnp.asarray(act_in), jnp.asarray(cards_in), P, n_steps,
        5, 10, interpret=True))

    state = ce.state_from_numpy(np.asarray(packed))
    got = ce.run_perpetual_det(state, torch.from_numpy(act_in),
                               torch.from_numpy(cards_in), P, n_steps, 5, 10)
    layout, _ = ce._field_layout(P)
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows], err_msg=name)
    cfg = TableConfig(num_seats=P)
    assert int(ce.unpack_field(got, cfg, "hand_ct").sum()) > 0
    if P == 6:  # the adversarial stream overflows a few tables: compared too
        assert int(ce.unpack_field(got, cfg, "overflow").sum()) > 0


def test_prng_plain_matches_jax_deferred_composition(monkeypatch):
    P, n_steps = 6, 64
    rng = np.random.default_rng(5)
    first = np.argsort(rng.random((T, 52)), axis=1)[:, :2 * P + 5] \
        .astype(np.int32)
    shape = ce.prng_words_shape(T, P, n_steps)
    assert shape == (n_steps // ce.DEFER, 2 * ce.DEFER + 2 * P + 5, T)
    words = rng.integers(0, 1 << 32, shape, dtype=np.int64)

    seq = iter([words[it, w].astype(np.uint32).reshape(ce.TILE)
                for it in range(shape[0]) for w in range(shape[1])])
    monkeypatch.setattr(jpe, "pltpu", types.SimpleNamespace(
        prng_random_bits=lambda s: jnp.asarray(next(seq))))
    packed = jpe.pack_state(JaxTableConfig(num_seats=P), first)
    layout, F = jpe._field_layout(P)
    st = jpe._unpack(packed[0], layout)
    for _ in range(shape[0]):
        for _ in range(ce.DEFER):
            st = jpe._step_nosettle(st, jpe._policy_prng(st, P), P, 5, 10)
        st = jpe._settle_pass(st, jpe._sample_cards(jpe.TILE, 2 * P + 5),
                              P, 5, 10)
    assert next(seq, None) is None  # every word consumed, in order
    want = np.asarray(jpe._pack(st, layout, F))[None]

    state = ce.pack_state(TableConfig(num_seats=P), torch.from_numpy(first))
    got = ce.run_perpetual_prng(0, state, P, n_steps, 5, 10,
                                words=torch.from_numpy(words))
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows], err_msg=name)
    assert int(ce.unpack_field(got, TableConfig(num_seats=P),
                               "hand_ct").sum()) > 0


def test_selfplay_cpu_runs_reference_rules_only():
    cfg = TableConfig(num_seats=6)
    state, hands, ovf = ce.selfplay_perpetual_kernel(3, cfg, T, 64)
    assert hands > 0 and ovf == 0
    sums, h = ce.position_deltas(state, cfg)
    assert h == hands and sums.shape == (6,)
    # the per-position meters sum to the per-seat meters
    seat = sum(int(ce.unpack_field(state, cfg, "seat_delta", k).sum())
               for k in range(6))
    assert seat == int(sums.sum())
    for rules in ("standard", "tournament"):
        bad = TableConfig(num_seats=6, rules=rules)
        with pytest.raises(NotImplementedError):
            ce.selfplay_perpetual_kernel(3, bad, T, 16)
        with pytest.raises(NotImplementedError):
            ce.run_perpetual_prng(0, state, 6, 16, 5, 10, rules=rules)
        with pytest.raises(NotImplementedError):
            ce.run_perpetual_det(state, torch.zeros((1, 1, *ce.TILE)),
                                 torch.zeros((1, 1, 17, *ce.TILE)), 6, 1,
                                 5, 10, rules=rules)
