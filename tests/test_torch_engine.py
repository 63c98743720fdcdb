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
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_net as cn

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
    """Every rule set's layout and first state, with full stacks and with
    stacks short enough that a blind goes all in."""
    rng = np.random.default_rng(P)
    first = np.argsort(rng.random((2 * T, 52)), axis=1)[:, :2 * P + 5]
    for rules in ("reference", "standard", "tournament"):
        assert ce._field_layout(P, rules) == jpe._field_layout(P, rules)
        for stack in (100, 8):
            want = np.asarray(jpe.pack_state(JaxTableConfig(
                num_seats=P, rules=rules, starting_stack=stack),
                first.astype(np.int32)))
            got = ce.pack_state(TableConfig(num_seats=P, rules=rules,
                                            starting_stack=stack),
                                torch.from_numpy(first))
            np.testing.assert_array_equal(ce.state_to_numpy(got), want,
                                          err_msg=f"{rules} {stack}")
    np.testing.assert_array_equal(
        ce.state_to_numpy(ce.state_from_numpy(want, "cpu")), want)


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

    state = ce.state_from_numpy(np.asarray(packed), "cpu")
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


@pytest.mark.parametrize("seed", [11, 29])
def test_det_plain_matches_jax_kernel_standard_rules(seed):
    """Standard rules (stack-capped payments, showdown-live all-ins,
    contributor pots, chained street transitions, capped blinds): the
    cases of tests/test_pallas_engine.py, over the whole state."""
    P, n_steps, hmax = 6, 48, 12
    actions, cards = _streams(seed, P, n_steps, hmax)
    jcfg = JaxTableConfig(num_seats=P, rules="standard")
    packed = jpe.pack_state(jcfg, cards[:, 0])
    act_in = actions.reshape(n_steps, *ce.TILE)[None]
    cards_in = cards.transpose(1, 2, 0).reshape(hmax, 2 * P + 5,
                                                *ce.TILE)[None]
    want = np.asarray(jpe.run_perpetual_det(
        packed, jnp.asarray(act_in), jnp.asarray(cards_in), P, n_steps,
        5, 10, rules="standard", interpret=True))

    cfg = TableConfig(num_seats=P, rules="standard")
    state = ce.pack_state(cfg, torch.from_numpy(cards[:, 0]))
    np.testing.assert_array_equal(ce.state_to_numpy(state),
                                  np.asarray(packed))
    got = ce.run_perpetual_det(state, torch.from_numpy(act_in),
                               torch.from_numpy(cards_in), P, n_steps, 5, 10,
                               rules="standard")
    layout, _ = ce._field_layout(P, "standard")
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows], err_msg=name)
    clean = ce.unpack_field(got, cfg, "overflow") == 0
    assert clean.float().mean() > 0.9
    assert int(ce.unpack_field(got, cfg, "hand_ct").sum()) > 0
    assert int(ce.unpack_field(got, cfg, "all_in").ne(0).sum()) > 0
    # Chips conserve on the tables within capacity, save where the stream
    # folds with nothing owed: when the last players who can act fold
    # free to a shorter all-in, the layers above the all-in have no
    # eligible winner and their chips vanish. The JAX engine does the
    # same (the state above equals it); the random policy and the net
    # never fold free.
    chips = sum(ce.unpack_field(got, cfg, "delta_sum", k) for k in range(P))
    assert float((chips[clean] == 0).float().mean()) > 0.99


def _jax_deferred(monkeypatch, first, words, P, rules, starting_stack=100,
                  **settle):
    """The JAX kernel body's deferred-settle composition on injected
    words: ``_policy_prng`` + ``_step_nosettle`` x DEFER, then
    ``_sample_cards`` + ``_settle_pass``."""
    seq = iter([words[it, w].astype(np.uint32).reshape(ce.TILE)
                for it in range(words.shape[0])
                for w in range(words.shape[1])])
    monkeypatch.setattr(jpe, "pltpu", types.SimpleNamespace(
        prng_random_bits=lambda s: jnp.asarray(next(seq))))
    packed = jpe.pack_state(JaxTableConfig(
        num_seats=P, rules=rules, starting_stack=starting_stack), first)
    layout, F = jpe._field_layout(P, rules)
    st = jpe._unpack(packed[0], layout)
    for _ in range(words.shape[0]):
        for _ in range(ce.DEFER):
            st = jpe._step_nosettle(st, jpe._policy_prng(st, P), P, 5, 10,
                                    rules)
        st = jpe._settle_pass(st, jpe._sample_cards(jpe.TILE, 2 * P + 5),
                              P, 5, 10, rules, **settle)
    assert next(seq, None) is None  # every word consumed, in order
    return np.asarray(jpe._pack(st, layout, F))[None]


@pytest.mark.parametrize("reset_stacks", [False, True])
def test_prng_plain_matches_jax_deferred_composition_standard_rules(
        monkeypatch, reset_stacks):
    P, n_steps = 6, 64
    rng = np.random.default_rng(7 + reset_stacks)
    first = np.argsort(rng.random((T, 52)), axis=1)[:, :2 * P + 5] \
        .astype(np.int32)
    words = rng.integers(0, 1 << 32, ce.prng_words_shape(T, P, n_steps),
                         dtype=np.int64)
    settle = {"ss": 100, "reset_stacks": reset_stacks}
    want = _jax_deferred(monkeypatch, first, words, P, "standard", **settle)

    cfg = TableConfig(num_seats=P, rules="standard")
    state = ce.pack_state(cfg, torch.from_numpy(first))
    got = ce._run_prng_plain(state, torch.from_numpy(words), P, n_steps, 5,
                             10, "standard", **settle)
    if not reset_stacks:  # the wrapper's CPU path is the same function
        assert torch.equal(got, ce.run_perpetual_prng(
            0, state, P, n_steps, 5, 10, rules="standard",
            words=torch.from_numpy(words)))
    layout, _ = ce._field_layout(P, "standard")
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows], err_msg=name)
    assert int(ce.unpack_field(got, cfg, "hand_ct").sum()) > 0
    assert int(ce.unpack_field(got, cfg, "overflow").sum()) == 0
    chips = sum(ce.unpack_field(got, cfg, "delta_sum", k) for k in range(P))
    assert bool((chips == 0).all())


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


def test_selfplay_cpu_runs_every_rule_set():
    cfg = TableConfig(num_seats=6)
    state, hands, ovf = ce.selfplay_perpetual_kernel(3, cfg, T, 64,
                                                      device="cpu")
    assert hands > 0 and ovf == 0
    sums, h = ce.position_deltas(state, cfg)
    assert h == hands and sums.shape == (6,)
    # the per-position meters sum to the per-seat meters
    seat = sum(int(ce.unpack_field(state, cfg, "seat_delta", k).sum())
               for k in range(6))
    assert seat == int(sums.sum())
    std = TableConfig(num_seats=6, rules="standard")
    st_std, hands_std, ovf_std = ce.selfplay_perpetual_kernel(3, std, T, 64,
                                                          device="cpu")
    assert hands_std > 0 and ovf_std == 0
    assert bool((sum(ce.unpack_field(st_std, std, "delta_sum", k)
                     for k in range(6)) == 0).all())
    # tournament rules: seats bust, the survivors' chips conserve
    tour = TableConfig(num_seats=6, rules="tournament", starting_stack=20)
    st_t, hands_t, ovf_t = ce.selfplay_perpetual_kernel(3, tour, T, 64,
                                                        device="cpu")
    assert hands_t > 0 and ovf_t == 0
    assert bool((sum(ce.unpack_field(st_t, tour, "delta_sum", k)
                     for k in range(6)) == 0).all())
    assert int((ce.unpack_field(st_t, tour, "bust_at", 0) >= 0).sum()) > 0
    assert ce.position_deltas(st_t, tour)[1] == hands_t
    # the net kernels take reference and standard rules only, as the JAX
    # net entry points do
    es3 = cn.net_weights(tpn.load_params("data/policy_6max_es3.npz"), "cpu")
    with pytest.raises(ValueError, match="net kernels"):
        cn.run_net_eval(0, st_t, es3, 6, 16, 5, 10, 20, "tournament", 1)
    with pytest.raises(ValueError, match="net kernels"):
        cn.run_net_det(st_t, torch.zeros((1, 1, 17, *ce.TILE)), es3, 6, 1,
                       5, 10, "tournament")
    with pytest.raises(ValueError, match="net kernels"):
        cn.selfplay_net_eval_kernel(0, tour, tpn.load_params(
            "data/policy_6max_es3.npz"), 1, T, 16, device="cpu")


@pytest.mark.parametrize("bad,match", [
    (dict(n_tables=1000), "not a multiple"),
    (dict(small_blind=0), "blinds must be positive"),
    (dict(num_seats=11), "num_seats"),
    (dict(rules="cash"), "rules"),
    (dict(first_table=-1024), "outside"),
    (dict(first_table=(1 << 32) - 1023), "outside")])
def test_first_state_checks_its_inputs(bad, match):
    """``first_state`` refuses what ``pack_state`` refuses, and tables
    outside the 2^32 streams of ``first_deal``."""
    args = dict(num_seats=6, rules="standard", small_blind=5,
                n_tables=ce.TABLES_PER_BLOCK, first_table=0)
    args.update(bad)
    cfg = TableConfig(num_seats=args["num_seats"], rules=args["rules"],
                      small_blind=args["small_blind"])
    with pytest.raises(ValueError, match=match):
        ce.first_state(1, cfg, args["n_tables"], "cpu", args["first_table"])
