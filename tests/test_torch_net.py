"""The port's policy-net path (features, MLP, K5/K6 plain versions) against
the JAX package.

- Features: bit-equal to ``pallas_engine._features`` on states reached by
  play (JAX ``run_perpetual_det``, standard rules).
- Logits: the es3 artifact's logits within 2e-6 of the largest logit of
  JAX ``policy_logits`` and of a float64 evaluation: the port sums in the
  kernels' fixed order, XLA's matmul in its own, so they agree within
  float32 rounding.
- K5: the plain version equals JAX ``run_net_det(interpret=True)``
  field for field, every seat playing one rule bot of ``bots.panel()``
  (logit margins far above float32 rounding, so argmax picks agree).
- K6: the plain version on injected words equals the JAX kernel body's
  composition (``_policy_prng`` + ``_net_action`` + ``_step_nosettle``
  x DEFER, ``_sample_cards`` + ``_settle_pass``) with ``pltpu`` replaced
  by a stub that hands out the same words in the kernel's draw order.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu.models import bots as jbots
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.ops import pallas_engine as jpe
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import features as tfe
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_net as cn
from test_torch_engine import _streams

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = ce.TABLES_PER_BLOCK
P = 6
ES3 = "data/policy_6max_es3.npz"


def _played_state(seed, n_steps, rules="standard"):
    """A standard-rules state after ``n_steps`` injected steps (JAX)."""
    actions, cards = _streams(seed, P, n_steps, 12)
    packed = jpe.pack_state(JaxTableConfig(num_seats=P, rules=rules),
                            cards[:, 0])
    return np.asarray(jpe.run_perpetual_det(
        packed, jnp.asarray(actions.reshape(n_steps, *ce.TILE)[None]),
        jnp.asarray(cards.transpose(1, 2, 0).reshape(12, 2 * P + 5,
                                                     *ce.TILE)[None]),
        P, n_steps, 5, 10, rules=rules, interpret=True))


def _jax_weights(params):
    """Kernel weight leaves as ``pallas_engine.selfplay_net_eval_kernel``
    builds them."""
    return (jnp.asarray(params.w1.T), jnp.asarray(params.b1).reshape(-1, 1),
            jnp.asarray(params.w2.T), jnp.asarray(params.b2).reshape(-1, 1),
            jnp.asarray(params.w3.T), jnp.asarray(params.b3).reshape(-1, 1))


def _port_params(jparams):
    return tpn.params_from_numpy([np.asarray(x) for x in jparams])


@pytest.fixture(scope="module")
def played():
    """Unpacked JAX and port views of states at several horizons."""
    out = []
    for seed, n in ((31, 24), (5, 9), (8, 40)):
        block = _played_state(seed, n)
        layout, _ = jpe._field_layout(P, "standard")
        jst = jpe._unpack(jnp.asarray(block[0]), layout)
        tst = ce._unpack(ce._to_rows(ce.state_from_numpy(block, "cpu")),
                         layout)
        out.append((jst, tst))
    return out


def test_features_bit_equal_to_jax_kernel_features(played):
    stages = set()
    for jst, tst in played:
        head, _, _ = jpe._head_info(jst, P)
        want = np.stack([np.asarray(f).reshape(-1)
                         for f in jpe._features(jst, head, P, 10)])
        thead, _, _ = ce._head_info(tst, P)
        got = tfe.features(tst, thead, P, 10).numpy()
        assert got.shape == (tfe.NUM_FEATURES, T) == want.shape
        for i in range(tfe.NUM_FEATURES):  # bit for bit, feature by feature
            np.testing.assert_array_equal(
                got[i].view(np.int32), want[i].astype(np.float32)
                .view(np.int32), err_msg=f"feature {i}")
        stages |= set(tst["stage"].tolist())
    assert stages == {0, 1, 2, 3}


def test_load_params_zero_pads_like_jax():
    want = jpn.load_params(ES3)
    got = tpn.load_params(ES3)
    assert tuple(got.w1.shape) == (tfe.NUM_FEATURES, tpn.HIDDEN)
    for name, a, b in zip(tpn.MLPParams._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    with np.load(ES3) as raw:
        n = raw["p_0"].shape[0]
        assert n == 20
        np.testing.assert_array_equal(got.w1[:n].numpy(), raw["p_0"])
    assert not got.w1[n:].any()


def _logits_f64(params, feats):
    w = [np.asarray(x, np.float64) for x in params]
    h = np.maximum(feats @ w[0] + w[1], 0)
    h = np.maximum(h @ w[2] + w[3], 0)
    return h @ w[4] + w[5]


def test_es3_logits_match_jax(played):
    """Two float32 summation orders of the same MLP: each is held to a
    float64 evaluation, and the two to each other, within 2e-6 of the
    largest logit (16 float32 ulps of it: the 64-term sums round at
    every step). An absolute 1e-5 is a few ulps at the magnitudes es3's
    logits reach, and the two orders differ by more."""
    jparams = jpn.load_params(ES3)
    params = tpn.load_params(ES3)
    net = tpn.PolicyNet(params)
    for jst, tst in played:
        head, _, _ = ce._head_info(tst, P)
        feats = tfe.features(tst, head, P, 10).T
        want = np.asarray(jpn.policy_logits(jparams,
                                            jnp.asarray(feats.numpy())))
        with torch.no_grad():
            got = net(feats)
        assert torch.equal(got, tpn.policy_logits(params, feats))
        exact = _logits_f64(jparams, feats.numpy())
        atol = 2e-6 * max(1.0, float(np.abs(exact).max()))
        for a, b in ((got.numpy(), exact), (want, exact),
                     (got.numpy(), want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_init_params_he_normal():
    g = torch.Generator().manual_seed(0)
    p = tpn.init_params(g)
    assert [tuple(x.shape) for x in p] == [tuple(s) for s in
                                           cn.WEIGHT_SHAPES]
    assert not p.b1.any() and not p.b2.any() and not p.b3.any()
    assert abs(float(p.w2.std()) - (2.0 / 64) ** 0.5) < 0.02
    again = tpn.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(p, again))


@pytest.mark.parametrize("hidden", [4, 64, 96])
def test_init_params_hidden_width_matches_jax(hidden):
    """``init_params(generator, hidden)`` gives JAX ``init_params(key,
    hidden)``'s shapes and scheme, and ``policy_logits`` runs at any
    width."""
    p = tpn.init_params(torch.Generator().manual_seed(hidden), hidden)
    want = jpn.init_params(jax.random.key(0), hidden=hidden)
    assert [tuple(x.shape) for x in p] == [tuple(x.shape) for x in want]
    assert all(x.dtype == torch.float32 for x in p)
    assert not p.b1.any() and not p.b2.any() and not p.b3.any()
    feats = torch.rand((8, tfe.NUM_FEATURES),
                       generator=torch.Generator().manual_seed(1))
    got = tpn.policy_logits(p, feats)
    ref = jpn.policy_logits(jpn.MLPParams(*(jnp.asarray(x.numpy())
                                            for x in p)),
                            jnp.asarray(feats.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _narrow():
    return tpn.init_params(torch.Generator().manual_seed(0), hidden=4)


def _es3():
    return tpn.load_params(ES3)


STD = TableConfig(num_seats=P, rules="standard")
# Every net wrapper and entry point of ops/cuda_net.py, given a net of
# hidden width 4 (the CPU path, so that a ValueError is the width's).
NARROW_CALLS = {
    "net_weights": lambda: cn.net_weights(_narrow(), "cpu"),
    "bank_weights": lambda: cn.bank_weights([_es3(), _narrow()],
                                            "cpu"),
    "pop_weights": lambda: cn.pop_weights([_narrow()], "cpu"),
    "pop_weights_opponent": lambda: cn.pop_weights(
        [_es3()], "cpu", opponent=_narrow()),
    "run_net_eval": lambda: cn.run_net_eval(
        0, cn.initial_packed_state(0, STD, T, "cpu"),
        torch.cat([x.reshape(-1) for x in _narrow()]), P, 4, 5, 10, 100,
        "standard", 1),
    "selfplay_net_eval_kernel": lambda: cn.selfplay_net_eval_kernel(
        0, STD, _narrow(), 1, T, 4, device="cpu"),
    "selfplay_net_league": lambda: cn.selfplay_net_league(
        0, STD, [_es3(), _narrow()], (0, 1) * 3, T, 4, device="cpu"),
    "selfplay_net_eval_pop": lambda: cn.selfplay_net_eval_pop(
        0, STD, [_es3(), _narrow()], 1, T, 4, device="cpu"),
    "selfplay_net_league_pop": lambda: cn.selfplay_net_league_pop(
        0, STD, [_es3()], _narrow(), T, 4, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(NARROW_CALLS))
def test_net_wrappers_refuse_other_widths(name):
    """The net kernels assume a hidden width of 64: every wrapper refuses
    another with a ValueError and launches nothing."""
    cn.reset_launches()
    with pytest.raises(ValueError):
        NARROW_CALLS[name]()
    assert not any(cn.LAUNCHES.values())


@pytest.mark.parametrize("bot", ["fof_raise", "jam_tight"])
def test_net_det_plain_matches_jax_kernel(bot):
    n_steps, hmax = 32, 16
    rng = np.random.default_rng(43)
    cards = np.argsort(rng.random((T, hmax, 52)), axis=-1)[..., :2 * P + 5] \
        .astype(np.int32)
    jparams = jbots.panel()[bot]
    jcfg = JaxTableConfig(num_seats=P, rules="standard")
    packed = jpe.pack_state(jcfg, cards[:, 0])
    cards_in = cards.transpose(1, 2, 0).reshape(hmax, 2 * P + 5,
                                                *ce.TILE)[None]
    want = np.asarray(jpe.run_net_det(
        packed, jnp.asarray(cards_in), _jax_weights(jparams), P, n_steps,
        5, 10, 100, "standard", interpret=True))

    cfg = TableConfig(num_seats=P, rules="standard")
    state = ce.pack_state(cfg, torch.from_numpy(cards[:, 0]))
    weights = cn.net_weights(_port_params(jparams), "cpu")
    got = cn.run_net_det(state, torch.from_numpy(cards_in), weights, P,
                         n_steps, 5, 10, "standard")
    layout, _ = ce._field_layout(P, "standard")
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows], err_msg=name)
    hands = ce.unpack_field(got, cfg, "hand_ct")
    assert int(hands.sum()) > 0 and int(hands.max()) < hmax - 1
    assert int(ce.unpack_field(got, cfg, "overflow").sum()) == 0


def _jax_net_eval(monkeypatch, first, words, jparams, rules, net_seats,
                  reset_stacks, w_refs=None, **banks):
    """The JAX kernel body's composition on injected words: one net
    ``jparams``, or wide banked weights ``w_refs`` with ``banks`` (the
    ``banks=`` and ``seat_to_bank=`` of ``_net_action``)."""
    seq = iter([words[it, w].astype(np.uint32).reshape(ce.TILE)
                for it in range(words.shape[0])
                for w in range(words.shape[1])])

    def bits(shape):
        n = int(np.prod(shape)) // T
        return jnp.asarray(np.stack([next(seq) for _ in range(n)])
                           .reshape(shape))

    monkeypatch.setattr(jpe, "pltpu",
                        types.SimpleNamespace(prng_random_bits=bits))
    packed = jpe.pack_state(JaxTableConfig(num_seats=P, rules=rules), first)
    layout, F = jpe._field_layout(P, rules)
    st = jpe._unpack(packed[0], layout)
    if w_refs is None:
        w_refs = _jax_weights(jparams)
    for _ in range(words.shape[0]):
        for _ in range(ce.DEFER):
            rand = jpe._policy_prng(st, P)
            head, _, _ = jpe._head_info(st, P)
            seat = (st["button"] + head) % P
            use_net = ((jnp.full_like(seat, net_seats) >> seat) & 1) != 0
            net = jpe._net_action(st, head, P, 5, 10, w_refs, **banks)
            st = jpe._step_nosettle(st, jnp.where(use_net, net, rand), P, 5,
                                    10, rules)
        st = jpe._settle_pass(st, jpe._sample_cards(jpe.TILE, 2 * P + 5),
                              P, 5, 10, rules, 100,
                              reset_stacks=reset_stacks)
    assert next(seq, None) is None  # every word consumed, in order
    return np.asarray(jpe._pack(st, layout, F))[None]


@pytest.mark.parametrize("rules,bot,net_seats,reset_stacks", [
    ("standard", "made_ladder", 0b000101, True),
    ("standard", "fof_raise", 0b111111, False),
    ("reference", "nit_ladder", 0b010010, True),
])
def test_net_eval_plain_matches_jax_composition(monkeypatch, rules, bot,
                                                net_seats, reset_stacks):
    n_steps = 32
    rng = np.random.default_rng(net_seats)
    first = np.argsort(rng.random((T, 52)), axis=1)[:, :2 * P + 5] \
        .astype(np.int32)
    shape = cn.net_words_shape(T, P, n_steps)
    assert shape == (2, 6 * ce.DEFER + 2 * P + 5, T)
    words = rng.integers(0, 1 << 32, shape, dtype=np.int64)
    jparams = jbots.panel()[bot]
    want = _jax_net_eval(monkeypatch, first, words, jparams, rules,
                         net_seats, reset_stacks)

    cfg = TableConfig(num_seats=P, rules=rules)
    state = ce.pack_state(cfg, torch.from_numpy(first))
    got = cn.run_net_eval(0, state, cn.net_weights(_port_params(jparams),
                                                   "cpu"), P,
                          n_steps, 5, 10, 100, rules, net_seats,
                          reset_stacks=reset_stacks,
                          words=torch.from_numpy(words))
    layout, _ = ce._field_layout(P, rules)
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows], err_msg=name)
    assert int(ce.unpack_field(got, cfg, "hand_ct").sum()) > 0


def test_selfplay_net_eval_cpu_one_block():
    cfg = TableConfig(num_seats=P, rules="standard")
    params = tpn.load_params(ES3)
    means, errs, hands = cn.selfplay_net_eval_kernel(
        3, cfg, params, 1, T, 64, steps_per_launch=32, device="cpu")
    assert means.shape == errs.shape == (P,) and hands > 0
    assert np.all(np.isfinite(means)) and np.all(errs > 0)
    # reset_stacks under standard rules conserves chips: per table, the
    # seat deltas sum to zero, so the seat means do too
    state = cn.initial_packed_state(3, cfg, T, "cpu")
    w = cn.net_weights(params, "cpu")
    for done in (0, 32):
        state = cn.run_net_eval((3 + done * 7919) & 0x7FFFFFFF, state, w, P,
                                32, 5, 10, 100, "standard", 1)
    assert cn.seat_meters(state, cfg)[2] == hands
    seat = sum(ce.unpack_field(state, cfg, "seat_delta", k) for k in range(P))
    assert bool((seat == 0).all())
    assert int(ce.unpack_field(state, cfg, "overflow").sum()) == 0
    assert abs(means.sum()) < 1e-9


def test_net_wrappers_check_their_inputs():
    cfg = TableConfig(num_seats=P, rules="standard")
    state = cn.initial_packed_state(1, cfg, T, "cpu")
    w = cn.net_weights(tpn.load_params(ES3), "cpu")
    with pytest.raises(ValueError):
        cn.run_net_eval(0, state, w.double(), P, 16, 5, 10, 100, "standard",
                        1)
    with pytest.raises(ValueError):
        cn.run_net_eval(0, state, w[:-1], P, 16, 5, 10, 100, "standard", 1)
    with pytest.raises(ValueError):
        cn.run_net_eval(0, state, w, P, 16, 5, 10, 100, "standard", 1 << P)
    with pytest.raises(ValueError):  # a reference-rules layout
        cn.run_net_eval(0, state, w, P, 16, 5, 10, 100, "reference", 1)
    with pytest.raises(ValueError, match="net kernels"):
        cn.run_net_det(state, torch.zeros((1, 2, 17, *ce.TILE)), w, P, 4, 5,
                       10, "tournament")
    big = torch.zeros((1 << 21, 1, 1, 1), dtype=torch.int32).expand(
        1 << 21, ce._field_layout(P, "standard")[1], *ce.TILE)
    with pytest.raises(ValueError, match="int32"):
        cn.run_net_eval(0, big, w, P, 16, 5, 10, 100, "standard", 1)
    probe = cn.net_probe(state, torch.zeros((4, T), dtype=torch.int64), w, P,
                         10, "standard")
    assert probe.shape == (cn.PROBE_ROWS, T) and probe.dtype == torch.float32
