"""The port's ES training path against the JAX package: ``models/bots.py``,
the banked and population forms of the net kernels' plain versions (B9
banked, B7, B8) and ``models/train_es.py``.

- Bots: every panel entry and constructor builds the JAX package's arrays
  exactly, and decides by its rule in the port's exact float32.
- Bank selection: the port runs the acting seat's bank alone; its logits
  equal the JAX wide block-diagonal form's group within the float32
  tolerance of ``test_torch_net.test_es3_logits_match_jax`` (2e-6 of the
  largest logit: the two sum in different orders).
- Banked B9 and B7: the plain versions equal JAX ``run_net_det(n_banks=2,
  interpret=True)`` and the JAX kernel body's banked composition on
  injected words, field for field (rule bots: logit margins far above
  float32 rounding).
- B8: candidate c of a population call equals a single call with c's
  weights, bit for bit; ``pop_meters`` equals JAX ``_pop_meters``.
- ``train_es``: with both packages' perturbation draws replaced by the
  same numpy array, the trajectories agree within 1e-6 (float32 sums in
  two orders); the JAX tests of the trainer's machinery, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu.models import bots as jbots
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.models import train_es as jte
from montecarlo_tpu.ops import pallas_engine as jpe
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import bots as tbots
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.models import train_es as tte
from montecarlo_tpu_torch.models.features import NUM_FEATURES
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_net as cn
from test_torch_net import _jax_net_eval

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = ce.TABLES_PER_BLOCK
P = 6
ES3 = "data/policy_6max_es3.npz"
STD = TableConfig(num_seats=P, rules="standard")


def _jax_params(params):
    return jpn.MLPParams(*(jnp.asarray(x.numpy()) for x in params))


def _port_params(jparams):
    return tpn.params_from_numpy([np.asarray(x) for x in jparams])


def _same_arrays(ours, theirs):
    for name, a, b in zip(tpn.MLPParams._fields, ours, theirs):
        assert a.dtype == torch.float32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


# ---------------------------------------------------------------------------
# models/bots.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jbots.panel()))
def test_panel_bots_equal_jax(name):
    assert sorted(tbots.panel()) == sorted(jbots.panel())
    _same_arrays(tbots.panel()[name], jbots.panel()[name])


RULE = np.random.default_rng(5).normal(size=NUM_FEATURES) * 0.05
CONSTRUCTORS = {
    "action_bot": lambda b: b.action_bot(2, strength=7.5),
    "vector_bot": lambda b: b.vector_bot(RULE, 0.1, hi=2, lo=1, gain=50.0),
    "threshold_bot": lambda b: b.threshold_bot({3: 0.5, 20: -1.0}, 0.2, 0,
                                               3),
    "ladder_bot": lambda b: b.ladder_bot(dict(enumerate(RULE)), 0.1,
                                         {14: 1.0}, 0.0625, top=2, mid=0,
                                         bot=1, slope=3.0, cap=0.5),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_bot_constructors_equal_jax(name):
    _same_arrays(CONSTRUCTORS[name](tbots), CONSTRUCTORS[name](jbots))


def test_bot_constructors_implement_their_rules():
    """The JAX package's test of the rules, on the port's float32 logits:
    the rectified pairs, designed against the TPU's bf16 matmul inputs,
    decide the same way without them."""
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.uniform(0.0, 1.0, (32, NUM_FEATURES))
                             .astype(np.float32))
    for a in range(4):
        logits = tpn.policy_logits(tbots.action_bot(a), feats)
        assert bool((logits.argmax(1) == a).all())
    with pytest.raises(ValueError):
        tbots.action_bot(4)

    bot = tbots.threshold_bot(tbots._HOLE, 1.0, hi=3, lo=0)
    s = sum(w * feats[:, i].numpy() for i, w in tbots._HOLE.items())
    logits = tpn.policy_logits(bot, feats).numpy()
    margin = np.abs(s - 1.0) > 0.01
    want = np.where(s > 1.0, 3, 0)
    assert np.all(np.argmax(logits, axis=1)[margin] == want[margin])
    assert np.all(logits[:, 1] < np.maximum(logits[:, 0], logits[:, 3]))
    assert np.all(logits[:, 2] < np.maximum(logits[:, 0], logits[:, 3]))
    h1 = torch.relu(tpn._dense(feats, bot.w1, bot.b1))
    assert float(h1.max()) <= 4.0

    def hole_feats(r0, r1, suited, paired):
        f = np.zeros(NUM_FEATURES, np.float32)
        f[16], f[17], f[18], f[19] = r0 / 14, r1 / 14, suited, paired
        return torch.from_numpy(f[None])

    tight = tbots.threshold_bot(tbots._HOLE, 1.00, hi=3, lo=0)
    loose = tbots.threshold_bot(tbots._HOLE, 0.85, hi=3, lo=0)
    aa, ako, s72 = hole_feats(14, 14, 0, 1), hole_feats(14, 13, 0, 0), \
        hole_feats(7, 2, 0, 0)
    assert int(tpn.policy_logits(tight, aa).argmax()) == 3
    assert int(tpn.policy_logits(tight, ako).argmax()) == 0
    assert int(tpn.policy_logits(loose, ako).argmax()) == 3
    assert int(tpn.policy_logits(loose, s72).argmax()) == 0
    for name, p in tbots.panel().items():
        out = tpn.policy_logits(p, feats)
        assert out.shape == (32, 4) and bool(out.isfinite().all()), name


def test_ladder_bot_three_way_rule():
    """argmax == (top if s1 > t1 else mid if s2 > t2 else bot) away from
    the cap/slope transition bands; the safe-range guard refuses an
    unnormalized rule."""
    rng = np.random.default_rng(3)

    def norm(v, t):
        c = max(1.0, (2.0 * float(np.abs(v).sum()) + abs(t)) / 4.0)
        return (v / c).astype(np.float32), t / c

    s1_vec, t1 = norm(rng.normal(size=NUM_FEATURES), 0.4)
    s2_vec, t2 = norm(rng.normal(size=NUM_FEATURES), -0.2)
    p = tbots.ladder_bot(dict(enumerate(s1_vec)), t1,
                         dict(enumerate(s2_vec)), t2, top=3, mid=1, bot=0)
    band = 0.25 / 4.0
    feats = rng.uniform(-1, 1, size=(4096, NUM_FEATURES)).astype(np.float32)
    s1, s2 = feats @ s1_vec, feats @ s2_vec
    clear = (np.abs(s1 - t1) > band) & (np.abs(s2 - t2) > band)
    feats, s1, s2 = feats[clear], s1[clear], s2[clear]
    assert len(feats) > 1000
    want = np.where(s1 > t1, 3, np.where(s2 > t2, 1, 0))
    got = tpn.policy_logits(p, torch.from_numpy(feats)).argmax(-1).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(AssertionError, match="bf16-safe"):
        tbots.ladder_bot({0: 10.0}, 0.0, {1: 1.0}, 0.0, top=3, mid=1, bot=0)


@pytest.mark.parametrize("name", sorted(jbots.panel()))
def test_bots_play_full_hands_through_net_eval(name):
    """Every seat plays the bot (K6's plain version, standard rules, stacks
    reset each hand): hands complete and every table's chips conserve."""
    state = cn.initial_packed_state(5, STD, T, "cpu")
    out = cn.run_net_eval(5, state, cn.net_weights(tbots.panel()[name],
                                                   "cpu"),
                          P, 32, 5, 10, 100, "standard", (1 << P) - 1)
    assert int(ce.unpack_field(out, STD, "hand_ct").sum()) > 0
    assert int(ce.unpack_field(out, STD, "overflow").sum()) == 0
    seat = sum(ce.unpack_field(out, STD, "seat_delta", k) for k in range(P))
    assert bool((seat == 0).all())


# ---------------------------------------------------------------------------
# Banks: selection, banked B9, B7
# ---------------------------------------------------------------------------

def test_bank_logits_equal_jax_wide_group():
    """Bank b's logits (the bank run alone, in the kernels' sum order)
    against the JAX wide form's group b (``_stack_weights_league``, XLA's
    dot) and a float64 evaluation, within 2e-6 of the largest logit."""
    nets = [tpn.init_params(torch.Generator().manual_seed(k))
            for k in range(3)]
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(NUM_FEATURES, 64)).astype(np.float32)
    w1t, b1, w2t, b2, w3t, b3 = _wide = jpe._stack_weights_league(
        [_jax_params(p) for p in nets])
    h = jnp.maximum(w1t @ feats + b1, 0.0)
    h = jnp.maximum(w2t @ h + b2, 0.0)
    wide = np.asarray(w3t @ h + b3)                     # [3 * 4, 64]
    weights = cn.bank_weights(nets, "cpu")[None]        # [1, 3, 6020]
    for b in range(3):
        bank = torch.full((64,), b, dtype=torch.int32)
        got = cn._bank_logits(torch.from_numpy(feats), weights, bank).numpy()
        assert np.array_equal(got, tpn.policy_logits(
            nets[b], torch.from_numpy(feats.T)).numpy().T)
        w = [x.numpy().astype(np.float64) for x in nets[b]]
        exact = (np.maximum(np.maximum(feats.T @ w[0] + w[1], 0) @ w[2]
                            + w[3], 0) @ w[4] + w[5]).T
        atol = 2e-6 * max(1.0, float(np.abs(exact).max()))
        for a, e in ((got, exact), (wide[4 * b:4 * b + 4], exact),
                     (got, wide[4 * b:4 * b + 4])):
            np.testing.assert_allclose(a, e, rtol=0, atol=atol)


def test_net_det_banked_plain_matches_jax_kernel():
    """Banked B9: jam_tight at seat 0, fof_call at seats 1-5, against JAX
    ``run_net_det(n_banks=2, interpret=True)``, every field of every
    table (tests/test_pallas_engine.py's case)."""
    n_steps, hmax = 32, 16
    rng = np.random.default_rng(43)
    cards = np.argsort(rng.random((T, hmax, 52)), axis=-1)[..., :2 * P + 5] \
        .astype(np.int32)
    jbanks = [jbots.panel()["jam_tight"], jbots.panel()["fof_call"]]
    stb = (0, 1, 1, 1, 1, 1)
    jcfg = JaxTableConfig(num_seats=P, rules="standard")
    cards_in = cards.transpose(1, 2, 0).reshape(hmax, 2 * P + 5,
                                                *ce.TILE)[None]
    want = np.asarray(jpe.run_net_det(
        jpe.pack_state(jcfg, cards[:, 0]), jnp.asarray(cards_in),
        jpe._stack_weights_league(jbanks), P, n_steps, 5, 10, 100,
        "standard", n_banks=2, seat_to_bank=stb, interpret=True))

    state = ce.pack_state(STD, torch.from_numpy(cards[:, 0]))
    weights = cn.bank_weights([_port_params(p) for p in jbanks], "cpu")
    got = cn.run_net_det(state, torch.from_numpy(cards_in), weights, P,
                         n_steps, 5, 10, "standard", seat_to_bank=stb)
    layout, _ = ce._field_layout(P, "standard")
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows], err_msg=name)
    clean = ce.unpack_field(got, STD, "overflow") == 0
    assert float(clean.float().mean()) > 0.95
    hands = ce.unpack_field(got, STD, "hand_ct")
    assert int(hands.sum()) > 0 and int(hands.max()) < hmax - 1
    # the banks route: one bank at every seat plays otherwise
    alone = cn.run_net_det(state, torch.from_numpy(cards_in), weights[1], P,
                           n_steps, 5, 10, "standard")
    assert not torch.equal(alone, got)


@pytest.mark.parametrize("rules,names,stb,net_seats,reset_stacks", [
    ("standard", ("made_ladder", "fof_raise"), (0, 1, 0, 1, 0, 1),
     0b110111, True),
    ("reference", ("nit_ladder", "jam_loose", "callbot"), (2, 0, 1, 1, 0, 2),
     0b111111, False),
])
def test_net_league_plain_matches_jax_composition(monkeypatch, rules, names,
                                                  stb, net_seats,
                                                  reset_stacks):
    """B7 on injected words against the JAX kernel body's composition with
    ``_net_action(banks=B, seat_to_bank=...)`` on the wide weights."""
    n_steps = 32
    rng = np.random.default_rng(net_seats)
    first = np.argsort(rng.random((T, 52)), axis=1)[:, :2 * P + 5] \
        .astype(np.int32)
    words = rng.integers(0, 1 << 32, cn.net_words_shape(T, P, n_steps),
                         dtype=np.int64)
    jbanks = [jbots.panel()[n] for n in names]
    want = _jax_net_eval(monkeypatch, first, words, None, rules, net_seats,
                         reset_stacks,
                         w_refs=jpe._stack_weights_league(jbanks),
                         banks=len(jbanks), seat_to_bank=stb)
    cfg = TableConfig(num_seats=P, rules=rules)
    got = cn.run_net_league(0, ce.pack_state(cfg, torch.from_numpy(first)),
                            cn.bank_weights([_port_params(p) for p in jbanks],
                                            "cpu"),
                            P, n_steps, 5, 10, 100, rules, net_seats, stb,
                            reset_stacks=reset_stacks,
                            words=torch.from_numpy(words))
    layout, _ = ce._field_layout(P, rules)
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows], err_msg=name)
    assert int(ce.unpack_field(got, cfg, "hand_ct").sum()) > 0


# ---------------------------------------------------------------------------
# B8: the population grid
# ---------------------------------------------------------------------------

def _candidates(n, seed=0):
    es3 = tpn.load_params(ES3)
    rng = np.random.default_rng(seed)
    return [tpn.params_from_numpy([x.numpy() + 0.5 * rng.standard_normal(
        x.shape).astype(np.float32) for x in es3]) for _ in range(n)]


@pytest.mark.parametrize("n_banks", [1, 2])
def test_pop_plain_candidates_equal_single_calls(n_banks):
    """Candidate c of a population call equals a single call with c's
    weights (K6, or B7 with the opponent bank), bit for bit: every
    candidate's table t reads the words of table t."""
    C, n_steps = 3, 32
    first = cn.initial_packed_state(4, STD, T, "cpu")
    state = first[None].expand(C, *first.shape).contiguous()
    cands = _candidates(C)
    weights = cn.pop_weights(cands, "cpu", tbots.panel()["jam_loose"]
                             if n_banks == 2 else None)
    stb = (1, 0, 1, 1, 0, 1) if n_banks == 2 else None
    decisions = torch.zeros(1, dtype=torch.int64)
    pop = cn.run_net_eval_pop(21, state, weights, P, n_steps, 5, 10, 100,
                              "standard", 0b011011, stb, decisions=decisions)
    total = 0
    for c in range(C):
        d = torch.zeros(1, dtype=torch.int64)
        if n_banks == 1:
            single = cn.run_net_eval(21, first, weights[c, 0], P, n_steps, 5,
                                     10, 100, "standard", 0b011011,
                                     decisions=d)
        else:
            single = cn.run_net_league(21, first, weights[c], P, n_steps, 5,
                                       10, 100, "standard", 0b011011, stb,
                                       decisions=d)
        assert torch.equal(pop[c], single)
        total += int(d)
    assert int(decisions) == total > 0
    assert not torch.equal(pop[0], pop[1])  # the candidates differ


def test_pop_meters_equal_jax_pop_meters():
    C = 3
    first = cn.initial_packed_state(6, STD, T, "cpu")
    state = cn.run_net_eval_pop(
        6, first[None].expand(C, *first.shape).contiguous(),
        cn.pop_weights(_candidates(C, 1), "cpu"), P, 32, 5, 10, 100,
        "standard", 1)
    got = cn.pop_meters(state, STD)
    want = jpe._pop_meters(jnp.asarray(state.numpy()),
                           JaxTableConfig(num_seats=P, rules="standard"))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for c in range(C):
        m, e, h = cn.seat_meters(state[c], STD)
        assert np.array_equal(m, got[0][c]) and np.array_equal(e, got[1][c])
        assert h == got[2][c] > 0


def test_pop_entry_points_cpu_one_block():
    C = 3
    cands = _candidates(C, 2)
    m, e, h = cn.selfplay_net_eval_pop(7, STD, cands, 0b000101, T, 32,
                                       steps_per_launch=16, device="cpu")
    assert m.shape == e.shape == (C, P) and h.shape == (C,)
    assert np.all(h > 0) and np.all(np.abs(m.sum(axis=1)) < 1e-9)
    single = cn.selfplay_net_eval_kernel(7, STD, cands[1], 0b000101, T, 32,
                                         steps_per_launch=16, device="cpu")
    assert np.array_equal(single[0], m[1]) and single[2] == h[1]

    opp = tbots.panel()["fof_call"]
    lm, _, lh = cn.selfplay_net_league_pop(7, STD, cands, opp, T, 32,
                                           device="cpu")
    assert lm.shape == (C, P) and np.all(lh > 0)
    assert np.all(np.abs(lm.sum(axis=1)) < 1e-9)
    league = cn.selfplay_net_league(7, STD, [cands[2], opp],
                                    (0, 1, 1, 1, 1, 1), T, 32, device="cpu")
    assert np.array_equal(league[0], lm[2]) and league[2] == lh[2]
    # two identical banks are the single net at every seat
    same = cn.selfplay_net_league(7, STD, [cands[0], cands[0]],
                                  tuple(k % 2 for k in range(P)), T, 32,
                                  device="cpu")
    alone = cn.selfplay_net_eval_kernel(7, STD, cands[0], (1 << P) - 1, T,
                                        32, device="cpu")
    assert np.array_equal(same[0], alone[0]) and same[2] == alone[2]


def test_banked_wrappers_check_their_inputs():
    state = cn.initial_packed_state(1, STD, T, "cpu")
    banks = cn.bank_weights([tbots.action_bot(1), tbots.action_bot(3)],
                            "cpu")
    cards = torch.zeros((1, 2, 2 * P + 5, *ce.TILE), dtype=torch.int32)
    for stb in ((0, 1, 1, 1, 1), (0, 1, 2, 1, 1, 1), (0, -1, 1, 1, 1, 1)):
        with pytest.raises(ValueError, match="seat_to_bank"):
            cn.run_net_league(0, state, banks, P, 16, 5, 10, 100, "standard",
                              1, stb)
        with pytest.raises(ValueError, match="seat_to_bank"):
            cn.run_net_det(state, cards, banks, P, 4, 5, 10, "standard", stb)
    ten = banks[:1].expand(10, cn.NUM_WEIGHTS).contiguous()
    with pytest.raises(ValueError, match="at most 9"):
        cn.run_net_league(0, state, ten, P, 16, 5, 10, 100, "standard", 1,
                          (0,) * P)
    assert cn.run_net_league(0, state, ten[:9], P, 16, 5, 10, 100,
                             "standard", 1, (8,) * P).shape == state.shape
    with pytest.raises(ValueError):  # one net's weights are not banks
        cn.run_net_league(0, state, banks[0], P, 16, 5, 10, 100, "standard",
                          1, (0,) * P)
    # the population grid: C x tables within int32, C within the grid's y
    F = ce._field_layout(P, "standard")[1]
    big = torch.zeros((1, 1, 1, 1, 1), dtype=torch.int32).expand(
        1 << 11, 1 << 10, F, *ce.TILE)
    w = torch.zeros((1, 1, cn.NUM_WEIGHTS)).expand(1 << 11, 1,
                                                   cn.NUM_WEIGHTS)
    with pytest.raises(ValueError, match="int32"):
        cn.run_net_eval_pop(0, big, w, P, 16, 5, 10, 100, "standard", 1)
    many = torch.zeros((1, 1, 1, 1, 1), dtype=torch.int32).expand(
        cn.MAX_CANDIDATES + 1, 1, F, *ce.TILE)
    with pytest.raises(ValueError, match="candidates"):
        cn.run_net_eval_pop(0, many, w[:1].expand(cn.MAX_CANDIDATES + 1, 1,
                                                  cn.NUM_WEIGHTS),
                            P, 16, 5, 10, 100, "standard", 1)
    pop = state[None].expand(2, *state.shape)
    with pytest.raises(ValueError, match="candidates' weights"):
        cn.run_net_eval_pop(0, pop, w[:3].contiguous(), P, 16, 5, 10, 100,
                            "standard", 1)


# ---------------------------------------------------------------------------
# models/train_es.py
# ---------------------------------------------------------------------------

TARGET = np.random.default_rng(1).normal(size=16).astype(np.float32) * 0.5


def _toy_fitness(vec):
    return -float(np.mean((np.asarray(vec, np.float64)[:16] - TARGET) ** 2))


def _jax_start():
    return jpn.init_params(jax.random.key(0))


@pytest.mark.parametrize("path", ["eval_fn", "eval_pop_fn"])
def test_train_es_trajectory_matches_jax(monkeypatch, path):
    """Six generations from the same start on the same perturbations (both
    packages' draws replaced by one numpy array) and a deterministic toy
    fitness: centers and fitness histories within 1e-6."""
    pop, gens = 4, 6
    jparams = _jax_start()
    dim = int(jte._flatten(jparams)[0].shape[0])
    draws = np.random.default_rng(2).standard_normal(
        (gens, pop, dim)).astype(np.float32)
    mask = np.ones(dim, np.float32)
    mask[::3] = 0.0

    def jax_draws():
        it = iter(draws)
        return lambda key, shape, dtype: jnp.asarray(next(it))

    port_it = iter(draws)
    monkeypatch.setattr(jax.random, "normal", jax_draws())
    monkeypatch.setattr(tte, "_perturbations",
                        lambda gen, n, d: torch.from_numpy(next(port_it)))

    def run(mod, params0, flat, mask_):
        def one(params, seed):
            return _toy_fitness(flat(params)), 100

        def many(params_list, seed):
            return [one(p, seed)[0] for p in params_list], \
                [100] * len(params_list)

        kw = {"eval_fn": one} if path == "eval_fn" else {"eval_pop_fn": many}
        return mod.train_es(3, params0, generations=gens, pop=pop, sigma=0.05,
                            lr=0.1, mask=mask_, **kw)

    want = run(jte, jparams, lambda p: np.asarray(jte._flatten(p)[0]),
               jnp.asarray(mask))
    got = run(tte, _port_params(jparams), lambda p: tte._flatten(p)[0]
              .numpy(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.fitness_history, want.fitness_history,
                               rtol=0, atol=1e-6)
    assert got.hands_total == want.hands_total == gens * 2 * pop * 100
    assert got.best_fitness == pytest.approx(want.best_fitness, abs=1e-6)
    for ours, theirs in ((got.params, want.params),
                         (got.final_params, want.final_params)):
        np.testing.assert_allclose(tte._flatten(ours)[0].numpy(),
                                   np.asarray(jte._flatten(theirs)[0]),
                                   rtol=0, atol=1e-6)
    moved = tte._flatten(got.final_params)[0] - \
        tte._flatten(_port_params(jparams))[0]
    assert float(moved.abs().max()) > 1e-3 and not bool(moved[::3].any())


def _port_start():
    return tpn.init_params(torch.Generator().manual_seed(0))


def _fitness_of(params):
    return _toy_fitness(tte._flatten(params)[0].numpy())


def test_es_trainer_improves_toy_fitness():
    out = tte.train_es(3, _port_start(), lambda p, s: (_fitness_of(p), 100),
                       generations=40, pop=8, sigma=0.05, lr=0.1)
    assert out.fitness_history[-5:].mean() > out.fitness_history[:5].mean()
    assert out.hands_total == 40 * 16 * 100


def test_es_pop_path_matches_per_candidate():
    """The generation reaches eval_pop_fn ordered [+e0, -e0, +e1, ...]:
    with a deterministic evaluator both paths give the same trajectory."""
    a = tte.train_es(3, _port_start(), lambda p, s: (_fitness_of(p), 100),
                     generations=6, pop=4, sigma=0.05, lr=0.1)
    b = tte.train_es(3, _port_start(), eval_pop_fn=lambda ps, s: (
        [_fitness_of(p) for p in ps], [100] * len(ps)),
        generations=6, pop=4, sigma=0.05, lr=0.1)
    assert np.array_equal(a.fitness_history, b.fitness_history)
    assert a.hands_total == b.hands_total
    assert torch.equal(tte._flatten(a.params)[0], tte._flatten(b.params)[0])
    with pytest.raises(ValueError):
        tte.train_es(3, _port_start(), generations=1)


def test_es_flatten_roundtrip_and_layer_mask():
    p = _port_start()
    vec, spec = tte._flatten(p)
    q = tte._unflatten(vec, spec)
    assert type(q) is tpn.MLPParams
    for a, b in zip(p, q):
        assert a.shape == b.shape and torch.equal(a, b)
    assert np.array_equal(tte.layer_mask(p, ("w3", "b1")).numpy(),
                          np.asarray(jte.layer_mask(_jax_start(),
                                                    ("w3", "b1"))))


def test_es_returns_best_mean_center():
    sched = [0.0, 1.0, 2.0, 1.0, 0.0]

    def eval_pop_fn(params_list, eval_seed):
        g = eval_seed - 3 * 1_000_003
        return [sched[g] + 1e-6 * i for i in range(len(params_list))], \
            [100] * len(params_list)

    a = tte.train_es(3, _port_start(), eval_pop_fn=eval_pop_fn,
                     generations=5, pop=4, sigma=0.05, lr=0.1)
    b = tte.train_es(3, _port_start(), eval_pop_fn=eval_pop_fn,
                     generations=2, pop=4, sigma=0.05, lr=0.1)
    va = tte._flatten(a.params)[0]
    assert int(np.argmax(a.fitness_history)) == 2
    assert torch.equal(va, tte._flatten(b.final_params)[0])
    assert not torch.equal(va, tte._flatten(a.final_params)[0])


def test_es_noise_floor_damps_collapsed_spread():
    vec0 = tte._flatten(_port_start())[0]

    def eval_pop_fn(params_list, eval_seed):
        return [1e-7 * i for i in range(len(params_list))], \
            [100] * len(params_list)

    kw = dict(eval_pop_fn=eval_pop_fn, generations=5, pop=4, sigma=0.05,
              lr=0.1)
    drift = tte.train_es(3, _port_start(), **kw)
    damped = tte.train_es(3, _port_start(), noise_floor=0.01, **kw)
    assert float((tte._flatten(drift.final_params)[0] - vec0).abs().max()) \
        > 1e-3
    assert float((tte._flatten(damped.final_params)[0] - vec0).abs().max()) \
        < 1e-4


def test_es_center_eval_fn_selects_best_holdout():
    scores = iter([0.0, 5.0, 1.0, 0.5, 0.5, 0.5])
    seen = []

    def center_eval(params):
        seen.append(tte._flatten(params)[0].clone())
        return next(scores)

    out = tte.train_es(3, _port_start(), eval_pop_fn=lambda ps, s: (
        [100.0 + s + 1e-3 * i for i in range(len(ps))], [1] * len(ps)),
        generations=5, pop=4, sigma=0.05, lr=0.1,
        center_eval_fn=center_eval, center_eval_every=1)
    assert len(seen) == 5
    assert torch.equal(tte._flatten(out.params)[0], seen[1])  # score 5.0


def test_es_checkpoint_fn_cadence_and_payload():
    rng = np.random.default_rng(4)
    base = tpn.params_from_numpy([rng.normal(size=s).astype(np.float32)
                                  for s in ((24, 4), (4,), (4, 4), (4,),
                                            (4, 4), (4,))])
    calls = []

    def quality(p):
        return -float(np.square(p.b3[:2].numpy()).sum())

    tte.train_es(3, base, eval_pop_fn=lambda cands, seed: (
        np.asarray([quality(c) for c in cands]), len(cands)),
        generations=21, pop=4, sigma=0.1, lr=0.2, center_eval_fn=quality,
        center_eval_every=10,
        checkpoint_fn=lambda g, c, b, q: calls.append((g, float(q))))
    assert [g for g, _ in calls] == [0, 10, 20]
    quals = [q for _, q in calls]
    assert quals == sorted(quals)


def test_es_adapt_hook_cadence_and_pool_mutation():
    pool, seen_at, log = ["attacker_v0"], [], []

    def adapt_fn(g, center):
        assert bool(tte._flatten(center)[0].isfinite().all())
        pool[0] = f"attacker_v{g}"
        seen_at.append(g)

    def eval_pop_fn(params_list, eval_seed):
        log.append(pool[0])
        return [0.0] * len(params_list), [1] * len(params_list)

    tte.train_es(3, _port_start(), eval_pop_fn=eval_pop_fn, generations=7,
                 pop=2, sigma=0.05, lr=0.1, adapt_fn=adapt_fn, adapt_every=3)
    assert seen_at == [0, 3, 6]
    assert log == ["attacker_v0"] * 3 + ["attacker_v3"] * 3 + ["attacker_v6"]


def _fake_kernels(monkeypatch, calls, per_seat=None):
    token = object()

    def fake_initial(seed, cfg, n_tables, device=None):
        return token

    def fake_eval_pop(seed, cfg, cands, net_seats, n_tables, n_steps,
                      state0):
        calls.append(("random", state0 is token, net_seats))
        m = np.full((len(cands), cfg.num_seats), 0.1)
        return m, None, np.full(len(cands), 100)

    def fake_league_pop(seed, cfg, cands, opp, n_tables, n_steps,
                        seat_to_bank, state0):
        calls.append(("league", state0 is token, seat_to_bank))
        m = np.full((len(cands), cfg.num_seats), 0.3) if per_seat is None \
            else np.tile(per_seat, (len(cands), 1))
        return m, None, np.full(len(cands), 200)

    monkeypatch.setattr(cn, "initial_packed_state", fake_initial)
    monkeypatch.setattr(cn, "selfplay_net_eval_pop", fake_eval_pop)
    monkeypatch.setattr(cn, "selfplay_net_league_pop", fake_league_pop)


def test_pool_eval_pop_fn_averages_over_opponents(monkeypatch):
    calls = []
    _fake_kernels(monkeypatch, calls)
    f = tte.kernel_pool_eval_pop_fn(STD, [None, tbots.action_bot(1)],
                                    n_tables=64, n_steps=8)
    fits, hands = f([_port_start()] * 4, eval_seed=7)
    np.testing.assert_allclose(np.asarray(fits), 0.2)  # (0.1 + 0.3) / 2
    assert hands == 4 * 100 + 4 * 200
    assert calls == [("random", True, 1), ("league", True,
                                           (0, 1, 1, 1, 1, 1))]


def test_pool_eval_pop_fn_lone_geometry_sums_candidate_seats(monkeypatch):
    """'lone': the opponent alone at ``seat``, fitness the sum over the
    candidate's P-1 seats; a bare MLPParams (a NamedTuple) is not taken
    for an (opponent, geometry) pair."""
    calls, per_seat = [], np.arange(P) * 0.1
    _fake_kernels(monkeypatch, calls, per_seat)
    bot = tbots.action_bot(1)
    f = tte.kernel_pool_eval_pop_fn(STD, [(bot, "lone"), bot], n_tables=64,
                                    n_steps=8)
    fits, hands = f([_port_start()] * 3, eval_seed=7)
    np.testing.assert_allclose(np.asarray(fits),
                               (per_seat[1:].sum() + per_seat[0]) / 2)
    assert hands == 3 * 200 * 2
    assert [c[2] for c in calls] == [(1, 0, 0, 0, 0, 0), (0, 1, 1, 1, 1, 1)]


def test_kernel_evaluators_cpu_one_block():
    """The evaluators on the plain versions: the population evaluator's
    fitnesses equal the per-candidate evaluator's, and two ES generations
    through either give the same result (the CPU form of the card's
    check); league fitness is the candidate's seat of
    ``selfplay_net_league_pop``."""
    cands = _candidates(2, 3)
    kw = dict(n_tables=T, n_steps=16, device="cpu")
    single = tte.kernel_eval_fn(STD, net_seats=0b100, **kw)
    pop = tte.kernel_eval_pop_fn(STD, net_seats=0b100, **kw)
    fits, hands = pop(cands, 11)
    for c, p in enumerate(cands):
        assert single(p, 11) == (fits[c], hands[c])
    opp = tbots.panel()["jam_tight"]
    lf, lh = tte.kernel_league_eval_pop_fn(STD, opp, seat=2, **kw)(cands, 11)
    m, _, h = cn.selfplay_net_league_pop(11, STD, cands, opp, T, 16,
                                         seat_to_bank=(1, 1, 0, 1, 1, 1),
                                         device="cpu")
    assert np.array_equal(lf, m[:, 2]) and np.array_equal(lh, h)

    es = dict(generations=2, pop=2, sigma=0.05, lr=0.1, noise_floor=0.1)
    a = tte.train_es(5, cands[0], eval_pop_fn=pop, **es)
    b = tte.train_es(5, cands[0], single, **es)
    assert np.array_equal(a.fitness_history, b.fitness_history)
    assert a.hands_total == b.hands_total > 0
    assert torch.equal(tte._flatten(a.final_params)[0],
                       tte._flatten(b.final_params)[0])
