"""The K4 and K6 splits' plain versions against the JAX kernels under the
same stubs.

The JAX scripts (``scripts/exp_step_split.py``, ``scripts/exp_net_split.py``)
monkeypatch one module-level piece of ``pallas_engine`` (or of
``ops/evaluator``) at a time and time the whole kernel. The JAX kernels
draw from the TPU's PRNG, which has no CPU lowering, so, as in
``tests/test_torch_engine.py`` and ``tests/test_torch_net.py``, the JAX
side here is the kernel body's own composition (``_policy_prng`` [+
``_net_action``] + ``_step_nosettle`` x DEFER, ``_sample_cards`` +
``_settle_pass``) with the script's stub applied by ``monkeypatch`` and
``pltpu`` replaced by a stub whose ``prng_random_bits`` hands out injected
words in the stubbed body's draw order; the port's plain variant gets the
same words (``split_words_shape``) and must equal it field by field, on
one block from ``pack_state`` and from a mid-hand state. ``full`` and the
controls (the stubs' copies with nothing stubbed) equal the unstubbed
plain K4 / K6. The scripts are loaded from their files
(``importlib``) to check the port's sizes against theirs.
"""

import functools
import importlib.util
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops import evaluator as jev
from montecarlo_tpu.ops import pallas_engine as jpe
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.ops import cuda_net_split as cns
from montecarlo_tpu_torch.ops import cuda_split as csp
from montecarlo_tpu_torch.scripts import exp_net_split as ens
from montecarlo_tpu_torch.scripts import exp_step_split as ess

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
T = ce.TABLES_PER_BLOCK
P = 6
NET = "data/policy_6max_200.npz"
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")


def _load_script(name):
    """A JAX script from ``scripts/``; its import points JAX's compile cache
    at its TPU directory and makes that directory: both are undone."""
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    makedirs = os.makedirs
    os.makedirs = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(
            f"reference_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.makedirs = makedirs
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def test_ported_scripts_keep_the_jax_sizes():
    for name, ours in (("exp_step_split", ess), ("exp_net_split", ens)):
        theirs = _load_script(name)
        assert (ours.N_TABLES, ours.N_STEPS) == (theirs.N_TABLES,
                                                 theirs.N_STEPS)
    assert csp.VARIANTS == _build.SPLITS and cns.VARIANTS == \
        _build.NET_SPLITS


# The scripts' stubs (exp_step_split.py:84-116, exp_net_split.py:70-95),
# each as (module, attribute, replacement).
TILE_ZEROS = functools.partial(jnp.zeros, jpe.TILE)
K4_STUBS = {
    "full": [],
    "stub_settle": [(jpe, "_settle_payout",
                     lambda st, pa, ps, pn, ih, P, ref:
                     jnp.zeros_like(st["stacks"]))],
    "stub_eval": [(jev, "eval_masks_cmp_impl", lambda m0, m1, m2, m3: m0)],
    "stub_deal": [(jpe, "_sample_cards",
                   lambda shape, k: jnp.zeros((k,) + shape, jnp.int32))],
    "stub_policy": [(jpe, "_policy_prng",
                     lambda st, P: TILE_ZEROS(jnp.int32))],
    "stub_street": [(jpe, "_street_update",
                     lambda lvl, ln, amount, do:
                     (lvl, ln, TILE_ZEROS(jnp.int32) != 0)),
                    (jpe, "_street_merge",
                     lambda lvl, ln, contrib, do: (lvl, ln))],
    # the controls stub nothing
    "settle_copy": [],
    "street_copy": [],
}
K6_STUBS = {
    "full": [],
    "stub_gumbel": [(jpe, "_gumbel_pick", lambda logits: jnp.min(
        jnp.where(logits == jnp.max(logits, axis=0)[None],
                  jpe._iota(logits.shape[0]), logits.shape[0]), axis=0))],
    "stub_feat_eval": [(jev, "eval_masks_impl", lambda m0, m1, m2, m3: m0)],
    # the script's list has 20 zeros, from before the four raise
    # features: the MLP's first layer now reads 24, so 24 zeros here
    "stub_features": [(jpe, "_features", lambda st, head, P, bb:
                       [TILE_ZEROS(jnp.float32)] * 24)],
    # the script's lambda takes (st, head, P, sb, bb, w_refs);
    # _net_action now also takes banks=, seat_to_bank= and det=, so the
    # stub takes the current signature
    "stub_net": [(jpe, "_net_action",
                  lambda st, head, P, sb, bb, w_refs, banks=None,
                  seat_to_bank=None, det=False: TILE_ZEROS(jnp.int32))],
    "feat_copy": [],
}


def _inject(monkeypatch, words):
    """``pltpu`` replaced: each ``prng_random_bits(shape)`` hands out the
    next words of ``words`` [n_it, W, T] in order (several rows for a
    leading axis)."""
    seq = iter([words[it, w].astype(np.uint32).reshape(ce.TILE)
                for it in range(words.shape[0])
                for w in range(words.shape[1])])

    def bits(shape):
        n = int(np.prod(shape)) // T
        return jnp.asarray(np.stack([next(seq) for _ in range(n)])
                           .reshape(shape))

    monkeypatch.setattr(jpe, "pltpu",
                        types.SimpleNamespace(prng_random_bits=bits))
    return seq


def _jax_state(state, rules):
    layout, F = jpe._field_layout(P, rules)
    return jpe._unpack(jnp.asarray(state[0].numpy()), layout), layout, F


def _compare(got, want, rules):
    layout, _ = ce._field_layout(P, rules)
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows], err_msg=name)


def _mid_hand(cfg, rules, n_steps=20, seed=37):
    """Tables after ``n_steps`` K3 steps (the plain version, held equal to
    JAX's run_perpetual_det by tests/test_torch_engine.py) on an injected
    stream: hands under way, pots on the table."""
    rng = np.random.default_rng(seed)
    u = rng.random((n_steps, T))
    acts = np.where(u < 0.2, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    deal = np.argsort(rng.random((T, 4, 52)), axis=-1)[..., :2 * P + 5]
    cards = deal.transpose(1, 2, 0).reshape(1, 4, 2 * P + 5, *ce.TILE)
    state = ce.pack_state(cfg, torch.from_numpy(deal[:, 0]))
    return ce.run_perpetual_det(
        state, torch.from_numpy(acts.reshape(1, n_steps, *ce.TILE)),
        torch.from_numpy(np.ascontiguousarray(cards).astype(np.int32)), P,
        n_steps, 5, 10, rules=rules)


@pytest.fixture(scope="module")
def k4_starts():
    cfg = TableConfig(num_seats=P, bets_impl="levels")
    mid = _mid_hand(cfg, "reference")
    assert int(ce.unpack_field(mid, cfg, "pot_amt", 0).ne(0).sum()) > 0
    return {"pack_state": ce.pack_state(cfg, ce.first_deal(2, T, P, "cpu")),
            "mid_hand": mid}


@pytest.mark.parametrize("start", ["pack_state", "mid_hand"])
@pytest.mark.parametrize("variant", csp.VARIANTS)
def test_k4_split_plain_matches_jax_under_the_same_stub(monkeypatch,
                                                        k4_starts, variant,
                                                        start):
    n_steps = 32
    state = k4_starts[start]
    rng = np.random.default_rng(csp.VARIANTS.index(variant))
    words = rng.integers(0, 1 << 32, csp.split_words_shape(
        variant, T, P, n_steps), dtype=np.int64)
    for mod, name, stub in K4_STUBS[variant]:
        monkeypatch.setattr(mod, name, stub)
    seq = _inject(monkeypatch, words)
    st, layout, F = _jax_state(state, "reference")
    for _ in range(words.shape[0]):
        for _ in range(ce.DEFER):
            st = jpe._step_nosettle(st, jpe._policy_prng(st, P), P, 5, 10)
        st = jpe._settle_pass(st, jpe._sample_cards(jpe.TILE, 2 * P + 5),
                              P, 5, 10)
    assert next(seq, None) is None  # every word consumed, in order
    want = np.asarray(jpe._pack(st, layout, F))[None]
    monkeypatch.undo()

    got = csp.run_split(variant, 0, state, P, n_steps, 5, 10,
                        words=torch.from_numpy(words))
    _compare(got, want, "reference")
    cfg = TableConfig(num_seats=P)
    assert int(ce.unpack_field(got, cfg, "hand_ct").sum()) > int(
        ce.unpack_field(state, cfg, "hand_ct").sum())
    if variant in ("full", *csp.CONTROLS):
        assert torch.equal(got, ce.run_perpetual_prng(
            0, state, P, n_steps, 5, 10, words=torch.from_numpy(words)))


def test_k4_split_full_is_k4_and_every_stub_changes_it(k4_starts):
    """Philox mode: ``full`` and the controls equal K4's plain version for a
    seed, and every stub gives another state."""
    state = k4_starts["mid_hand"]
    k4 = ce.run_perpetual_prng(9, state, P, 32, 5, 10)
    for variant in csp.VARIANTS:
        out = csp.run_split(variant, 9, state, P, 32, 5, 10)
        assert torch.equal(out, k4) == (variant in ("full", *csp.CONTROLS)), \
            variant


@pytest.fixture(scope="module")
def k6_inputs():
    cfg = TableConfig(num_seats=P, rules="standard", bets_impl="levels")
    mid = _mid_hand(cfg, "standard", seed=41)
    assert int(ce.unpack_field(mid, cfg, "pot_amt", 0).ne(0).sum()) > 0
    jparams = [np.asarray(x) for x in tpn.load_params(NET)]
    return {"starts": {"pack_state": cn.initial_packed_state(4, cfg, T,
                                                             "cpu"),
                       "mid_hand": mid},
            "weights": cn.net_weights(tpn.params_from_numpy(jparams), "cpu"),
            "w_refs": (jnp.asarray(jparams[0].T),
                       jnp.asarray(jparams[1]).reshape(-1, 1),
                       jnp.asarray(jparams[2].T),
                       jnp.asarray(jparams[3]).reshape(-1, 1),
                       jnp.asarray(jparams[4].T),
                       jnp.asarray(jparams[5]).reshape(-1, 1))}


@pytest.mark.parametrize("start", ["pack_state", "mid_hand"])
@pytest.mark.parametrize("variant", cns.VARIANTS)
def test_k6_split_plain_matches_jax_under_the_same_stub(monkeypatch,
                                                        k6_inputs, variant,
                                                        start):
    n_steps, net_seats = 32, 0b001001
    state = k6_inputs["starts"][start]
    rng = np.random.default_rng(10 + cns.VARIANTS.index(variant))
    words = rng.integers(0, 1 << 32, cns.split_words_shape(
        variant, T, P, n_steps), dtype=np.int64)
    for mod, name, stub in K6_STUBS[variant]:
        monkeypatch.setattr(mod, name, stub)
    seq = _inject(monkeypatch, words)
    st, layout, F = _jax_state(state, "standard")
    for _ in range(words.shape[0]):
        for _ in range(ce.DEFER):
            rand = jpe._policy_prng(st, P)
            head, _, _ = jpe._head_info(st, P)
            seat = (st["button"] + head) % P
            use_net = ((jnp.full_like(seat, net_seats) >> seat) & 1) != 0
            net = jpe._net_action(st, head, P, 5, 10, k6_inputs["w_refs"])
            st = jpe._step_nosettle(st, jnp.where(use_net, net, rand), P, 5,
                                    10, "standard")
        st = jpe._settle_pass(st, jpe._sample_cards(jpe.TILE, 2 * P + 5),
                              P, 5, 10, "standard", 100, reset_stacks=True)
    assert next(seq, None) is None  # every word consumed, in order
    want = np.asarray(jpe._pack(st, layout, F))[None]
    monkeypatch.undo()

    decisions = torch.zeros(1, dtype=torch.int64)
    got = cns.run_net_split(variant, 0, state, k6_inputs["weights"], P,
                            n_steps, 5, 10, 100, net_seats,
                            words=torch.from_numpy(words),
                            decisions=decisions)
    _compare(got, want, "standard")
    assert int(decisions) > 0
    if variant in ("full", *cns.CONTROLS):
        assert torch.equal(got, cn.run_net_eval(
            0, state, k6_inputs["weights"], P, n_steps, 5, 10, 100,
            "standard", net_seats, words=torch.from_numpy(words)))


def test_k6_split_full_is_k6_and_every_stub_changes_it(k6_inputs):
    """Philox mode: ``full`` and the control equal K6's plain version for a
    seed, and every stub gives another state (es3, whose decisions read the made-hand key
    more than policy_6max_200's do)."""
    state = k6_inputs["starts"]["mid_hand"]
    w = cn.net_weights(tpn.load_params("data/policy_6max_es3.npz"), "cpu")
    k6 = cn.run_net_eval(9, state, w, P, 32, 5, 10, 100, "standard", 1)
    for variant in cns.VARIANTS:
        out = cns.run_net_split(variant, 9, state, w, P, 32, 5, 10, 100, 1)
        assert torch.equal(out, k6) == (variant in ("full", *cns.CONTROLS)), \
            variant


def test_split_wrappers_check_their_inputs(k4_starts, k6_inputs):
    state = k4_starts["pack_state"]
    with pytest.raises(ValueError):
        csp.run_split("nope", 0, state, P, 16, 5, 10)
    with pytest.raises(ValueError):  # the K4 split runs reference rules
        csp.run_split("full", 0, k6_inputs["starts"]["pack_state"], P, 16,
                      5, 10)
    with pytest.raises(ValueError):
        csp.run_split("stub_deal", 0, state, P, 16, 5, 10,
                      words=torch.zeros((1, 17, T), dtype=torch.int64))
    std = k6_inputs["starts"]["pack_state"]
    with pytest.raises(ValueError):
        cns.run_net_split("nope", 0, std, k6_inputs["weights"], P, 16, 5,
                          10, 100, 1)
    with pytest.raises(ValueError):  # the K6 split runs standard rules
        cns.run_net_split("full", 0, state, k6_inputs["weights"], P, 16, 5,
                          10, 100, 1)
    with pytest.raises(ValueError):
        _build.build_probe("split", "nope")
    with pytest.raises(KeyError):
        _build.build_probe("nope", "full")
    assert csp.split_words_shape("stub_policy", T, P, 32) == (2, 17, T)
    assert csp.split_words_shape("stub_deal", T, P, 32) == (2, 32, T)
    assert cns.split_words_shape("stub_net", T, P, 32) == (2, 49, T)
    assert cns.split_words_shape("full", T, P, 32) == \
        cn.net_words_shape(T, P, 32)


def test_split_scripts_run_the_plain_versions_on_the_cpu(capsys):
    """The ported scripts' CPU path: one JSON line a variant, each
    variant's output the plain wrapper's."""
    res = ess.main(["stub_deal", "full", "--tables", str(T), "--steps",
                    "16"], device="cpu")
    assert list(res) == ["stub_deal", "full"]
    cfg = TableConfig(num_seats=P, bets_impl="levels")
    state0 = ess.build_state(cfg, "cpu", T)
    assert torch.equal(res["full"]["out"], ce.run_perpetual_prng(
        ess.SEED, state0, P, 16, 5, 10))
    res2 = ens.main(["stub_net", "--tables", str(T), "--steps", "16"],
                    device="cpu")
    assert res2["stub_net"]["net_decisions"] > 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    assert all(r["device"] == "cpu (plain versions)" and r["hands"] > 0
               for r in (*res.values(), *res2.values()))
