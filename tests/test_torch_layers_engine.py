"""The port's engine in the layers street form (``bets_impl="layers"``,
the default) against the JAX engine's, bit for bit, and against the
port's own levels form and K3's plain version.

- The same seeded numpy actions and decks drive ``jax.vmap(step_table)``
  and the port's ``step_table`` (``test_torch_step.run_both``), both in
  the layers form, at 2, 3 and 6 seats under each rule set: every field
  but the key, the ``Layers`` street and the pots included, equals JAX's
  at every step.
- Zero-chip blinds (0/0, 0/10, 5/0) under reference rules, which the
  levels form refuses: the reference threads the posts unguarded, so a
  zero post makes a zero-amount layer, and JAX's layers engine does the
  same.
- The layers form against the levels form on the same streams: equal
  under ``bets_as_layers`` at every step, overflow latch included.
- A JAX state of a default config (layers form) carried across with
  ``state_from_numpy`` continues equal to JAX.
- ``replay.k3_fields`` of a layers state equals that of the levels state
  it mirrors, and a layers replay equals K3's plain version on every table
  within capacity (the CPU form of ``chip_smoke.py``'s path m2).
Tolerance 0: every output is an integer.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu_torch.engine import replay
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine import step as tstep
from montecarlo_tpu_torch.engine.bets import Layers
from montecarlo_tpu_torch.engine.street import Street, bets_as_layers
from montecarlo_tpu_torch.ops import cuda_engine as ce
from test_torch_step import (
    RULES,
    _k3_stream,
    assert_states_equal,
    jax_fns,
    jax_init,
    jax_numpy,
    jax_select,
    k3_cfg,
    run_both,
    streams,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)


def cfgs(P, rules, **kw):
    """(JAX, port) configs in the layers form."""
    return (JaxTableConfig(num_seats=P, rules=rules, bets_impl="layers",
                           **kw),
            tstate.TableConfig(num_seats=P, rules=rules,
                               bets_impl="layers", **kw))


def test_default_config_is_the_layers_form():
    for cfg in (tstate.TableConfig(num_seats=6),
                tstate.TableConfig(num_seats=6, rules="standard")):
        st = tstate.init_state(0, cfg, 4, "cpu")
        assert isinstance(st.bets, Layers)
        assert st.bets.amt.shape == (4, cfg.max_layers)
    levels = tstate.TableConfig(num_seats=6, bets_impl="levels")
    assert isinstance(tstate.init_state(0, levels, 4, "cpu").bets, Street)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("P", [2, 3, 6])
def test_layers_engine_equals_jax(P, rules):
    kw = dict(starting_stack=40 if rules == "tournament" else 100,
              max_layers=8, max_pot_layers=24)

    def check(i, js, ts):
        assert isinstance(ts.bets, Layers)
        assert_states_equal(jax_numpy(js), ts, f"step {i}")

    js, ts = run_both(P, rules, 32, 64, 16, 30 * P + len(rules),
                      *cfgs(P, rules, **kw), check)
    assert int(ts.hand_idx.sum()) > 32
    if rules == "tournament":
        assert bool(ts.hand_over.any())


@pytest.mark.parametrize("P", [2, 6])
@pytest.mark.parametrize("blinds", [(0, 0), (0, 10), (5, 0)])
def test_zero_chip_blinds_equal_jax(blinds, P):
    sb, bb = blinds
    kw = dict(small_blind=sb, big_blind=bb, max_layers=10,
              max_pot_layers=40)
    zero_layer = []

    def check(i, js, ts):
        assert_states_equal(jax_numpy(js), ts, f"step {i}")
        live = torch.arange(10)[None] < ts.bets.count[:, None]
        zero_layer.append(bool((live & (ts.bets.amt == 0)).any()))

    _, ts = run_both(P, "reference", 24, 48, 12, 7 * P + sb + bb,
                     *cfgs(P, "reference", **kw), check)
    assert zero_layer[0]  # the zero post's layer at the first deal
    assert int(ts.hand_idx.sum()) > 24
    with pytest.raises(ValueError):  # the levels form refuses them
        tstate.init_state(0, tstate.TableConfig(
            num_seats=P, small_blind=sb, big_blind=bb, bets_impl="levels"),
            4, "cpu")


def _redealt(ts, prev, decks, T):
    """Tables whose hand counter moved get the next injected deck (as
    run_both does)."""
    hand = ts.hand_idx.numpy()
    deck = decks[np.arange(T), np.minimum(hand, decks.shape[1] - 1)]
    return tstate._select_tree(ts.hand_idx != prev,
                               tstate.redeal(ts, torch.from_numpy(deck)),
                               ts)


def _both_forms(rules, T, capacity, seed, on_step):
    """The port's levels and layers forms in lockstep on ``streams``'
    actions and decks; ``on_step(i, levels, layers, clean)`` after every
    step, ``clean`` (bool [T]) the tables on which neither form's street
    or pots has overflowed before this step: the forms are
    trajectory-equal there (``tests/test_street.py`` pins it), and a
    dropped layer ends it. Returns the count of tables that overflowed."""
    P = 6
    actions, decks = streams(seed, T, 64, 12)
    kw = dict(num_seats=P, rules=rules, max_layers=capacity,
              max_pot_layers=4 * capacity,
              starting_stack=40 if rules == "tournament" else 100)
    states = [tstate.redeal(tstate.init_state(
        0, tstate.TableConfig(bets_impl=impl, **kw), T, "cpu"),
        torch.from_numpy(decks[:, 0])) for impl in ("levels", "layers")]
    clean = torch.ones(T, dtype=torch.bool)
    on_step(-1, *states, clean)
    for i, a in enumerate(actions):
        nxt = []
        for ts in states:
            stepped = tstep.step_table(
                ts, tstep.clamp_action(ts, torch.from_numpy(a)), rules=rules)
            nxt.append(_redealt(stepped, ts.hand_idx, decks, T))
        states = nxt
        on_step(i, *states, clean)
        for ts in states:
            clean &= ~(ts.bets.overflow | ts.pots.overflow)
    return int((~clean).sum())


@pytest.mark.parametrize("rules", RULES)
def test_layers_form_equals_levels_form(rules):
    """The port's two forms on the same streams, at a capacity that
    overflows some tables: equal under ``bets_as_layers`` at every step,
    every field on the tables that have not overflowed, the overflow
    latches on all of them (the first overflow comes at the same step)."""
    def check(i, lv, ly, clean):
        view = tstate.state_to_numpy(lv._replace(
            bets=bets_as_layers(lv.bets, lv.folded)))
        got = tstate.state_to_numpy(ly)
        keep = clean.numpy()
        for name in tstate.TableState._fields:
            w, g = getattr(view, name), getattr(got, name)
            for sub, x, y in (zip(w._fields, w, g) if isinstance(w, tuple)
                              else [("", w, g)]):
                np.testing.assert_array_equal(
                    y[keep], x[keep], err_msg=f"step {i} {name} {sub}")
        for field in ("bets", "pots"):
            assert torch.equal(getattr(lv, field).overflow[clean],
                               getattr(ly, field).overflow[clean]), i

    assert _both_forms(rules, 64, 4, 5, check) > 0


@pytest.mark.parametrize("rules", RULES)
def test_jax_default_state_carries_across(rules):
    """A JAX batch of ``TableConfig(num_seats=P)`` (the layers form),
    carried across after 16 steps, continues equal to JAX for 32 more."""
    P, T, hmax = 6, 32, 16
    kw = dict(starting_stack=40 if rules == "tournament" else 100)
    jcfg = JaxTableConfig(num_seats=P, rules=rules, **kw)
    assert jcfg.bets_impl == "layers"
    actions, decks = streams(21, T, 48, hmax)
    clamp, step, redeal, _, _ = jax_fns(rules)
    js = redeal(jax_init(jcfg, T), jnp.asarray(decks[:, 0]))

    def advance(js, a):
        prev = np.asarray(js.hand_idx)
        js = step(js, clamp(js, jnp.asarray(a)))
        hand = np.asarray(js.hand_idx)
        deck = decks[np.arange(T), np.minimum(hand, hmax - 1)]
        return jax_select(hand != prev, redeal(js, jnp.asarray(deck)), js)

    for a in actions[:16]:
        js = advance(js, a)
    ts = tstate.state_from_numpy(jax_numpy(js), device="cpu")
    assert isinstance(ts.bets, Layers)
    assert_states_equal(jax_numpy(js), ts, "carried")
    back = tstate.state_to_numpy(ts)
    assert np.array_equal(back.bets.mem, np.asarray(js.bets.mem))
    for i, a in enumerate(actions[16:]):
        js = advance(js, a)
        stepped = tstep.step_table(
            ts, tstep.clamp_action(ts, torch.from_numpy(a)), rules=rules)
        ts = _redealt(stepped, ts.hand_idx, decks, T)
        assert_states_equal(jax_numpy(js), ts, f"step {16 + i}")


@pytest.mark.parametrize("rules", RULES)
def test_k3_fields_of_a_layers_state(rules):
    """``k3_fields`` of the layers form equals the levels form's at every
    step, on every table where the two forms are held equal (past an
    overflow the levels form's contributions need not sit on a kept
    boundary)."""
    compared = []

    def check(i, lv, ly, clean):
        keep = clean & ~ly.bets.overflow
        compared.append(int(keep.sum()))
        want, got = replay.k3_fields(lv), replay.k3_fields(ly)
        for name in want:
            w, g = want[name], got[name]
            assert w.shape == g.shape and w.dtype == g.dtype, name
            assert torch.equal(w[keep], g[keep]), (i, name)

    assert _both_forms(rules, 64, 5, 9, check) > 0
    assert min(compared) > 16


@pytest.mark.parametrize("rules,stack", [("reference", 100),
                                         ("standard", 100)])
def test_layers_replay_equals_k3_plain(rules, stack):
    """The layers form on K3's injected stream at one block: the first
    state equals ``pack_state``'s, and 64 steps equal K3's plain version
    on every table within capacity, with the same tables overflowed."""
    P, T, n_steps, hmax = 6, ce.TABLES_PER_BLOCK, 64, 12
    cfg = dataclasses.replace(k3_cfg(P, rules, stack), bets_impl="layers")
    actions, cards = _k3_stream(13, P, T, n_steps, hmax)
    first = torch.from_numpy(cards[:, 0])
    packed = ce.pack_state(cfg, first)
    st0 = tstate.redeal(tstate.init_state(0, cfg, T, "cpu"),
                        replay.decks_from_deals(first))
    assert isinstance(st0.bets, Layers)
    assert replay.against_pack_state(packed, cfg, st0) == []
    out = ce.run_perpetual_det(
        packed, torch.from_numpy(actions.reshape(n_steps, *ce.TILE)[None]),
        torch.from_numpy(cards.transpose(1, 2, 0).reshape(
            hmax, 2 * P + 5, *ce.TILE)[None]), P, n_steps, cfg.small_blind,
        cfg.big_blind, rules=rules)
    rep = replay.replay_injected(cfg, st0, torch.from_numpy(actions),
                                 torch.from_numpy(cards))
    agree = replay.against_k3(out, cfg, rep)
    assert torch.equal(agree.k3_overflow, rep.overflow), "overflow sets"
    for name, bad in agree.mismatch.items():
        assert not bool(bad.any()), f"{name}: table {int(bad.nonzero()[0])}"
    assert float(agree.k3_overflow.float().mean()) < 0.1
    assert int(rep.hand_ct.sum()) > T


def test_exp_levels_ab_script():
    """The ported A/B script at a small size on the CPU: both variants'
    lines, equal hand counts, final states equal under
    ``bets_as_layers``."""
    from montecarlo_tpu_torch.scripts import exp_levels_ab

    out = exp_levels_ab.main(["--tables", "256", "--steps", "24", "--runs",
                              "1"], device="cpu")
    (ly_line, ly), (lv_line, lv) = out["layers"], out["levels"]
    assert ly_line["hands"] == lv_line["hands"] > 0
    assert ly_line["ns_per_table_step"] > 0
    view = tstate.state_to_numpy(lv._replace(
        bets=bets_as_layers(lv.bets, lv.folded)))
    assert_states_equal(view, ly)
