"""The port's table engine (``montecarlo_tpu_torch/engine``) against the JAX
engine, bit for bit, and against K3's plain version.

The same seeded numpy actions and decks drive ``jax.vmap(step_table)``
(``bets_impl="levels"``) and the port's ``step_table`` at 2, 3 and 6 seats
under each rule set; a table whose hand counter moves is redealt from the
injected decks on both sides (``tests/test_pallas_engine.py:_replica``).
Every field but the PRNG key equals JAX's at every step: the tolerance is
0, every output is an integer. The JAX key is a threefry key and the port's
a Philox key, so the first deal of each side differs until ``redeal``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import state as jstate
from montecarlo_tpu.engine import step as jstep
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine import step as tstep
from montecarlo_tpu_torch.engine import replay
from montecarlo_tpu_torch.engine.replay import (
    against_k3,
    decks_from_deals,
    replay_injected,
)
from montecarlo_tpu_torch.ops import cuda_engine as ce

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

RULES = ("reference", "standard", "tournament")


def jax_cfg(P, rules, **kw):
    return jstate.TableConfig(num_seats=P, rules=rules, bets_impl="levels",
                              **kw)


def port_cfg(P, rules, **kw):
    """The port's config of ``jax_cfg``: the levels street form unless
    ``kw`` names another."""
    return tstate.TableConfig(num_seats=P, rules=rules,
                              **{"bets_impl": "levels", **kw})


@functools.lru_cache(maxsize=None)
def jax_fns(rules):
    """The JAX engine over a leading table axis, jitted once per rule set:
    (clamp, step_table, redeal, next_hand, begin_hand)."""
    return (jax.jit(jax.vmap(jstep.clamp_action)),
            jax.jit(jax.vmap(functools.partial(jstep.step_table,
                                               rules=rules))),
            jax.jit(jax.vmap(jstate.redeal)),
            jax.jit(jax.vmap(functools.partial(jstate.next_hand,
                                               rules=rules))),
            jax.jit(jax.vmap(functools.partial(jstate.begin_hand,
                                               rules=rules))))


def jax_init(cfg, T, seed=1):
    keys = jax.random.split(jax.random.key(seed), T)
    return jax.vmap(lambda k: jstate.init_state(k, cfg))(keys)


def jax_numpy(st):
    """A batched JAX state as numpy, its key left out."""
    return jax.tree.map(np.asarray, st._replace(key=np.zeros(())))


def jax_select(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(
        jnp.asarray(pred).reshape((-1,) + (1,) * (x.ndim - 1)), x, y), a, b)


def assert_states_equal(want, got, where=""):
    """Every field but ``key`` of a JAX state (numpy) equals the port's,
    values and kinds (int / bool)."""
    got = tstate.state_to_numpy(got)
    for name in tstate.TableState._fields:
        if name == "key":
            continue
        w, g = getattr(want, name), getattr(got, name)
        pairs = zip(w._fields, w, g) if isinstance(w, tuple) else \
            [("", w, g)]
        for sub, x, y in pairs:
            x = np.asarray(x)
            assert x.shape == y.shape and (x.dtype == bool) == (
                y.dtype == bool), (where, name, sub)
            np.testing.assert_array_equal(y, x, err_msg=f"{where} {name} "
                                                        f"{sub}")


def streams(seed, T, n_steps, hmax):
    """Raw actions (folds 20%, calls 50%, raises of 1..20 15%, raises of
    30..499 15%, which the clamp turns into all-ins) and per-hand decks
    [T, hmax, 52]."""
    rng = np.random.default_rng(seed)
    u = rng.random((n_steps, T))
    small = rng.integers(1, 21, (n_steps, T))
    big = rng.integers(30, 500, (n_steps, T))
    actions = np.where(u < 0.2, -1, np.where(u < 0.7, 0, np.where(
        u < 0.85, small, big))).astype(np.int32)
    decks = np.argsort(rng.random((T, hmax, 52)), axis=-1).astype(np.int32)
    return actions, decks


def run_both(P, rules, T, n_steps, hmax, seed, jcfg, pcfg, on_step=None):
    """Drive the JAX and the port engine on the same streams; call
    ``on_step(i, jax_state, port_state)`` after every step."""
    actions, decks = streams(seed, T, n_steps, hmax)
    clamp, step, redeal, _, _ = jax_fns(rules)
    js = redeal(jax_init(jcfg, T), jnp.asarray(decks[:, 0]))
    ts = tstate.redeal(tstate.init_state(0, pcfg, T, "cpu"),
                       torch.from_numpy(decks[:, 0]))
    if on_step:
        on_step(-1, js, ts)
    for i in range(n_steps):
        ca = clamp(js, jnp.asarray(actions[i]))
        ta = tstep.clamp_action(ts, torch.from_numpy(actions[i]))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ca))
        prev = np.asarray(js.hand_idx)
        js = step(js, ca)
        ts = tstep.step_table(ts, ta, rules=rules)
        hand = np.asarray(js.hand_idx)
        moved = hand != prev
        deck = decks[np.arange(T), np.minimum(hand, hmax - 1)]
        js = jax_select(moved, redeal(js, jnp.asarray(deck)), js)
        ts = tstate._select_tree(torch.from_numpy(moved),
                                 tstate.redeal(ts, torch.from_numpy(deck)),
                                 ts)
        if on_step:
            on_step(i, js, ts)
    return js, ts


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("P", [2, 3, 6])
def test_step_table_trajectories_equal_jax(P, rules):
    stack = 40 if rules == "tournament" else 100
    kw = dict(starting_stack=stack)

    def check(i, js, ts):
        assert_states_equal(jax_numpy(js), ts, f"step {i}")

    js, ts = run_both(P, rules, 32, 64, 16, 10 * P + len(rules),
                      jax_cfg(P, rules, **kw), port_cfg(P, rules, **kw),
                      check)
    assert int(ts.hand_idx.sum()) > 32  # hands completed and redealt
    if rules == "reference":  # the reference lets stacks go negative
        assert int(ts.stacks.min()) < 0
    else:
        assert bool(ts.all_in.any()) or bool(ts.hand_over.any())
    if rules == "tournament":
        assert bool(ts.hand_over.any())  # frozen tables among them


@pytest.mark.parametrize("rules", RULES)
def test_begin_next_hand_and_redeal_equal_jax(rules):
    """On states reached by play (carried across with
    ``state_from_numpy``), ``begin_hand``, ``next_hand`` and ``redeal`` on
    injected decks equal JAX's field by field; under tournament rules with
    tables left one player and frozen tables among them."""
    P, T, hmax = 6, 32, 16
    kw = dict(starting_stack=40 if rules == "tournament" else 100)
    jcfg, pcfg = jax_cfg(P, rules, **kw), port_cfg(P, rules, **kw)
    js, _ = run_both(P, rules, T, 24, hmax, 7, jcfg, pcfg)
    if rules == "tournament":
        # table 0: one player holds every chip; table 1: the big blind's
        # position is dead; table 2: only positions 0 and 4 alive
        stacks = np.asarray(js.stacks).copy()
        stacks[0] = [6 * 40, 0, 0, 0, 0, 0]
        stacks[1] = [60, 0, 60, 60, 60, 0]
        stacks[2] = [100, 0, 0, 0, 140, 0]
        js = js._replace(stacks=jnp.asarray(stacks))
    _, _, redeal, next_hand, begin_hand = jax_fns(rules)
    rng = np.random.default_rng(3)
    deck = np.argsort(rng.random((T, 52)), axis=-1).astype(np.int32)
    ts = tstate.state_from_numpy(jax_numpy(js), device="cpu")
    assert_states_equal(jax_numpy(js), ts, "carried")
    tdeck = torch.from_numpy(deck)
    assert_states_equal(jax_numpy(redeal(js, jnp.asarray(deck))),
                        tstate.redeal(ts, tdeck), "redeal")
    for name, jf, tf in (("begin_hand", begin_hand, tstate.begin_hand),
                         ("next_hand", next_hand, tstate.next_hand)):
        jn = jf(js)
        tn = tf(ts, rules=rules)
        # a frozen table keeps its deck; every other is redealt
        kept = np.asarray(jn.hand_over)
        jd = np.where(kept[:, None], np.asarray(jn.deck), deck)
        assert_states_equal(jax_numpy(redeal(jn, jnp.asarray(jd))),
                            tstate.redeal(tn, torch.from_numpy(jd)), name)
    if rules == "tournament":
        frozen = tstate.next_hand(ts, rules=rules)
        assert bool(frozen.hand_over[0]) and not bool(frozen.hand_over[1:3]
                                                      .any())
        # frozen tables are fixed points of next_hand and step_table
        again = tstate.next_hand(frozen, rules=rules)
        stepped = tstep.step_table(frozen, torch.zeros(T, dtype=torch.int32),
                                   rules=rules)
        for other in (again, stepped):
            one = tstate._select_tree(frozen.hand_over, other, frozen)
            assert_states_equal(tstate.state_to_numpy(frozen), one, "fixed")


def test_init_state_decks_are_seeded_permutations():
    cfg = port_cfg(6, "reference")
    a = tstate.init_state(5, cfg, 64, "cpu")
    b = tstate.init_state(5, cfg, 64, "cpu")
    assert torch.equal(a.deck, b.deck) and torch.equal(a.key, b.key)
    assert torch.equal(a.deck.sort(1).values,
                       torch.arange(52, dtype=torch.int32).expand(64, 52))
    assert len({tuple(d) for d in a.deck.tolist()}) == 64
    assert not torch.equal(tstate.init_state(6, cfg, 64, "cpu").deck, a.deck)
    # the deal follows the deck; hand 1 of a table is a new deck
    assert torch.equal(a.hole[:, :, 0], a.deck[:, :6])
    assert torch.equal(a.community, a.deck[:, [13, 14, 15, 17, 19]])
    nxt = tstate.next_hand(a)
    assert torch.equal(nxt.deck, tstate.shuffled_decks(a.key, a.hand_idx + 1))
    assert not torch.equal(nxt.deck, a.deck)


@pytest.mark.parametrize("kw", [
    dict(small_blind=0, bets_impl="levels"),
    dict(big_blind=-5, bets_impl="levels"), dict(rules="fixed-limit"),
    dict(bets_impl="lists"), dict(num_seats=1)])
def test_init_state_refuses_what_the_levels_engine_cannot_run(kw):
    with pytest.raises(ValueError):
        tstate.init_state(0, tstate.TableConfig(**{"num_seats": 3, **kw}), 4,
                          "cpu")


def _k3_stream(seed, P, T, n_steps, hmax, dense=False):
    """K3's injected stream (tests/test_pallas_engine.py:_streams): folds
    20%, calls 72%, raises of 1..20 8%; ``dense``: calls 40%, raises of
    1..5 40%, which run streets out of layers, some on an all-in call
    that ends the street. And per-hand deals."""
    rng = np.random.default_rng(seed)
    u = rng.random((n_steps, T))
    calls, hi = (0.6, 6) if dense else (0.92, 21)
    actions = np.where(u < 0.20, -1, np.where(
        u < calls, 0, rng.integers(1, hi, (n_steps, T)))).astype(np.int32)
    cards = np.argsort(rng.random((T, hmax, 52)), axis=-1)[..., :2 * P + 5]
    return actions, cards.astype(np.int32)


def k3_cfg(P, rules, stack=100):
    """K3's capacities: 6 street layers under reference rules, 10
    otherwise; 4 streets of pots."""
    L = ce._L_for(rules)
    return port_cfg(P, rules, starting_stack=stack, max_layers=L,
                    max_pot_layers=4 * L)


@pytest.mark.parametrize("rules,stack,dense", [
    ("reference", 100, False), ("standard", 100, False),
    ("tournament", 20, False), ("standard", 30, True),
    ("tournament", 20, True)])
def test_replay_equals_k3_plain(rules, stack, dense):
    """The CPU form of chip_smoke.py's path g at one block: the first
    state equals ``pack_state``'s, and 64 steps of the injected stream
    equal K3's plain version on every table within capacity, with the
    same tables overflowed."""
    P, T, n_steps, hmax = 6, ce.TABLES_PER_BLOCK, 64, 12
    cfg = k3_cfg(P, rules, stack)
    actions, cards = _k3_stream(1 if dense else 11, P, T, n_steps, hmax,
                                dense)
    first = torch.from_numpy(cards[:, 0])
    packed = ce.pack_state(cfg, first)
    st0 = tstate.redeal(tstate.init_state(0, cfg, T, "cpu"),
                        decks_from_deals(first))
    assert replay.against_pack_state(packed, cfg, st0) == []

    out = ce.run_perpetual_det(
        packed, torch.from_numpy(actions.reshape(n_steps, *ce.TILE)[None]),
        torch.from_numpy(cards.transpose(1, 2, 0).reshape(
            hmax, 2 * P + 5, *ce.TILE)[None]), P, n_steps, cfg.small_blind,
        cfg.big_blind, rules=rules)
    rep = replay_injected(cfg, st0, torch.from_numpy(actions),
                          torch.from_numpy(cards))
    agree = against_k3(out, cfg, rep)
    assert torch.equal(agree.k3_overflow, rep.overflow), "overflow sets"
    for name, bad in agree.mismatch.items():
        assert not bool(bad.any()), f"{name}: table {int(bad.nonzero()[0])}"
    assert float(agree.k3_overflow.float().mean()) < 0.1
    assert int(rep.hand_ct.sum()) > T
    if rules == "reference" or dense:  # these streams overflow a few
        assert bool(agree.k3_overflow.any())
    if rules == "tournament":  # busts, frozen tables, ROADMAP C-5
        assert bool((rep.bust_at >= 0).any())
        assert bool(agree.frozen_fresh.any())
    else:
        assert not bool(agree.frozen_fresh.any())


def test_count_engine_ops_script():
    """The op and byte count of a step (scripts/count_engine_ops.py):
    every rule set's step that ends every hand holds the deck's Philox
    operations and more; a step that ends none deals no deck, so it reads
    less than the deck and the ending step."""
    from montecarlo_tpu_torch.scripts import count_engine_ops

    out = count_engine_ops.main(["--tables", "16"])
    deck = out["shuffled_decks"]
    assert deck["ops"] > 52 and deck["written_gb_at_2^20"] > 0
    for rules in RULES:
        ends, continues = out[rules]["ends"], out[rules]["continues"]
        assert ends["ops"] > deck["ops"]
        assert ends["read_gb_at_2^20"] > deck["read_gb_at_2^20"]
        assert continues["read_gb_at_2^20"] < ends["read_gb_at_2^20"]
        assert continues["ops"] < ends["ops"]
