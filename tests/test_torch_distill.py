"""The port's distillation (``montecarlo_tpu_torch/models/distill.py``)
against the JAX module on the CPU, on the toy game of
``tests/test_distill.py`` (the no-raise artifact geometry, three rivers,
every 16th combo).

Both sides read the same states (the port's node states carried into JAX)
and the same solver strategies (JAX's, carried to the port), so every
difference is the module's own:
- ``turn_river_examples`` (Nash and BR targets and reach profiles),
  ``prelude_examples`` and ``stack_examples``: features, targets, masks
  and weights within 1e-6;
- ``_masked_ce`` and its gradient within 1e-6 on the same rows;
- ``distill`` on the same minibatches (one ``np.random.default_rng``
  stream): one Adam step within 1e-6 of JAX's on every entry with a
  gradient above rounding noise, and 20 steps' losses and resulting
  policy within 5e-5 and 1e-4 (Adam scales each entry's step by its own
  gradient's size, so noise-level gradients take rounding-set steps);
- the JAX tests' certificates on the port: the mapping invariants,
  distillation moving the net toward the solver, BR targets.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.models import distill as jd
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.models import turn_solver as jt
from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.models import distill as pd
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.models import turn_solver as pt

from test_torch_river_solver import jax_node, jax_state

torch.set_num_threads(1)

BOARD4 = [make_card(2, 13), make_card(0, 8), make_card(1, 5),
          make_card(3, 2)]
RIVERS = [make_card(2, 12), make_card(0, 3), make_card(1, 9)]


@functools.lru_cache(maxsize=None)
def toy():
    """Both sides' game, node states (port's, and carried into JAX), JAX's
    400-iteration Nash profile and JAX's initial params."""
    pts, prs, sizes, ppre = pt.turn_river_node_states(
        BOARD4, RIVERS, with_prelude=True, device="cpu")
    kw = dict(rivers=RIVERS, combos=jt.turn_combos(BOARD4)[::16],
              pot=sizes["pot"], bet=sizes["bet"],
              river_bets=sizes["river_bets"], turn_raise=False,
              river_raise=False)
    jg, combos = jt.make_turn_river_game(BOARD4, **kw)
    pg, _ = pt.make_turn_river_game(BOARD4, device="cpu", **kw)
    jts = {k: jax_node(v) for k, v in pts.items()}
    jrs = {L: {k: jax_state(v) for k, v in ns.items()}
           for L, ns in prs.items()}
    jpre = {k: jax_node(v) for k, v in ppre.items()}
    nash = jt.solve_turn_river(jg, iterations=400)
    params0 = jpn.init_params(jax.random.key(0))
    return dict(jg=jg, pg=pg, combos=combos, pts=pts, prs=prs, ppre=ppre,
                jts=jts, jrs=jrs, jpre=jpre, nash=nash, params0=params0)


def to_port_strat(strat):
    return pt.TurnRiverStrategy(*(torch.tensor(np.asarray(x))
                                  for x in strat))


def to_port_params(params):
    return tpn.params_from_numpy([np.asarray(x) for x in params])


def profiles(mode):
    """(targets, prof_p1, prof_p2) as JAX strategies: the Nash profile, or
    the best response to es3 and the two mixed profiles."""
    t = toy()
    if mode == "nash":
        return t["nash"], t["nash"], t["nash"]
    sub = jt.net_turn_river_strategy(
        jpn.load_params("data/policy_6max_es3.npz"), t["jts"], t["jrs"],
        t["combos"])
    br = jt.best_response_strategy(t["jg"], sub)
    return br, jt.mix_strategies(br, sub), jt.mix_strategies(sub, br)


def assert_sets_close(want, got, tol=1e-6):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g.feats.numpy(), np.asarray(w.feats),
                                   rtol=0, atol=tol, err_msg=f"feats {i}")
        np.testing.assert_allclose(g.target.numpy(), np.asarray(w.target),
                                   rtol=0, atol=tol, err_msg=f"target {i}")
        np.testing.assert_array_equal(g.fold_masked.numpy(),
                                      np.asarray(w.fold_masked))
        np.testing.assert_allclose(g.weight.numpy(), np.asarray(w.weight),
                                   rtol=tol, atol=tol, err_msg=f"weight {i}")


@functools.lru_cache(maxsize=None)
def examples(mode):
    """(JAX sets, port sets) of one mode."""
    t = toy()
    jprof = profiles(mode)
    want = jd.turn_river_examples(t["jg"], t["combos"], t["jts"], t["jrs"],
                                  *jprof)
    got = pd.turn_river_examples(t["pg"], t["combos"], t["pts"], t["prs"],
                                 *(to_port_strat(p) for p in jprof))
    return want, got


@pytest.mark.parametrize("mode", ["nash", "br"])
def test_turn_river_examples_match_jax(mode):
    want, got = examples(mode)
    assert len(got) == 16   # 4 turn nodes + 3 lines x 4 river nodes
    assert_sets_close(want, got)
    ws, gs = jd.stack_examples(want), pd.stack_examples(got)
    assert_sets_close([ws], [gs])


def test_prelude_examples_match_jax():
    t = toy()
    want = jd.prelude_examples(t["params0"], t["jpre"], t["combos"])
    got = pd.prelude_examples(to_port_params(t["params0"]), t["ppre"],
                              t["combos"])
    assert_sets_close(want, got)


@functools.lru_cache(maxsize=None)
def stacked():
    """(JAX data, JAX anchor) of the Nash mode, stacked."""
    t = toy()
    return (jd.stack_examples(examples("nash")[0]),
            jd.stack_examples(jd.prelude_examples(t["params0"], t["jpre"],
                                                  t["combos"])))


def to_port_set(ex):
    return pd.ExampleSet(*(torch.tensor(np.asarray(x)) for x in ex))


def test_masked_ce_and_gradient_match_jax():
    data, _ = stacked()
    idx = np.random.default_rng(4).integers(0, data.feats.shape[0], 512)
    params0 = toy()["params0"]
    loss, grads = jax.value_and_grad(jd._masked_ce)(params0, data,
                                                    jnp.asarray(idx))
    leaves = [x.clone().requires_grad_(True)
              for x in to_port_params(params0)]
    ploss = pd._masked_ce(tpn.MLPParams(*leaves), to_port_set(data),
                          torch.as_tensor(idx))
    ploss.backward()
    assert float(ploss.detach()) == pytest.approx(float(loss), rel=1e-6,
                                                  abs=1e-6)
    for name, g, leaf in zip(tpn.MLPParams._fields, grads, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_distill_matches_jax():
    """The same minibatches (one ``default_rng`` stream), loss terms and
    Adam: after one step every entry whose first gradient exceeds 1e-5 or
    is 0 (over 80% of each leaf) moved as JAX's within 1e-6; over 20
    steps each step's loss within 5e-5 (logged to 5 decimals) and the
    distilled policy's probabilities on every row within 1e-4. Entries
    whose gradient is rounding noise (1e-10 against a median of 1e-3) are
    not compared: Adam divides each gradient by its own size, so rounding
    sets their step (up to 0.17 lr after one step)."""
    data, anchor = stacked()
    params0 = toy()["params0"]
    kw = dict(batch=512, lr=1e-3, seed=1)
    pdata, panchor = to_port_set(data), to_port_set(anchor)

    rng = np.random.default_rng(kw["seed"])
    idx = jnp.asarray(rng.permutation(data.feats.shape[0])[:kw["batch"]])
    aidx = jnp.asarray(rng.integers(0, anchor.feats.shape[0],
                                    size=min(kw["batch"],
                                             anchor.feats.shape[0])))
    g0 = jax.grad(lambda p: jd._masked_ce(p, data, idx)
                  + jd._masked_ce(p, anchor, aidx))(params0)
    want = jd.distill(params0, data, anchor=anchor, steps=1, **kw)
    got = pd.distill(to_port_params(params0), pdata, anchor=panchor,
                     steps=1, **kw)
    for name, g, w, p in zip(tpn.MLPParams._fields, g0, want, got):
        g = np.asarray(g)
        sure = (np.abs(g) > 1e-5) | (g == 0)
        assert sure.mean() > 0.8, name
        np.testing.assert_allclose(p.numpy()[sure], np.asarray(w)[sure],
                                   rtol=0, atol=1e-6, err_msg=name)

    jlog, plog = [], []
    want = jd.distill(params0, data, anchor=anchor, steps=20,
                      log=jlog.append, log_every=1, **kw)
    got = pd.distill(to_port_params(params0), pdata, anchor=panchor,
                     steps=20, log=plog.append, log_every=1, **kw)
    assert [d["step"] for d in plog] == list(range(20))
    np.testing.assert_allclose([d["loss"] for d in plog],
                               [d["loss"] for d in jlog], rtol=0, atol=5e-5)
    feats = np.asarray(data.feats)
    np.testing.assert_allclose(
        torch.softmax(pd._train_logits(got, pdata.feats), -1).numpy(),
        np.asarray(jax.nn.softmax(jpn.policy_logits(want, feats), -1)),
        rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# The certificates of tests/test_distill.py, on the port
# ---------------------------------------------------------------------------

def test_example_mapping_invariants():
    t = toy()
    data = pd.stack_examples(examples("nash")[1])
    tg, fm = data.target.numpy(), data.fold_masked.numpy()
    assert np.allclose(tg.sum(-1), 1.0, atol=1e-5)
    assert np.all(tg[fm, 0] == 0.0)        # masked fold carries no mass
    assert np.all(tg[:, 2] == 0.0)         # small raise never targeted
    assert np.all(data.weight.numpy() > 0)
    anchor = pd.stack_examples(pd.prelude_examples(
        to_port_params(t["params0"]), t["ppre"], t["combos"]))
    at = anchor.target.numpy()
    assert np.allclose(at.sum(-1), 1.0, atol=1e-5)
    assert np.all(at[anchor.fold_masked.numpy(), 0] < 1e-6)


def test_distill_moves_net_toward_solver():
    t = toy()
    pg, combos = t["pg"], t["combos"]
    params0 = to_port_params(t["params0"])
    nash = to_port_strat(t["nash"])
    data = pd.stack_examples(pd.turn_river_examples(
        pg, combos, t["pts"], t["prs"], nash, nash, nash))
    anchor = pd.stack_examples(pd.prelude_examples(params0, t["ppre"],
                                                   combos))
    losses = []
    params = pd.distill(params0, data, anchor=anchor, steps=400,
                        batch=2048, lr=1e-3, seed=1,
                        log=lambda d: losses.append(d["loss"]),
                        log_every=100)
    assert losses[-1] < 0.6 * losses[0], losses
    gap0 = pt.exploitability_gap(pg, pt.net_turn_river_strategy(
        params0, t["pts"], t["prs"], combos))
    gap1 = pt.exploitability_gap(pg, pt.net_turn_river_strategy(
        params, t["pts"], t["prs"], combos))
    assert gap1 < 0.6 * gap0, (gap0, gap1)
    fm = anchor.fold_masked
    l0 = tpn.fold_masked(tpn.policy_logits(params0, anchor.feats), fm)
    l1 = tpn.fold_masked(tpn.policy_logits(params, anchor.feats), fm)
    assert float((l0.argmax(-1) == l1.argmax(-1)).float().mean()) > 0.9


def test_br_targets_attack_the_subject():
    t = toy()
    pg, combos = t["pg"], t["combos"]
    subject = tpn.init_params(torch.Generator().manual_seed(7))
    sub = pt.net_turn_river_strategy(subject, t["pts"], t["prs"], combos)
    br = pt.best_response_strategy(pg, sub)
    br1, br2 = pt.best_response_values(pg, sub)
    ev1, _ = pt.strategy_values(pg, pt.mix_strategies(br, sub))
    assert ev1 == pytest.approx(br1, abs=1e-3 * max(1.0, abs(br1)))
    assert br1 + br2 - pg.pot >= -1e-3
    data = pd.stack_examples(pd.turn_river_examples(
        pg, combos, t["pts"], t["prs"], br, pt.mix_strategies(br, sub),
        pt.mix_strategies(sub, br)))
    assert np.all(np.isin(data.target.numpy(), [0.0, 1.0]))
