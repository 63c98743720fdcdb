"""The port's emulation of the TPU matmul's bfloat16 inputs
(``policy_net.policy_logits(..., matmul="tpu_bf16")``) against JAX on the
CPU, and the rehearsal of the solver records in both modes.

- Logits: es3, es9 and ``policy_6max_200`` on the features of 256 tables
  of the port's random self-play, against the rehearsal's JAX emulation
  (``tests/rehearse_solver_records.py``: bfloat16-rounded inputs,
  ``Precision.HIGHEST`` products). The two sum each product in another
  order, so a hidden activation within float32 rounding of a bfloat16
  rounding boundary can round to neighbouring bfloat16 values on the two
  sides, and the row's logits then differ by far more than float32
  rounding (es3: 5e-6 of the largest logit). Such rows are counted, at
  most 1 in 64 (one of 256 for each net); every other row is within
  2e-6 of the largest logit (the repo's logit rule,
  ``test_torch_net.py``). Layer by layer, on the same inputs, every row
  is within that rule. The default is bit-equal to the ordered float32
  chain of ``_dense``; the two modes are apart by more than 1e-4 of the
  largest logit somewhere, so the emulation is not the identity.
- Extraction: ``net_river_strategy`` and ``net_turn_river_strategy``
  (stride 24) under ``"tpu_bf16"`` against JAX's with its
  ``policy_logits`` patched to the emulation: the f32 extraction tests'
  1e-5 on all but at most 1% of the strategy rows (the rounding flips
  above: es9's river, 2 rows of 961 at 3e-5), every row within 1e-3.
- ``softened`` equals ``scripts/train_es_kernel.py``'s recipe bit for bit.
- ``tests/rehearse_solver_records.json``: every row with a record has a
  ``tpu_bf16`` block with the row's value keys, and the counts of record
  values each mode reproduces (within 1e-4, ``untrained`` left out) are
  the ones the rehearsal found.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rehearse_solver_records as reh
from montecarlo_tpu.models import distill as jdistill
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.models import river_solver as jr
from montecarlo_tpu.models import turn_solver as jt
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine import step as tstep
from montecarlo_tpu_torch.models import features as tfe
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.models import river_solver as pr
from montecarlo_tpu_torch.models import turn_solver as pt
from montecarlo_tpu_torch.rollout import policy as tpol
from montecarlo_tpu_torch.scripts import train_es_kernel
from test_torch_river_solver import COMBOS
from test_torch_river_solver import node_states as river_nodes
from test_torch_step import port_cfg
from test_torch_turn_solver import BOARD4
from test_torch_turn_solver import node_states as turn_nodes

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

NETS = ["data/policy_6max_es3.npz", "data/policy_6max_es9.npz",
        "data/policy_6max_200.npz"]
NO_SOLVE = ("gap_bb", "br_vs_net_p1_bb", "br_vs_net_p2_bb")
VS_NASH = ("net_p1_vs_nash_bb", "net_p2_vs_nash_bb")


def played_features():
    """[256, NUM_FEATURES]: 256 standard 6-max tables after 24 steps of
    the port's random self-play (seed 22)."""
    st = tstate.init_state(22, port_cfg(6, "standard"), 256, "cpu")
    key = tpol.policy_key(22, 256, tpol.SUB_PERPETUAL, "cpu")
    raises = torch.zeros(256, dtype=torch.int32)
    for i in range(24):
        action = tstep.clamp_action(st, tpol.random_policy(
            tpol.at_step(key, i), st, raises))
        nxt = tstep.step_table(st, action, rules="standard")
        raises = torch.where((nxt.stage != st.stage)
                             | (nxt.hand_idx != st.hand_idx), 0,
                             raises + (action > 0).to(torch.int32))
        st = nxt
    return tfe.state_features(st)


@pytest.fixture(scope="module")
def feats():
    return played_features()


def _bound(logits):
    return 2e-6 * max(1.0, float(np.abs(logits).max()))


def _jax_layers(params, feats):
    """The rehearsal's emulation, layer by layer: (the three products'
    bfloat16-rounded inputs, the logits)."""
    def bf16(x):
        return jnp.asarray(x, jnp.float32).astype(jnp.bfloat16) \
            .astype(jnp.float32)

    hi = jax.lax.Precision.HIGHEST
    x0 = bf16(feats)
    x1 = bf16(jax.nn.relu(jnp.matmul(x0, bf16(params.w1), precision=hi)
                          + params.b1))
    x2 = bf16(jax.nn.relu(jnp.matmul(x1, bf16(params.w2), precision=hi)
                          + params.b2))
    return (x0, x1, x2), jnp.matmul(x2, bf16(params.w3), precision=hi) \
        + params.b3


def _port_layers(params, feats):
    """The same of the port's ``policy_logits(..., "tpu_bf16")``."""
    x0 = tpn._bf16(feats)
    x1 = tpn._bf16(torch.relu(tpn._dense(x0, tpn._bf16(params.w1),
                                         params.b1)))
    x2 = tpn._bf16(torch.relu(tpn._dense(x1, tpn._bf16(params.w2),
                                         params.b2)))
    return (x0, x1, x2), tpn.policy_logits(params, feats, matmul="tpu_bf16")


@pytest.mark.parametrize("path", NETS)
def test_tpu_bf16_logits_match_jax_emulation(feats, path):
    jp, p = jpn.load_params(path), tpn.load_params(path)
    x = jnp.asarray(feats.numpy())
    jin, want = _jax_layers(jp, x)
    np.testing.assert_array_equal(np.asarray(want),
                                  np.asarray(reh.tpu_bf16_logits(jp, x)))
    want = np.asarray(want)
    pin, got = _port_layers(p, feats)
    assert got.dtype == torch.float32 and got.shape == (256, 4)
    flipped = np.zeros(256, bool)
    for j, t in zip(jin, pin):
        flipped |= (np.asarray(j) != t.numpy()).any(1)
    assert flipped.sum() <= 256 // 64
    np.testing.assert_allclose(got.numpy()[~flipped], want[~flipped],
                               rtol=0, atol=_bound(want))

    # layer by layer on the same inputs: only the order of the sums differs
    for k, (w, b) in enumerate(((p.w1, p.b1), (p.w2, p.b2), (p.w3, p.b3))):
        mine = tpn._dense(pin[k], tpn._bf16(w), b)
        theirs = np.asarray(jnp.matmul(
            jnp.asarray(pin[k].numpy()),
            jnp.asarray(tpn._bf16(w).numpy()),
            precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b.numpy()))
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=_bound(theirs), err_msg=f"layer {k}")


@pytest.mark.parametrize("path", NETS)
def test_default_is_the_ordered_f32_chain(feats, path):
    p = tpn.load_params(path)
    h = torch.relu(tpn._dense(feats, p.w1, p.b1))
    h = torch.relu(tpn._dense(h, p.w2, p.b2))
    chain = tpn._dense(h, p.w3, p.b3)
    assert torch.equal(tpn.policy_logits(p, feats), chain)
    assert torch.equal(tpn.policy_logits(p, feats, matmul="f32"), chain)


@pytest.mark.parametrize("path", NETS)
def test_modes_differ(feats, path):
    p = tpn.load_params(path)
    f32 = tpn.policy_logits(p, feats)
    bf16 = tpn.policy_logits(p, feats, matmul="tpu_bf16")
    scale = float(f32.abs().max())
    assert float((f32 - bf16).abs().max()) > 1e-4 * scale


def test_unknown_mode_is_refused(feats):
    with pytest.raises(ValueError, match="matmul"):
        tpn.policy_logits(tpn.load_params(NETS[0]), feats, matmul="bf16")


def _assert_rows_close(want, got):
    """Strategy rows within 1e-5 but at most 1% of them, all within
    1e-3."""
    off = np.concatenate([
        np.abs(g.numpy() - np.asarray(w)).max(-1).ravel()
        for w, g in zip(want, got)])
    assert off.max() <= 1e-3, off.max()
    assert (off > 1e-5).mean() <= 0.01, f"{(off > 1e-5).sum()} of {off.size}"


@pytest.fixture
def jax_tpu_bf16(monkeypatch):
    """The JAX solvers' ``policy_logits`` as the rehearsal patches it."""
    monkeypatch.setattr(jpn, "policy_logits", reh.tpu_bf16_logits)
    monkeypatch.setattr(jdistill, "policy_logits", reh.tpu_bf16_logits)


@pytest.mark.parametrize("path", NETS[:2])
def test_net_river_strategy_tpu_bf16_matches_jax(jax_tpu_bf16, path):
    hero, vill = COMBOS[::5], COMBOS[2::7]
    jstates, pstates = river_nodes()
    want = jr.net_river_strategy(jpn.load_params(path), jstates, hero, vill)
    got = pr.net_river_strategy(tpn.load_params(path), pstates, hero, vill,
                                matmul="tpu_bf16")
    _assert_rows_close(want, got)


@pytest.mark.parametrize("path", NETS[:2])
def test_net_turn_river_strategy_tpu_bf16_matches_jax(jax_tpu_bf16, path):
    combos = jt.turn_combos(BOARD4)[::24]
    jts, jrs, pts, prs, _ = turn_nodes()
    want = jt.net_turn_river_strategy(jpn.load_params(path), jts, jrs,
                                      combos)
    got = pt.net_turn_river_strategy(tpn.load_params(path), pts, prs,
                                     combos, matmul="tpu_bf16")
    _assert_rows_close(want, got)


def test_softened_is_the_train_es_kernel_recipe():
    """``w3`` and ``b3`` divided by the divisor, nothing else touched
    (``scripts/train_es_kernel.py:182-184``), bit for bit; the port's
    script softens through the helper."""
    jp = jpn.load_params("data/policy_6max_es7.npz")
    want = jp._replace(w3=jp.w3 / 20.0, b3=jp.b3 / 20.0)
    got = tpn.softened(tpn.load_params("data/policy_6max_es7.npz"), 20.0)
    for name, g, w in zip(tpn.MLPParams._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert train_es_kernel.softened is tpn.softened
    assert reh.SOFTEN == 20.0
    for name, r, w in zip(tpn.MLPParams._fields, reh.softened(jp), want):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(w),
                                      err_msg=name)


@pytest.fixture(scope="module")
def rehearsal():
    with open("tests/rehearse_solver_records.json") as f:
        return json.load(f)


def test_rehearsal_rows_have_a_tpu_bf16_block(rehearsal):
    rows = [r for r in rehearsal if "record" in r]
    assert len(rows) == len(rehearsal) == 67
    for row in rows:
        values = {k for k in row if k not in reh.NOT_VALUES}
        assert set(row["tpu_bf16"]) == values, row
        for k in values:
            if isinstance(row[k], dict):
                assert set(row["tpu_bf16"][k]) == set(row[k]), (row, k)


def in_mode(row, mode):
    return row if mode == "f32" else row[mode]


def _reproduced(rehearsal, part, keys, mode):
    """(reproduced, total) record values of ``part``'s subject rows,
    ``untrained`` left out."""
    n = total = 0
    for row in rehearsal:
        if row["part"] != part or row.get("subject") in (None, "untrained") \
                or "stride" in row:
            continue
        vals = in_mode(row, mode)
        for k in keys:
            total += 1
            n += abs(vals[k] - row["record"][k]) <= 1e-4 + 1e-9
    return n, total


# (part, value keys) -> {mode: (reproduced, total)}, as the rehearsal
# found them
COUNTS = {
    ("river", NO_SOLVE): {"f32": (19, 60), "tpu_bf16": (60, 60)},
    ("river", VS_NASH): {"f32": (21, 40), "tpu_bf16": (40, 40)},
    ("turn", NO_SOLVE): {"f32": (14, 60), "tpu_bf16": (24, 60)},
    ("stride4", NO_SOLVE): {"f32": (36, 36), "tpu_bf16": (9, 36)},
}


@pytest.mark.parametrize("mode", ["f32", "tpu_bf16"])
@pytest.mark.parametrize("part,keys", list(COUNTS))
def test_rehearsal_counts(rehearsal, part, keys, mode):
    assert _reproduced(rehearsal, part, keys, mode) == COUNTS[part, keys][
        mode]


def test_rehearsal_softened_start(rehearsal):
    """The distillation record's start: es7 as it is reproduces it in
    neither mode (0.3 bb off or more), es7 softened by 20 on both boards
    in f32 and on one in tpu_bf16."""
    rows = [r for r in rehearsal if "distill_result" in r]
    assert len(rows) == 2
    held = {"f32": 0, "tpu_bf16": 0}
    for row in rows:
        rec = row["record"]["gap_bb_start"]
        for mode in held:
            vals = in_mode(row, mode)["distill_result"]
            assert set(vals) == {"gap_bb_start", "gap_bb_distilled",
                                 "gap_bb_start_softened"}
            assert abs(vals["gap_bb_start"] - rec) > 0.3
            held[mode] += abs(vals["gap_bb_start_softened"] - rec) \
                <= 1e-4 + 1e-9
    assert held == {"f32": 2, "tpu_bf16": 1}


def test_rehearsal_br_rows(rehearsal):
    """The BR distillation records (dataset rows and exact edges) are
    f32's: es9's at stride 1 and es7's at stride 4 reproduced there; in
    tpu_bf16 es9's stride-1 dataset differs (453,935 rows against
    453,515) and its edges are 0.004-0.011 bb off."""
    rows = {(r["subject"], r["stride"]): r for r in rehearsal
            if r["part"] == "br"}
    assert set(rows) == {("es9", 1), ("es7", 1), ("es7", 2), ("es7", 3),
                         ("es7", 4)}

    def same(vals, rec):
        return vals["dataset_rows"] == rec["dataset_rows"] and all(
            abs(vals["exact_br_edge_bb"][b] - e) <= 1e-4 + 1e-9
            for b, e in rec["exact_br_edge_bb"].items())

    for key in (("es9", 1), ("es7", 4)):
        assert same(rows[key], rows[key]["record"]), key
    es9 = rows["es9", 1]
    assert es9["tpu_bf16"]["dataset_rows"] == 453935
    assert not same(es9["tpu_bf16"], es9["record"])
