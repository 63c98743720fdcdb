"""The decision-point analysis (``montecarlo_tpu_torch/scripts/
exp_leak_anatomy.py`` and the scripts on it) against the JAX scripts.

- The numpy statistics (``np_logits`` .. ``decode_attacker``, and
  ``fold_gate_check.v2_usage`` and ``policy_diff.diff_on``) on records of
  the JAX ``collect`` equal the JAX scripts' exactly (tolerance 0: the
  same numpy float32 on the same arrays).
- ``collect`` against a JAX chain of its body (``state_features``,
  ``policy_logits``, the fold mask, ``clamp_action`` + ``step_table``) on
  the port's decks, injected with ``redeal`` as
  ``test_torch_selfplay_chains.py`` does, with bots whose logit margins
  make every pick the argmax: position, free flag, stage and pick equal
  bit for bit; the features within one float32 ulp (XLA's jit multiplies
  by a rounded reciprocal where the port divides, ``models/features.py``).
- ``policy_diff``: two subjects with the same name keep both blocks and
  both fold-gate entries (the JAX script kept one of each).
- ``make_fold_anchor``: the same anchor in two processes with different
  ``PYTHONHASHSEED``s; ``exp_leak_anatomy.main`` end to end.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import step as jstep
from montecarlo_tpu.engine.street import bets_needed as jbets_needed
from montecarlo_tpu.models import bots as jbots
from montecarlo_tpu.models import features as jfeat
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu_torch.models import bots as tbots
from montecarlo_tpu_torch.models.policy_net import load_params
from montecarlo_tpu_torch.scripts import exp_leak_anatomy as ela
from montecarlo_tpu_torch.scripts import fold_gate_check, make_fold_anchor
from montecarlo_tpu_torch.scripts import policy_diff
from test_torch_selfplay import jax_first, port_decks
from test_torch_step import jax_cfg, jax_fns, jax_select, port_cfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
jela = importlib.import_module("scripts.exp_leak_anatomy")


@pytest.fixture(scope="module")
def jax_records():
    """Records of the JAX ``collect``: es9 self-play, 8 tables x 48 steps."""
    cfg = jax_cfg(6, "standard")
    es9 = jpn.load_params("data/policy_6max_es9.npz")
    keys = jax.random.split(jax.random.key(7), 8)
    _, recs = jela.collect(keys, cfg, 48, es9, es9)
    return jela.flatten_recs(recs)


@pytest.mark.parametrize("name", ["es9", "es8", "distill"])
def test_numpy_statistics_equal_jax(jax_records, name):
    feats, seat, free, stage, idx = jax_records
    ours = load_params(f"data/policy_6max_{name}.npz")
    theirs = jpn.load_params(f"data/policy_6max_{name}.npz")
    np.testing.assert_array_equal(ela.np_logits(ours, feats),
                                  jela.np_logits(theirs, feats))
    a, b = ela.masked_argmax(ela.np_logits(ours, feats), free), \
        jela.masked_argmax(jela.np_logits(theirs, feats), free)
    np.testing.assert_array_equal(a[0], b[0])
    (ia, ma, sa), (ib, mb, sb) = (ela.margin_stats(ours, feats, free),
                                  jela.margin_stats(theirs, feats, free))
    np.testing.assert_array_equal(ma, mb)
    assert sa == sb
    assert ela.fold_gate(ours, feats, free) == \
        jela.fold_gate(theirs, feats, free)
    assert ela.es_flip_fraction(ours, feats, free, draws=4) == \
        jela.es_flip_fraction(theirs, feats, free, draws=4)
    assert ela.behavior_hist(stage, idx, seat == 0) == \
        jela.behavior_hist(stage, idx, seat == 0)
    jfg = importlib.import_module("scripts.fold_gate_check")
    assert fold_gate_check.v2_usage(ours, feats, free) == \
        jfg.v2_usage(theirs, feats, free)
    jpd = importlib.import_module("scripts.policy_diff")
    es8, jes8 = (load_params("data/policy_6max_es8.npz"),
                 jpn.load_params("data/policy_6max_es8.npz"))
    assert policy_diff.diff_on(feats, free, stage, ours, es8) == \
        jpd.diff_on(feats, free, stage, theirs, jes8)


def test_flatten_and_decode_equal_jax(jax_records):
    assert ela.FEATURE_NAMES == jela.FEATURE_NAMES
    assert ela.ACTION_NAMES == jela.ACTION_NAMES
    for path, subject in (("data/exploitability_opt_es9.json", "es9"),
                          ("data/exploitability_opt.json", "es3")):
        assert ela.decode_attacker(path, subject) == \
            jela.decode_attacker(path, subject)
    feats = jax_records[0]
    assert feats.shape == (8 * 48, 24) and feats.dtype == np.float32


def _jax_collect_chain(seed, P, T, steps, p0, p1):
    """The JAX ``collect`` body step by step, by argmax, on the port's
    decks."""
    clamp, step, redeal, _, _ = jax_fns("standard")
    feats_of = jax.jit(jax.vmap(jfeat.state_features))
    heads = jax.jit(jax.vmap(jstep.head_info))
    owes = jax.jit(jax.vmap(lambda st, s: jbets_needed(st.bets, s)))
    act = jax.jit(jax.vmap(jpn.action_from_index))
    js = jax_first(jax_cfg(P, "standard"), seed, T, "standard")
    recs = []
    for _ in range(steps):
        feats = feats_of(js)
        seat = heads(js)[0]
        logits = jnp.where((seat == 0)[:, None], jpn.policy_logits(p0, feats),
                           jpn.policy_logits(p1, feats))
        free = owes(js, seat) == 0
        logits = logits.at[:, 0].add(jnp.where(free, -1e9, 0.0))
        idx = jnp.argmax(logits, axis=1)
        action = clamp(js, act(idx, js))
        recs.append([np.asarray(x) for x in (feats, seat, free, js.stage,
                                             idx)])
        prev = np.asarray(js.hand_idx)
        js = step(js, action)
        moved = np.asarray(js.hand_idx) != prev
        deck = jnp.asarray(port_decks(seed, T, js.hand_idx).numpy())
        js = jax_select(moved, redeal(js, deck), js)
    return [np.stack(c, axis=1) for c in zip(*recs)]


@pytest.mark.parametrize("P,bot0,rest", [(6, "minraisebot", "callbot"),
                                         (3, "potraisebot", "callbot"),
                                         (2, "callbot", "minraisebot")])
def test_collect_equals_jax_chain_on_the_ports_decks(P, bot0, rest):
    seed, T, steps = 40 + P, 16, 40
    want = _jax_collect_chain(seed, P, T, steps, jbots.panel()[bot0],
                              jbots.panel()[rest])
    _, got = ela.collect(seed, port_cfg(P, "standard"), steps,
                         tbots.panel()[bot0], tbots.panel()[rest], T, "cpu")
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1.2e-7,
                               atol=0)
    for name, a, b in zip(("seat", "free", "stage", "idx"), got[1:],
                          want[1:]):
        np.testing.assert_array_equal(a.numpy(), b.astype(a.numpy().dtype),
                                      err_msg=name)
    assert len(np.unique(want[2])) == 2 and len(np.unique(want[3])) > 1


def test_policy_diff_keeps_both_subjects_of_one_name(tmp_path):
    """The JAX script writes both subjects' blocks under one key when their
    names collide, so one overwrites the other; the port keeps both."""
    save = tmp_path / "diff.json"
    doc = policy_diff.main(["--a", "es=data/policy_6max_es9.npz", "--b",
                            "es=data/policy_6max_es8.npz", "--tables", "4",
                            "--steps", "24", "--save", str(save)],
                           device="cpu")
    blocks = [k for k in doc if k.startswith("on_")]
    assert blocks == ["on_es_a_selfplay", "on_es_b_selfplay"]
    for k in blocks:
        assert set(doc[k]["fold_gate"]) == {"es_a", "es_b"}
    assert doc["on_es_a_selfplay"] != doc["on_es_b_selfplay"]
    assert json.loads(save.read_text())["on_es_b_selfplay"]["decisions"] \
        == 4 * 24
    assert policy_diff.subject_tags("x", "y") == ("x", "y")


def test_exp_leak_anatomy_main(tmp_path, capsys):
    """The report end to end at a tiny size, on the JAX script's keys."""
    save = tmp_path / "leak.json"
    out = ela.main(["--tables", "2", "--steps", "24", "--save", str(save)],
                   device="cpu")
    assert json.loads(save.read_text()) == json.loads(json.dumps(out))
    assert set(out) == {"tables", "steps", "seed", "sixmax", "vs_attacker",
                        "attacker_decode", "hu"}
    assert set(out["sixmax"]) == {"es3", "es4", "es3_vs_es4_argmax_disagree"}
    assert out["vs_attacker"]["attacker_behavior"]["preflop"]["decisions"]
    assert "hu300" in out["hu"]
    assert '"collected_6max_selfplay": 48' in capsys.readouterr().out


ANCHOR = """
import json, sys, torch
torch.set_num_threads(1)
from montecarlo_tpu_torch.scripts import make_fold_anchor as m
meta = m.main(["--subject", "data/policy_6max_es8.npz", "--tables", "4",
               "--steps", "32", "--save", sys.argv[1]], device="cpu")
print(json.dumps([m.profile_seed(11, "distill"),
                  m.profile_seed(11, "subject"), meta]))
"""


def test_make_fold_anchor_is_the_same_in_every_process(tmp_path):
    outs = []
    for hashseed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": hashseed,
               "PYTHONPATH": str(ROOT)}
        path = tmp_path / f"anchor{hashseed}.npz"
        run = subprocess.run([sys.executable, "-c", ANCHOR, str(path)],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300, check=True)
        outs.append(json.loads(run.stdout.strip().splitlines()[-1]))
        outs[-1].append(np.load(path)["feats"].tolist())
    assert outs[0] == outs[1]
    assert outs[0][0] == 11 + make_fold_anchor.zlib.crc32(b"distill") % 1000
    assert outs[0][2]["rows"] > 0
