"""The ported training and exploitability scripts
(``montecarlo_tpu_torch/scripts/``) on the CPU, through the kernels' plain
versions, at one block of tables (1024) and a few steps.

- Each of ``league_eval``, ``exploit_probe``, ``opt_bot``,
  ``train_es_kernel``, ``train_policy``, ``train_br``, ``eval_attacker``
  and ``train_mix`` runs its ``main`` end to end with ``device="cpu"``.
- The JSON lines it prints use only keys that the JAX script's own dict
  literals name (its f-string keys as patterns), and its result line has
  the JAX result's keys exactly.
- ``league_eval``'s self-check holds (identical banks on B7's plain
  version equal the single net on K6's).
- ``resolve_opponent`` takes every spec: random, bot:, optbot:,
  adaptive:, an artifact path, each with @lone.
- No ported script writes to ``data/`` by default: every ``--save`` is
  required (``train_policy``'s defaults to no save; ``league_eval`` only
  prints), and each script takes exactly its JAX twin's options.
"""

import ast
import importlib
import json
import re

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.models import bots
from montecarlo_tpu_torch.scripts import (
    eval_attacker,
    exploit_probe,
    league_eval,
    opt_bot,
    train_br,
    train_es_kernel,
    train_mix,
    train_policy,
)

torch.set_num_threads(1)

T = "1024"
SCRIPTS = ("league_eval", "exploit_probe", "opt_bot", "train_es_kernel",
           "train_policy", "train_br", "eval_attacker", "train_mix",
           "exp_leak_anatomy", "fold_gate_check", "policy_diff",
           "make_fold_anchor")


def _pattern(fstring):
    """An f-string key as a regular expression."""
    return "".join(re.escape(v.value) if isinstance(v, ast.Constant)
                   else ".+" for v in fstring.values)


def _jax_dicts(name):
    """The dict literals of the JAX script: (constant keys, f-string key
    patterns, whether it spreads another dict) of each; then the keys it
    sets by subscript or ``.update(key=...)``, as one more entry."""
    tree = ast.parse(open(f"scripts/{name}.py").read())
    out, later = [], set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and isinstance(node.slice, ast.Constant):
            later.add(node.slice.value)
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "update":
            later |= {k.arg for k in node.keywords if k.arg}
        if isinstance(node, ast.DictComp) and isinstance(node.key,
                                                         ast.JoinedStr):
            out.append((set(), {_pattern(node.key)}, True))
        if isinstance(node, ast.Dict):
            keys, pats = set(), set()
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
                elif isinstance(k, ast.JoinedStr):
                    pats.add(_pattern(k))
            out.append((keys, pats, None in node.keys))
    return out + [(later, set(), True)]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _check_keys(name, text, marker):
    """Every printed key is one the JAX script's dicts name, and the last
    line with ``marker`` has the keys of a JAX dict literal holding it
    (at least them where that literal spreads another dict)."""
    dicts = _jax_dicts(name)
    keys = set().union(*(k for k, _, _ in dicts))
    pats = [re.compile(p) for _, ps, _ in dicts for p in ps]
    lines = _json_lines(text)
    assert lines
    for line in lines:
        for k in line:
            assert k in keys or any(p.fullmatch(k) for p in pats), (name, k)
    got = [set(line) for line in lines if marker in line][-1]
    assert any(marker in k and (k <= got if spread or pats else k == got)
               for k, pats, spread in dicts), (name, got)


def test_league_eval_selfcheck_and_keys(monkeypatch, capsys):
    monkeypatch.setattr(league_eval, "SELFCHECK_TABLES", 1024)
    monkeypatch.setattr(league_eval, "SELFCHECK_STEPS", 32)
    res = league_eval.main(["--a", "data/policy_6max_es9.npz", "--b",
                            "data/policy_6max_es8.npz", "--tables", T,
                            "--steps", "32"], device="cpu")
    assert res["selfcheck_exact"] is True and min(res["selfcheck_hands"])
    assert res["hands"] > 0 and len(res["per_seat_bb_per_hand"]) == 6
    assert abs(res["A_mean_bb"] + res["B_mean_bb"]) < 1e-3
    out = capsys.readouterr().out
    _check_keys("league_eval", out, "edge_A_minus_B")
    _check_keys("league_eval", out, "selfcheck_exact")


def test_exploit_probe_both_geometries(tmp_path, capsys):
    save = tmp_path / "probe.json"
    doc = exploit_probe.main(
        ["--subjects", "es9=data/policy_6max_es9.npz", "--tables", T,
         "--steps", "8", "--geometry", "both", "--save", str(save)],
        device="cpu")
    assert json.loads(save.read_text()) == doc
    sub = doc["subjects"]["es9"]
    assert set(sub["per_bot"]) == set(bots.panel())
    assert sub["exploitability_lb_bb"] == max(
        r["max_bb"] for r in sub["per_bot"].values())
    _check_keys("exploit_probe", capsys.readouterr().out,
                "exploitability_lb_bb")


def test_opt_bot_runs_both_families(tmp_path, capsys):
    save = tmp_path / "opt.json"
    doc = opt_bot.main(
        ["--subjects", "es9=data/policy_6max_es9.npz", "--pairs",
         "3:0,3:1:0", "--generations", "2", "--popsize", "4", "--tables", T,
         "--steps", "8", "--eval-tables", T, "--eval-steps", "8",
         "--holdout-every", "1", "--save", str(save)], device="cpu")
    rows = doc["subjects"]["es9"]["per_pair"]
    assert len(rows["3:0"]["x"]) == opt_bot.spec_dim((3, 0))
    assert len(rows["3:1:0"]["x"]) == opt_bot.spec_dim((3, 1, 0))
    assert doc["subjects"]["es9"]["best_pair"] in rows
    _check_keys("opt_bot", capsys.readouterr().out, "adaptive_bot_lb_bb")


def test_eval_attacker(tmp_path, capsys):
    save = tmp_path / "att.json"
    out = eval_attacker.main(
        ["--attacker", "data/br_solver_vs_es7.npz", "--subject",
         "es7=data/policy_6max_es7.npz", "--tables", T, "--steps", "16",
         "--save", str(save)], device="cpu")
    assert json.loads(save.read_text()) == out
    _check_keys("eval_attacker", capsys.readouterr().out,
                "attacker_artifact")


def test_train_es_kernel_pool_leash_and_adaptive(monkeypatch, tmp_path,
                                                 capsys):
    monkeypatch.setattr(train_es_kernel, "EVAL_TABLES", 1024)
    monkeypatch.setattr(train_es_kernel, "EVAL_STEPS", 8)
    save = str(tmp_path / "es.npz")
    summary = train_es_kernel.main(
        ["--generations", "2", "--pop", "2", "--tables", T, "--steps", "8",
         "--opponents", "random,bot:jam_loose,adaptive:3-0@lone",
         "--adapt-every", "2", "--adapt-gens", "1", "--adapt-popsize", "4",
         "--adapt-tables", T, "--fold-anchor", "data/fold_anchor.npz",
         "--save", save], device="cpu")
    from montecarlo_tpu_torch.models.leash import make_anchor_score
    from montecarlo_tpu_torch.models.policy_net import load_params

    score, _ = make_anchor_score("data/fold_anchor.npz")
    assert summary["start_anchor_logp"] == score(
        load_params("data/policy_6max_200.npz"))
    assert summary["generations"] == 2
    for a, b in zip(load_params(save), summary["result"].params):
        assert torch.equal(a, b)
    _check_keys("train_es_kernel", capsys.readouterr().out, "pool_mean_bb")


def test_train_es_kernel_population_and_per_candidate(monkeypatch, tmp_path,
                                                      capsys):
    monkeypatch.setattr(train_es_kernel, "EVAL_TABLES", 1024)
    monkeypatch.setattr(train_es_kernel, "EVAL_STEPS", 8)
    for extra in ([], ["--per-candidate", "--mask", "w3,b3"]):
        train_es_kernel.main(
            ["--generations", "1", "--pop", "1", "--tables", T, "--steps",
             "8", "--start", "data/policy_6max_es3.npz", "--save",
             str(tmp_path / f"es{len(extra)}.npz"), *extra], device="cpu")
    _check_keys("train_es_kernel", capsys.readouterr().out,
                "bb_per_hand_seat0")


def test_train_policy_heads_up(monkeypatch, capsys):
    monkeypatch.setattr(train_policy, "DUP_TABLES", 128)
    res = train_policy.main(["--steps", "2", "--tables", "64"],
                            device="cpu")
    assert res["history"].shape == (2,)
    assert set(res["edges"]) == {"untrained", "trained"}
    assert "reward bb/hand: first10=" in capsys.readouterr().out


def test_train_br_runs_and_resumes(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(train_br, "EVAL_TABLES", 1024)
    monkeypatch.setattr(train_br, "EVAL_STEPS", 8)
    save = str(tmp_path / "br.npz")
    argv = ["--opponent", "es9=data/policy_6max_es9.npz", "--tables", "64",
            "--eval-every", "1", "--save", save]
    res = train_br.main(argv + ["--updates", "1"], device="cpu")
    assert res["overflowed_tables"] == 0 and len(res["train_bb"]) == 1
    res = train_br.main(argv + ["--updates", "2", "--resume"], device="cpu")
    assert len(res["train_bb"]) == 1  # resumed after update 1
    assert json.loads(open(save + ".result.json").read())["updates"] == 2
    _check_keys("train_br", capsys.readouterr().out,
                "learned_br_bb_per_hand")


def test_train_mix_pool(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(train_es_kernel, "EVAL_STEPS", 8)
    out = train_mix.main(["--updates", "3", "--tables", "64",
                          "--eval-every", "2", "--eval-tables", T,
                          "--save", str(tmp_path / "mix.npz")], device="cpu")
    assert set(out["per_opponent"]) == {"bot:fof_raise", "self", "random"}
    _check_keys("train_mix", capsys.readouterr().out, "final_slack_bb")


def test_resolve_opponent_every_spec(tmp_path):
    r = train_es_kernel.resolve_opponent
    assert r("random") == ("random", None, "five")
    assert r("adaptive:3-1-0@lone") == ("adaptive:3-1-0", None, "lone")
    tag, params, geom = r("bot:fof_raise@lone")
    assert geom == "lone"
    for a, b in zip(params, bots.panel()["fof_raise"]):
        assert torch.equal(a, b)
    tag, params, geom = r("data/policy_6max_es9.npz")
    assert geom == "five" and params.w1.shape == (24, 64)
    x = np.round(np.linspace(-1, 1, opt_bot.spec_dim((1, 0))), 4)
    path = tmp_path / "o.json"
    path.write_text(json.dumps({"subjects": {"s": {
        "best_pair": "1:0", "per_pair": {"1:0": {"x": list(x)}}}}}))
    tag, params, geom = r(f"optbot:{path}:s")
    for a, b in zip(params, opt_bot.make_bot(x, (1, 0))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", SCRIPTS)
def test_no_default_writes_into_data(name):
    mod = importlib.import_module(f"montecarlo_tpu_torch.scripts.{name}")
    actions = {a.dest: a for a in mod.parser()._actions}
    save = actions.get("save")
    if name == "league_eval":  # prints only, as the JAX script
        assert save is None
    elif name == "train_policy":
        assert save.default == ""
    else:
        assert save.required and save.default is None
    jax_opts = {o for o in re.findall(r'add_argument\("(--[a-z0-9-]+)"',
                                      open(f"scripts/{name}.py").read())}
    ours = {o for a in actions.values() for o in a.option_strings
            if o.startswith("--") and o != "--help"}
    assert ours == jax_opts, ours ^ jax_opts
