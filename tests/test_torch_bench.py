"""The port's measurement entry points on the CPU: ``scripts/bench.py`` and
the ported ``bench_*`` scripts (``montecarlo_tpu_torch/scripts/``).

- ``bench.main`` with ``--device cpu`` at small sizes prints one stdout
  line whose keys are exactly the root ``bench.py``'s (read from its
  source with ``ast``: importing it would configure JAX's compile cache),
  and its stderr line's equity is within 4 sigma of ``equity_exact``.
- ``bench_es_generation``'s candidates equal the JAX script's arrays bit
  for bit: ``scripts/bench_net_throughput.py`` is loaded from its file
  (``importlib``) with its kernel call replaced by one that records the
  candidates it is given.
- The CPU forms of the bench scripts give what the plain calls they wrap
  give for the same seeds.
"""

import importlib.util
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.rollout import equity as teq
from montecarlo_tpu_torch.rollout import selfplay as tsp
from montecarlo_tpu_torch.scripts import bench
from montecarlo_tpu_torch.scripts import bench_kernel_engine as bke
from montecarlo_tpu_torch.scripts import bench_net_throughput as bnt
from montecarlo_tpu_torch.scripts import bench_perpetual as bpp
from montecarlo_tpu_torch.scripts import bench_selfplay as bsp

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
T = ce.TABLES_PER_BLOCK
ES3 = "data/policy_6max_es3.npz"
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")
SMALL = ["--device", "cpu", "--equity-rollouts", str(1 << 16),
         "--launches", "1", "--tables", str(T), "--steps", "32",
         "--sweep-rollouts", "256", "--net-tables", str(T), "--net-steps",
         "16", "--train-tables", str(T), "--train-steps", "16", "--pop", "1"]


def bench_keys() -> set:
    """The keys of the root ``bench.py``'s stdout line
    (``bench.reference_keys``)."""
    return bench.reference_keys(ROOT / "bench.py")


def test_bench_keys_read_from_the_root_script():
    assert bench_keys() == {
        "metric", "value", "unit", "vs_baseline", "betting_hands_per_sec",
        "betting_rules", "betting_tables", "betting_steps_per_hand",
        "betting_ns_per_table_step", "betting_backend",
        "sweep169_seconds_warm", "sweep169_rollouts",
        "net_eval_hands_per_sec", "net_eval_tables", "train_hands_per_sec",
        "train_pop"}


def test_bench_cpu_prints_bench_keys_and_the_exact_equity(capsys):
    out = bench.main(SMALL)
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == bench_keys()
    assert all(v is not None for v in out.values())
    assert out["betting_backend"] == "plain"
    assert out["betting_rules"] == "reference"
    assert out["betting_tables"] == T and out["train_pop"] == 2
    assert out["sweep169_rollouts"] == 169 * 256
    assert out["vs_baseline"] == out["value"] / bench.NORTH_STAR
    diag = json.loads(captured.err.strip().splitlines()[-1])
    assert diag["backend"] == "plain" and diag["device"] == "cpu"
    n = diag["rollouts"]
    assert n == 1 << 16
    hero, villain = [teq.make_card(0, 14), teq.make_card(0, 13)], \
        [teq.make_card(1, 12), teq.make_card(2, 12)]
    ex = teq.equity_exact(hero, villain, device="cpu")
    exact = (ex.wins + 0.5 * ex.ties) / ex.n
    sigma = np.sqrt(exact * (1 - exact) / n)
    assert abs(diag["equity_AKs_vs_QQ"] - exact) < 4 * sigma


def test_bench_plain_axes_equal_the_plain_calls():
    """The CPU axes: the equity counts are ``equity_vs_hand``'s for the
    timed seed, and the plain engine's hands ``play_hands_perpetual``'s
    with no overflow (``_run_selfplay`` asserts it)."""
    hero, villain = [0, 12], [25, 38]
    best, w, t, m, backend = bench._run_xla(hero, villain, 4096)
    assert backend == "plain" and m == 4096 and best > 0
    r = [teq.equity_vs_hand(s, hero, villain, 4096, device="cpu")
         for s in (1, 2, 3)]
    assert (w, t) in [(x.wins, x.ties) for x in r]
    b = bench._run_selfplay(T, 24)
    cfg = TableConfig(num_seats=6, max_layers=8, max_pot_layers=16)
    hands = {int(tsp.play_hands_perpetual(s, cfg, T, 24, device="cpu")[1])
             for s in (1, 2, 3)}
    assert round(T * 24 / b["betting_steps_per_hand"]) in hands
    assert b["betting_backend"] == "plain"


@pytest.fixture(scope="module")
def jax_net_script():
    """``scripts/bench_net_throughput.py`` loaded from its file. Its import
    points JAX's compile cache at its TPU directory and makes that
    directory: both are undone, so the other tests of this process keep
    their cache and nothing is written outside the checkout."""
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    makedirs = os.makedirs
    os.makedirs = lambda *a, **k: None
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_bench_net_throughput",
            ROOT / "scripts" / "bench_net_throughput.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.makedirs = makedirs
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _recorder(calls, hands_of):
    def pop(s, cfg, cands, net_seats, n_tables, n_steps, state0=None):
        calls.append(cands)
        return None, None, hands_of(len(cands))
    return pop


def test_es_candidates_equal_the_jax_scripts_bit_for_bit(monkeypatch,
                                                         jax_net_script):
    pop = 3
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_net_script, "initial_packed_state",
                        lambda *a, **k: None)
    monkeypatch.setattr(jax_net_script, "selfplay_net_eval_pop",
                        _recorder(jax_calls, lambda c: np.ones(c)))
    jax_net_script.bench_es_generation(
        JaxTableConfig(num_seats=6, rules="standard"),
        jpn.load_params(ES3), T, 16, pop=pop, reps=1)
    monkeypatch.setattr(bnt, "initial_packed_state", lambda *a, **k: None)
    monkeypatch.setattr(bnt, "selfplay_net_eval_pop",
                        _recorder(port_calls, lambda c: np.ones(c)))
    params = tpn.load_params(ES3)
    bnt.bench_es_generation(TableConfig(num_seats=6, rules="standard"),
                            params, T, 16, pop=pop, reps=1, device="cpu")
    assert len(jax_calls) == len(port_calls) == 2  # warm-up, one timed
    want = [[np.asarray(x) for x in c] for c in jax_calls[0]]
    assert len(want) == 2 * pop
    for calls in (port_calls[0], port_calls[1], jax_calls[1]):
        for got, ref in zip(calls, want):
            for g, r in zip(got, ref):
                g = np.asarray(g)
                assert g.dtype == r.dtype == np.float32
                np.testing.assert_array_equal(g.view(np.int32),
                                              r.view(np.int32))
    cands = bnt.es_candidates(params, pop)
    for got, ref in zip(cands, want):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.view(np.int32), r.view(np.int32))
    assert not np.array_equal(cands[0][0], cands[1][0])


def test_net_bench_cpu_forms_equal_the_plain_calls():
    cfg = TableConfig(num_seats=6, rules="standard")
    params = tpn.load_params(ES3)
    r = bnt.bench_net_eval(cfg, params, T, 16, seed=11, reps=1,
                           device="cpu")
    assert r["net_eval_hands"] == cn.selfplay_net_eval_kernel(
        12, cfg, params, 1, T, 16,
        state0=cn.initial_packed_state(11, cfg, T, "cpu"))[2] > 0
    r = bnt.bench_es_generation(cfg, params, T, 16, pop=1, seed=13, reps=1,
                                device="cpu")
    cands = [tpn.params_from_numpy(c) for c in bnt.es_candidates(params, 1)]
    hands = cn.selfplay_net_eval_pop(
        14, cfg, cands, 1, T, 16,
        state0=cn.initial_packed_state(13, cfg, T, "cpu"))[2]
    assert r["train_hands"] == int(hands.sum()) > 0 and r["train_pop"] == 2


def test_kernel_engine_bench_cpu_forms_equal_the_plain_calls(capsys):
    cfg = TableConfig(num_seats=6)
    out = bke.main(["--tables", str(T), "--steps", "32"], device="cpu")
    state0 = ce.pack_state(cfg, ce.first_deal(0, T, 6, "cpu"))
    hands = {int(ce.unpack_field(ce.run_perpetual_prng(
        s, state0, 6, 32, 5, 10), cfg, "hand_ct").sum()) for s in (1, 2, 3)}
    assert out["hands_completed"] in hands and out["rules"] == "reference"
    smoke = bke.main(["--smoke", "--rules", "standard"], device="cpu")
    std = TableConfig(num_seats=6, rules="standard")
    state, h, ovf = ce.selfplay_perpetual_kernel(3, std, T, 64,
                                                 steps_per_launch=64,
                                                 device="cpu")
    assert (smoke["hands"], smoke["overflow_tables"]) == (h, ovf)
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(x)["mode"] for x in lines] == ["kernel_perpetual",
                                                       "smoke"]


def test_selfplay_and_perpetual_bench_cpu_forms_equal_the_plain_calls():
    cfg = TableConfig(num_seats=6)
    out = bsp.main(["--tables", "64"], device="cpu")
    final = tsp.play_hands(2, cfg, 64, num_hands=1, device="cpu")
    assert out["completed_frac"] == 1.0
    assert round(out["actions_per_sec"] * out["seconds"]) == \
        int(final.time.sum())
    perp, one = bpp.main(["--tables", "64", "--steps", "40"], device="cpu")
    hands = {int(tsp.play_hands_perpetual(s, cfg, 64, 40, device="cpu")[1])
             for s in (1, 2, 3)}
    assert perp["hands_completed"] in hands
    st = bpp.perpetual_scan(5, cfg, 64, 40, "cpu")
    want = tsp.play_hands_perpetual(5, cfg, 64, 40, device="cpu")[0]
    assert torch.equal(st.stacks, want.stacks)
    assert torch.equal(st.hand_idx, want.hand_idx)
    assert one["tables"] == 64 and one["hands_per_sec"] > 0
