"""The probes' plain versions against the JAX probe scripts.

Both scripts are loaded from their files in ``scripts/`` (importlib), not
copied. Carry: the three Pallas kernels of ``scripts/exp_carry_model.py``
run in interpret mode (the script's ``pl`` replaced by a namespace whose
``pallas_call`` interprets) at ``N_BLOCKS = 2`` and ``N_STEPS = 8``, and
must equal the port's plain version exactly. Stages: each ``v_*`` of
``scripts/debug_kernel_compile.py`` runs a few steps on one block with
``pallas_engine.pltpu`` replaced by a stub whose ``prng_random_bits``
returns injected words, and the port's plain stage on the same words must
equal it field by field, from ``pack_state`` and from a mid-hand state.
"""

import functools
import importlib.util
import json
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from montecarlo_tpu.ops import pallas_engine as jpe
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_carry as cc
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_stages as cs
from montecarlo_tpu_torch.scripts import debug_kernel_compile as dkc
from montecarlo_tpu_torch.scripts import exp_carry_model as ecm

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
T = ce.TABLES_PER_BLOCK
P = 6
JAX_CACHE_KEYS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def carry_script():
    """The carry script with interpret-mode kernels at a small size. Its
    import points JAX's compile cache at its TPU directory and makes that
    directory: both are undone, so the other tests of this process keep
    their cache and nothing is written outside the checkout."""
    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_KEYS}
    makedirs = os.makedirs
    os.makedirs = lambda *a, **k: None
    try:
        mod = _load_script("exp_carry_model")
    finally:
        os.makedirs = makedirs
        for k, v in saved.items():
            jax.config.update(k, v)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    mod.N_BLOCKS, mod.N_STEPS = 2, 8
    return mod


def _words_that_wrap(R, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2**31, 2**31, (2, R, *ce.TILE)).astype(np.int32)
    x[0, 0, 0, :4] = [2**31 - 1, 2**31 - 5, -1, -2**31]
    return x


@pytest.mark.parametrize("form,name,R", [
    ("array", "carry_array", 16), ("array", "carry_array", 36),
    ("array", "carry_array", 70), ("array", "carry_array", 141),
    ("dict", "carry_dict", 141), ("ref", "ref_resident", 141)])
def test_carry_plain_matches_jax_kernel(carry_script, form, name, R):
    x = _words_that_wrap(R, R)
    want = np.asarray(getattr(carry_script, name)(R)(jnp.asarray(x)))
    got = cc.carry(form, torch.from_numpy(x), carry_script.N_STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_carry_checks_its_inputs():
    x = torch.zeros((1, 141, *ce.TILE), dtype=torch.int32)
    for form, bad in (("nope", x), ("dict", x[:, :16]),
                      ("array", x[:, :15]), ("ref", x.to(torch.int64))):
        with pytest.raises(ValueError):
            cc.carry(form, bad, 4)
    assert torch.equal(cc.carry("array", x, 0), x)


@pytest.fixture(scope="module")
def stage_script():
    return _load_script("debug_kernel_compile")


def _mid_hand_state(n_steps=20, seed=37):
    """Tables after ``n_steps`` K3 steps (the plain version, held equal to
    JAX's run_perpetual_det by tests/test_torch_engine.py) on an injected
    stream: hands under way, pots on the table, some tables overflowed."""
    rng = np.random.default_rng(seed)
    u = rng.random((n_steps, T))
    acts = np.where(u < 0.2, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    deal = np.argsort(rng.random((T, 4, 52)), axis=-1)[..., :2 * P + 5]
    cards = deal.transpose(1, 2, 0).reshape(1, 4, 2 * P + 5, *ce.TILE)
    state = ce.pack_state(dkc.cfg, torch.from_numpy(deal[:, 0]))
    return ce.run_perpetual_det(
        state, torch.from_numpy(acts.reshape(1, n_steps, *ce.TILE)),
        torch.from_numpy(cards.astype(np.int32)), P, n_steps, 5, 10)


@pytest.fixture(scope="module")
def starts():
    mid = _mid_hand_state()
    assert int(ce.unpack_field(mid, dkc.cfg, "pot_amt", 0).ne(0).sum()) > 0
    return {"pack_state": dkc.first_state(1, "cpu"), "mid_hand": mid}


@pytest.mark.parametrize("start", ["pack_state", "mid_hand"])
@pytest.mark.parametrize("stage", cs.STAGES)
def test_stage_plain_matches_jax_stage(monkeypatch, stage_script, starts,
                                       stage, start):
    n_steps = 3
    state = starts[start]
    W = cs.words_per_step(stage, P)
    rng = np.random.default_rng(cs.STAGES.index(stage))
    words = rng.integers(0, 1 << 32, (n_steps, W, T), dtype=np.int64)
    seq = iter([words[i, w].astype(np.uint32).reshape(ce.TILE)
                for i in range(n_steps) for w in range(W)])
    monkeypatch.setattr(jpe, "pltpu", types.SimpleNamespace(
        prng_random_bits=lambda shape: jnp.asarray(next(seq))))
    assert stage_script.pe is jpe and stage_script.F == dkc.F
    st = jpe._unpack(jnp.asarray(state[0].numpy()), stage_script.layout)
    for _ in range(n_steps):
        st = getattr(stage_script, f"v_{stage}")(st)
    assert next(seq, None) is None  # every word consumed, in order
    want = np.asarray(jpe._pack(st, stage_script.layout, stage_script.F))

    got = cs.run_stage(stage, 0, state, P, n_steps, 5, 10,
                       words=torch.from_numpy(words))
    assert got.dtype == torch.int32
    for name, (off, rows) in dkc.layout.items():
        np.testing.assert_array_equal(got[0, off:off + rows].numpy(),
                                      want[off:off + rows], err_msg=name)
    if stage == "settle" and start == "mid_hand":  # chips were paid out
        assert not torch.equal(got, state)


def test_stage_philox_words_are_the_injected_stream():
    """Philox mode on the CPU equals the same stage fed stage_words, and
    the words of a step do not depend on the number of tables."""
    state = _mid_hand_state(8)
    n_steps = 4
    for stage in ("policy", "full"):
        words = torch.stack([cs.stage_words(9, T, stage, P, i, "cpu")
                             for i in range(n_steps)])
        assert tuple(words.shape) == cs.stage_words_shape(stage, T, P,
                                                          n_steps)
        assert torch.equal(cs.run_stage(stage, 9, state, P, n_steps, 5, 10),
                           cs.run_stage(stage, 9, state, P, n_steps, 5, 10,
                                        words=words))
        assert torch.equal(cs.stage_words(9, 2 * T, stage, P, 2, "cpu")[:, :T],
                           words[2])


def test_ported_scripts_run_the_plain_versions_on_the_cpu(capsys, starts):
    """The ported scripts' CPU path prints the JAX script's keys (and the
    port's extra word counts) and returns the plain stage's state."""
    res = ecm.main(device="cpu", n_blocks=1, n_steps=2)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    jax_keys = {f"array_R{R}" for R in (16, 36, 70, 141)} | {"dict_R141",
                                                               "ref_R141"}
    assert jax_keys <= set(res) and lines[-1]["ns_per_table_step"] == res
    assert lines[-1]["device"] == "cpu (plain versions)"
    mid = starts["mid_hand"]
    out = dkc.compile_variant("settle", n_steps=2, state=mid, device="cpu")
    assert "nvcc_s" not in out and out["ns_per_table_step"] > 0
    assert torch.equal(out["out"], cs.run_stage("settle", 0, mid, P, 2, 5,
                                                10))


def test_stage_wrapper_checks_its_inputs():
    state = dkc.first_state(1, "cpu")
    with pytest.raises(ValueError):
        cs.run_stage("nope", 0, state, P, 2, 5, 10)
    with pytest.raises(ValueError):  # the stage probe runs reference rules
        cs.run_stage("carry", 0, ce.pack_state(
            TableConfig(num_seats=P, rules="standard"),
            ce.first_deal(0, T, P, "cpu")), P, 2, 5, 10)
    with pytest.raises(ValueError):
        cs.run_stage("deal", 0, state, P, 2, 5, 10,
                     words=torch.zeros((2, 3, T), dtype=torch.int64))
    with pytest.raises(ValueError):
        _build.build_probe("stage", "nope")


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15mc_stage_kernelILi6EEvPijPKiiiiijj' for 'sm_90a'
ptxas info    : Function properties for _Z15mc_stage_kernelILi6EEvPijPKiiiiijj
    688 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 153 registers, used 0 barriers, 688 bytes cumulative stack size, 384 bytes cmem[0]
ptxas info    : Function properties for _Z9helper_fnv
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z21mc_carry_array_kernelILi16EEvPKiPiii' for 'sm_90a'
ptxas info    : Function properties for _Z21mc_carry_array_kernelILi16EEvPKiPiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers, 384 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_stack_and_spills():
    assert _build.ptxas_report(PTXAS) == {
        "_Z15mc_stage_kernelILi6EEvPijPKiiiiijj": {
            "registers": 153, "stack": 688, "spill_stores": 12,
            "spill_loads": 16},
        "_Z21mc_carry_array_kernelILi16EEvPKiPiii": {
            "registers": 30, "stack": 0, "spill_stores": 0,
            "spill_loads": 0}}
