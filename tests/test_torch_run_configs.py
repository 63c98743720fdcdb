"""The ported ``scripts/run_configs.py`` (``montecarlo_tpu_torch/scripts/
run_configs.py``) on the CPU, with config 4's tables and config 5's
rollouts cut: every config runs, config 2's side pots equal those of the
JAX engine's run of the script's config 2 (they depend on no card),
config 1's and 2's chips equal JAX's in total, AKs vs QQ lies within 4
sigma of the exact 0.458708, and config 5 runs the plain sweep sharded
over ``make_mesh()`` on the CPU (a world of one), never the sweep kernel.
"""

import contextlib
import inspect
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from montecarlo_tpu.engine import (
    TableConfig as JaxTableConfig,
    clamp_action as jclamp,
    init_state as jinit,
    public_board as jpublic,
    settle_showdown as jsettle,
    step_action as jstep,
)
from montecarlo_tpu_torch.scripts import run_configs as rc

torch.set_num_threads(1)

EXACT_AKS_QQ = 0.458708


def _jax_config(cfg, seed, stacks, script, ids):
    """The JAX script's config 1 / 2 body: (final stacks, pots)."""
    st = jinit(jax.random.key(seed), cfg)
    if stacks is not None:
        st = st._replace(stacks=jnp.array(stacks, jnp.int32))
    for a in script:
        st = jstep(st, jclamp(st, jnp.asarray(a, jnp.int32)))
    st = jsettle(st)
    return np.asarray(st.stacks), jpublic(st, ids)["pots"]


@pytest.fixture(scope="module")
def ran():
    """``main(["--quick"], "cpu")``'s results and printed text."""
    def no_kernel(*a, **k):
        raise AssertionError("config 5 on the CPU launched the sweep kernel")

    assert not dist.is_initialized()
    text = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(text):
        mp.setitem(rc.TABLES, True, 512)
        mp.setitem(rc.SWEEP_ROLLOUTS, True, 2048)
        mp.setattr(rc, "equity_sweep_kernel", no_kernel)
        try:
            out = rc.main(["--quick"], device="cpu")
        finally:
            dist.destroy_process_group()
    return out, text.getvalue()


def test_every_config_prints_its_lines(ran):
    _, text = ran
    for n in range(1, 6):
        assert f"=== Config {n}:" in text
    assert text.count("final stacks:") == 2
    assert "devices=1 rollouts/hand=2,048" in text


def test_config2_pots_equal_jax(ran):
    out, _ = ran
    _, want = _jax_config(JaxTableConfig(num_seats=3), 7, [95, 90, 40],
                          [30, 0, 0] + [0] * 6,
                          ["p1", "p2", "p3"])
    assert out["config2"] == want
    assert json.dumps(out["config2"]) == json.dumps(want)


def test_config1_chips_equal_jax(ran):
    out, _ = ran
    cfg = JaxTableConfig(num_seats=2, small_blind=5, big_blind=5)
    want, _ = _jax_config(cfg, 2024, None, [0, 0] + [0, 0] * 3,
                          ["hero", "villain"])
    assert int(out["config1"].stacks.sum()) == int(want.sum())


def test_config3_and_4(ran):
    out, _ = ran
    res = out["config3"]
    assert res.n == 1_000_000
    assert abs(res.equity - EXACT_AKS_QQ) < 4 * res.stderr
    done, stats = out["config4"]
    assert done == 1.0 and stats["tables"] == 512


def test_config5_sweep_on_the_mesh(ran):
    out, _ = ran
    eq, n = out["config5"]
    assert n == 2048 and eq.shape == (169,)
    names = [name for name, _ in rc.canonical_hands()]
    assert names[int(np.argmax(eq))] == "AA"
    assert eq[names.index("AA")] > eq[names.index("KQs")] > \
        eq[names.index("72o")]


def test_no_fallback_between_devices():
    """Config 5 picks K2 or the sharded plain sweep by the device; no
    exception sends one to the other."""
    assert "except" not in inspect.getsource(rc)
