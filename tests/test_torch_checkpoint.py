"""The port's table-state checkpoints (``montecarlo_tpu_torch/utils/
checkpoint.py``) against themselves and against the JAX package's files.

- A batch saved after k steps, loaded and stepped m more equals the
  uninterrupted k + m steps field by field, keys included, under each rule
  set (the decks after the save come from the restored keys).
- The file layout is the JAX one: ``bets_impl`` and ``leaf_NNNN`` in
  ``TableState`` order, the street fields nested; the port's key as
  uint32 words, marked by ``key_form``.
- A JAX ``save_states`` file loads equal to the JAX state in every field
  but the key, which becomes ``table_keys(seed)``: the levels form, and
  the layers form of a default config; the older JAX form without
  ``street_raises``/``last_raiser`` loads with their defaults. A port file
  in the layers form loads in JAX, and the port resumes a layers batch as
  it resumes a levels one.
Tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu.utils import checkpoint as jckpt
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine import step as tstep
from montecarlo_tpu_torch.engine.bets import Layers
from montecarlo_tpu_torch.utils.checkpoint import load_states, save_states
from test_torch_step import (
    RULES,
    assert_states_equal,
    jax_cfg,
    jax_fns,
    jax_init,
    jax_numpy,
    port_cfg,
    streams,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T, P = 6, 3


def _steps(ts, actions, rules):
    for a in actions:
        ts = tstep.step_table(ts, tstep.clamp_action(
            ts, torch.from_numpy(a)), rules=rules)
    return ts


def _assert_all_fields_equal(a, b):
    for x, y in zip(tstate._tree_map(lambda v: v, a),
                    tstate._tree_map(lambda v: v, b)):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert u.dtype == v.dtype
            assert torch.equal(u, v)


@pytest.mark.parametrize("rules", RULES)
def test_resume_equals_uninterrupted(rules, tmp_path):
    k, m = 12, 20
    actions, _ = streams(7, T, k + m, 1)
    st = tstate.init_state(3, port_cfg(P, rules), T, "cpu")
    mid = _steps(st, actions[:k], rules)
    path = str(tmp_path / "snap.npz")
    save_states(path, mid)
    restored = load_states(path, device="cpu")
    _assert_all_fields_equal(restored, mid)
    resumed = _steps(restored, actions[k:], rules)
    straight = _steps(mid, actions[k:], rules)
    _assert_all_fields_equal(resumed, straight)
    assert int(straight.hand_idx.max()) >= 1  # decks dealt after the save


def test_file_layout_is_the_jax_one(tmp_path):
    st = tstate.init_state(3, port_cfg(P, "standard"), T, "cpu")
    path = str(tmp_path / "snap.npz")
    save_states(path, st)
    with np.load(path) as data:
        assert str(data["bets_impl"]) == "levels"
        leaves = sorted(k for k in data.files if k.startswith("leaf_"))
        assert leaves == [f"leaf_{i:04d}" for i in range(32)]
        # the port's key, as JAX's key data are stored
        assert data["leaf_0000"].dtype == np.uint32
        assert str(data["key_form"]) == "philox"
        np.testing.assert_array_equal(data["leaf_0016"],
                                      st.bets.level.numpy())
        np.testing.assert_array_equal(data["leaf_0031"],
                                      st.last_raiser.numpy())


@pytest.mark.parametrize("rules", RULES)
def test_jax_file_loads_equal_except_the_key(rules, tmp_path):
    actions, decks = streams(11, T, 10, 1)
    clamp, step, redeal, _, _ = jax_fns(rules)
    js = redeal(jax_init(jax_cfg(P, rules), T), jnp.asarray(decks[:, 0]))
    for a in actions:
        js = step(js, clamp(js, jnp.asarray(a)))
    path = str(tmp_path / "jax.npz")
    jckpt.save_states(path, js)
    got = load_states(path, device="cpu", seed=5)
    assert_states_equal(jax_numpy(js), got)
    assert torch.equal(got.key, tstate.table_keys(5, T, "cpu"))


def test_jax_file_of_the_older_form_loads_with_defaults(tmp_path):
    js = jax_init(jax_cfg(P, "reference"), T)
    path = str(tmp_path / "jax.npz")
    jckpt.save_states(path, js)
    with np.load(path) as data:
        old = {k: data[k] for k in data.files
               if k not in ("leaf_0030", "leaf_0031")}
    old_path = str(tmp_path / "old.npz")
    np.savez_compressed(old_path, **old)
    got = load_states(old_path, device="cpu")
    assert torch.equal(got.street_raises, torch.zeros(T, dtype=torch.int32))
    assert torch.equal(got.last_raiser, torch.full((T,), P,
                                                   dtype=torch.int32))
    want = load_states(path, device="cpu")
    assert torch.equal(got.stacks, want.stacks)
    assert torch.equal(got.bets.level, want.bets.level)


def test_layers_file_is_refused(tmp_path):
    """No longer refused: a JAX file of a default config (the layers form)
    loads equal to the JAX state but the key, and a port file in the
    layers form loads in JAX equal to the port's state but the key. A
    file naming another form is refused."""
    cfg = JaxTableConfig(num_seats=P)  # bets_impl="layers"
    actions, decks = streams(12, T, 10, 1)
    clamp, step, redeal, _, _ = jax_fns("reference")
    js = redeal(jax_init(cfg, T), jnp.asarray(decks[:, 0]))
    for a in actions:
        js = step(js, clamp(js, jnp.asarray(a)))
    path = str(tmp_path / "layers.npz")
    jckpt.save_states(path, js)
    got = load_states(path, device="cpu", seed=5)
    assert isinstance(got.bets, Layers)
    assert_states_equal(jax_numpy(js), got)

    ours = tstate.init_state(4, port_cfg(P, "reference", bets_impl="layers"),
                             T, "cpu")
    ours = _steps(ours, actions, "reference")
    mine = str(tmp_path / "port.npz")
    save_states(mine, ours)
    back = jckpt.load_states(mine)
    assert type(back.bets).__name__ == "Layers"
    assert_states_equal(jax_numpy(back), ours)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(back.key)), ours.key.numpy())

    with np.load(mine) as data:
        other = {k: data[k] for k in data.files}
    other["bets_impl"] = np.asarray("lists")
    np.savez_compressed(str(tmp_path / "other.npz"), **other)
    with pytest.raises(ValueError, match="bets_impl"):
        load_states(str(tmp_path / "other.npz"), device="cpu")


@pytest.mark.parametrize("rules", RULES)
def test_layers_resume_equals_uninterrupted(rules, tmp_path):
    """A layers-form batch saved mid-hand, loaded and stepped on equals
    the uninterrupted run, keys included; the file says "layers"."""
    k, m = 9, 20
    actions, _ = streams(8, T, k + m, 1)
    st = tstate.init_state(3, port_cfg(P, rules, bets_impl="layers"), T,
                           "cpu")
    mid = _steps(st, actions[:k], rules)
    path = str(tmp_path / "snap.npz")
    save_states(path, mid)
    with np.load(path) as data:
        assert str(data["bets_impl"]) == "layers"
    restored = load_states(path, device="cpu")
    assert isinstance(restored.bets, Layers)
    _assert_all_fields_equal(restored, mid)
    _assert_all_fields_equal(_steps(restored, actions[k:], rules),
                             _steps(mid, actions[k:], rules))
