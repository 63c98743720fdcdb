"""The port's layer algebra (``montecarlo_tpu_torch/engine/bets.py``)
against the JAX package's ``engine/bets.py``, applied per table.

Random sequences of ``update_bets``, fold + ``merge_bets`` and check +
``merge_bets`` run over T tables at once, each table its own op, seat and
amount at every step (the engine's per-table select); the JAX functions
run under ``jax.vmap``. After every step every field of the layer lists
equals JAX's, the rows past ``count`` included, and so do ``total_bet``
and ``needed_bet`` of every seat. L in {1, 3, 8} and P in {2, 6, 23}
cover a single layer, the 6-max table and the widest bitmask; amounts
include 0 and the standing boundaries, and the short capacities overflow.
Tolerance 0: every output is an integer.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import bets as jbets
from montecarlo_tpu_torch.engine import bets as tbets
from montecarlo_tpu_torch.engine.street import bets_fold_check_merge

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = 24


@functools.lru_cache(maxsize=None)
def jax_ops():
    """The JAX algebra over a leading table axis."""
    return (jax.jit(jax.vmap(jbets.update_bets)),
            jax.jit(jax.vmap(lambda ly, s: jbets.merge_bets(
                jbets.remove_player(ly, s)))),
            jax.jit(jax.vmap(jbets.merge_bets)),
            jax.jit(jax.vmap(jbets.total_bet)),
            jax.jit(jax.vmap(jbets.needed_bet)))


def jax_empty(L, P):
    one = jbets.empty_layers(L, P)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (T,) + x.shape), one)


def assert_layers_equal(want, got, where):
    for name, w, g in zip(tbets.Layers._fields, want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert w.shape == g.shape and (w.dtype == bool) == (
            g.dtype == bool), (where, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")


def jax_select(kind, thread, fold, check):
    def pick(a, b, c):
        k = kind.reshape((-1,) + (1,) * (np.asarray(a).ndim - 1))
        return np.where(k == 0, np.asarray(a),
                        np.where(k == 1, np.asarray(b), np.asarray(c)))
    return jbets.Layers(*(pick(a, b, c) for a, b, c in
                          zip(thread, fold, check)))


def draw_amounts(rng, ly, seats):
    """Per table: 0 (15%), a standing boundary (35%), or the total plus
    0..12 chips (the rest): splits, exact joins, appends, zero layers."""
    amt = np.asarray(ly.amt)
    count = np.asarray(ly.count)
    prefix = np.cumsum(np.where(np.arange(amt.shape[1])[None]
                                < count[:, None], amt, 0), axis=1)
    u = rng.random(T)
    at = rng.integers(0, amt.shape[1], T)
    boundary = prefix[np.arange(T), np.minimum(at, np.maximum(count - 1,
                                                              0))]
    fresh = prefix[:, -1] + rng.integers(0, 13, T)
    return np.where(u < 0.15, 0, np.where(u < 0.5, boundary, fresh)) \
        .astype(np.int32)


@pytest.mark.parametrize("P", [2, 6, 23])
@pytest.mark.parametrize("L", [1, 3, 8])
def test_random_sequences_equal_jax(L, P):
    update, fold_merge, merge, total, needed = jax_ops()
    rng = np.random.default_rng(100 * L + P)
    js = jax_empty(L, P)
    ts = tbets.empty_layers(L, P, T, "cpu")
    most, zero_layer = 0, False
    for step in range(40):
        seats = rng.integers(0, P, T).astype(np.int32)
        amounts = draw_amounts(rng, js, seats)
        # 0 thread (55%), 1 fold + merge (20%), 2 check + merge
        kind = np.where(rng.random(T) < 0.55, 0,
                        np.where(rng.random(T) < 0.45, 1, 2))
        js = jax_select(kind, update(js, jnp.asarray(amounts),
                                     jnp.asarray(seats)),
                        fold_merge(js, jnp.asarray(seats)), merge(js))
        tk = torch.from_numpy(kind)
        seat_t = torch.from_numpy(seats)
        threaded = tbets.update_bets(ts, torch.from_numpy(amounts), seat_t)
        merged = bets_fold_check_merge(ts, tk == 1, seat_t)
        ts = tbets.Layers(*(torch.where(
            (tk == 0).view(-1, *[1] * (a.dim() - 1)), a, b)
            for a, b in zip(threaded, merged)))
        assert_layers_equal(js, ts, f"L={L} P={P} step {step}")
        np.testing.assert_array_equal(tbets.total_bet(ts).numpy(),
                                      np.asarray(total(js)))
        for s in range(P):
            seat = np.full(T, s, np.int32)
            np.testing.assert_array_equal(
                tbets.needed_bet(ts, s).numpy(),
                np.asarray(needed(js, jnp.asarray(seat))))
        count = np.asarray(js.count)
        most = max(most, int(count.max()))
        live = np.arange(L)[None] < count[:, None]
        zero_layer |= bool((live & (np.asarray(js.amt) == 0)).any())
    assert most >= min(L, 4)  # long lists
    assert zero_layer  # zero-amount layers
    if L < 8:
        assert np.asarray(js.overflow).any()  # capacity exceeded


@pytest.mark.parametrize("P", [2, 6, 23])
def test_each_op_equals_jax_at_a_python_seat(P):
    """The ops take a Python int seat and amount as well as [T] tensors:
    a blind sequence with a zero post, a fold and a check."""
    update, fold_merge, merge, total, needed = jax_ops()
    L = 4
    js, ts = jax_empty(L, P), tbets.empty_layers(L, P, T, "cpu")
    for amount, seat in ((0, 0), (10, 1), (10, 0), (30, P - 1), (0, 1)):
        js = update(js, jnp.full(T, amount, jnp.int32),
                    jnp.full(T, seat, jnp.int32))
        ts = tbets.update_bets(ts, amount, seat)
        assert_layers_equal(js, ts, f"update {amount} {seat}")
    js = fold_merge(js, jnp.full(T, 1, jnp.int32))
    ts = tbets.merge_bets(tbets.remove_player(ts, 1))
    assert_layers_equal(js, ts, "fold")
    js, ts = merge(js), tbets.merge_bets(ts)
    assert_layers_equal(js, ts, "check")
    assert tbets.total_bet(ts).tolist() == np.asarray(total(js)).tolist()
    assert tbets.needed_bet(ts, P - 1).tolist() == np.asarray(
        needed(js, jnp.full(T, P - 1, jnp.int32))).tolist()


def test_reference_quirks():
    """n-inflation (a member joins again), the later layer's n on a merge,
    a fold leaving ``orig``, and the overflow latch with ``count`` at L."""
    ly = tbets.empty_layers(2, 3, 1, "cpu")
    ly = tbets.update_bets(ly, 5, 0)    # [5 {0} n1]
    ly = tbets.update_bets(ly, 10, 1)   # [5 {0,1} n2, 5 {1} n1]
    ly = tbets.update_bets(ly, 5, 0)    # seat 0 joins layer 0 again
    assert ly.amt.tolist() == [[5, 5]] and ly.n.tolist() == [[3, 1]]
    assert ly.mem.tolist() == [[0b011, 0b010]]
    folded = tbets.merge_bets(tbets.remove_player(ly, 0))
    # the sets now differ only in orig: no merge; orig keeps seat 0
    assert folded.mem.tolist() == [[0b010, 0b010]]
    assert folded.orig.tolist() == [[0b011, 0b010]]
    assert folded.count.tolist() == [2]
    over = tbets.update_bets(ly, 7, 2)  # splits layer 1 of a full list
    assert over.count.tolist() == [2] and over.overflow.tolist() == [True]
    assert over.amt.tolist() == [[5, 2]]
    same = tbets.Layers(amt=torch.tensor([[3, 4]], dtype=torch.int32),
                        mem=torch.tensor([[6, 6]], dtype=torch.int32),
                        orig=torch.tensor([[6, 6]], dtype=torch.int32),
                        n=torch.tensor([[5, 2]], dtype=torch.int32),
                        count=torch.tensor([2], dtype=torch.int32),
                        overflow=torch.tensor([False]))
    merged = tbets.merge_bets(same)
    assert merged.amt.tolist() == [[7, 0]] and merged.n.tolist() == [[2, 0]]
    assert merged.count.tolist() == [1]
