"""The port's levels street form (``montecarlo_tpu_torch/engine/street.py``)
against the JAX package's literal layer algebra and layers engine.

The port's levels form (``bets_impl="levels"``; ``test_torch_bets.py``
and ``test_torch_layers_engine.py`` hold its layers form): its layer view
(``street_to_layers``) must equal the four-column ``bet.clj``
transcription of the JAX ``engine/bets.py`` after every operation of
random algebra sequences, and at every step of full trajectories of the
JAX engine run with ``bets_impl="layers"``. Tolerance 0: every output is
an integer.
"""

import random

import jax
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import public as jpublic
from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu.engine.bets import (
    empty_layers as j_empty_layers,
    merge_bets,
    needed_bet,
    remove_player,
    total_bet,
    update_bets,
)
from montecarlo_tpu_torch.engine import public as tpublic
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine.bets import empty_layers, member_matrix
from montecarlo_tpu_torch.engine.street import (
    empty_street,
    street_merge,
    street_needed,
    street_to_layers,
    street_total,
    street_update,
)
from test_torch_step import (
    assert_states_equal,
    jax_numpy,
    port_cfg,
    run_both,
)

torch.set_num_threads(1)

L, P = 8, 6


def layers_tuple(ly, t=0):
    """Table ``t``'s live layers as (amt, mem, orig, n, count) tuples."""
    c = np.asarray(ly.count)
    c = int(c[t] if c.ndim else c)

    def row(x):
        x = np.asarray(x)
        return tuple(int(v) for v in (x[t] if x.ndim == 2 else x)[:c])

    return (row(ly.amt), row(ly.mem), row(ly.orig), row(ly.n), c)


def one(x):
    return torch.tensor([x], dtype=torch.int32)


def test_blinds_shape():
    """SB 5 then BB 10 give [Bet 5 {sb,bb} n=2, Bet 5 {bb} n=1]
    (gameplay.clj:77-88)."""
    s = street_update(empty_street(L, P, 1, "cpu"), 5, 0)
    s = street_update(s, 10, 1)
    ly = street_to_layers(s, torch.zeros((1, P), dtype=torch.bool))
    assert layers_tuple(ly) == ((5, 5), (0b11, 0b10), (0b11, 0b10), (2, 1),
                                2)
    assert street_total(s).tolist() == [10]
    assert street_needed(s, 0).tolist() == [5]
    assert street_needed(s, 1).tolist() == [0]
    assert street_needed(s, 2).tolist() == [10]


def _random_sequences(n_seqs, n_ops, seed):
    """Engine-like op sequences (tests/test_street.py): threads carry a
    seat's new street total, folds and checks trigger the merge; amounts
    sometimes collide with existing boundaries."""
    rng = random.Random(seed)
    for _ in range(n_seqs):
        ops, contrib, folded = [], [0] * P, [False] * P
        levels = set()
        for _ in range(n_ops):
            kind = rng.random()
            actors = [s for s in range(P) if not folded[s]]
            if not actors:
                break
            seat = rng.choice(actors)
            if kind < 0.55:
                base = max(contrib[seat] + 1, 1)
                if levels and rng.random() < 0.4:
                    amount = rng.choice(sorted(levels))
                    if amount <= contrib[seat]:
                        amount = base + rng.randrange(0, 12)
                else:
                    amount = base + rng.randrange(0, 12)
                contrib[seat] = max(contrib[seat], amount)
                levels.add(amount)
                ops.append(("thread", seat, amount))
            elif kind < 0.8:
                ops.append(("check", seat, 0))
            else:
                folded[seat] = True
                ops.append(("fold", seat, 0))
        yield ops


@pytest.mark.parametrize("seed", range(8))
def test_random_algebra_equals_jax_layer_algebra(seed):
    """After every op the port's layer view equals the JAX literal layer
    algebra: amounts, member and original sets, n, count; needed and total
    bets of every non-folded seat too."""
    for ops in _random_sequences(25, 14, seed):
        ly = j_empty_layers(L, P)
        st = empty_street(L, P, 1, "cpu")
        folded = torch.zeros((1, P), dtype=torch.bool)
        for op, seat, amount in ops:
            if op == "thread":
                ly = update_bets(ly, amount, seat)
                st = street_update(st, one(amount), one(seat))
            elif op == "fold":
                folded[0, seat] = True
                ly = merge_bets(remove_player(ly, seat))
                st = street_merge(st)
            else:
                ly = merge_bets(ly)
                st = street_merge(st)
            if bool(ly.overflow) or bool(st.overflow[0]):
                assert bool(ly.overflow) == bool(st.overflow[0])
                break
            got = street_to_layers(st, folded)
            assert layers_tuple(got) == layers_tuple(ly), (ops, op, seat)
            for s in range(P):
                if not bool(folded[0, s]):
                    assert int(street_needed(st, s)[0]) == int(
                        needed_bet(ly, s))
            assert int(street_total(st)[0]) == int(total_bet(ly))


@pytest.mark.parametrize("rules", ["reference", "standard", "tournament"])
def test_layer_view_equals_jax_layers_engine(rules):
    """JAX run with bets_impl="layers" against the port (levels): the
    port's ``street_to_layers`` equals JAX's street Layers at every step,
    every other field equals too, and so does the host view of a few
    tables."""
    P6, T = 6, 16
    kw = dict(max_layers=8, max_pot_layers=16,
              starting_stack=40 if rules == "tournament" else 100)
    jcfg = JaxTableConfig(num_seats=P6, rules=rules, bets_impl="layers",
                          **kw)
    ids = [f"p{i}" for i in range(P6)]

    def check(i, js, ts):
        want = jax_numpy(js)
        view = ts._replace(bets=street_to_layers(ts.bets, ts.folded))
        assert_states_equal(want, view, f"step {i}")
        for t in range(0, T, 5):
            jone = jax_table(js, t)
            assert tpublic.public_board(ts, ids, t) == \
                jpublic.public_board(jone, ids), (i, t)
            assert tpublic.player_hand_json(ts, 2, t) == \
                jpublic.player_hand_json(jone, 2)

    run_both(P6, rules, T, 40, 12, 3, jcfg, port_cfg(P6, rules, **kw),
             check)


def jax_table(js, t):
    """Table ``t`` of a batched JAX state, unbatched."""
    return jax.tree.map(lambda x: x[t], js)


def test_state_carry_round_trip_and_refusals():
    cfg = port_cfg(3, "standard")
    st = tstate.init_state(9, cfg, 8, "cpu")
    back = tstate.state_from_numpy(tstate.state_to_numpy(st), seed=9,
                                   device="cpu")

    def leaves(x):
        if isinstance(x, tuple):
            return [y for f in x for y in leaves(f)]
        return [x]

    for a, b in zip(leaves(st), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a layers street (the JAX default form) carries across as a Layers
    jl = j_empty_layers(L, 3)
    carried = tstate.state_from_numpy(tstate.state_to_numpy(st)._replace(
        bets=jax.tree.map(lambda x: np.broadcast_to(x, (8,) + x.shape),
                          jl)), device="cpu")
    assert type(carried.bets).__name__ == "Layers"
    assert carried.bets.amt.shape == (8, L)
    assert torch.equal(carried.stacks, st.stacks)
    with pytest.raises(ValueError):
        empty_layers(4, 24, 1, "cpu")


def test_member_matrix_and_empty_layers():
    masks = torch.tensor([[0b101, 0], [0b010, 0b111]], dtype=torch.int32)
    m = member_matrix(masks, 3)
    assert m.shape == (2, 2, 3)
    assert m[0, 0].tolist() == [True, False, True]
    assert m[1, 1].tolist() == [True, True, True]
    assert not bool(m[0, 1].any())
    ly = empty_layers(5, 4, 3, "cpu")
    assert ly.capacity == 5 and ly.amt.shape == (3, 5)
    assert ly.count.tolist() == [0, 0, 0] and not bool(ly.overflow.any())
    assert np.array_equal(np.asarray(j_empty_layers(5, 4).amt),
                          ly.amt[0].numpy())
