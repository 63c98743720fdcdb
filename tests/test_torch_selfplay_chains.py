"""The port's ``play_tournament`` and ``play_hands_perpetual`` against
chains of the JAX engine, bit for bit, under a deterministic policy on the
port's decks (see ``test_torch_selfplay.py``).

- ``play_tournament``: JAX ``play_one_hand`` + ``next_hand`` + ``redeal``
  hand by hand, with the JAX module's bust records and seat view, past the
  hand at which every table has frozen (where the port's loop stops);
- ``play_hands_perpetual``: JAX ``clamp_action`` + ``step_table`` step by
  step, a table redealt with the port's deck where its hand counter moves,
  the policy's street-raise count carried as the JAX module carries it.
Tolerance 0: every output is an integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.rollout import selfplay as jsp
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.rollout import selfplay as tsp
from test_torch_selfplay import (
    jax_first,
    jax_hand,
    jax_hash,
    jax_keys,
    jax_next,
    port_decks,
    port_hash,
)
from test_torch_step import (
    assert_states_equal,
    jax_cfg,
    jax_fns,
    jax_numpy,
    jax_select,
    port_cfg,
)

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = 48


def seat_view(stacks, button):
    """JAX ``play_tournament``'s positional -> seat view, in numpy."""
    P = stacks.shape[1]
    idx = (np.arange(P)[None] - np.asarray(button)[:, None]) % P
    return np.take_along_axis(np.asarray(stacks), idx, axis=1)


@pytest.mark.parametrize("P", [2, 3, 6])
def test_play_tournament_chain_equals_jax(P):
    seed, max_hands = 300 + P, 40
    kw = dict(starting_stack=20)
    jcfg, pcfg = jax_cfg(P, "tournament", **kw), port_cfg(P, "tournament",
                                                          **kw)
    steps = tsp.hand_action_bound(pcfg)
    final, busted, seats = tsp.play_tournament(seed, pcfg, T, max_hands,
                                               policy=port_hash,
                                               device="cpu")
    hand = jax_hand(P, "tournament", "hash", steps)
    js = jax_first(jcfg, seed, T, "tournament")
    want = np.full((T, P), max_hands + 1, np.int32)
    for i in range(max_hands):
        if i:
            js = jax_next(js, seed, "tournament")
        js = hand(js, jax_keys(T))
        newly = (seat_view(js.stacks, js.button) <= 0) & (want > max_hands)
        want = np.where(newly, i, want)
    assert_states_equal(jax_numpy(js), final, "final")
    np.testing.assert_array_equal(busted.numpy(), want)
    np.testing.assert_array_equal(seats.numpy(),
                                  seat_view(js.stacks, js.button))
    # every table froze well before the last hand: the loop stopped early
    assert bool(final.hand_over.all())
    assert int(busted.max()) == max_hands + 1 and int(busted.min()) < 8
    places = tsp.tournament_placements(busted, seats)
    np.testing.assert_array_equal(
        places, jsp.tournament_placements(want, np.asarray(seats)))
    np.testing.assert_array_equal(np.sort(places, axis=1),
                                  np.tile(np.arange(1, P + 1), (T, 1)))


@pytest.mark.parametrize("P,rules", [(6, "reference"), (3, "standard"),
                                     (2, "tournament")])
def test_play_hands_perpetual_equals_jax_step_chain(P, rules):
    seed, n_steps = 400 + P, 60
    kw = dict(starting_stack=40 if rules == "tournament" else 100)
    jcfg, pcfg = jax_cfg(P, rules, **kw), port_cfg(P, rules, **kw)
    final, hands = tsp.play_hands_perpetual(seed, pcfg, T, n_steps,
                                            policy=port_hash, device="cpu")
    clamp, step, redeal, _, _ = jax_fns(rules)
    js = jax_first(jcfg, seed, T, rules)
    raises = jnp.zeros(T, jnp.int32)
    for _ in range(n_steps):
        prev_stage, prev_hand = np.asarray(js.stage), np.asarray(js.hand_idx)
        over = np.asarray(js.hand_over)
        action = clamp(js, _jax_hash(js, raises))
        js = step(js, action)
        moved = np.asarray(js.hand_idx) != prev_hand
        deck = jnp.asarray(port_decks(seed, T, js.hand_idx).numpy())
        js = jax_select(moved, redeal(js, deck), js)
        applied = (np.asarray(action) > 0) & ~over
        reset = (np.asarray(js.stage) != prev_stage) | moved
        raises = jnp.asarray(np.where(reset, 0, np.asarray(raises) + applied)
                             .astype(np.int32))
    assert_states_equal(jax_numpy(js), final, "final")
    assert int(hands) == int(np.asarray(js.hand_idx).sum()) > T


_jax_hash = jax.jit(jax.vmap(lambda st, r: jax_hash(None, st, r)))


def test_first_decks_are_the_engines():
    """The chains inject the port's decks: they are ``init_state``'s."""
    cfg = port_cfg(3, "standard")
    st = tstate.init_state(9, cfg, 16, "cpu")
    assert torch.equal(st.deck, port_decks(9, 16, np.zeros(16, np.int32)))
