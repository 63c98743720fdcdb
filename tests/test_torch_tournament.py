"""The port's tournament rules (K3/K4 plain versions) against the JAX engine.

Det mode: ``run_perpetual_det`` on the CPU must equal the JAX kernel
``run_perpetual_det(..., rules="tournament", interpret=True)`` over the
whole packed state, ``bust_at`` included, on the injected streams of
``tests/test_pallas_engine.py`` and with stacks short enough that seats
bust, the blinds skip dead positions and tables freeze within the run.
PRNG mode: the JAX kernel body's deferred-settle composition on injected
words (``test_torch_engine._jax_deferred``), short stacks, so that frozen
tables sit through settle passes. Every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine.state import TableConfig as JaxTableConfig
from montecarlo_tpu.ops import pallas_engine as jpe
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import cuda_engine as ce
from test_torch_engine import _jax_deferred, _streams

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = ce.TABLES_PER_BLOCK
P = 6
SHORT = 20  # chips a seat: seats bust within tens of hands


def _cfgs(stack):
    return (JaxTableConfig(num_seats=P, rules="tournament",
                           starting_stack=stack),
            TableConfig(num_seats=P, rules="tournament", starting_stack=stack))


def _assert_states_equal(got, want):
    layout, _ = ce._field_layout(P, "tournament")
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(
            ce.state_to_numpy(got[:, off:off + rows]),
            want[:, off:off + rows], err_msg=name)


def _det_both(seed, n_steps, hmax, stack):
    """(port state, JAX state as numpy, port config) after ``n_steps``
    injected steps from the same first state."""
    jcfg, cfg = _cfgs(stack)
    actions, cards = _streams(seed, P, n_steps, hmax)
    packed = jpe.pack_state(jcfg, cards[:, 0])
    act_in = actions.reshape(n_steps, *ce.TILE)[None]
    cards_in = cards.transpose(1, 2, 0).reshape(hmax, 2 * P + 5,
                                                *ce.TILE)[None]
    want = np.asarray(jpe.run_perpetual_det(
        packed, jnp.asarray(act_in), jnp.asarray(cards_in), P, n_steps, 5,
        10, rules="tournament", interpret=True))
    state = ce.pack_state(cfg, torch.from_numpy(cards[:, 0]))
    np.testing.assert_array_equal(ce.state_to_numpy(state),
                                  np.asarray(packed))
    got = ce.run_perpetual_det(state, torch.from_numpy(act_in),
                               torch.from_numpy(cards_in), P, n_steps, 5, 10,
                               rules="tournament")
    return got, want, cfg


def _seat_rows(state, cfg, name):
    return torch.stack([ce.unpack_field(state, cfg, name, k)
                        for k in range(P)])


@pytest.mark.parametrize("seed", [11, 29])
def test_det_plain_matches_jax_kernel_tournament_rules(seed):
    got, want, cfg = _det_both(seed, 48, 12, 100)
    _assert_states_equal(got, want)
    assert int(ce.unpack_field(got, cfg, "hand_ct").sum()) > 0
    # the adversarial stream busts a few seats even from 100 chips
    assert int((_seat_rows(got, cfg, "bust_at") >= 0).sum()) > 0


@pytest.fixture(scope="module")
def short_det():
    return _det_both(5, 96, 24, SHORT)


def test_det_plain_matches_jax_kernel_tournament_short_stacks(short_det):
    """Short stacks: seats bust, dead positions are skipped (the button
    moves by more than one), and tables freeze within the run."""
    got, want, cfg = short_det
    _assert_states_equal(got, want)
    busted = (_seat_rows(got, cfg, "bust_at") >= 0).any(0)
    frozen = ((ce.unpack_field(got, cfg, "order") == 0)
              & (ce.unpack_field(got, cfg, "wait") == 0))
    # without a skip the button would equal the hand count mod P
    skipped = (ce.unpack_field(got, cfg, "button")
               != ce.unpack_field(got, cfg, "hand_ct") % P) & ~frozen
    assert int(busted.sum()) > T // 2
    assert int(frozen.sum()) > 0 and int(skipped.sum()) > 0


def test_prng_plain_matches_jax_deferred_composition_tournament_rules(
        monkeypatch):
    n_steps = 96
    rng = np.random.default_rng(3)
    first = np.argsort(rng.random((T, 52)), axis=1)[:, :2 * P + 5] \
        .astype(np.int32)
    words = rng.integers(0, 1 << 32, ce.prng_words_shape(T, P, n_steps),
                         dtype=np.int64)
    want = _jax_deferred(monkeypatch, first, words, P, "tournament",
                         starting_stack=SHORT)
    _, cfg = _cfgs(SHORT)
    state = ce.pack_state(cfg, torch.from_numpy(first))
    got = ce.run_perpetual_prng(0, state, P, n_steps, 5, 10,
                                rules="tournament",
                                words=torch.from_numpy(words))
    _assert_states_equal(got, want)
    # frozen tables sat through settle passes: one player holds every chip
    frozen = ce.unpack_field(got, cfg, "order") == 0
    stacks = _seat_rows(got, cfg, "stacks")
    assert int(frozen.sum()) > T // 4
    assert bool((stacks[:, frozen].amax(0) == P * SHORT).all())
    assert int(ce.unpack_field(got, cfg, "overflow").sum()) == 0


def test_tournament_results_match_jax(short_det):
    """Places from the same state, ties included (seats that bust on the
    same hand, and live seats with equal stacks)."""
    got, want, cfg = short_det
    places, frozen = ce.tournament_results(got, cfg)
    jplaces, jfrozen = jpe.tournament_results(jnp.asarray(want),
                                              _cfgs(SHORT)[0])
    np.testing.assert_array_equal(places, np.asarray(jplaces))
    np.testing.assert_array_equal(frozen, np.asarray(jfrozen))
    bust = _seat_rows(got, cfg, "bust_at").numpy().T
    same_hand = [np.unique(b[b >= 0]).size < (b >= 0).sum() for b in bust]
    assert any(same_hand)
    assert bool((np.sort(places, axis=1) == np.arange(1, P + 1)).all())


def test_tournaments_to_completion_cpu():
    _, cfg = _cfgs(SHORT)
    state, steps = ce.tournaments_to_completion(1, cfg, T,
                                                steps_per_launch=64,
                                                device="cpu")
    assert steps % 64 == 0 and steps > 64
    places, frozen = ce.tournament_results(state, cfg)
    stacks = _seat_rows(state, cfg, "stacks")
    assert bool(frozen.all())
    assert bool((stacks.amax(0) == P * SHORT).all())   # winner takes all
    assert bool((stacks.sum(0) == P * SHORT).all())    # chips conserve
    assert bool((np.sort(places, axis=1) == np.arange(1, P + 1)).all())
    # the winner is the seat that holds the chips
    seat_stacks = np.take_along_axis(
        stacks.numpy().T, (np.arange(P)[None] - ce.unpack_field(
            state, cfg, "button").numpy()[:, None]) % P, axis=1)
    np.testing.assert_array_equal(np.argmax(seat_stacks, axis=1),
                                  np.argmin(places, axis=1))
    assert int(ce.unpack_field(state, cfg, "overflow").sum()) == 0
    with pytest.raises(RuntimeError, match="still live"):
        ce.tournaments_to_completion(1, cfg, T, steps_per_launch=16,
                                     max_steps=32, device="cpu")


def test_tournament_entry_points_take_tournament_rules_only():
    std = TableConfig(num_seats=P, rules="standard")
    with pytest.raises(ValueError, match="tournament"):
        ce.tournaments_to_completion(1, std, T, device="cpu")
    state = ce.pack_state(std, ce.first_deal(0, T, P, "cpu"))
    with pytest.raises(ValueError, match="tournament"):
        ce.tournament_results(state, std)


def test_completion_from_a_rotated_button_relabels_the_seats():
    """``run_to_completion`` is ``tournaments_to_completion``'s loop; with
    the first button written to 3 the positions play the same hands on the
    same words, so every table's winner is the button-0 winner's seat + 3
    (the seat view of bust_at, stacks and tournament_results follows the
    button). The card runs this at 2^20 tables in chip_smoke.py."""
    _, cfg = _cfgs(SHORT)
    state0 = ce.pack_state(cfg, ce.first_deal(2, T, P, "cpu"))
    want, steps = ce.tournaments_to_completion(2, cfg, T, 64, device="cpu")
    got, got_steps = ce.run_to_completion(2, state0, cfg, 64)
    assert torch.equal(got, want) and got_steps == steps
    layout, _ = ce._field_layout(P, "tournament")
    rotated = state0.clone()
    rotated[:, layout["button"][0]] = 3
    state3, steps3 = ce.run_to_completion(2, rotated, cfg, 64)
    assert steps3 == steps
    win0 = np.argmin(ce.tournament_results(want, cfg)[0], axis=1)
    win3 = np.argmin(ce.tournament_results(state3, cfg)[0], axis=1)
    np.testing.assert_array_equal(win3, (win0 + 3) % P)
    with pytest.raises(ValueError, match="tournament"):
        ce.run_to_completion(2, state0, TableConfig(num_seats=P), 64)
