"""The port's push/fold solver (``models/pushfold.py``) against the JAX
package's, on the CPU.

The copied numpy parts (representatives, combos, pair counts, the two
solvers) must give arrays equal to JAX's; the exact matchup scores equal
JAX's integers; the Monte Carlo matrix, drawn from the port's Philox
streams, is held to the committed exact matrix in aggregate. The push/fold
cases of ``tests/test_models.py`` run on the port.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.models import pushfold as jpf
from montecarlo_tpu.ops import evaluator as jev
from montecarlo_tpu.rollout import equity as jeq
from montecarlo_tpu_torch.models import pushfold as tpf
from montecarlo_tpu_torch.rollout import equity as teq

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent.parent / "data"


def _npz(name):
    with np.load(DATA / name) as d:
        return {k: d[k] for k in d.files}


def test_representatives_and_combos_match_jax():
    for got, want in zip(tpf._representatives(), jpf._representatives()):
        if isinstance(want, list):
            assert got == want
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for got, want in zip(tpf._all_combos(), jpf._all_combos()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert [l for l, _ in teq.canonical_hands()] == \
        [l for l, _ in jeq.canonical_hands()]


def test_matchup_pair_counts_match_jax_and_the_artifact():
    n = tpf.matchup_pair_counts()
    assert n.dtype == np.int64
    np.testing.assert_array_equal(n, jpf.matchup_pair_counts())
    np.testing.assert_array_equal(n, _npz("pushfold_eq169_cr.npz")["n_pairs"])


@pytest.mark.parametrize("stack_bb", [3.0, 10.0, 20.0])
def test_solvers_match_jax_on_the_committed_matrices(stack_bb):
    for name in ("pushfold_eq169.npz", "pushfold_eq169_exact.npz"):
        eq = _npz(name)["equity"]
        got = tpf.solve_push_fold(eq, stack_bb)
        want = jpf.solve_push_fold(eq, stack_bb)
        np.testing.assert_array_equal(got.jam, want.jam)
        np.testing.assert_array_equal(got.call, want.call)
        assert got.labels == want.labels and got.stack_bb == want.stack_bb
    cr = _npz("pushfold_eq169_cr.npz")
    got = tpf.solve_push_fold_cr(cr["equity"], cr["n_pairs"], stack_bb)
    want = jpf.solve_push_fold_cr(cr["equity"], cr["n_pairs"], stack_bb)
    np.testing.assert_array_equal(got.jam, want.jam)
    np.testing.assert_array_equal(got.call, want.call)
    assert got.jam_fraction == want.jam_fraction
    assert got.call_fraction == want.call_fraction


def test_exact_ranges_reproduce_the_committed_table():
    """``data/pushfold_ranges.json`` came from the exact matrix: the port's
    solver gives its ranges and (to its 4 decimals) its fractions."""
    eq = _npz("pushfold_eq169_exact.npz")["equity"]
    with open(DATA / "pushfold_ranges.json") as f:
        table = json.load(f)["solutions"]
    for key, want in table.items():
        sol = tpf.solve_push_fold(eq, float(key[:-2]))
        assert sol.jam_range() == want["sb_jam_range"], key
        assert sol.call_range() == want["bb_call_range"], key
        assert round(sol.jam_fraction, 4) == want["sb_jam_fraction"], key
        assert round(sol.call_fraction, 4) == want["bb_call_fraction"], key


def test_pair_exact_scores_match_jax():
    """2 * wins + ties of a few matchups over a slice of the C(48, 5)
    boards: JAX's padded scan and the port's chunks (a short last one)
    give the same integers."""
    heroes, villains = tpf._matchups()
    sel = [0, 12, 100, 5000, 14280, 28560]
    slots = tpf._all_board_slots()
    np.testing.assert_array_equal(slots, jpf._all_board_slots())
    boards = slots[::400][:4096]
    dead, hm, vm = tpf._pair_masks(heroes[sel], villains[sel], "cpu")
    got = tpf._pair_exact_scores(dead, hm, vm, torch.from_numpy(boards), 1000)
    want = jpf._pair_exact_scores(
        jnp.asarray(np.sort(np.concatenate([heroes[sel], villains[sel]], 1),
                            1)),
        jev.suit_masks_from_cards(jnp.asarray(heroes[sel])),
        jev.suit_masks_from_cards(jnp.asarray(villains[sel])),
        jnp.asarray(boards.reshape(4, 1024, 5)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


def test_exact_rows_follow_the_scores(monkeypatch):
    """``matchup_equity_matrix_exact``'s rows are the exact scores over
    2 x the boards (here a slice of them)."""
    boards = tpf._all_board_slots()[::997]
    monkeypatch.setattr(tpf, "_all_board_slots", lambda: boards)
    rows = tpf._exact_rows([0, 168], m_chunk=100, board_chunk=500,
                           device="cpu")
    heroes, villains = tpf._matchups()
    sel = np.r_[0:169, 168 * 169:169 * 169]
    dead, hm, vm = tpf._pair_masks(heroes[sel], villains[sel], "cpu")
    scores = tpf._pair_exact_scores(dead, hm, vm, torch.from_numpy(boards),
                                    1 << 12).numpy()
    np.testing.assert_array_equal(rows.reshape(-1),
                                  scores / (2.0 * len(boards)))


def test_cr_matrix_aggregates_as_jax(monkeypatch):
    """``matchup_equity_matrix_cr``'s class aggregation equals JAX's on the
    same pair results (a seeded stand-in for the full sweep)."""
    _, reps, _, _ = tpf._representatives()
    combos, _ = tpf._all_combos()
    rng = np.random.default_rng(5)
    weight = np.array([[float(not set(h) & set(c)) for c in combos.tolist()]
                       for h in reps.tolist()])
    pe = np.where(weight > 0, rng.random(weight.shape), np.nan)
    res = teq.RangeEquityResult(0.5, pe, weight, 1712304)

    def fake(*args, **kwargs):
        return res
    monkeypatch.setattr(tpf, "equity_exact_range_vs_range", fake)
    monkeypatch.setattr(jeq, "equity_exact_range_vs_range", fake)
    got_eq, got_n = tpf.matchup_equity_matrix_cr(device="cpu")
    want_eq, want_n = jpf.matchup_equity_matrix_cr()
    np.testing.assert_array_equal(got_eq, want_eq)
    np.testing.assert_array_equal(got_n, want_n)


def test_matchup_equity_matrix_within_4_sigma_of_exact():
    n_per = 64
    eq = tpf.matchup_equity_matrix(11, n_per=n_per, m_chunk=4096,
                                   device="cpu")
    exact = _npz("pushfold_eq169_exact.npz")["equity"]
    assert eq.shape == (169, 169) and eq.dtype == np.float64
    # the entries are exact fractions of the draws
    np.testing.assert_array_equal(eq * 2 * n_per, np.round(eq * 2 * n_per))
    # each entry an independent estimate, its variance at most
    # p (1 - p) / n_per: the sum of z^2 sees every entry (a transposed,
    # shifted or constant matrix fails it), the strict upper triangle's z a
    # bias between hero and villain
    z_e = (eq - exact) / np.sqrt(exact * (1 - exact) / n_per)
    chi2 = (z_e ** 2).sum()
    assert chi2 < z_e.size + 4 * np.sqrt(2 * z_e.size), chi2
    up = z_e[np.triu_indices(169, 1)]
    assert abs(up.sum() / np.sqrt(up.size)) < 4, up.sum()
    # matchup p's boards are rollouts p * n_per ... of sample_distinct
    slots = teq.sample_distinct(11, 48, 5, 2 * n_per, device="cpu")
    heroes, villains = tpf._matchups()
    dead, hm, vm = tpf._pair_masks(heroes[:2], villains[:2], "cpu")
    s = tpf._scores(list(slots.reshape(2, n_per, 5).unbind(-1)), dead, hm,
                    vm)
    np.testing.assert_array_equal(eq.reshape(-1)[:2],
                                  s.numpy() / (2.0 * n_per))


# ---- tests/test_models.py's push/fold cases, on the port -----------------

def test_push_fold_solver_logic_on_synthetic_matrix():
    idx = np.arange(169, dtype=np.float64)
    strength = 1.0 - idx / 168.0
    eqm = 0.5 + 0.4 * (strength[:, None] - strength[None, :])
    sol10 = tpf.solve_push_fold(eqm, 10)
    sol5 = tpf.solve_push_fold(eqm, 5)
    assert sol10.jam[0] > 0.9 and sol10.call[0] > 0.9
    assert sol10.jam[-1] < 0.1
    assert sol5.jam_fraction >= sol10.jam_fraction
    assert sol5.call_fraction >= sol10.call_fraction


def test_push_fold_matches_published_nash():
    sol = tpf.solve_push_fold(_npz("pushfold_eq169.npz")["equity"], 10.0)
    assert 0.52 < sol.jam_fraction < 0.64
    assert 0.32 < sol.call_fraction < 0.44
    assert "AA" in sol.jam_range() and "AA" in sol.call_range()
    assert "32o" not in sol.jam_range()
    fr = [tpf.solve_push_fold(_npz("pushfold_eq169.npz")["equity"],
                              s).jam_fraction for s in (3.0, 10.0, 20.0)]
    assert fr[0] > fr[1] > fr[2]


def test_all_combos_partition():
    combos, cls = tpf._all_combos()
    assert combos.shape == (1326, 2) and cls.shape == (1326,)
    _, _, _, w = tpf._representatives()
    np.testing.assert_array_equal(np.bincount(cls, minlength=169),
                                  w.astype(np.int64))
    assert len({tuple(sorted(c)) for c in combos.tolist()}) == 1326


def test_matchup_pair_counts_invariants():
    _, _, _, w = tpf._representatives()
    n = tpf.matchup_pair_counts()
    np.testing.assert_array_equal(n.sum(axis=1), (w * 1225).astype(np.int64))
    np.testing.assert_array_equal(n, n.T)
    labels = [l for l, _ in teq.canonical_hands()]
    aa, kk = labels.index("AA"), labels.index("KK")
    assert n[aa, aa] == 6 * 1
    assert n[aa, kk] == 6 * 6


def test_push_fold_cr_solver_book_values():
    eq = _npz("pushfold_eq169_exact.npz")["equity"]
    sol = tpf.solve_push_fold_cr(eq, tpf.matchup_pair_counts(), 10.0)
    assert 0.50 < sol.jam_fraction < 0.66, sol.jam_fraction
    assert 0.30 < sol.call_fraction < 0.45, sol.call_fraction
    assert "AA" in sol.jam_range() and "AA" in sol.call_range()
    assert "72o" not in sol.call_range()


def test_push_fold_cr_artifact_matches_book():
    """The port's solver on the committed card-removal matrix reproduces
    ``data/pushfold_ranges_cr.json`` at every stack, 10 bb at jam 0.5825
    and call 0.3738."""
    cr = _npz("pushfold_eq169_cr.npz")
    eq, n_pairs = cr["equity"], cr["n_pairs"]
    np.testing.assert_allclose(eq + eq.T, 1.0, atol=1e-9)
    np.testing.assert_array_equal(n_pairs, n_pairs.T)
    with open(DATA / "pushfold_ranges_cr.json") as f:
        ranges = json.load(f)["stacks_bb"]
    for key, want in ranges.items():
        sol = tpf.solve_push_fold_cr(eq, n_pairs, float(key))
        assert sol.jam_fraction == want["jam_fraction"], key
        assert sol.call_fraction == want["call_fraction"], key
        assert sol.jam_range() == want["jam"], key
        assert sol.call_range() == want["call"], key
    assert round(ranges["10"]["jam_fraction"], 4) == 0.5825
    assert round(ranges["10"]["call_fraction"], 4) == 0.3738
    fracs = [ranges[s]["jam_fraction"] for s in ("3", "5", "10", "20")]
    assert fracs == sorted(fracs, reverse=True)
