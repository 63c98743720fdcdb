"""The port's native loader (``montecarlo_tpu_torch/native.py``): the C++
table engine and evaluators of ``native/mcpoker.cpp`` built under
``montecarlo_tpu_torch/_build/native/``, never in ``native/``.

- A few of ``tests/test_native.py``'s cases through the port's loader:
  the evaluator against the oracle, table trajectories against the
  oracle, a short-stack side pot, the comparison key against JAX's.
- ``NativeTable`` against the port's table engine (``step_table`` on one
  table, the same deck injected with ``redeal``): every field of the
  native snapshot at every step, and the settled stacks at hand end.
- The build: one library under ``_build/native/<hash>/``, nothing new in
  ``native/``, concurrent builds making one library.
Tolerance 0 throughout.
"""

import random
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops.evaluator import eval_masks_cmp, suit_masks_from_cards
from montecarlo_tpu.ops.ref_evaluator import ref_eval_best
from montecarlo_tpu_torch import native
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine import step as tstep
from montecarlo_tpu_torch.engine.street import bets_as_layers
from oracle_engine import OracleGame
from test_conformance import gen_action

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = ROOT / "native"


@pytest.fixture(scope="module", autouse=True)
def native_dir_untouched():
    """No file appears in, or changes under, ``native/`` while the port's
    library is built and used."""
    if native.compiler() is None:
        pytest.skip("needs a host C++ compiler to build native/mcpoker.cpp")
    before = {p.name: p.stat().st_mtime_ns for p in NATIVE_DIR.iterdir()}
    assert native.available()
    yield
    after = {p.name: p.stat().st_mtime_ns for p in NATIVE_DIR.iterdir()}
    # the JAX package's own tests may build libmcpoker.so in native/ at the
    # same time (its loader runs make there); the port adds nothing else
    new = set(after) - set(before) - {"libmcpoker.so"}
    assert not new, new
    assert {k: v for k, v in after.items() if k in before
            and k != "libmcpoker.so"} == \
        {k: v for k, v in before.items() if k != "libmcpoker.so"}


def test_library_lies_under_the_ports_build_directory():
    lib = native.library_path()
    assert lib.exists()
    assert lib.parent.parent == ROOT / "montecarlo_tpu_torch" / "_build" \
        / "native"
    assert native._load()._name == str(lib)
    # the build flags: the Makefile's, less -march=native
    makefile = (NATIVE_DIR / "Makefile").read_text()
    assert "-march=native" in makefile
    assert "-march=native" not in native.CXX_FLAGS


def test_concurrent_builds_make_one_library(tmp_path, monkeypatch):
    """Processes that build at once (pytest workers) build once between
    them: the lock holds the others until the library is in place."""
    code = ("import sys; from pathlib import Path; "
            "from montecarlo_tpu_torch import native; "
            f"native.BUILD = Path({str(tmp_path)!r}); "
            "print(native.build())")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(set(outs)) == 1
    built = list(tmp_path.rglob("*.so"))
    assert [str(p) for p in built] == outs[:1]
    assert not [p for p in tmp_path.rglob("*") if p.name.startswith(
        ".libmcpoker")], "a temporary file was left behind"


def test_native_eval7_vs_oracle():
    rng = random.Random(99)
    hands = [rng.sample(range(52), 7) for _ in range(2000)]
    got = native.eval7_batch(np.array(hands, dtype=np.int32))
    want = np.array([ref_eval_best(h) for h in hands], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
    assert native.eval7(hands[0]) == want[0]


def test_native_cmp_key_bit_exact_vs_jax():
    rng = np.random.default_rng(7)
    hands = np.argsort(rng.random((50_000, 52)), axis=1)[:, :7].astype(
        np.int32)
    got = native.eval7_cmp_batch(hands)
    want = np.asarray(eval_masks_cmp(*suit_masks_from_cards(
        jnp.asarray(hands)))).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def _snapshot_matches_oracle(g, t):
    s, nt = g.snapshot(), t.snapshot()
    for k in ("stacks", "in_hand", "remaining", "stage", "time",
              "n_revealed", "over", "head"):
        assert nt[k] == s[k], k
    assert nt["bets"] == [tuple(x) for x in s["bets"]]
    assert nt["pots"] == [tuple(x) for x in s["pots"]]


@pytest.mark.parametrize("n_seats,seed", [(2, 21), (3, 22), (6, 24)])
def test_native_table_trajectory_vs_oracle(n_seats, seed):
    rng = random.Random(seed)
    deck = list(range(52))
    rng.shuffle(deck)
    g = OracleGame(n=n_seats, small=5, big=10, deck=deck)
    t = native.NativeTable(n_seats, 5, 10, deck)
    _snapshot_matches_oracle(g, t)
    for _ in range(300):
        if g.over:
            break
        raw = gen_action(rng, g)
        assert t.clamp(raw) == g.clamp(raw)
        t.act(raw)
        g.act(g.clamp(raw))
        _snapshot_matches_oracle(g, t)
    else:
        pytest.fail("game did not terminate")
    t.settle()
    g.settle()
    assert t.snapshot()["stacks"] == g.stacks


def test_native_custom_stacks_all_in_side_pot():
    deck = list(range(52))
    g = OracleGame(n=3, small=5, big=10, deck=deck, stacks=[100, 100, 40])
    t = native.NativeTable(3, 5, 10, deck, stacks=[100, 100, 40])
    for a in [30, 0, 0, 0, 0, 0, 0, 0, 0]:
        t.act(a)
        g.act(g.clamp(a))
        _snapshot_matches_oracle(g, t)
    assert g.over
    t.settle()
    g.settle()
    assert t.snapshot()["stacks"] == g.stacks


def _layers(layers, P):
    """Table 0's layer list as the native snapshot's tuples."""
    def members(mask):
        return frozenset(j for j in range(P) if (int(mask) >> j) & 1)

    return [(int(layers.amt[0, i]), members(layers.mem[0, i]),
             members(layers.orig[0, i]), int(layers.n[0, i]))
            for i in range(int(layers.count[0]))]


def _port_view(st):
    P = st.num_seats
    head, _, exists = tstep.head_info(st)

    def seats(mask):
        return frozenset(j for j in range(P) if bool(mask[0, j]))

    return {
        "stacks": st.stacks[0].tolist(), "in_hand": seats(st.in_hand),
        "remaining": seats(st.to_act), "stage": int(st.stage[0]),
        "time": int(st.time[0]), "n_revealed": int(st.n_community[0]),
        "head": int(head[0]) if bool(exists[0]) else None,
        "bets": _layers(bets_as_layers(st.bets, st.folded), P),
        "pots": _layers(st.pots, P),
    }


@pytest.mark.parametrize("n_seats,seed", [(2, 31), (3, 32), (4, 33),
                                          (6, 34)])
def test_native_table_equals_step_table_on_the_same_deck(n_seats, seed):
    """One hand on the native table and on the port's ``step_table`` (one
    table, the native deck injected): every snapshot field after every
    action, then the native settlement equal to the stacks the port's
    step carried into its next hand (rotated one seat, the new blinds
    posted)."""
    rng = random.Random(seed)
    deck = list(range(52))
    rng.shuffle(deck)
    cfg = tstate.TableConfig(num_seats=n_seats)
    st = tstate.init_state(seed, cfg, 1, "cpu")
    st = tstate.redeal(st, torch.tensor([deck]))
    t = native.NativeTable(n_seats, 5, 10, deck)
    g = OracleGame(n=n_seats, small=5, big=10, deck=deck)  # draws actions
    for _ in range(300):
        snap = t.snapshot()
        view = _port_view(st)
        for k, v in view.items():
            assert snap[k] == v, k
        raw = gen_action(rng, g)
        assert t.clamp(raw) == int(tstep.clamp_action(st, raw)[0])
        t.act(raw)
        g.act(g.clamp(raw))
        st = tstep.step_table(st, tstep.clamp_action(st, raw))
        if t.snapshot()["over"]:
            break
    else:
        pytest.fail("game did not terminate")
    assert int(st.hand_idx[0]) == 1
    t.settle()
    settled = t.snapshot()["stacks"]
    posted = [5, 10] + [0] * (n_seats - 2)
    # new position k is old position k + 1
    carried = [st.stacks[0, (j - 1) % n_seats].item()
               + posted[(j - 1) % n_seats] for j in range(n_seats)]
    assert settled == carried
