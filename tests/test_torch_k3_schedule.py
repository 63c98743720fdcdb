"""K3's warp schedule against the plain K3 and the JAX kernel.

K3 (``csrc/engine.cuh``, ``mc_run_det``) steps each table on its own
cursor and settles a warp's waiting tables together, once
``DET_SETTLE_MIN`` of its 32 wait or none can step.
``ops/cuda_engine._run_det_warps`` runs that schedule in plain PyTorch:
its state must equal ``_run_det_plain``'s (a settle pass after every
step) and JAX's ``run_perpetual_det(interpret=True)`` bit for bit, over
the whole packed state, under every rule set, at P = 2 and 6, with tables
waiting at entry, tables that freeze within the launch, more hands than
the stash holds (the clamped stash row) and step counts of 1 and of no
round size. Its counts are pinned on a hand-built block
(``tests/test_torch_csrc_host.py`` holds its ``DET_SETTLE_MIN`` to the
kernel's ``#define``). Every comparison is exact (tolerance 0). One
block of 1024 tables.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops import pallas_engine as jpe
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.ops import cuda_engine as ce
from test_torch_csrc_host import _waiting_at_entry

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

T = ce.TABLES_PER_BLOCK
SB, BB = 5, 10


def _streams(seed, P, n_steps, hmax):
    """Raw actions [1, n_steps, 8, 128] (folds 20%, calls 72%, raises 8%,
    pre-clamp, as tests/test_pallas_engine.py) and deals [T, hmax,
    2P+5]."""
    rng = np.random.default_rng(seed)
    u = rng.random((n_steps, T))
    acts = np.where(u < 0.20, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    deal = np.argsort(rng.random((T, hmax, 52)), axis=-1)[..., :2 * P + 5]
    return acts.reshape(1, n_steps, *ce.TILE), deal.astype(np.int32)


def _stash(deal):
    """[T, hmax, 2P+5] -> the kernel's [1, hmax, 2P+5, 8, 128]."""
    hmax, nc = deal.shape[1], deal.shape[2]
    return np.ascontiguousarray(deal.transpose(1, 2, 0)
                                .reshape(1, hmax, nc, *ce.TILE))


def _frozen(state, cfg):
    return (ce.unpack_field(state, cfg, "order") == 0) \
        & (ce.unpack_field(state, cfg, "wait") == 0)


# P, rules, starting stack, n_steps, hmax, share of tables waiting at entry
CASES = [
    (6, "reference", 100, 37, 2, 0.0),    # more hands than the stash rows
    (2, "reference", 100, 1, 12, 0.5),    # one step; waiting at entry
    (6, "standard", 100, 1, 12, 0.5),
    (2, "standard", 100, 29, 3, 0.25),
    (6, "tournament", 10, 23, 12, 0.0),   # most tables freeze in the launch
    (2, "tournament", 20, 31, 4, 0.25),
]


@pytest.mark.parametrize("P,rules,stack,n_steps,hmax,share", CASES)
def test_warp_schedule_equals_plain_and_jax(P, rules, stack, n_steps, hmax,
                                            share):
    seed = 31 * P + n_steps
    acts, deal = _streams(seed, P, n_steps, hmax)
    cards = _stash(deal)
    cfg = TableConfig(num_seats=P, rules=rules, starting_stack=stack)
    state = ce.pack_state(cfg, torch.from_numpy(deal[:, 0]))
    if share:
        state = _waiting_at_entry(state, P, rules, share, seed)
        n_wait = int(ce.unpack_field(state, cfg, "wait").sum())
        assert 0 < n_wait < T
    acts_t, cards_t = torch.from_numpy(acts), torch.from_numpy(cards)
    got, counts = ce._run_det_warps(state, acts_t, cards_t, P, n_steps, SB,
                                    BB, rules)
    plain = ce._run_det_plain(state, acts_t, cards_t, P, n_steps, SB, BB,
                              rules)
    want = np.asarray(jpe.run_perpetual_det(
        jnp.asarray(ce.state_to_numpy(state)), jnp.asarray(acts),
        jnp.asarray(cards), P, n_steps, SB, BB, rules=rules,
        interpret=True))
    layout, _ = ce._field_layout(P, rules)
    for name, (off, rows) in layout.items():
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      plain[:, off:off + rows].numpy(),
                                      err_msg=f"plain {name}")
        np.testing.assert_array_equal(got[:, off:off + rows].numpy(),
                                      want[:, off:off + rows],
                                      err_msg=f"JAX {name}")
    hands = ce.unpack_field(got, cfg, "hand_ct")
    assert int(hands.sum()) > 0
    if hmax < 12:  # some table dealt past the stash: its last row again
        assert int(hands.max()) >= hmax
    if stack == 10:
        froze = _frozen(got, cfg) & ~_frozen(state, cfg)
        assert float(froze.float().mean()) > 0.5
    # a warp settles no more often than the plain schedule; a warp whose
    # tables do not freeze passes at least once a step
    assert counts["warps"] == T // ce.WARP
    assert 0 < counts["settle_passes"] <= counts["plain_settle_steps"]
    if rules != "tournament":
        assert counts["iterations"] >= n_steps * counts["warps"]


def test_warp_schedule_counts_on_a_hand_built_block():
    """Heads-up reference tables on streams of one action each: a fold
    ends the hand in one step, and calls end it at showdown after 8 (two
    a street). Over 16 steps:
    - warps 0-9 fold throughout: all 32 tables wait after every step, so
      16 passes that step, each with a settle pass (the plain schedule:
      16 settle steps);
    - warps 10-19 call throughout: hands end together at steps 7 and 15,
      so 16 passes and 2 settle passes (plain: 2);
    - warps 20-31: lanes 0-3 fold, the rest call. The 4 folders wait from
      the first pass (fewer than DET_SETTLE_MIN) while the callers step,
      until the callers' hands end on passes 8 and 16; then the folders'
      14 steps left run alone, each settled at once: 30 passes, 16
      settle passes (plain: 16)."""
    P, n_steps, hmax = 2, 16, 20
    assert ce.DET_SETTLE_MIN > 4
    lane = np.arange(T)
    warp, in_warp = lane // ce.WARP, lane % ce.WARP
    folds = (warp < 10) | ((warp >= 20) & (in_warp < 4))
    acts = np.broadcast_to(np.where(folds, -1, 0).astype(np.int32),
                           (n_steps, T)).reshape(1, n_steps, *ce.TILE)
    _, deal = _streams(5, P, 1, hmax)
    cards = torch.from_numpy(_stash(deal))
    cfg = TableConfig(num_seats=P)
    state = ce.pack_state(cfg, torch.from_numpy(deal[:, 0]))
    acts_t = torch.from_numpy(np.ascontiguousarray(acts))
    got, counts = ce._run_det_warps(state, acts_t, cards, P, n_steps, SB,
                                    BB)
    assert torch.equal(got, ce._run_det_plain(state, acts_t, cards, P,
                                              n_steps, SB, BB))
    hands = ce.unpack_field(got, cfg, "hand_ct").numpy()
    np.testing.assert_array_equal(hands, np.where(folds, 16, 2))
    assert counts == {"warps": 32,
                      "iterations": 10 * 16 + 10 * 16 + 12 * 30,
                      "settle_passes": 10 * 16 + 10 * 2 + 12 * 16,
                      "plain_settle_steps": 10 * 16 + 10 * 2 + 12 * 16}

