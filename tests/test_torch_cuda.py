"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the
decision is taken inside the ``cuda`` fixture, never at import). On a
machine with a card:  python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.engine import replay
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import bots
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_carry as cc
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.ops import cuda_net_split as cns
from montecarlo_tpu_torch.ops import cuda_split as csp
from montecarlo_tpu_torch.ops import cuda_stages as cs
from montecarlo_tpu_torch.ops import philox
from montecarlo_tpu_torch.rollout import equity as teq
from test_torch_csrc_host import _waiting_at_entry
from test_torch_philox import PHILOX_KAT

pytestmark = pytest.mark.cuda

AKS = [teq.make_card(0, 14), teq.make_card(0, 13)]
QQ = [teq.make_card(1, 12), teq.make_card(2, 12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n_board", [0, 3, 4])
def test_equity_kernel_equals_plain(cuda, n_board):
    g = torch.Generator(device=cuda).manual_seed(n_board)
    board = [teq.make_card(3, 2), teq.make_card(1, 7), teq.make_card(2, 13),
             teq.make_card(0, 9)][:n_board]
    dead, hm, vm = cq._hand_masks(AKS, QQ, board, cuda)
    words = cq.random_words(g, (5 - n_board, 1 << 18), cuda)
    before = cq.LAUNCHES["equity"]
    k = cq.equity_counts(0, dead, hm, vm, 1 << 18, words=words)
    assert cq.LAUNCHES["equity"] == before + 1
    p = cq._equity_counts_plain(words, dead.tolist(), hm.tolist(),
                                vm.tolist())
    assert k.tolist() == p.tolist()


@pytest.mark.parametrize("ctr_key,want", PHILOX_KAT)
def test_philox_kernel_known_answers(cuda, ctr_key, want):
    got = philox.philox_blocks(torch.tensor([ctr_key], dtype=torch.int64,
                                            device=cuda))
    assert got[0].tolist() == want


@pytest.mark.parametrize("n_board", [0, 3, 4])
def test_equity_kernel_philox_equals_cpu(cuda, n_board):
    """Philox mode: the kernel and the CPU plain version give the same
    counts for a seed (n not a multiple of the grid's threads)."""
    board = [teq.make_card(3, 2), teq.make_card(1, 7), teq.make_card(2, 13),
             teq.make_card(0, 9)][:n_board]
    n = (1 << 20) + 7
    k = cq.equity_vs_hand_counts(99, AKS, QQ, n, board, cuda)[0]
    p = cq.equity_vs_hand_counts(99, AKS, QQ, n, board, "cpu")[0]
    assert k.tolist() == p.tolist()


def test_sweep_kernel_philox_equals_cpu(cuda):
    heroes = torch.tensor([list(c) for _, c in teq.canonical_hands()[:30]],
                          dtype=torch.int32)
    dead = torch.sort(heroes, dim=1).values
    hm = torch.stack(cq.suit_masks_from_cards(heroes), dim=1)
    k = cq.sweep_counts(5, dead.to(cuda), hm.to(cuda), 20001)
    assert torch.equal(k.cpu(), cq.sweep_counts(5, dead, hm, 20001))


@pytest.mark.parametrize("P,n_steps", [(6, 64), (2, 24)])
def test_selfplay_kernel_philox_equals_cpu(cuda, P, n_steps):
    cfg = TableConfig(num_seats=P)
    T = 2 * ce.TABLES_PER_BLOCK
    k = ce.selfplay_perpetual_kernel(8, cfg, T, n_steps, device=cuda)
    p = ce.selfplay_perpetual_kernel(8, cfg, T, n_steps, device="cpu")
    assert torch.equal(k[0].cpu(), p[0]) and k[1:] == p[1:]


def test_sweep_kernel_equals_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    heroes = torch.tensor([list(c) for _, c in teq.canonical_hands()[:20]],
                          dtype=torch.int32)
    dead = torch.sort(heroes, dim=1).values.to(cuda)
    hm = torch.stack(cq.suit_masks_from_cards(heroes), dim=1).to(cuda)
    words = cq.random_words(g, (7, 20, 4096), cuda)
    k = cq.sweep_counts(0, dead, hm, 4096, words=words)
    assert torch.equal(k, cq._sweep_counts_plain(words, dead, hm))


def _sweep_inputs(H, device):
    heroes = torch.tensor([list(c) for _, c in teq.canonical_hands()[:H]],
                          dtype=torch.int32)
    return (torch.sort(heroes, dim=1).values.to(device),
            torch.stack(cq.suit_masks_from_cards(heroes), dim=1).to(device))


@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("H,n", [(1, 77), (1, 100_001), (169, 77),
                                 (169, 20_001)])
def test_sweep_kernel_forms_equal_plain(cuda, inject, H, n):
    """Both K2 instantiations (Philox, injected words) at one hand and at
    169, with n odd and n under one block: the counts equal the plain
    version's and the call launches the kernel once."""
    dead, hm = _sweep_inputs(H, cuda)
    words = None
    if inject:
        g = torch.Generator(device=cuda).manual_seed(H + n)
        words = cq.random_words(g, (7, H, n), cuda)
    before = cq.LAUNCHES["sweep"]
    k = cq.sweep_counts(3, dead, hm, n, words=words)
    assert cq.LAUNCHES["sweep"] == before + 1
    p = (cq._sweep_counts_plain(words, dead, hm) if inject
         else cq._sweep_counts_plain_philox(3, dead, hm, n))
    assert torch.equal(k, p)


def test_sweep_kernel_wave_grid_equals_plain(cuda):
    """K2's grid from the card (MC_EQUITY_WAVES waves of resident blocks
    over the hands) differs from the first form's 132 x 16 / H blocks a
    hand, and the counts still equal the plain version's."""
    H, n = 169, 200_003
    blocks, per_sm = cq.sweep_grid(H, n)
    assert blocks != 132 * 16 // H and per_sm >= 1
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert blocks == -(-16 * n_sms * per_sm // H)
    dead, hm = _sweep_inputs(H, cuda)
    assert torch.equal(cq.sweep_counts(9, dead, hm, n),
                       cq._sweep_counts_plain_philox(9, dead, hm, n))


def test_equity_vs_hand_philox_within_4_sigma_of_exact(cuda):
    exact = teq.equity_exact(AKS, QQ, device=cuda).equity
    r = teq.equity_vs_hand(7, AKS, QQ, 1 << 26, device=cuda)
    assert abs(r.equity - exact) < 4 * r.stderr, (r.equity, exact)


@pytest.mark.parametrize("P", [2, 6])
def test_engine_det_kernel_equals_plain(cuda, P):
    _engine_det_kernel_equals_plain(cuda, P, "reference")


@pytest.mark.parametrize("P", [2, 6])
def test_engine_det_kernel_equals_plain_standard_rules(cuda, P):
    _engine_det_kernel_equals_plain(cuda, P, "standard")


@pytest.mark.parametrize("P,stack", [(2, 30), (6, 20), (6, 100)])
def test_engine_det_kernel_equals_plain_tournament_rules(cuda, P, stack):
    _engine_det_kernel_equals_plain(cuda, P, "tournament", stack)


@pytest.mark.parametrize("rules", ce.RULES)
def test_engine_det_kernel_long_run_equals_plain(cuda, rules):
    """K3's step cursors far apart: 4 blocks x 200 steps, 4 stash rows
    (most hands dealt from the clamped last row)."""
    _engine_det_kernel_equals_plain(cuda, 6, rules, nb=4, n_steps=200,
                                    hmax=4)


def test_engine_det_kernel_freezing_warps_equal_plain(cuda):
    """Tournaments from 10-chip stacks over 200 steps: most warps freeze
    whole within the launch, their tables leaving K3's schedule one by
    one."""
    k = _engine_det_kernel_equals_plain(cuda, 6, "tournament", 10, nb=4,
                                        n_steps=200)
    cfg = TableConfig(num_seats=6, rules="tournament", starting_stack=10)
    frozen = (ce.unpack_field(k, cfg, "order") == 0) \
        & (ce.unpack_field(k, cfg, "wait") == 0)
    assert float(frozen.view(-1, ce.WARP).all(1).float().mean()) > 0.5


@pytest.mark.parametrize("rules", ce.RULES)
def test_engine_det_kernel_one_step_equals_plain(cuda, rules):
    """One step, from a state where a quarter of the tables wait at entry
    (settled before their first step)."""
    _engine_det_kernel_equals_plain(
        cuda, 6, rules, n_steps=1,
        prepare=lambda st: _waiting_at_entry(st, 6, rules, 0.25, 1))


@pytest.mark.parametrize("rules", ce.RULES)
def test_engine_det_kernel_frozen_warps_at_entry_equal_plain(cuda, rules):
    """Whole warps frozen at entry (every third warp, and all 64 tables of
    one CUDA block), beside tables that wait at entry: the frozen lanes
    stay in their warps' loops without a table, and their rows are left
    as they were."""
    def prepare(state):
        state = _waiting_at_entry(state, 6, rules, 0.25, 2)
        layout, _ = ce._field_layout(6, rules)
        rows = ce._to_rows(state).clone()
        t = torch.arange(rows.shape[1], device=rows.device)
        off = (t // ce.WARP) % 3 == 0
        off |= (t >= ce.TABLES_PER_BLOCK + 128) \
            & (t < ce.TABLES_PER_BLOCK + 192)
        for name in ("order", "wait"):
            rows[layout[name][0], off] = 0
        return ce._to_blocks(rows)
    k = _engine_det_kernel_equals_plain(cuda, 6, rules, prepare=prepare)
    assert int(ce.unpack_field(k, TableConfig(num_seats=6, rules=rules),
                               "hand_ct").sum()) > 0


def _engine_det_kernel_equals_plain(cuda, P, rules, stack=100, nb=2,
                                    n_steps=40, hmax=12, prepare=None):
    """K3 against its plain version on an injected stream; ``prepare``
    edits the first state. Returns the kernel's state."""
    rng = np.random.default_rng(P)
    T = nb * ce.TABLES_PER_BLOCK
    u = rng.random((nb, n_steps, 8, 128))
    acts = np.where(u < 0.2, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    deal = np.argsort(rng.random((T, hmax, 52)), axis=-1)[..., :2 * P + 5]
    cards = deal.reshape(nb, 1024, hmax, 2 * P + 5).transpose(0, 2, 3, 1) \
        .reshape(nb, hmax, 2 * P + 5, 8, 128).astype(np.int32)
    state = ce.pack_state(TableConfig(num_seats=P, rules=rules,
                                      starting_stack=stack),
                          torch.from_numpy(deal[:, 0]).to(cuda))
    if prepare is not None:
        state = prepare(state)
    acts_t = torch.from_numpy(acts).to(cuda)
    cards_t = torch.from_numpy(np.ascontiguousarray(cards)).to(cuda)
    before = ce.LAUNCHES[f"engine_det_{rules}"]
    k = ce.run_perpetual_det(state, acts_t, cards_t, P, n_steps, 5, 10,
                             rules=rules)
    assert ce.LAUNCHES[f"engine_det_{rules}"] == before + 1
    p = ce._run_det_plain(state, acts_t, cards_t, P, n_steps, 5, 10, rules)
    assert torch.equal(k, p)
    return k


@pytest.mark.parametrize("rules,stack", [("reference", 100),
                                         ("standard", 100),
                                         ("tournament", 20)])
def test_table_engine_card_equals_cpu_and_k3(cuda, rules, stack):
    """The ported ``step_table`` on the card, driven on K3's injected
    stream at four blocks, equals itself on the CPU in every field and
    meter, and equals K3 on every table within capacity
    (``engine/replay.against_k3``)."""
    P, nb, n_steps, hmax = 6, 4, 48, 12
    T = nb * ce.TABLES_PER_BLOCK
    L = ce._L_for(rules)
    cfg = TableConfig(num_seats=P, rules=rules, starting_stack=stack,
                      max_layers=L, max_pot_layers=4 * L)
    rng = np.random.default_rng(29)
    u = rng.random((n_steps, T))
    acts = np.where(u < 0.2, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    deal = np.argsort(rng.random((T, hmax, 52)), axis=-1)[..., :2 * P + 5] \
        .astype(np.int32)
    first = torch.from_numpy(deal[:, 0])
    reps = {}
    for dev in ("cpu", cuda):
        st0 = tstate.redeal(tstate.init_state(0, cfg, T, dev),
                            replay.decks_from_deals(first.to(dev)))
        reps[dev] = replay.replay_injected(
            cfg, st0, torch.from_numpy(acts).to(dev),
            torch.from_numpy(deal).to(dev))
    want, got = (_leaves(tstate.state_to_numpy(reps[d]))
                 for d in ("cpu", cuda))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    packed = ce.pack_state(cfg, first.to(cuda))
    out = ce.run_perpetual_det(
        packed, torch.from_numpy(acts.reshape(n_steps, nb, 8, 128)
                                 .transpose(1, 0, 2, 3).copy()).to(cuda),
        torch.from_numpy(deal.reshape(nb, 1024, hmax, 2 * P + 5)
                         .transpose(0, 2, 3, 1).reshape(
                             nb, hmax, 2 * P + 5, 8, 128).copy()).to(cuda),
        P, n_steps, cfg.small_blind, cfg.big_blind, rules=rules)
    agree = replay.against_k3(out, cfg, reps[cuda])
    assert torch.equal(agree.k3_overflow, reps[cuda].overflow)
    for name, bad in agree.mismatch.items():
        assert not bool(bad.any()), name
    assert float(agree.k3_overflow.float().mean()) < 0.1


def _leaves(x):
    if isinstance(x, tuple):
        return [y for f in x for y in _leaves(f)]
    return [x]


@pytest.mark.parametrize("P,n_steps", [(6, 32), (6, 24), (2, 48)])
def test_engine_prng_kernel_equals_plain(cuda, P, n_steps):
    g = torch.Generator(device=cuda).manual_seed(P + n_steps)
    T = 2 * ce.TABLES_PER_BLOCK
    state = ce.pack_state(TableConfig(num_seats=P),
                          ce.first_deal(3, T, P, cuda))
    words = cq.random_words(g, ce.prng_words_shape(T, P, n_steps), cuda)
    k = ce.run_perpetual_prng(0, state, P, n_steps, 5, 10, words=words)
    assert torch.equal(k, ce._run_prng_plain(state, words, P, n_steps, 5, 10))


def test_selfplay_slots_per_hand(cuda):
    cfg = TableConfig(num_seats=6)
    _, hands, ovf = ce.selfplay_perpetual_kernel(5, cfg, 1 << 16, 512,
                                                 device=cuda)
    assert ovf == 0
    assert abs((1 << 16) * 512 / hands / 33.1 - 1) < 0.02


@pytest.mark.parametrize("P,n_steps", [(6, 32), (6, 24), (2, 48)])
def test_engine_prng_kernel_equals_plain_standard_rules(cuda, P, n_steps):
    g = torch.Generator(device=cuda).manual_seed(P + n_steps)
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules="standard")
    state = ce.pack_state(cfg, ce.first_deal(3, T, P, cuda))
    words = cq.random_words(g, ce.prng_words_shape(T, P, n_steps), cuda)
    k = ce.run_perpetual_prng(0, state, P, n_steps, 5, 10, rules="standard",
                              words=words)
    assert torch.equal(k, ce._run_prng_plain(state, words, P, n_steps, 5, 10,
                                             "standard"))
    # Philox mode: the kernel and the CPU plain version agree for a seed
    k = ce.run_perpetual_prng(7, state, P, n_steps, 5, 10, rules="standard")
    assert torch.equal(k.cpu(), ce.run_perpetual_prng(
        7, state.cpu(), P, n_steps, 5, 10, rules="standard"))


@pytest.mark.parametrize("P,n_steps", [(6, 128), (2, 48)])
def test_engine_prng_kernel_equals_plain_tournament_rules(cuda, P, n_steps):
    """Short stacks, so that seats bust and frozen tables sit through
    settle passes; injected words and Philox mode."""
    g = torch.Generator(device=cuda).manual_seed(P + n_steps)
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules="tournament", starting_stack=20)
    state = ce.pack_state(cfg, ce.first_deal(3, T, P, cuda))
    words = cq.random_words(g, ce.prng_words_shape(T, P, n_steps), cuda)
    before = ce.LAUNCHES["engine_prng_tournament"]
    k = ce.run_perpetual_prng(0, state, P, n_steps, 5, 10,
                              rules="tournament", words=words)
    assert ce.LAUNCHES["engine_prng_tournament"] == before + 1
    assert torch.equal(k, ce._run_prng_plain(state, words, P, n_steps, 5, 10,
                                             "tournament"))
    k = ce.run_perpetual_prng(7, state, P, n_steps, 5, 10, rules="tournament")
    assert torch.equal(k.cpu(), ce.run_perpetual_prng(
        7, state.cpu(), P, n_steps, 5, 10, rules="tournament"))
    assert int((ce.unpack_field(k, cfg, "order") == 0).sum()) > 0


def test_engine_prng_kernel_freezing_blocks_equal_plain(cuda):
    """K4 under tournament rules on four 1024-table blocks that freeze at
    different slots: 12-chip and 20-chip stacks (most tournaments end
    within the launch), 100-chip stacks with every 37th table frozen before
    it, and a block frozen whole before it (run to completion), so warps
    and blocks leave their loops at different times. Injected words and
    Philox mode, against the plain version."""
    P, n_steps = 6, 256
    T = ce.TABLES_PER_BLOCK
    cfgs = [TableConfig(num_seats=P, rules="tournament", starting_stack=s)
            for s in (12, 20, 100)]
    fd = ce.first_deal(8, 3 * T, P, cuda)
    blocks = [ce.pack_state(c, fd[k * T:(k + 1) * T])
              for k, c in enumerate(cfgs)]
    layout = ce._field_layout(P, "tournament")[0]
    for name in ("order", "wait"):
        blocks[2][:, layout[name][0]].view(-1)[::37] = 0
    blocks.append(ce.tournaments_to_completion(9, cfgs[0], T, 64,
                                               device=cuda)[0])
    state = torch.cat(blocks)

    def frozen(st):
        return ((ce.unpack_field(st, cfgs[0], "order") == 0)
                & (ce.unpack_field(st, cfgs[0], "wait") == 0)).view(4, T)
    g = torch.Generator(device=cuda).manual_seed(12)
    words = cq.random_words(g, ce.prng_words_shape(4 * T, P, n_steps), cuda)
    k = ce.run_perpetual_prng(0, state, P, n_steps, 5, 10,
                              rules="tournament", words=words)
    assert torch.equal(k, ce._run_prng_plain(state, words, P, n_steps, 5, 10,
                                             "tournament"))
    k = ce.run_perpetual_prng(13, state, P, n_steps, 5, 10,
                              rules="tournament")
    assert torch.equal(k, ce._run_prng_plain_philox(13, state, P, n_steps, 5,
                                                    10, "tournament"))
    froze = (frozen(k) & ~frozen(state)).sum(1).tolist()
    assert froze[0] > froze[1] > froze[2] >= 0 and froze[3] == 0
    assert bool(frozen(state)[3].all()) and torch.equal(k[3], state[3])


def test_tournaments_to_completion_kernel_equals_cpu(cuda):
    cfg = TableConfig(num_seats=6, rules="tournament", starting_stack=20)
    T = 2 * ce.TABLES_PER_BLOCK
    k, k_steps = ce.tournaments_to_completion(4, cfg, T, 64, device=cuda)
    p, p_steps = ce.tournaments_to_completion(4, cfg, T, 64, device="cpu")
    assert torch.equal(k.cpu(), p) and k_steps == p_steps
    places, frozen = ce.tournament_results(k, cfg)
    assert frozen.all()
    assert (np.sort(places, axis=1) == np.arange(1, 7)).all()


@pytest.mark.parametrize("n_hands,board", [
    (3, ()), (2, (5, 6, 7)), (6, (5, 6, 7, 44)), (12, ()),
    (4, (5, 6, 7, 44, 50))])
def test_multiway_kernel_equals_plain(cuda, n_hands, board):
    """B3 on injected words and in Philox mode (n not a multiple of the
    grid's threads)."""
    hands = [[8 + 2 * h, 9 + 2 * h] for h in range(n_hands)]
    dead, hm = cq._multiway_masks(hands, board, cuda)
    g = torch.Generator(device=cuda).manual_seed(n_hands)
    n = (1 << 18) + 5
    words = cq.random_words(g, (5 - len(board), n), cuda)
    before = cq.LAUNCHES["multiway"]
    k = cq.multiway_shares(0, dead, hm, n, words=words)
    assert cq.LAUNCHES["multiway"] == before + 1
    assert torch.equal(k, cq._multiway_shares_plain(words, dead.tolist(),
                                                    hm.tolist()))
    assert int(k.sum()) == cq.multiway_scale(n_hands) * n
    k = cq.multiway_shares(9, dead, hm, n)
    assert torch.equal(k.cpu(), cq.multiway_shares(9, dead.cpu(), hm.cpu(),
                                                   n))


@pytest.mark.parametrize("n_hands", range(2, 13))
@pytest.mark.parametrize("n_draw", range(6))
def test_multiway_kernel_every_form_equals_plain(cuda, n_hands, n_draw):
    """B3 in each of its instantiations (N hands, NDRAW = 5 - K drawn
    cards; Philox and injected words) equals its plain version."""
    rng = np.random.default_rng(100 * n_hands + n_draw)
    deal = rng.permutation(52)[:2 * n_hands + 5 - n_draw].tolist()
    hands = [deal[2 * h:2 * h + 2] for h in range(n_hands)]
    dead, hm = cq._multiway_masks(hands, deal[2 * n_hands:], cuda)
    n = (1 << 16) + 3
    words = torch.from_numpy(rng.integers(0, 1 << 32, (n_draw, n))).to(cuda)
    k = cq.multiway_shares(0, dead, hm, n, words=words)
    assert torch.equal(k, cq._multiway_shares_plain(words, dead.tolist(),
                                                    hm.tolist()))
    k = cq.multiway_shares(n_draw, dead, hm, n)
    assert torch.equal(k, cq._multiway_shares_plain_philox(
        n_draw, dead.tolist(), hm.tolist(), n, cuda))
    assert int(k.sum()) == cq.multiway_scale(n_hands) * n


def test_multiway_kernel_largest_rollouts_per_thread(cuda):
    """B3 where a thread's 32-bit shares come closest to 2^32: 12 hands on
    a known board (every rollout the same, so 2^40 rollouts run at once),
    a grid of as few threads as the counters allow (mc_rollout_grid), each
    with some 155,000 rollouts of lcm(1..12) = 27,720 shares."""
    hands = [[2 * h, 2 * h + 1] for h in range(12)]
    dead, hm = cq._multiway_masks(hands, [30, 35, 40, 45, 50], cuda)
    n = 1 << 40
    k = cq.multiway_shares(3, dead, hm, n)
    one = cq._multiway_shares_plain(torch.zeros((0, 1), dtype=torch.int64,
                                                device=cuda),
                                    dead.tolist(), hm.tolist())
    assert torch.equal(k, one * n)
    assert int(k.sum()) == cq.multiway_scale(12) * n


@pytest.fixture
def es3(cuda):
    return cn.net_weights(tpn.load_params("data/policy_6max_es3.npz"), cuda)


@pytest.mark.parametrize("rules", cn.RULES)
def test_net_probe_kernel_equals_plain(cuda, es3, rules):
    """Features, masked logits and Gumbel scores bit for bit on the card:
    the kernel's __fdiv_rn/__fmul_rn/__fadd_rn and logf against PyTorch's
    elementwise operations and log on the same inputs."""
    P, T = 6, 4 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules=rules)
    state = cn.run_net_eval(4, cn.initial_packed_state(4, cfg, T, cuda), es3,
                            P, 24, 5, 10, 100, rules, 0b111111)
    words = ce.table_words(5, T, 0, 4, cuda)
    k = cn.net_probe(state, words, es3, P, 10, rules)
    p = cn._net_probe_plain(state, words, es3, P, 10, rules)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.parametrize("rules", cn.RULES)
def test_net_det_kernel_equals_plain(cuda, es3, rules):
    P, n_steps, hmax = 6, 40, 16
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules=rules)
    stash = cn.deal_stash(5, T, P, hmax, cuda)
    state = ce.pack_state(cfg, ce._stash_rows(stash)[0].T)
    before = cn.LAUNCHES[f"net_det_{rules}"]
    k = cn.run_net_det(state, stash, es3, P, n_steps, 5, 10, rules)
    assert cn.LAUNCHES[f"net_det_{rules}"] == before + 1
    p = cn._run_net_det_plain(state, stash, es3, P, n_steps, 5, 10, rules)
    assert torch.equal(k, p)
    assert int(ce.unpack_field(k, cfg, "hand_ct").sum()) > 0


@pytest.mark.parametrize("rules,P,net_seats,n_steps", [
    ("standard", 6, 1, 32), ("standard", 6, 0b101101, 24),
    ("reference", 6, 0b010010, 32), ("standard", 2, 0b01, 32),
    ("standard", 10, 0b1000000001, 16)])
def test_net_eval_kernel_equals_plain(cuda, es3, rules, P, net_seats,
                                      n_steps):
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules=rules)
    state = cn.initial_packed_state(2, cfg, T, cuda)
    g = torch.Generator(device=cuda).manual_seed(net_seats)
    words = cq.random_words(g, cn.net_words_shape(T, P, n_steps), cuda)
    k = cn.run_net_eval(0, state, es3, P, n_steps, 5, 10, 100, rules,
                        net_seats, words=words)
    p = cn._run_net_eval_plain(state, words, es3, P, n_steps, 5, 10, 100,
                               rules, net_seats, True)
    assert torch.equal(k, p)
    k = cn.run_net_eval(11, state, es3, P, n_steps, 5, 10, 100, rules,
                        net_seats)
    p = cn._run_net_eval_plain_philox(11, state, es3, P, n_steps, 5, 10, 100,
                                      rules, net_seats, True)
    assert torch.equal(k, p)
    if rules == "standard":
        seat = sum(ce.unpack_field(k, cfg, "seat_delta", i) for i in range(P))
        assert bool((seat == 0).all())


def _banks(cuda, names):
    panel = bots.panel()
    nets = {"es3": tpn.load_params("data/policy_6max_es3.npz"), **panel}
    return cn.bank_weights([nets[n] for n in names], cuda)


@pytest.mark.parametrize("rules", cn.RULES)
def test_net_det_banked_kernel_equals_plain(cuda, rules):
    P, n_steps, hmax = 6, 40, 16
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules=rules)
    stash = cn.deal_stash(5, T, P, hmax, cuda)
    state = ce.pack_state(cfg, ce._stash_rows(stash)[0].T)
    weights = _banks(cuda, ["jam_tight", "fof_call", "es3"])
    stb = (0, 1, 2, 1, 2, 1)
    before = cn.LAUNCHES[f"net_det_banked_{rules}"]
    k = cn.run_net_det(state, stash, weights, P, n_steps, 5, 10, rules, stb)
    assert cn.LAUNCHES[f"net_det_banked_{rules}"] == before + 1
    p = cn._run_net_det_plain(state, stash, weights, P, n_steps, 5, 10, rules,
                              stb)
    assert torch.equal(k, p)
    assert int(ce.unpack_field(k, cfg, "hand_ct").sum()) > 0


@pytest.mark.parametrize("rules", cn.RULES)
def test_net_det_nine_banks_kernel_equals_plain(cuda, rules):
    """Banked K5 with the most banks a launch takes: seats 0 and 3 play
    banks 7 and 8, which the kernel reads from global memory."""
    P, n_steps, hmax = 6, 40, 16
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules=rules)
    stash = cn.deal_stash(8, T, P, hmax, cuda)
    state = ce.pack_state(cfg, ce._stash_rows(stash)[0].T)
    weights = _banks(cuda, ["es3", "jam_tight", "fof_call", "fof_raise",
                            "nit_ladder", "made_ladder", "jam_loose",
                            "minraisebot", "potraisebot"])
    stb = (7, 1, 2, 8, 4, 0)
    k = cn.run_net_det(state, stash, weights, P, n_steps, 5, 10, rules, stb)
    p = cn._run_net_det_plain(state, stash, weights, P, n_steps, 5, 10, rules,
                              stb)
    assert torch.equal(k, p)


@pytest.mark.parametrize("rules,n_banks,stb", [
    ("standard", 2, (0, 1, 1, 1, 1, 1)), ("reference", 3, (2, 0, 1, 1, 0, 2)),
    ("standard", 9, (8, 7, 6, 5, 4, 3)), ("reference", 8, (7, 0, 7, 1, 7, 2))])
def test_net_league_kernel_equals_plain(cuda, rules, n_banks, stb):
    """B7 on injected words and in Philox mode, with the decisions the
    kernel counts; seven banks and the staging rows take 214,928 bytes of
    dynamic shared memory (the opt-in above 48 KB), and banks 7 and 8 are
    read from global memory."""
    P, n_steps = 6, 32
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules=rules)
    state = cn.initial_packed_state(2, cfg, T, cuda)
    names = ["es3", *bots.panel()][:n_banks]
    weights = _banks(cuda, names)
    g = torch.Generator(device=cuda).manual_seed(n_banks)
    words = cq.random_words(g, cn.net_words_shape(T, P, n_steps), cuda)
    before = cn.LAUNCHES[f"net_league_{rules}"]
    k = cn.run_net_league(0, state, weights, P, n_steps, 5, 10, 100, rules,
                          0b111011, stb, words=words)
    assert cn.LAUNCHES[f"net_league_{rules}"] == before + 1
    p = cn._run_net_eval_plain(state, words, weights, P, n_steps, 5, 10, 100,
                               rules, 0b111011, True, stb)
    assert torch.equal(k, p)
    dk, dp = (torch.zeros(1, dtype=torch.int64, device=cuda) for _ in "kp")
    k = cn.run_net_league(11, state, weights, P, n_steps, 5, 10, 100, rules,
                          0b111011, stb, decisions=dk)
    p = cn._run_net_eval_plain_philox(11, state, weights, P, n_steps, 5, 10,
                                      100, rules, 0b111011, True, stb, dp)
    assert torch.equal(k, p) and int(dk) == int(dp) > 0


@pytest.mark.parametrize("n_banks", [1, 2])
def test_net_pop_kernel_equals_plain_and_singles(cuda, n_banks):
    """B8: the population launch against its plain version, and candidate
    c against a single launch with c's banks (common random numbers)."""
    P, n_steps, C = 6, 32, 5
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules="standard")
    first = cn.initial_packed_state(4, cfg, T, cuda)
    state = first[None].expand(C, *first.shape).contiguous()
    es3 = tpn.load_params("data/policy_6max_es3.npz")
    rng = np.random.default_rng(0)
    cands = [tpn.params_from_numpy([np.asarray(x) + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32) for x in es3]) for _ in range(C)]
    weights = cn.pop_weights(cands, cuda,
                             bots.panel()["fof_raise"] if n_banks == 2
                             else None)
    stb = (0, 1, 1, 1, 1, 1) if n_banks == 2 else None
    form = "pop" if n_banks == 1 else "league_pop"
    before = cn.LAUNCHES[f"net_{form}_standard"]
    k = cn.run_net_eval_pop(9, state, weights, P, n_steps, 5, 10, 100,
                            "standard", 0b000011, stb)
    assert cn.LAUNCHES[f"net_{form}_standard"] == before + 1
    p = cn._run_net_eval_plain_philox(9, state, weights, P, n_steps, 5, 10,
                                      100, "standard", 0b000011, True, stb)
    assert torch.equal(k, p)
    for c in range(C):
        if n_banks == 1:
            single = cn.run_net_eval(9, first, weights[c, 0], P, n_steps, 5,
                                     10, 100, "standard", 0b000011)
        else:
            single = cn.run_net_league(9, first, weights[c], P, n_steps, 5,
                                       10, 100, "standard", 0b000011, stb)
        assert torch.equal(k[c], single)
    means, _, hands = cn.pop_meters(k, cfg)
    for c in range(C):
        m, _, h = cn.seat_meters(k[c], cfg)
        assert np.array_equal(m, means[c]) and h == hands[c]


@pytest.mark.parametrize("net_seats", [0b111111, 0b000100])
def test_net_eval_block_phase_kernel_equals_plain(cuda, es3, net_seats):
    """K6's block phase with every seat a net (nearly every table staged
    each slot) and with one net seat (a few rows a slot), and the count of
    net decisions."""
    P, n_steps = 6, 32
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules="standard")
    state = cn.initial_packed_state(21, cfg, T, cuda)
    dk, dp = (torch.zeros(1, dtype=torch.int64, device=cuda) for _ in "kp")
    k = cn.run_net_eval(17, state, es3, P, n_steps, 5, 10, 100, "standard",
                        net_seats, decisions=dk)
    p = cn._run_net_eval_plain_philox(17, state, es3, P, n_steps, 5, 10,
                                      100, "standard", net_seats, True,
                                      decisions=dp)
    assert torch.equal(k, p) and int(dk) == int(dp) > 0


@pytest.mark.parametrize("stb,net_seats", [
    ((0, 1, 1, 1, 1, 1), 0b000001), ((1, 1, 1, 1, 1, 1), 0b011010)])
def test_net_bank_absent_kernel_equals_plain(cuda, stb, net_seats):
    """B7 and B8 with two banks of which one has no row in any block: bank
    1's seats play the random policy, or bank 0 plays no seat (bank 1's
    segment starts at row 0)."""
    P, n_steps, C = 6, 32, 3
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules="standard")
    first = cn.initial_packed_state(22, cfg, T, cuda)
    weights = _banks(cuda, ["es3", "fof_raise"])
    k = cn.run_net_league(5, first, weights, P, n_steps, 5, 10, 100,
                          "standard", net_seats, stb)
    p = cn._run_net_eval_plain_philox(5, first, weights, P, n_steps, 5, 10,
                                      100, "standard", net_seats, True, stb)
    assert torch.equal(k, p)
    state = first[None].expand(C, *first.shape).contiguous()
    pw = weights[None].expand(C, *weights.shape).contiguous()
    k = cn.run_net_eval_pop(5, state, pw, P, n_steps, 5, 10, 100,
                            "standard", net_seats, stb)
    assert all(torch.equal(k[c], p) for c in range(C))


def test_net_det_banked_bank_absent_kernel_equals_plain(cuda):
    """Banked K5 where bank 0 plays no seat: its segment is empty in every
    block and step."""
    P, n_steps, hmax = 6, 40, 16
    T = 2 * ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules="standard")
    stash = cn.deal_stash(6, T, P, hmax, cuda)
    state = ce.pack_state(cfg, ce._stash_rows(stash)[0].T)
    weights = _banks(cuda, ["jam_tight", "fof_call"])
    k = cn.run_net_det(state, stash, weights, P, n_steps, 5, 10, "standard",
                       (1,) * P)
    p = cn._run_net_det_plain(state, stash, weights, P, n_steps, 5, 10,
                              "standard", (1,) * P)
    assert torch.equal(k, p)


def _block_buttons(state, cfg):
    """``state`` with the button of every table at (its CUDA block of 256
    tables) mod P: in the first slots every table of a block has the same
    seat acting, so a bank's segment is empty in some blocks of a launch
    and full in others."""
    rows = ce._to_rows(state).clone()
    off = ce._field_layout(cfg.num_seats, cfg.rules)[0]["button"][0]
    rows[off] = (torch.arange(rows.shape[1], device=rows.device) // 256) \
        % cfg.num_seats
    return ce._to_blocks(rows)


@pytest.mark.parametrize("form", ["K5b", "B7", "B8"])
def test_net_block_buttons_kernel_equals_plain(cuda, form):
    """Banked K5, B7 and B8 (two banks, bank 0 at seat 0 alone) on blocks
    whose tables share a button: one launch has bank segments empty in
    some blocks and full in others."""
    P, n_steps, C = 6, 32, 3
    T = 2 * ce.TABLES_PER_BLOCK
    stb = (0, 1, 1, 1, 1, 1)
    cfg = TableConfig(num_seats=P, rules="standard")
    if form == "K5b":
        stash = cn.deal_stash(7, T, P, 16, cuda)
        state = _block_buttons(
            ce.pack_state(cfg, ce._stash_rows(stash)[0].T), cfg)
        weights = _banks(cuda, ["jam_tight", "fof_call"])
        k = cn.run_net_det(state, stash, weights, P, n_steps, 5, 10,
                           "standard", stb)
        p = cn._run_net_det_plain(state, stash, weights, P, n_steps, 5, 10,
                                  "standard", stb)
        assert torch.equal(k, p)
        return
    first = _block_buttons(cn.initial_packed_state(23, cfg, T, cuda), cfg)
    weights = _banks(cuda, ["es3", "fof_raise"])
    p = cn._run_net_eval_plain_philox(5, first, weights, P, n_steps, 5, 10,
                                      100, "standard", 0b000011, True, stb)
    if form == "B7":
        k = cn.run_net_league(5, first, weights, P, n_steps, 5, 10, 100,
                              "standard", 0b000011, stb)
        assert torch.equal(k, p)
        return
    state = first[None].expand(C, *first.shape).contiguous()
    pw = weights[None].expand(C, *weights.shape).contiguous()
    k = cn.run_net_eval_pop(5, state, pw, P, n_steps, 5, 10, 100,
                            "standard", 0b000011, stb)
    assert all(torch.equal(k[c], p) for c in range(C))


@pytest.mark.parametrize("kernel", cn.KERNELS)
def test_net_occupancy(cuda, kernel):
    """Every net kernel launches with its banks and staging rows: at least
    one block an SM, up to the most banks, of which the block holds
    ``cn.SHARED_BANKS`` in shared memory (the probe takes one net)."""
    for n_banks in (1,) if kernel == "probe" else (1, 2, cn.MAX_BANKS):
        smem, blocks = cn.net_occupancy(kernel, 6, "standard", n_banks)
        shared = min(n_banks, cn.SHARED_BANKS)
        assert smem >= shared * cn.NUM_WEIGHTS * 4 and blocks >= 1


@pytest.mark.parametrize("form,R", [(f, R) for f in cc.FORMS
                                    for R in cc.R_OF[f]])
def test_carry_kernel_equals_plain(cuda, form, R):
    """Each carry form and R, words that wrap included."""
    g = torch.Generator(device=cuda).manual_seed(R)
    x = torch.randint(-2**31, 2**31, (2, R, *ce.TILE), generator=g,
                      dtype=torch.int64, device=cuda).to(torch.int32)
    x[0, 0, 0, :2] = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32)
    before = cc.LAUNCHES[f"carry_{form}_R{R}"]
    k = cc.carry(form, x, 37)
    assert cc.LAUNCHES[f"carry_{form}_R{R}"] == before + 1
    assert torch.equal(k, cc._carry_plain(x, 37))


def _stage_state(cuda):
    """Reference-rules tables in mid-hand (pots on the table) after 24 K3
    steps on an injected stream."""
    P, nb, n_steps, hmax = 6, 2, 24, 4
    rng = np.random.default_rng(3)
    T = nb * ce.TABLES_PER_BLOCK
    u = rng.random((nb, n_steps, 8, 128))
    acts = np.where(u < 0.2, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    deal = np.argsort(rng.random((T, hmax, 52)), axis=-1)[..., :2 * P + 5]
    cards = deal.reshape(nb, 1024, hmax, 2 * P + 5).transpose(0, 2, 3, 1) \
        .reshape(nb, hmax, 2 * P + 5, 8, 128).astype(np.int32)
    state = ce.pack_state(TableConfig(num_seats=P),
                          torch.from_numpy(deal[:, 0]).to(cuda))
    return ce.run_perpetual_det(
        state, torch.from_numpy(acts).to(cuda),
        torch.from_numpy(np.ascontiguousarray(cards)).to(cuda), P, n_steps,
        5, 10)


@pytest.mark.parametrize("stage", cs.STAGES)
def test_stage_build_and_kernel_equal_plain(cuda, stage):
    """A separate build of each stage (its id, one kernel in its ptxas
    report), then the kernel on injected words and in Philox mode against
    the plain version, from a mid-hand state."""
    P, n_steps = 6, 16
    build = cs.stage_library(stage, P, fresh=True)
    assert build.lib.mc_probe_stage_id() == cs.STAGES.index(stage)
    assert build.seconds > 0 and build.ptxas["registers"] > 0
    state = _stage_state(cuda)
    T = state.shape[0] * ce.TABLES_PER_BLOCK
    g = torch.Generator(device=cuda).manual_seed(len(stage))
    words = cq.random_words(g, cs.stage_words_shape(stage, T, P, n_steps),
                            cuda)
    before = cs.LAUNCHES[f"stage_{stage}"]
    k = cs.run_stage(stage, 0, state, P, n_steps, 5, 10, words=words)
    assert cs.LAUNCHES[f"stage_{stage}"] == before + 1
    assert torch.equal(k, cs._run_stage_plain(
        stage, state, lambda i: words[i], P, n_steps, 5, 10))
    k = cs.run_stage(stage, 21, state, P, n_steps, 5, 10)
    assert torch.equal(k.cpu(), cs.run_stage(stage, 21, state.cpu(), P,
                                             n_steps, 5, 10))
    assert not torch.equal(k, state)



@pytest.mark.parametrize("variant", csp.VARIANTS)
def test_split_build_and_kernel_equal_plain(cuda, variant):
    """A separate build of each K4 split variant (its id, one kernel in its
    ptxas report), then the kernel against the plain variant (on the card
    and on the CPU: integer work alike everywhere), from a mid-hand state;
    ``full`` and the controls equal K4."""
    P, n_steps = 6, 64
    build = _build.probe_library("split", variant, P, fresh=True)
    assert build.lib.mc_probe_split_id() == csp.VARIANTS.index(variant)
    assert build.seconds > 0 and build.ptxas["registers"] > 0
    state = _stage_state(cuda)
    T = state.shape[0] * ce.TABLES_PER_BLOCK
    before = csp.LAUNCHES[f"split_{variant}"]
    k = csp.run_split(variant, 23, state, P, n_steps, 5, 10)
    assert csp.LAUNCHES[f"split_{variant}"] == before + 1
    assert torch.equal(k, csp._split_plain(
        variant, state, lambda it: csp.split_words(
            23, T, variant, P, n_steps, it, cuda), P, n_steps, 5, 10))
    assert torch.equal(k.cpu(), csp.run_split(variant, 23, state.cpu(), P,
                                              n_steps, 5, 10))
    k4 = ce.run_perpetual_prng(23, state, P, n_steps, 5, 10)
    assert torch.equal(k, k4) == (variant in ("full", *csp.CONTROLS))


@pytest.mark.parametrize("variant", cns.VARIANTS)
def test_net_split_build_and_kernel_equal_plain(cuda, es3, variant):
    """Each K6 split variant's build, then its kernel on injected words and
    in Philox mode against the plain variant on the card (the count of net
    decisions too); ``full`` and the control equal K6."""
    P, n_steps, net_seats = 6, 64, 0b100001
    build = _build.probe_library("net_split", variant, P, fresh=True)
    assert build.lib.mc_probe_net_split_id() == cns.VARIANTS.index(variant)
    assert build.ptxas["registers"] > 0
    cfg = TableConfig(num_seats=P, rules="standard")
    state = cn.initial_packed_state(4, cfg, 2 * ce.TABLES_PER_BLOCK, cuda)
    T = state.shape[0] * ce.TABLES_PER_BLOCK
    g = torch.Generator(device=cuda).manual_seed(len(variant))
    words = cq.random_words(g, cns.split_words_shape(variant, T, P, n_steps),
                            cuda)
    before = cns.LAUNCHES[f"net_split_{variant}"]
    k = cns.run_net_split(variant, 0, state, es3, P, n_steps, 5, 10, 100,
                          net_seats, words=words)
    assert cns.LAUNCHES[f"net_split_{variant}"] == before + 1
    assert torch.equal(k, cns._split_plain(
        variant, state, lambda it: words[it], es3, P, n_steps, 5, 10, 100,
        net_seats))
    dk = torch.zeros(1, dtype=torch.int64, device=cuda)
    dp = torch.zeros(1, dtype=torch.int64, device=cuda)
    k = cns.run_net_split(variant, 31, state, es3, P, n_steps, 5, 10, 100,
                          net_seats, decisions=dk)
    p = cns._split_plain(variant, state, lambda it: cns.split_words(
        31, T, variant, P, n_steps, it, cuda), es3, P, n_steps, 5, 10, 100,
        net_seats, decisions=dp)
    assert torch.equal(k, p) and int(dk) == int(dp) > 0
    k6 = cn.run_net_eval(31, state, es3, P, n_steps, 5, 10, 100, "standard",
                         net_seats)
    assert torch.equal(k, k6) == (variant in ("full", *cns.CONTROLS))

def test_exact_range_vs_range_card_equals_cpu(cuda):
    """The exact sweep on the card gives the CPU's integers: the wins and
    ties of every combo pair on a flop, and the same result."""
    hero = teq.expand_range(["QQ", "AKs"])
    vill = teq.expand_range(["JJ", "T9s", "AQo"])
    board = [teq.make_card(0, 12), teq.make_card(1, 7), teq.make_card(2, 2)]
    boards, valid = teq._enumerate_boards(np.asarray(board, np.int32),
                                          1 << 12, len(hero) * len(vill))
    counts = {}
    for dev in ("cpu", cuda):
        hm = cq.suit_masks_from_cards(torch.from_numpy(hero).to(dev))
        vm = cq.suit_masks_from_cards(torch.from_numpy(vill).to(dev))
        w, t = teq._range_pair_counts(
            torch.from_numpy(boards.reshape(-1, 5)).to(dev),
            torch.from_numpy(valid.reshape(-1)).to(dev), hm, vm,
            boards.shape[1])
        counts[str(dev)] = (w.cpu(), t.cpu())
    assert torch.equal(counts["cpu"][0], counts["cuda"][0])
    assert torch.equal(counts["cpu"][1], counts["cuda"][1])
    on_card = teq.equity_exact_range_vs_range(hero, vill, board=board,
                                              device=cuda)
    on_cpu = teq.equity_exact_range_vs_range(hero, vill, board=board,
                                             device="cpu")
    assert on_card.equity == on_cpu.equity
    np.testing.assert_array_equal(on_card.pair_equity, on_cpu.pair_equity)


def test_sample_distinct_and_vs_range_card_equal_cpu(cuda):
    """A seed gives the same slots, and equity_vs_range the same counts, on
    the card and on the CPU."""
    a = teq.sample_distinct(17, 48, 5, (1 << 16) + 3, device=cuda)
    assert torch.equal(a.cpu(), teq.sample_distinct(17, 48, 5, (1 << 16) + 3,
                                                    device="cpu"))
    qk = teq.expand_range(["QQ", "KK"])
    args = (9, AKS, qk, (1 << 16) + 5)
    assert teq.equity_vs_range(*args, weights=np.arange(1, 13), device=cuda) \
        == teq.equity_vs_range(*args, weights=np.arange(1, 13), device="cpu")


def _states_equal(a, b):
    for x, y in zip(tstate.state_to_numpy(a), tstate.state_to_numpy(b)):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("rules", ["reference", "standard"])
def test_selfplay_card_equals_cpu(cuda, rules):
    """Perpetual and independent-hand self-play under the random policy:
    the card's first tables equal a CPU run's field by field (the same
    Philox decks and policy words), and no kernel launches."""
    from montecarlo_tpu_torch.rollout import selfplay as tsp

    cfg = TableConfig(num_seats=6, rules=rules)
    ce.reset_launches()
    card, _ = tsp.play_hands_perpetual(4, cfg, 4096, 96, device=cuda)
    cpu, _ = tsp.play_hands_perpetual(4, cfg, 256, 96, device="cpu")
    _states_equal(tstate._tree_map(lambda x: x[:256].cpu(), card), cpu)
    final, deltas = tsp.play_hands(5, cfg, 4096, num_hands=3,
                                   collect_deltas=True, device=cuda)
    cf, cd = tsp.play_hands(5, cfg, 256, num_hands=3, collect_deltas=True,
                            device="cpu")
    _states_equal(tstate._tree_map(lambda x: x[:256].cpu(), final), cf)
    assert torch.equal(deltas[:256].cpu(), cd)
    assert not any(ce.LAUNCHES.values())


def test_tournament_and_net_selfplay_card_equal_cpu(cuda):
    """Tournaments to the last table, and a net pinned to a seat with
    Gumbel draws: the card's first tables equal the CPU's (the logits are
    the same bits on both; the Gumbel noise's logarithms may differ in the
    last bit between the two devices, which moves a pick only on a tie
    within an ulp)."""
    from montecarlo_tpu_torch.rollout import policy as tpol
    from montecarlo_tpu_torch.rollout import selfplay as tsp

    tour = TableConfig(num_seats=6, rules="tournament", starting_stack=20)
    card = tsp.play_tournament(6, tour, 4096, 200, device=cuda)
    cpu = tsp.play_tournament(6, tour, 256, 200, device="cpu")
    _states_equal(tstate._tree_map(lambda x: x[:256].cpu(), card[0]), cpu[0])
    for a, b in zip(card[1:], cpu[1:]):
        assert torch.equal(a[:256].cpu(), b)
    std = TableConfig(num_seats=6, rules="standard")
    es3 = tpn.load_params("data/policy_6max_es3.npz")
    policy = tpol.pinned_seat_policies(
        [tpn.net_policy(es3)] + [tpol.random_policy] * 5)
    _, d = tsp.play_hands(7, std, 4096, num_hands=2, policy=policy,
                          collect_deltas=True, device=cuda)
    _, dc = tsp.play_hands(7, std, 256, num_hands=2, policy=policy,
                           collect_deltas=True, device="cpu")
    assert torch.equal(d[:256].cpu(), dc)
