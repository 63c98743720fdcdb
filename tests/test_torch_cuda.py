"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (the
decision is taken inside the ``cuda`` fixture, never at import). On a
machine with a card:  python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.ops import philox
from montecarlo_tpu_torch.rollout import equity as teq
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


def _engine_det_kernel_equals_plain(cuda, P, rules):
    rng = np.random.default_rng(P)
    nb, n_steps, hmax = 2, 40, 12
    T = nb * ce.TABLES_PER_BLOCK
    u = rng.random((nb, n_steps, 8, 128))
    acts = np.where(u < 0.2, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    deal = np.argsort(rng.random((T, hmax, 52)), axis=-1)[..., :2 * P + 5]
    cards = deal.reshape(nb, 1024, hmax, 2 * P + 5).transpose(0, 2, 3, 1) \
        .reshape(nb, hmax, 2 * P + 5, 8, 128).astype(np.int32)
    state = ce.pack_state(TableConfig(num_seats=P, rules=rules),
                          torch.from_numpy(deal[:, 0]).to(cuda))
    acts_t = torch.from_numpy(acts).to(cuda)
    cards_t = torch.from_numpy(np.ascontiguousarray(cards)).to(cuda)
    before = ce.LAUNCHES[f"engine_det_{rules}"]
    k = ce.run_perpetual_det(state, acts_t, cards_t, P, n_steps, 5, 10,
                             rules=rules)
    assert ce.LAUNCHES[f"engine_det_{rules}"] == before + 1
    p = ce._run_det_plain(state, acts_t, cards_t, P, n_steps, 5, 10, rules)
    assert torch.equal(k, p)


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


@pytest.fixture
def es3(cuda):
    return cn.net_weights(tpn.load_params("data/policy_6max_es3.npz"), cuda)


@pytest.mark.parametrize("rules", ce.RULES)
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


@pytest.mark.parametrize("rules", ce.RULES)
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
