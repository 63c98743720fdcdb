"""K1's variants (B-6) and the plain versions' graph-replayed loops, on the
card.

Marked ``cuda``: without a CUDA device every test here skips (the
decision is taken inside the ``cuda`` fixture, never at import). On a
machine with a card:
python -m pytest tests/test_torch_cuda_k1_variants.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import bots
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_k1_variants as kv
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.ops import cuda_stages as cs
from montecarlo_tpu_torch.rollout import equity as teq

pytestmark = pytest.mark.cuda

AKS = [teq.make_card(0, 14), teq.make_card(0, 13)]
QQ = [teq.make_card(1, 12), teq.make_card(2, 12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def builds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return _build.build_probes("k1", kv.VARIANTS, tiles=("current",))


@pytest.mark.parametrize("variant", kv.VARIANTS)
def test_variant_kernel_equals_plain(cuda, builds, variant):
    """One variant on injected words (some in the top range) and at 2^20
    Philox rollouts, at K1's launch shape and at one wave (several trips
    of the grid-stride loop a thread), against its plain version; one
    launch each."""
    assert builds[variant].ptxas["registers"] > 0
    dead, hm, vm = cq._hand_masks(AKS, QQ, (), cuda)
    rng = np.random.default_rng(kv.VARIANTS.index(variant))
    n = 1 << 16
    w = rng.integers(0, 1 << 32, (kv.n_words(variant), n), dtype=np.int64)
    w[rng.random(w.shape) < 0.02] = (1 << 32) - 1
    words = torch.from_numpy(w).to(cuda)
    before = kv.LAUNCHES[f"k1_{variant}"]
    k = kv.variant_counts(variant, 0, dead, hm, vm, n, words=words)
    p = kv._variant_counts_plain(variant, words, dead.tolist(), hm.tolist(),
                                 vm.tolist())
    assert k.tolist() == p.tolist()
    n = 1 << 20
    p = kv._variant_counts_plain_philox(variant, 7, dead.tolist(),
                                        hm.tolist(), vm.tolist(), n, cuda)
    for tile in (kv.TILE, (256, 1)):
        k = kv.variant_counts(variant, 7, dead, hm, vm, n, tile=tile)
        assert k.tolist() == p.tolist(), tile
    blocks, _ = kv.variant_grid(variant, n, (256, 1))
    assert n / (blocks * 256) > 2
    assert kv.LAUNCHES[f"k1_{variant}"] == before + 3


def test_current_is_k1_at_every_tile(cuda, builds):
    dead, hm, vm = cq._hand_masks(AKS, QQ, (), cuda)
    n = (1 << 22) + 77
    want = cq.equity_counts(3, dead, hm, vm, n).tolist()
    for tile in ((128, 16), (256, 16), (512, 4), (1024, 1), (256, 64)):
        got = kv.variant_counts("current", 3, dead, hm, vm, n, tile=tile)
        assert got.tolist() == want, tile
    blocks, per_sm = kv.variant_grid("current", 1 << 29)
    assert blocks >= 1 and per_sm >= 1
    # the other block sizes are the tile build's alone
    grid = (ctypes.c_int * 2)()
    assert builds["current"].lib.mc_probe_k1_grid(n, 512, 16, 0, grid) != 0
    assert _build.probe_built("k1", "current", tiles=True)


# The plain versions' loops replayed from a CUDA graph of one step (their
# loop on the card) equal the eager loops.

def _eager(monkeypatch, fn):
    """``fn()`` with the plain versions' loops run eagerly on the card."""
    with monkeypatch.context() as m:
        m.setattr(ce, "_GRAPH_ON_CARD", False)
        return fn()


def _mid_state(cuda, cfg, blocks=1):
    return ce.run_perpetual_prng(5, ce.pack_state(cfg, ce.first_deal(
        1, blocks * ce.TABLES_PER_BLOCK, 6, cuda)), 6, 16, 5, 10,
        rules=cfg.rules)


@pytest.mark.parametrize("rules", ["reference", "standard", "tournament"])
def test_graph_loop_equals_eager_engine(cuda, rules, monkeypatch):
    cfg = TableConfig(num_seats=6, rules=rules, starting_stack=20
                      if rules == "tournament" else 100)
    st = _mid_state(cuda, cfg, 2)
    for n_steps in (16, 64):
        a = _eager(monkeypatch, lambda: ce._run_prng_plain_philox(
            9, st, 6, n_steps, 5, 10, rules))
        b = ce._run_prng_plain_philox(9, st, 6, n_steps, 5, 10, rules)
        assert torch.equal(a, b)
    g = torch.Generator(device=cuda).manual_seed(1)
    acts = torch.randint(-1, 4, (2, 24, 8, 128), generator=g,
                         device=cuda).to(torch.int32)
    cards = torch.rand((2 * 1024, 4, 52), generator=g, device=cuda) \
        .argsort(-1)[..., :17].to(torch.int32).reshape(2, 1024, 4, 17) \
        .permute(0, 2, 3, 1).reshape(2, 4, 17, 8, 128).contiguous()
    a = _eager(monkeypatch, lambda: ce._run_det_plain(
        st, acts, cards, 6, 24, 5, 10, rules))
    b = ce._run_det_plain(st, acts, cards, 6, 24, 5, 10, rules)
    assert torch.equal(a, b)


def test_graph_loop_equals_eager_net(cuda, monkeypatch):
    std = TableConfig(num_seats=6, rules="standard")
    st = _mid_state(cuda, std)
    es = tpn.init_params(torch.Generator().manual_seed(3))
    w1 = cn.net_weights(es, cuda)
    wb = cn.bank_weights([es, bots.action_bot(1)], cuda)
    wp = cn.pop_weights([es, bots.action_bot(3)], cuda)
    stb = (0, 1, 0, 1, 0, 1)
    for w, seats, s2b, state in ((w1, 1, None, st), (wb, 63, stb, st),
                                 (wp, 1, None, torch.stack([st, st]))):
        da = torch.zeros(1, dtype=torch.int64, device=cuda)
        db = torch.zeros(1, dtype=torch.int64, device=cuda)
        a = _eager(monkeypatch, lambda: cn._run_net_eval_plain_philox(
            4, state, w, 6, 64, 5, 10, 100, "standard", seats, True, s2b,
            da))
        b = cn._run_net_eval_plain_philox(4, state, w, 6, 64, 5, 10, 100,
                                          "standard", seats, True, s2b, db)
        assert torch.equal(a, b) and int(da) == int(db) > 0
    stash = cn.deal_stash(2, ce.TABLES_PER_BLOCK, 6, 8, cuda)
    panel = bots.panel()
    wd = cn.bank_weights([panel["jam_tight"], panel["fof_call"]], cuda)
    a = _eager(monkeypatch, lambda: cn._run_net_det_plain(
        st, stash, wd, 6, 32, 5, 10, "standard", (0, 1, 1, 1, 1, 1)))
    b = cn._run_net_det_plain(st, stash, wd, 6, 32, 5, 10, "standard",
                              (0, 1, 1, 1, 1, 1))
    assert torch.equal(a, b)


@pytest.mark.parametrize("stage", cs.STAGES)
def test_graph_loop_equals_eager_stage(cuda, stage, monkeypatch):
    st = _mid_state(cuda, TableConfig(num_seats=6))
    T = ce.TABLES_PER_BLOCK

    def words_of(i):
        return cs.stage_words(3, T, stage, 6, i, cuda)

    a = _eager(monkeypatch, lambda: cs._run_stage_plain(
        stage, st, words_of, 6, 32, 5, 10))
    b = cs._run_stage_plain(stage, st, words_of, 6, 32, 5, 10)
    assert torch.equal(a, b)
