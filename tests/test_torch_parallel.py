"""The port's scale-out (``montecarlo_tpu_torch/parallel``) on a gloo world
of two ranks on the CPU, against JAX's 8-device CPU mesh
(``tests/test_parallel.py``) and against the port's unsharded calls.

One world runs every rank function once (``torch_parallel_workers.
scenarios``, module-scoped); a world of one in this process
(``make_mesh("cpu")``) gives the W = 1 forms. Tolerances:
- the plain equity rows: the textbook 0.460 within 0.008; each result
  within 4 sigma of JAX's mesh result (sigma from both standard errors:
  the two draw different streams);
- the kernel rows (K1, K3, K4, K5 on their plain versions) and the plain
  engine's shards: bit for bit (K1: the sum of each rank's single call;
  K3: JAX's sharded kernel on a 2-device mesh; K5: JAX's single-device
  kernel on each rank's stash; K4 and the engine: the port's single calls);
- data-parallel REINFORCE: both ranks' parameters equal after every
  step; W = 2 on T tables each against W = 1 on 2T tables within 1e-6
  (the rewards and log-probs are the same numbers, only the order of the
  float32 sums of the means and gradients differs); the rank loss equal
  to JAX's formula (``train_dp.py:63-75``) in float64 within 1e-6.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JaxMesh

from montecarlo_tpu.models import bots as jbots
from montecarlo_tpu.ops import pallas_engine as jpe
from montecarlo_tpu.parallel import mesh as jm
from montecarlo_tpu_torch.engine.state import TableConfig, state_to_numpy
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.parallel import local
from montecarlo_tpu_torch.parallel import mesh as tm
from montecarlo_tpu_torch.parallel import train_dp
from montecarlo_tpu_torch.rollout import equity as teq
from montecarlo_tpu_torch.rollout import selfplay as tsp

import torch_parallel_workers as workers
from test_pallas_engine import CFG as K3_CFG, HMAX, N_CARDS, _streams, \
    make_cfg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
W = 2
T = ce.TABLES_PER_BLOCK
K5_HMAX = 8


def _k3_inputs():
    """Rows 7's global arrays: one block a rank, rank d's injected stream
    and stash ``tests/test_pallas_engine._streams(1000 + d)``, as
    ``tests/test_parallel.py`` builds them."""
    blocks, acts, cards = [], [], []
    for d in range(W):
        actions, c = _streams(1000 + d)
        blocks.append(np.asarray(jpe.pack_state(K3_CFG, c[:, 0])))
        acts.append(actions[:workers.K3_STEPS].reshape(
            workers.K3_STEPS, *ce.TILE))
        cards.append(c.transpose(1, 2, 0).reshape(HMAX, N_CARDS, *ce.TILE))
    return {"cfg": TableConfig(**dataclasses.asdict(K3_CFG)),
            "state": np.concatenate(blocks), "actions": np.stack(acts),
            "cards": np.stack(cards)}


def _port_params(jparams):
    return tpn.params_from_numpy([np.asarray(x) for x in jparams])


def _k5_inputs():
    """Row 8's: two banks (jam_tight at seat 0, fof_call elsewhere), one
    block a rank with its own stash (``tests/test_parallel.py``'s)."""
    cfg = TableConfig(**dataclasses.asdict(make_cfg("standard")))
    bots = jbots.panel()
    banks = [bots["jam_tight"], bots["fof_call"]]
    rng = np.random.default_rng(71)
    blocks, stashes = [], []
    for _ in range(W):
        c = np.argsort(rng.random((T, K5_HMAX, 52)), axis=-1)[
            ..., :N_CARDS].astype(np.int32)
        blocks.append(ce.state_to_numpy(ce.pack_state(cfg,
                                                      torch.from_numpy(
                                                          c[:, 0]))))
        stashes.append(c.transpose(1, 2, 0).reshape(K5_HMAX, N_CARDS,
                                                    *ce.TILE))
    return {"cfg": cfg, "banks": banks,
            "weights": cn.bank_weights([_port_params(b) for b in banks],
                                       "cpu").numpy(),
            "seat_to_bank": (0,) + (1,) * 5,
            "state": np.concatenate(blocks), "cards": np.stack(stashes)}


def _checklist_inputs():
    """``__graft_entry__.dryrun_multichip``'s items 6 and 7 (one block a
    rank, check/call actions, 4 steps)."""
    rng = np.random.default_rng(0)
    seats, hmax, n_steps = 6, 2, 4
    cfg_k = TableConfig(num_seats=seats, max_layers=6, max_pot_layers=24,
                        bets_impl="levels")
    cards = np.argsort(rng.random((W * T, hmax, 52)),
                       axis=-1)[..., :N_CARDS].astype(np.int32)
    cards_k = cards.reshape(W, -1, hmax, N_CARDS).transpose(
        0, 2, 3, 1).reshape(W, hmax, N_CARDS, *ce.TILE)
    cfg_n = TableConfig(num_seats=seats, max_layers=10, max_pot_layers=40,
                        rules="standard", bets_impl="levels")
    cards_n = np.argsort(rng.random((W * T, 4, 52)),
                         axis=-1)[..., :N_CARDS].astype(np.int32)
    stash_n = cards_n.reshape(W, -1, 4, N_CARDS).transpose(
        0, 2, 3, 1).reshape(W, 4, N_CARDS, *ce.TILE)
    bots = jbots.panel()
    return {
        "cfg_k": cfg_k, "cards_k": cards_k,
        "state_k": ce.state_to_numpy(ce.pack_state(
            cfg_k, torch.from_numpy(cards[:, 0]))),
        "acts": np.zeros((W, n_steps) + ce.TILE, np.int32),
        "cfg_n": cfg_n, "cards_n": stash_n,
        "state_n": ce.state_to_numpy(ce.pack_state(
            cfg_n, torch.from_numpy(cards_n[:, 0]))),
        "weights": cn.bank_weights([_port_params(bots["jam_tight"]),
                                    _port_params(bots["fof_call"])],
                                   "cpu").numpy(),
        "seat_to_bank": (0,) + (1,) * (seats - 1)}


def _params():
    return [x.numpy() for x in
            tpn.init_params(torch.Generator().manual_seed(0))]


@pytest.fixture(scope="module")
def inputs():
    return {"k3": _k3_inputs(), "k5": _k5_inputs(), "params": _params(),
            "checklist": _checklist_inputs()}


@pytest.fixture(scope="module")
def world(inputs):
    """Every rank function's results on a gloo world of two CPU ranks."""
    return local.spawn(workers.scenarios, W, "gloo", "cpu", inputs)


@pytest.fixture(scope="module")
def mesh1():
    """A world of one in this process, started by ``make_mesh`` (no group
    exists before it); destroyed after the module."""
    assert not dist.is_initialized()
    mesh = tm.make_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_mesh():
    return jm.make_mesh()


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for sub in tree for x in _leaves(sub)]
    return [np.asarray(tree)]


def _assert_rows(shard, full, lo, what):
    """Every field of ``shard`` equals rows lo .. of ``full``."""
    for i, (a, b) in enumerate(zip(_leaves(shard), _leaves(full))):
        np.testing.assert_array_equal(a, b[lo:lo + len(a)],
                                      err_msg=f"{what} leaf {i}")


def _z(a, b):
    """|a - b| in units of both results' standard errors."""
    return abs(a.equity - b.equity) / np.hypot(a.stderr, b.stderr)


# ---- row 1: the mesh ----------------------------------------------------

def test_mesh_is_the_group(world, mesh1):
    assert [w["rank"] for w in world] == [0, 1]
    assert all(w["size"] == W and w["backend"] == "gloo"
               and w["device"] == "cpu" for w in world)
    assert (mesh1.rank, mesh1.size, mesh1.backend) == (0, 1, "gloo")
    assert tm.make_mesh("cpu") == mesh1  # the group now exists: reused
    assert tm.AXIS == jm.AXIS


TORCHRUN_RANK = """
import torch
from montecarlo_tpu_torch.parallel import mesh as tm
m = tm.make_mesh("cpu")
x = tm.all_reduce(m, torch.tensor([m.rank + 1]))
print(m.rank, m.size, m.backend, int(x))
"""


def test_make_mesh_joins_a_torchrun_world():
    """With torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT, here on 127.0.0.1) ``make_mesh`` joins that world: two
    processes, two ranks, one all_reduce."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port), "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", TORCHRUN_RANK], cwd=ROOT,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [["0", "2", "gloo", "3"], ["1", "2", "gloo", "3"]]


# ---- rows 2-3: plain rollouts -------------------------------------------

def test_sharded_equity_matches_textbook_and_jax(world, jax_mesh):
    res = [teq.EquityResult(*w["equity"]) for w in world]
    assert res[0] == res[1]
    e = workers.EQUITY
    batch = e["batch"]
    assert res[0].n == batch * W * -(-e["n"] // (batch * W)) >= e["n"]
    assert abs(res[0].equity - 0.460) < 0.008, res[0].equity
    want = jm.sharded_equity_vs_hand(
        jax_mesh, jax.random.key(0), workers.HERO, workers.VILLAIN,
        n_rollouts=e["n"], per_device_batch=batch)
    assert _z(res[0], want) < 4


def test_equity_sweep_orders_hands_and_matches_jax(world, jax_mesh):
    (eq0, n0), (eq1, n1) = (w["sweep"] for w in world)
    np.testing.assert_array_equal(eq0, eq1)
    s = workers.SWEEP
    assert n0 == n1 == s["batch"] * W * -(-s["n"] // (s["batch"] * W))
    assert eq0[0] > eq0[1] > eq0[2], eq0
    want, n_jax = jm.equity_sweep(jax_mesh, jax.random.key(1),
                                  np.array(workers.SWEEP_HEROES, np.int32),
                                  n_rollouts_per_hand=s["n"],
                                  per_device_batch=s["batch"])
    se = np.sqrt(eq0 * (1 - eq0) / n0 + want * (1 - want) / n_jax)
    assert np.all(np.abs(eq0 - want) < 4 * se), (eq0, want)


def test_streams_name_the_rank_and_the_chunk():
    """No two ranks, chunks or heroes share words."""
    a = tm._mesh_words(3, 0, 0, tm.SUB_MESH_HAND, 5, 64, "cpu")
    for other in (tm._mesh_words(3, 1, 0, tm.SUB_MESH_HAND, 5, 64, "cpu"),
                  tm._mesh_words(3, 0, 1, tm.SUB_MESH_HAND, 5, 64, "cpu"),
                  tm._mesh_words(3, 0, 0, tm.SUB_MESH_SWEEP, 5, 64, "cpu")):
        assert not (a == other).any()
    sweep = tm._mesh_words(3, 0, 0, tm.SUB_MESH_SWEEP + torch.arange(2), 7,
                           64, "cpu")
    assert sweep.shape == (7, 2, 64)
    assert not (sweep[:, 0] == sweep[:, 1]).any()


# ---- row 4: K1 ------------------------------------------------------------

def test_sharded_k1_is_the_sum_of_single_calls(world, mesh1):
    k = workers.K1
    per = k["n"] // W
    dead, hm, vm = cq._hand_masks(workers.HERO, workers.VILLAIN, (), "cpu")
    single = sum(cq.equity_counts((k["seed"] + 0x9E3779 * r) & 0xFFFFFFFF,
                                  dead, hm, vm, per) for r in range(W))
    w, t = single.tolist()
    assert world[0]["k1"] == world[1]["k1"] == (w, t, W * per - w - t,
                                                W * per)
    one = tm.sharded_equity_pallas(mesh1, k["seed"], workers.HERO,
                                   workers.VILLAIN, 1000)
    w, t, n = cq.equity_vs_hand_kernel(k["seed"], workers.HERO,
                                       workers.VILLAIN, 1000, device="cpu")
    assert (one.wins, one.ties, one.n) == (w, t, n)


# ---- row 5: the plain engine's shards ----------------------------------

def test_sharded_selfplay_is_rows_of_the_unsharded_call(world):
    s = workers.SELFPLAY
    full = state_to_numpy(tsp.play_hands(s["seed"], s["cfg"],
                                         W * s["tables"], device="cpu"))
    for w in world:
        assert w["selfplay"].hand_over.all()
        _assert_rows(w["selfplay"], full, w["rank"] * s["tables"],
                     "selfplay")


def test_sharded_perpetual_is_rows_of_the_unsharded_call(world):
    p = workers.PERPETUAL
    full, hands = tsp.play_hands_perpetual(p["seed"], p["cfg"],
                                           W * p["tables"], p["steps"],
                                           device="cpu")
    full = state_to_numpy(full)
    for w in world:
        state, total = w["perpetual"]
        assert total == int(hands) > W * p["tables"]
        _assert_rows(state, full, w["rank"] * p["tables"], "perpetual")


def test_sharded_tournaments(world):
    t = workers.TOURNAMENT
    full = tsp.play_tournament(t["seed"], t["cfg"], W * t["tables"],
                               t["hands"], device="cpu")
    full = (state_to_numpy(full[0]), full[1].numpy(), full[2].numpy())
    for w in world:
        state, busted, stacks = w["tournament"]
        _assert_rows((state, busted, stacks), full,
                     w["rank"] * t["tables"], "tournament")
        np.testing.assert_array_equal(stacks.sum(1), 200)
        places = tsp.tournament_placements(busted, stacks)
        assert places.shape == (t["tables"], 2)
        np.testing.assert_array_equal(np.sort(places, 1), [[1, 2]] *
                                      t["tables"])
    stacks = np.concatenate([w["tournament"][2] for w in world])
    assert ((stacks > 0).sum(1) == 1).mean() > 0.9


# ---- rows 6-8: the engine kernels ----------------------------------------

def test_sharded_k4_is_each_ranks_single_launch(world, mesh1):
    k = workers.K4
    cfg, P = k["cfg"], k["cfg"].num_seats
    hands = 0
    for w in world:
        r = w["rank"]
        first = ce.first_deal(k["seed"], T, P, "cpu", r * T)
        np.testing.assert_array_equal(
            first, ce.first_deal(k["seed"], W * T, P, "cpu")[r * T:][:T])
        single = ce.run_perpetual_prng(
            (k["seed"] + 7919 * r) & 0x7FFFFFFF, ce.pack_state(cfg, first),
            P, k["steps"], cfg.small_blind, cfg.big_blind)
        np.testing.assert_array_equal(w["k4"][0], single.numpy())
        hands += int(ce.unpack_field(single, cfg, "hand_ct").sum())
    assert world[0]["k4"][1] == world[1]["k4"][1] == hands > 0
    one, one_hands = tm.sharded_selfplay_kernel(mesh1, k["seed"], cfg, 1,
                                                k["steps"])
    want, want_hands, _ = ce.selfplay_perpetual_kernel(
        k["seed"], cfg, T, k["steps"], steps_per_launch=k["steps"],
        device="cpu")
    np.testing.assert_array_equal(one.numpy(), want.numpy())
    assert one_hands == want_hands


def test_sharded_k3_matches_jax_sharded_kernel(world, inputs):
    k3 = inputs["k3"]
    mesh = JaxMesh(np.array(jax.devices()[:W]), ("tables",))
    want, want_hands = jm.sharded_selfplay_kernel_det(
        mesh, K3_CFG, k3["state"], k3["actions"], k3["cards"],
        workers.K3_STEPS, interpret=True)
    want = np.asarray(want)
    for w in world:
        np.testing.assert_array_equal(w["k3"][0], want[w["rank"]:][:1])
        assert w["k3"][1] == want_hands > 0


def test_sharded_k5_matches_jax_per_rank(world, inputs):
    k5 = inputs["k5"]
    jcfg = make_cfg("standard")
    weights = jpe._stack_weights_league(k5["banks"])
    total = 0
    for w in world:
        r = w["rank"]
        single = np.asarray(jpe.run_net_det(
            k5["state"][r:r + 1], k5["cards"][r:r + 1], weights, 6,
            workers.K5_STEPS, jcfg.small_blind, jcfg.big_blind,
            jcfg.starting_stack, jcfg.rules, n_banks=2,
            seat_to_bank=k5["seat_to_bank"], interpret=True))
        np.testing.assert_array_equal(w["k5"][0], single, err_msg=str(r))
        total += int(ce.unpack_field(torch.tensor(single), k5["cfg"],
                                     "hand_ct").sum())
    assert world[0]["k5"][1] == world[1]["k5"][1] == total > 0


# ---- row 9: data-parallel REINFORCE --------------------------------------

def test_dp_step_two_ranks_against_one(world, inputs, mesh1):
    d = workers.DP
    (p0, r0), (p1, r1) = (world[0]["dp"], world[1]["dp"])
    one = workers.dp_steps(mesh1, inputs["params"], d["cfg"],
                           W * d["tables"], d["max_steps"], d["seeds"])
    for step in range(len(d["seeds"])):
        a, b = world[0]["dp"][step], world[1]["dp"][step]
        for x, y in zip(a[0], b[0]):
            np.testing.assert_array_equal(x, y)
        assert a[1] == b[1] and np.isfinite(a[1])
        np.testing.assert_allclose(a[1], one[step][1], atol=1e-6)
        for x, y in zip(a[0], one[step][0]):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)
    moved = sum(np.abs(x - y).sum()
                for x, y in zip(inputs["params"], world[0]["dp"][-1][0]))
    assert moved > 0


def test_dp_loss_is_jax_formula():
    rng = np.random.default_rng(5)
    rewards = [rng.normal(0, 3, 64), rng.normal(0.5, 2, 64)]
    lps = [rng.normal(-2, 1, 64), rng.normal(-2, 1, 64)]
    g = np.mean([r.mean() for r in rewards])
    v = np.mean([((r - g) ** 2).mean() for r in rewards])
    for r, lp in zip(rewards, lps):
        want = -np.mean((r - g) / np.sqrt(v + 1e-6) * lp)
        got = train_dp.dp_loss(torch.tensor(lp), torch.tensor(r),
                               torch.tensor(g), torch.tensor(v))
        assert abs(float(got) - want) < 1e-6


# ---- __graft_entry__.dryrun_multichip's checklist ------------------------

def test_dryrun_multichip_checklist_on_two_ranks(world):
    for w in world:
        items = w["checklist"]
        assert items[1] == [True, True]
        assert 0.0 < items[2] < 1.0
        assert items[3] == (2,)
        assert items[4] > 0
        assert np.isfinite(items[5])
        assert items[6] >= 0 and items[7] >= 0
        assert items[8] < 1.0
