"""Rank functions of the port's scale-out tests: each runs on every rank
of a world that ``parallel/local.spawn`` starts, and returns numpy
results for the test process to compare with JAX and with the port's
unsharded calls.

This module imports no JAX (``spawn`` re-imports it in every rank), and
neither does anything it imports.
"""

import torch

from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.engine.state import TableConfig, state_to_numpy
from montecarlo_tpu_torch.models import turn_solver as pt
from montecarlo_tpu_torch.models.policy_net import params_from_numpy
from montecarlo_tpu_torch.parallel import mesh as tm
from montecarlo_tpu_torch.parallel.train_dp import make_dp_train_step

# tests/test_parallel.py's textbook hands (AKs, QQ) and sweep heroes
HERO = [make_card(0, 14), make_card(0, 13)]
VILLAIN = [make_card(1, 12), make_card(2, 12)]
SWEEP_HEROES = [[make_card(0, 14), make_card(1, 14)],   # AA
                [make_card(0, 13), make_card(0, 12)],   # KQs
                [make_card(0, 7), make_card(1, 2)]]     # 72o
EQUITY = dict(seed=0, n=320_000, batch=1 << 13)
SWEEP = dict(seed=1, n=64_000, batch=1 << 12)
K1 = dict(seed=0xFFFFFFF0, n=1 << 16)
# the plain engine's shards (tests/test_parallel.py's configurations)
SELFPLAY = dict(seed=2, cfg=TableConfig(num_seats=6, max_layers=16,
                                        max_pot_layers=48), tables=8)
PERPETUAL = dict(seed=7, cfg=TableConfig(num_seats=6, max_layers=8,
                                         max_pot_layers=16),
                 tables=16, steps=64)
TOURNAMENT = dict(seed=8, cfg=TableConfig(num_seats=2, rules="tournament",
                                          small_blind=25, big_blind=50,
                                          max_layers=8, max_pot_layers=16),
                  tables=16, hands=48)
K4 = dict(seed=0x7FFFFFF0, cfg=TableConfig(num_seats=6), steps=32)
K3_STEPS = 12
K5_STEPS = 10
DP = dict(cfg=TableConfig(num_seats=2, rules="standard", max_layers=8,
                          max_pot_layers=16),
          tables=16, max_steps=24, seeds=(1, 2))
TURN_BOARD = [make_card(2, 13), make_card(0, 8), make_card(1, 5),
              make_card(3, 2)]  # Ks 8h 5d 2c


def _np(x):
    return x.detach().cpu().numpy()


def turn_game(n_rivers, stride, device="cpu"):
    dead = {int(c) for c in TURN_BOARD}
    rivers = [c for c in range(52) if c not in dead][:n_rivers]
    combos = pt.turn_combos(TURN_BOARD)[::stride]
    game, _ = pt.make_turn_river_game(TURN_BOARD, rivers=rivers,
                                      combos=combos, pot=4.0, bet=4.0,
                                      raise_=12.0, device=device)
    return game


def dp_steps(mesh, params, cfg, tables, max_steps, seeds):
    """The data-parallel step at ``seeds`` in turn: each step's parameters
    (numpy leaves) and mean reward."""
    opt_init, step = make_dp_train_step(mesh, cfg, tables_per_device=tables,
                                        max_steps=max_steps)
    p = params_from_numpy(params)
    opt = opt_init(p)
    out = []
    for seed in seeds:
        p, opt, mean_r = step(p, opt, seed)
        out.append(([_np(x) for x in p], mean_r))
    return out


def scenarios(mesh, inp):
    """Every row of the mesh module on this rank, and the eight items of
    ``__graft_entry__.dryrun_multichip``."""
    r, W = mesh.rank, mesh.size
    out = {"rank": r, "size": W, "backend": mesh.backend,
           "device": str(mesh.device)}
    out["equity"] = tuple(tm.sharded_equity_vs_hand(
        mesh, EQUITY["seed"], HERO, VILLAIN, EQUITY["n"],
        per_device_batch=EQUITY["batch"]))
    out["sweep"] = tm.equity_sweep(mesh, SWEEP["seed"], SWEEP_HEROES,
                                   SWEEP["n"],
                                   per_device_batch=SWEEP["batch"])
    out["k1"] = tuple(tm.sharded_equity_pallas(mesh, K1["seed"], HERO,
                                               VILLAIN, K1["n"]))
    final = tm.sharded_selfplay(mesh, SELFPLAY["seed"], SELFPLAY["cfg"],
                                SELFPLAY["tables"])
    out["selfplay"] = state_to_numpy(final)
    final, hands = tm.sharded_selfplay_perpetual(
        mesh, PERPETUAL["seed"], PERPETUAL["cfg"], PERPETUAL["tables"],
        PERPETUAL["steps"])
    out["perpetual"] = (state_to_numpy(final), hands)
    final, busted, stacks = tm.sharded_tournaments(
        mesh, TOURNAMENT["seed"], TOURNAMENT["cfg"], TOURNAMENT["tables"],
        TOURNAMENT["hands"])
    out["tournament"] = (state_to_numpy(final), _np(busted), _np(stacks))
    state, hands = tm.sharded_selfplay_kernel(mesh, K4["seed"], K4["cfg"],
                                              1, K4["steps"])
    out["k4"] = (_np(state), hands)
    k3 = inp["k3"]
    state, hands = tm.sharded_selfplay_kernel_det(
        mesh, k3["cfg"], k3["state"][r:r + 1], k3["actions"][r:r + 1],
        k3["cards"][r:r + 1], K3_STEPS)
    out["k3"] = (_np(state), hands)
    k5 = inp["k5"]
    # rank 1 holds other weights: the broadcast gives it rank 0's
    weights = torch.from_numpy(k5["weights"] * (1 if r == 0 else -3))
    state, hands = tm.sharded_net_kernel_det(
        mesh, k5["cfg"], k5["state"][r:r + 1], k5["cards"][r:r + 1],
        weights, K5_STEPS, k5["seat_to_bank"])
    out["k5"] = (_np(state), hands)
    out["dp"] = dp_steps(mesh, inp["params"], DP["cfg"], DP["tables"],
                         DP["max_steps"], DP["seeds"])
    out["checklist"] = checklist(mesh, inp)
    return out


def checklist(mesh, inp):
    """``__graft_entry__.dryrun_multichip``'s eight items at this world's
    size, on tiny shapes: what each returned."""
    W = mesh.size
    items = {}
    items[1] = [bool(tm.sharded_selfplay(
        mesh, 1, TableConfig(num_seats=6, max_layers=8, max_pot_layers=16,
                             bets_impl=impl), 4).hand_over.all())
        for impl in ("layers", "levels")]
    items[2] = tm.sharded_equity_vs_hand(mesh, 2, HERO, VILLAIN, W * 512,
                                         per_device_batch=512).equity
    items[3] = tm.equity_sweep(mesh, 3, [HERO, VILLAIN], W * 256,
                               per_device_batch=256)[0].shape
    items[4] = tm.sharded_selfplay_perpetual(
        mesh, 6, TableConfig(num_seats=6, max_layers=8, max_pot_layers=16),
        4, 40)[1]
    items[5] = dp_steps(mesh, inp["params"], DP["cfg"], 8, 24, (5,))[0][1]
    c = inp["checklist"]
    items[6] = tm.sharded_selfplay_kernel_det(
        mesh, c["cfg_k"], c["state_k"][mesh.rank:mesh.rank + 1],
        c["acts"][mesh.rank:mesh.rank + 1],
        c["cards_k"][mesh.rank:mesh.rank + 1], 4)[1]
    items[7] = tm.sharded_net_kernel_det(
        mesh, c["cfg_n"], c["state_n"][mesh.rank:mesh.rank + 1],
        c["cards_n"][mesh.rank:mesh.rank + 1],
        torch.from_numpy(c["weights"]), 4, c["seat_to_bank"])[1]
    game = turn_game(W, 40)
    strat = pt.solve_turn_river(game, iterations=50, mesh=mesh)
    items[8] = pt.exploitability_gap(game, strat)
    return items


def turn_solve(mesh, iterations):
    """Row 10 on this rank: the 8-river, stride-24 game solved over the
    mesh (every rank returns the whole strategy, numpy), and the text of
    the error that refuses 3 rivers on 2 ranks (None if none)."""
    strat = pt.solve_turn_river(turn_game(8, 24), iterations=iterations,
                                mesh=mesh)
    try:
        pt.solve_turn_river(turn_game(3, 40), iterations=1, mesh=mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    return [_np(x) for x in strat], refused
