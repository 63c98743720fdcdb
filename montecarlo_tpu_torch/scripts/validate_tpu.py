"""On-card validation of the port's kernels: the port of
``scripts/validate_tpu.py`` (its name kept so that the counterpart is
found). Exits non-zero on any failure.

Every check of the JAX script, on the card (``--device cpu`` runs the
plain versions, at sizes a CPU can take only where a check says so):

- ``check_engine_kernel``: (a) K3 on an injected stream (folds 20%, calls
  72%, raises 8%) against the plain engine driven on the same stream
  (``engine/replay.replay_injected``), bit for bit on every table within
  capacity and over 90% of tables within it; (a2) a stream with 3% raises,
  every table within capacity and equal; (b) K4 against the plain
  perpetual engine: slots a hand within 3% of the engine's steps a hand
  plus K4's deferred-settle idle slots, each position's bb/hand within
  0.25 of ``data/position_winrates.json``, no overflow; (c) K4 under
  standard rules conserves every chip (stacks plus the street and the
  pots); (c2) tournaments run to completion: every table frozen, the
  winner holds every chip, places a permutation; (d) the trained net at
  seat 0 beats the untrained one by separated 2-sigma intervals and is
  above 0 by 2 sigma; (e) K4 on the mesh (a world of one) gives K4's
  slots a hand within 5%;
- ``check_net_kernels``: B8 equals per-candidate K6 launches exactly; B7
  with identical banks equals K6 with the net at every seat; bank routing
  under reference rules (a call bot wins at seat 0, a pot-raise bot
  loses, the population's candidates alike);
- ``check_net_det``: K5 with two rule-bot banks against the plain net
  pipeline (``replay_net_det``), bit for bit on every table within
  capacity;
- the equity section: K2 (AA, 72o vs random) in the textbook ranges; K1
  through the mesh near 0.460; K1 on a flop within 0.003 of exact
  enumeration; B3 against the plain multiway path (other draws) within
  0.004; K1 against the plain equity path (other draws, within 6 combined
  standard errors) and the textbook values (within 0.02) on three
  matchups.

The JAX script compared the compiled kernels with the XLA engine and the
XLA equity paths and read its engine streams from the JAX tests' helpers;
the port compares with its plain PyTorch versions, makes its streams here
and its untrained net with ``init_params``. The untrained net's own edge
depends on its draw, so (d) asks the trained net's to be above 0 and
above the untrained net's, where the JAX check also asked the untrained
draw's to be above 0.

    python -m montecarlo_tpu_torch.scripts.validate_tpu
        [--only engine|equity|net] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from montecarlo_tpu_torch.cards import make_card
from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine import replay as erp
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import bots
from montecarlo_tpu_torch.models.policy_net import init_params, load_params
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_net as cn

H, D, S, C = 0, 1, 2, 3

MATCHUPS = [
    ("AKs vs QQ", [make_card(H, 14), make_card(H, 13)],
     [make_card(D, 12), make_card(S, 12)], 0.460),
    ("AA vs KK", [make_card(H, 14), make_card(D, 14)],
     [make_card(H, 13), make_card(D, 13)], 0.820),
    ("72o vs AKo", [make_card(H, 7), make_card(D, 2)],
     [make_card(S, 14), make_card(C, 13)], 0.32),
]

N = 4_000_000
P = 6
HMAX = 12


def _report(name, ok, **numbers):
    print(json.dumps({"check": name, "ok": bool(ok), **numbers}),
          flush=True)
    return 0 if ok else 1


def injected_stream(seed, n_tables, n_steps, raise_p, device,
                    hmax: int = HMAX):
    """A K3 stream on ``device``: raw actions [n_blocks, n_steps, 8, 128]
    (folds 20%, raises ``raise_p`` of 1..20 chips, calls the rest) and
    deals [n_blocks, hmax, 2P + 5, 8, 128] (hmax random permutations'
    first 2P + 5 cards a table), from numpy's generator of ``seed``."""
    rng = np.random.default_rng(seed)
    u = rng.random((n_steps, n_tables))
    amt = rng.integers(1, 21, (n_steps, n_tables))
    acts = np.where(u < 0.20, -1, np.where(u < 1 - raise_p, 0, amt))
    deals = np.argsort(rng.random((n_tables, hmax, 52)),
                       axis=-1)[..., :2 * P + 5]
    nb = n_tables // ce.TABLES_PER_BLOCK
    acts = torch.from_numpy(acts.astype(np.int32)).reshape(
        n_steps, nb, *ce.TILE).permute(1, 0, 2, 3).contiguous()
    cards = torch.from_numpy(deals.astype(np.int32)).reshape(
        nb, ce.TABLES_PER_BLOCK, hmax, 2 * P + 5).permute(0, 2, 3, 1) \
        .reshape(nb, hmax, 2 * P + 5, *ce.TILE).contiguous()
    return acts.to(device), cards.to(device)


def det_against_engine(cfg, acts, cards, n_steps):
    """K3 (``run_perpetual_det``) on the stream and the plain engine on the
    same stream: (K3's output, the agreement, the replay)."""
    T = acts.shape[0] * ce.TABLES_PER_BLOCK
    deals = ce._stash_rows(cards).permute(2, 0, 1).contiguous()
    packed = ce.pack_state(cfg, deals[:, 0])
    out = ce.run_perpetual_det(packed, acts, cards, P, n_steps,
                               cfg.small_blind, cfg.big_blind, cfg.rules)
    L = ce._L_for(cfg.rules)
    gcfg = TableConfig(num_seats=P, rules=cfg.rules,
                       starting_stack=cfg.starting_stack, max_layers=L,
                       max_pot_layers=4 * L, bets_impl="levels")
    st0 = tstate.redeal(tstate.init_state(0, gcfg, T, acts.device),
                        erp.decks_from_deals(deals[:, 0]))
    rows = acts.permute(1, 0, 2, 3).reshape(n_steps, T)
    rep = erp.replay_injected(gcfg, st0, rows, deals)
    return out, erp.against_k3(out, gcfg, rep), rep


def _det_check(name, cfg, acts, cards, n_steps, need_clean):
    _, agree, rep = det_against_engine(cfg, acts, cards, n_steps)
    clean = float((~agree.k3_overflow).float().mean())
    equal = not any(bool(b.any()) for b in agree.mismatch.values())
    same_ovf = bool(torch.equal(agree.k3_overflow, rep.overflow))
    T = agree.k3_overflow.numel()
    return _report(name, equal and same_ovf and clean >= need_clean,
                   tables=T, within_capacity=clean,
                   hands=int(rep.hand_ct.sum()))


def in_play_chips(state, cfg):
    """Chips in the street (the contributions) and in the pots (amount
    times contributors) of every table, int64 [T]."""
    layout, _ = ce._field_layout(cfg.num_seats, cfg.rules)
    total = sum(ce.unpack_field(state, cfg, "contrib", k).long()
                for k in range(layout["contrib"][1]))
    for k in range(layout["pot_amt"][1]):
        pset = ce.unpack_field(state, cfg, "pot_set", k)
        n = sum((pset >> s) & 1 for s in range(cfg.num_seats))
        total = total + ce.unpack_field(state, cfg, "pot_amt", k).long() * n
    return total


def check_engine_kernel(device=None) -> int:
    """The engine section at the JAX script's sizes; returns the count of
    checks that failed."""
    dev = resolve(device)
    cfg = TableConfig(num_seats=P, max_layers=8, max_pot_layers=16)
    return (_check_det(1024, 24, dev) + _check_prng(cfg, 1 << 14, 256, dev)
            + _check_standard(1 << 13, dev) + _check_tournament(1 << 13, dev)
            + _check_policy_net(1 << 14, 256, dev)
            + _check_mesh(cfg, 8, 1 << 14, 256, dev))


def _check_det(n_tables, n_steps, dev):
    """(a) K3 on an injected stream against the plain engine; (a2) a
    low-raise stream, every table within capacity."""
    cfg = TableConfig(num_seats=P, bets_impl="levels")
    failures = 0
    for name, seed, raise_p, need in (
            ("engine det (K3) vs plain engine", 23, 0.08, 0.9),
            ("engine det (K3) full block, 3% raises", 41, 0.03, 1.0)):
        acts, cards = injected_stream(seed, n_tables, n_steps, raise_p, dev)
        failures += _det_check(name, cfg, acts, cards, n_steps, need)
    return failures


def _prng_slots_per_hand(cfg, n_tables, n_steps, dev):
    """K4's run of ``check_engine_kernel`` (b): (state, slots a hand,
    overflowed tables)."""
    state, hands_k, ovf = ce.selfplay_perpetual_kernel(
        5, cfg, n_tables, n_steps, steps_per_launch=n_steps, device=dev)
    return state, n_tables * n_steps / max(hands_k, 1), ovf


def _check_prng(cfg, prng_tables, prng_steps, dev):
    """(b) K4 against the plain perpetual engine."""
    from montecarlo_tpu_torch.rollout.selfplay import play_hands_perpetual

    state, sph_k, ovf = _prng_slots_per_hand(cfg, prng_tables, prng_steps,
                                             dev)
    _, hands_x = play_hands_perpetual(5, cfg, prng_tables, prng_steps,
                                      device=dev)
    sph_x = prng_tables * prng_steps / max(int(hands_x), 1)
    defer = ce._defer_for(prng_steps)
    sph_expect = sph_x + (defer - 1) / 2
    with open("data/position_winrates.json") as f:
        art = json.load(f)["reference_rules"]["positions"]
    sums, hands_m = ce.position_deltas(state, cfg)
    pos_bb = sums / max(hands_m, 1) / cfg.big_blind
    worst = max(abs(pos_bb[k] - art[str(k)]["bb_per_hand"])
                for k in range(P))
    return _report(
        "engine prng (K4) vs plain engine",
        ovf == 0 and abs(sph_k - sph_expect) / sph_expect < 0.03
        and worst < 0.25, slots_per_hand=sph_k, expected=sph_expect,
        engine_steps_per_hand=sph_x, worst_position_diff_bb=worst,
        overflow=ovf)


def _check_standard(std_tables, dev):
    """(c) standard rules: chips conserve exactly."""
    cfg_std = TableConfig(num_seats=P, rules="standard")
    state2, hands2, ovf2 = ce.selfplay_perpetual_kernel(
        9, cfg_std, std_tables, 256, steps_per_launch=256, device=dev)
    stacks = sum(ce.unpack_field(state2, cfg_std, "stacks", k).long()
                 for k in range(P))
    total = stacks + in_play_chips(state2, cfg_std)
    expected = P * cfg_std.starting_stack
    return _report(
        "engine standard rules: chips conserved",
        ovf2 == 0 and hands2 > 0 and bool((total == expected).all()),
        hands=hands2, tables_off=int((total != expected).sum()),
        overflow=ovf2)


def _check_tournament(tour_tables, dev):
    """(c2) tournaments to completion."""
    cfg_t = TableConfig(num_seats=P, rules="tournament")
    state3, steps3 = ce.tournaments_to_completion(
        13, cfg_t, tour_tables, steps_per_launch=1024, device=dev)
    ovf3 = int(ce.unpack_field(state3, cfg_t, "overflow").sum())
    stacks3 = torch.stack([ce.unpack_field(state3, cfg_t, "stacks", k)
                           for k in range(P)]).cpu().numpy()
    frozen = (ce.unpack_field(state3, cfg_t, "order") == 0).cpu().numpy()
    chips = P * cfg_t.starting_stack
    places, frozen_r = ce.tournament_results(state3, cfg_t)
    return _report(
        "engine tournament to completion",
        ovf3 == 0 and frozen.all() and (stacks3.max(0) == chips).all()
        and (stacks3.sum(0) == chips).all() and frozen_r.all()
        and places.shape == (tour_tables, P)
        and (np.sort(places, axis=1) == np.arange(1, P + 1)[None]).all(),
        tables=tour_tables, steps=steps3, overflow=ovf3)


def _check_policy_net(net_tables, net_steps, dev):
    """(d) the in-kernel policy net: trained against untrained at seat
    0."""
    cfg_net = TableConfig(num_seats=P, rules="standard")
    mt, et, _ = cn.selfplay_net_eval_kernel(
        11, cfg_net, load_params("data/policy_6max_200.npz"), 1, net_tables,
        net_steps, device=dev)
    mu, eu, _ = cn.selfplay_net_eval_kernel(
        11, cfg_net, init_params(torch.Generator().manual_seed(0)), 1,
        net_tables, net_steps, device=dev)
    return _report(
        "in-kernel policy net: trained beats untrained",
        mt[0] - 2 * et[0] > mu[0] + 2 * eu[0] and mt[0] - 2 * et[0] > 0,
        trained=float(mt[0]), trained_se=float(et[0]),
        untrained=float(mu[0]), untrained_se=float(eu[0]))


def _check_mesh(cfg, mesh_blocks, prng_tables, prng_steps, dev):
    """(e) K4 through the mesh (a world of one here) against (b)'s K4."""
    from montecarlo_tpu_torch.parallel.mesh import (
        make_mesh,
        sharded_selfplay_kernel,
    )

    _, sph_k, _ = _prng_slots_per_hand(cfg, prng_tables, prng_steps, dev)
    mesh = make_mesh(dev)
    _, hands_mesh = sharded_selfplay_kernel(mesh, 7, cfg, mesh_blocks, 256)
    sph_m = (mesh.size * mesh_blocks * ce.TABLES_PER_BLOCK * 256
             / max(hands_mesh, 1))
    return _report("mesh + engine kernel",
                   abs(sph_m - sph_k) / sph_k < 0.05, hands=hands_mesh,
                   ranks=mesh.size, slots_per_hand=sph_m)


def check_net_kernels(device=None, n_tables=4096, n_steps=256,
                      seed=314) -> int:
    dev = resolve(device)
    failures = 0
    cfg = TableConfig(num_seats=P, rules="standard")
    cands = [load_params("data/policy_6max_200.npz"),
             init_params(torch.Generator().manual_seed(7))]
    state0 = cn.initial_packed_state(seed, cfg, n_tables, dev)
    pm, pe, ph = cn.selfplay_net_eval_pop(seed, cfg, cands, 1, n_tables,
                                          n_steps, state0=state0)
    ok = True
    for c, params in enumerate(cands):
        m, e, h = cn.selfplay_net_eval_kernel(seed, cfg, params, 1,
                                              n_tables, n_steps,
                                              state0=state0)
        ok &= bool(np.array_equal(m, pm[c]) and np.array_equal(e, pe[c])
                   and h == ph[c])
    failures += _report(f"pop kernel (B8) vs {len(cands)} single launches",
                        ok, hands=[int(x) for x in ph])

    m1, _, h1 = cn.selfplay_net_eval_kernel(seed, cfg, cands[0],
                                            (1 << P) - 1, n_tables, n_steps,
                                            state0=state0)
    m2, _, h2 = cn.selfplay_net_league(seed, cfg, [cands[0], cands[0]],
                                       tuple(k % 2 for k in range(P)),
                                       n_tables, n_steps, state0=state0)
    failures += _report("league kernel (B7, identical banks) vs single net",
                        np.array_equal(m1, m2) and h1 == h2, hands=h2)

    # bank routing under reference rules, where an all-in seat is left out
    # of the showdown: the pot-raise bot jams and loses its stack
    rcfg = TableConfig(num_seats=P)
    rstate0 = cn.initial_packed_state(seed, rcfg, n_tables, dev)
    callbot, raisebot = bots.action_bot(1), bots.action_bot(3)
    stb = (0,) + (1,) * (P - 1)
    ma = cn.selfplay_net_league(seed, rcfg, [callbot, raisebot], stb,
                                n_tables, n_steps, state0=rstate0)[0]
    mb = cn.selfplay_net_league(seed, rcfg, [raisebot, callbot], stb,
                                n_tables, n_steps, state0=rstate0)[0]
    mp = cn.selfplay_net_league_pop(seed, rcfg, [callbot, raisebot],
                                    raisebot, n_tables, n_steps,
                                    seat_to_bank=stb, state0=rstate0)[0]
    failures += _report(
        "league bank routing (call at 0 vs raise at 0)",
        ma[0] > 0 > mb[0] and mp[0, 0] > mp[1, 0],
        seat0=[float(ma[0]), float(mb[0])],
        pop=[float(mp[0, 0]), float(mp[1, 0])])
    return failures


def check_net_det(device=None, n_tables=1024, n_steps=24, hmax=16) -> int:
    """K5 with two rule-bot banks (jam_tight at seat 0, fof_call elsewhere)
    on injected deals, against the plain net pipeline."""
    dev = resolve(device)
    L = ce._L_for("standard")
    cfg = TableConfig(num_seats=P, rules="standard", max_layers=L,
                      max_pot_layers=4 * L, bets_impl="levels")
    rng = np.random.default_rng(97)
    deals = torch.from_numpy(np.argsort(rng.random((n_tables, hmax, 52)),
                                        axis=-1)[..., :2 * P + 5]
                             .astype(np.int32)).to(dev)
    nb = n_tables // ce.TABLES_PER_BLOCK
    cards = deals.reshape(nb, ce.TABLES_PER_BLOCK, hmax, 2 * P + 5) \
        .permute(0, 2, 3, 1).reshape(nb, hmax, 2 * P + 5, *ce.TILE) \
        .contiguous()
    panel = bots.panel()
    banks = [panel["jam_tight"], panel["fof_call"]]
    stb = (0,) + (1,) * (P - 1)
    packed = ce.pack_state(cfg, deals[:, 0])
    out = cn.run_net_det(packed, cards, cn.bank_weights(banks, dev), P,
                         n_steps, cfg.small_blind, cfg.big_blind, cfg.rules,
                         stb)
    decks = erp.decks_from_deals(deals.reshape(-1, 2 * P + 5)).reshape(
        n_tables, hmax, 52)
    st0 = tstate.redeal(tstate.init_state(0, cfg, n_tables, dev),
                        decks[:, 0])
    rep = erp.replay_net_det(cfg, st0, banks, stb, decks, n_steps)
    agree = erp.against_k5(out, cfg, rep)
    clean = float((~agree.k3_overflow).float().mean())
    equal = not any(bool(b.any()) for b in agree.mismatch.values())
    return _report("net det kernel (K5, two banks) vs plain net pipeline",
                   equal and clean > 0.95
                   and bool(torch.equal(agree.k3_overflow, rep.overflow)),
                   tables=n_tables, within_capacity=clean,
                   hands=int(rep.hand_ct.sum()))


def check_equity(device=None) -> int:
    """The equity section at the JAX script's sizes; returns the count of
    checks that failed."""
    dev = resolve(device)
    return (_check_sweep(2_000_000, dev) + _check_mesh_equity(2_000_000, dev)
            + _check_flop(2_000_000, dev) + _check_multiway(2_000_000, dev)
            + _check_matchups(N, dev))


def _check_sweep(n, dev):
    """K2: AA and 72o against a random hand, in their textbook ranges."""
    heroes = [[make_card(H, 14), make_card(D, 14)],   # AA ~0.853
              [make_card(H, 7), make_card(D, 2)]]     # 72o ~0.347
    eq, _ = cq.equity_sweep_kernel(11, heroes, n, dev)
    return sum(_report(f"sweep (K2) {nm} vs random", lo < eq[i] < hi,
                       equity=float(eq[i]))
               for i, (nm, lo, hi) in enumerate([("AA", 0.84, 0.87),
                                                 ("72o", 0.30, 0.37)]))


def _check_mesh_equity(n, dev):
    """K1 through the mesh (a world of one here), near 0.460."""
    from montecarlo_tpu_torch.parallel.mesh import (
        make_mesh,
        sharded_equity_pallas,
    )

    mesh = make_mesh(dev)
    r = sharded_equity_pallas(mesh, 29, [make_card(H, 14), make_card(H, 13)],
                              [make_card(D, 12), make_card(S, 12)], n)
    return _report("mesh + equity kernel (K1)", abs(r.equity - 0.460) < 0.01,
                   equity=r.equity, ranks=mesh.size)


def _check_flop(n, dev):
    """K1 on a flop against exact enumeration (990 completions)."""
    from montecarlo_tpu_torch.rollout.equity import equity_exact

    hero = [make_card(H, 14), make_card(H, 13)]
    villain = [make_card(D, 12), make_card(S, 12)]
    flop = [make_card(H, 12), make_card(H, 7), make_card(H, 2)]
    exact = equity_exact(hero, villain, board=flop, device=dev)
    w, t, m = cq.equity_vs_hand_kernel(13, hero, villain, n, flop, dev)
    kern = (w + 0.5 * t) / m
    return _report("flop kernel (K1) vs exact",
                   abs(kern - exact.equity) < 0.003, exact=exact.equity,
                   kernel=kern)


def _check_multiway(n, dev):
    """B3 against the plain multiway path on other draws."""
    trio = [[make_card(H, 14), make_card(D, 14)],
            [make_card(S, 13), make_card(C, 13)],
            [make_card(H, 7), make_card(D, 6)]]
    eq_k, _ = cq.equity_multiway_kernel(17, trio, n, (), dev)
    dead, hm = cq._multiway_masks(trio, (), dev)
    shares = cq._multiway_shares_plain_philox(18, dead.tolist(), hm.tolist(),
                                              n, dev)
    eq_x = shares.cpu().numpy() / (cq.multiway_scale(3) * n)
    return _report("multiway kernel (B3) vs plain multiway path",
                   max(abs(a - b) for a, b in zip(eq_k, eq_x)) < 0.004,
                   kernel=[float(x) for x in eq_k],
                   plain=[float(x) for x in eq_x])


def _check_matchups(n, dev):
    """K1 against the plain equity path (other draws, within 6 combined
    standard errors) and the textbook values (within 0.02)."""
    failures = 0
    for name, hero, villain, approx in MATCHUPS:
        dead, hm, vm = cq._hand_masks(hero, villain, (), dev)
        wx, tx = cq._equity_counts_plain_philox(
            1, dead.tolist(), hm.tolist(), vm.tolist(), n, dev).tolist()
        plain = (wx + 0.5 * tx) / n
        w, t, m = cq.equity_vs_hand_kernel(2, hero, villain, n, (), dev)
        kern = (w + 0.5 * t) / m
        se = math.sqrt(0.25 / n) * 2  # conservative combined SE
        failures += _report(
            f"{name}: kernel (K1) vs plain path and textbook",
            abs(plain - kern) < 6 * se and abs(kern - approx) < 0.02,
            plain=plain, kernel=kern, textbook=approx)
    return failures


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["engine", "equity", "net"],
                    default=None, help="run one section")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = args.device
    failures = 0
    if args.only in (None, "engine"):
        failures += check_engine_kernel(dev)
    if args.only in (None, "engine", "net"):
        failures += check_net_kernels(dev)
        failures += check_net_det(dev)
    if args.only in (None, "equity"):
        failures += check_equity(dev)
    print(json.dumps({"failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
