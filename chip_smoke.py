"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase is caught):

0. setup: require CUDA, print the card's name and power limit, build the
   kernels from ``montecarlo_tpu_torch/csrc`` (nvcc, sm_90a), and hold the
   card's Philox4x32-10 against the Random123 known-answer vectors;
1. main path, with every launch counter reset first: equity rollouts
   (K1, AKs vs QQ preflop and on a flop), the 169-hand sweep (K2),
   deterministic engine steps at full width (K3) and random-policy
   perpetual self-play (K4, 6-max, reference rules); every kernel must
   have launched;
2. results: equity within 4 sigma of exact enumeration, the sweep within
   5 sigma of ``data/sweep169.json``, self-play with no overflow and
   slots/hand within 2% of 33.1 (25.57 steps per hand plus (16 - 1) / 2
   idle slots of deferred settlement);
3. agreement, tolerance 0 (the outputs are integers): every kernel call of
   phase 1 against its plain PyTorch version on the card, on the same
   inputs at the same size (the plain versions compute the kernels'
   Philox words, ``ops/philox.py``), timed once with CUDA events; then
   K1, K2 and K4 on injected words (their ``words`` option);
4. timing: each main-path kernel call again on the card (CUDA events).

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20261016
SLOTS_PER_HAND = 33.1   # reference rules, DEFER = 16, random policy
# Main-path sizes (bench.py's): rollouts, sweep rollouts per hand, tables,
# det steps, self-play slots.
N_EQUITY = 1 << 30
N_FLOP = 1 << 28
N_SWEEP = 10_000_000
T_FULL = 1 << 20
DET_STEPS = 64
HMAX = 12
SP_SLOTS = 512
# Rollouts per chunk of a plain version on the card.
PLAIN_CHUNK = 1 << 24
# Philox4x32-10 known answers: (counter x0..x3, key k0 k1) -> output, from
# the Random123 distribution's kat_vectors (Salmon et al., SC'11).
PHILOX_KAT = [
    ([0, 0, 0, 0, 0, 0],
     [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 6,
     [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822,
      0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(*a):
    print(*a, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from montecarlo_tpu_torch.device import cuda_device
    from montecarlo_tpu_torch.engine.state import TableConfig
    from montecarlo_tpu_torch.ops import _build
    from montecarlo_tpu_torch.ops import cuda_engine as ce
    from montecarlo_tpu_torch.ops import cuda_equity as cq
    from montecarlo_tpu_torch.ops import philox
    from montecarlo_tpu_torch.rollout import equity as teq

    dev = cuda_device()

    def sync():
        torch.cuda.synchronize(dev)

    def timed(fn):
        """(result, ms) of one run of ``fn`` on the card (CUDA events)."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def cuda_ms(fn, reps=3):
        """Median time of ``fn`` on the card over ``reps`` runs, after one
        warm-up."""
        fn()
        sync()
        return float(np.median([timed(fn)[1] for _ in range(reps)]))

    # ---- 0. setup ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    lib_path, build_s = _build.build()
    _build.library()
    log(f"build: {build_s:.1f} s -> {lib_path}")
    log((lib_path.parent / "build.log").read_text()
        if (lib_path.parent / "build.log").exists() else "")

    kat = philox.philox_blocks(torch.tensor([c for c, _ in PHILOX_KAT],
                                            dtype=torch.int64, device=dev))
    check(kat.tolist() == [w for _, w in PHILOX_KAT],
          "the card's Philox4x32-10 gives the known answers")
    log("Philox4x32-10 on the card: known answers match")

    AKS = [teq.make_card(0, 14), teq.make_card(0, 13)]
    QQ = [teq.make_card(1, 12), teq.make_card(2, 12)]
    FLOP = [teq.make_card(3, 2), teq.make_card(1, 7), teq.make_card(2, 13)]
    cfg = TableConfig(num_seats=6)
    P, SB, BB = cfg.num_seats, cfg.small_blind, cfg.big_blind
    heroes = torch.tensor([list(c) for _, c in teq.canonical_hands()],
                          dtype=torch.int32)
    sdead = torch.sort(heroes, dim=1).values.to(dev)
    smask = torch.stack(cq.suit_masks_from_cards(heroes), dim=1).to(dev)

    # K3's injected streams (folds 20%, calls 72%, raises 8%) and deals.
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.rand((DET_STEPS, T_FULL), generator=g, device=dev)
    raises = torch.randint(1, 21, (DET_STEPS, T_FULL), generator=g,
                           device=dev)
    acts_full = torch.where(u < 0.20, -1, torch.where(u < 0.92, 0, raises)) \
        .to(torch.int32).reshape(DET_STEPS, T_FULL // 1024, 8, 128) \
        .permute(1, 0, 2, 3).contiguous()
    deal_full = torch.rand((T_FULL, HMAX, 52), generator=g, device=dev) \
        .argsort(dim=-1)[..., :2 * P + 5].to(torch.int32)
    cards_full = deal_full.reshape(T_FULL // 1024, 1024, HMAX, 2 * P + 5) \
        .permute(0, 2, 3, 1).reshape(T_FULL // 1024, HMAX, 2 * P + 5, 8,
                                     128).contiguous()
    st_full = ce.pack_state(cfg, deal_full[:, 0])
    del u, raises, deal_full
    exact_pre = teq.equity_exact(AKS, QQ, device=dev)
    exact_flop = teq.equity_exact(AKS, QQ, FLOP, device=dev)
    sync()

    # ---- 1. main path ---------------------------------------------------
    cq.reset_launches()
    ce.reset_launches()
    t0 = time.perf_counter()
    r_pre = teq.equity_vs_hand(SEED, AKS, QQ, N_EQUITY, device=dev)
    r_flop = teq.equity_vs_hand(SEED + 1, AKS, QQ, N_FLOP, FLOP, device=dev)
    eq169, n169 = cq.equity_sweep_kernel(SEED + 2, heroes, N_SWEEP, dev)
    det_out = ce.run_perpetual_det(st_full, acts_full, cards_full, P,
                                   DET_STEPS, SB, BB)
    sp_state, sp_hands, sp_ovf = ce.selfplay_perpetual_kernel(
        SEED, cfg, T_FULL, SP_SLOTS, steps_per_launch=SP_SLOTS, device=dev)
    sync()
    main_s = time.perf_counter() - t0
    launches = {"K1": cq.LAUNCHES["equity"], "K2": cq.LAUNCHES["sweep"],
                "K3": ce.LAUNCHES["engine_det"],
                "K4": ce.LAUNCHES["engine_prng"]}
    log(f"main path: {main_s:.2f} s, launches {launches}")
    check(all(v > 0 for v in launches.values()),
          "every kernel of the path launched")

    # ---- 2. results -----------------------------------------------------
    for name, r, ex in (("preflop", r_pre, exact_pre),
                        ("flop", r_flop, exact_flop)):
        z = (r.equity - ex.equity) / r.stderr
        log(f"AKs vs QQ {name}: {r.equity:.6f} over {r.n} rollouts, exact "
            f"{ex.equity:.6f}, z = {z:+.2f}")
        check(r.wins + r.ties + r.losses == r.n, f"{name} counts add up")
        check(abs(z) < 4, f"{name} equity within 4 sigma of exact")
    rec = json.loads((ROOT / "data" / "sweep169.json").read_text())
    n_rec = rec["rollouts_per_hand"]
    zmax, worst = 0.0, None
    for (label, _), e in zip(teq.canonical_hands(), eq169):
        want = rec["equity"][label]
        var = want * (1 - want)
        z = (e - want) / np.sqrt(var / n169 + var / n_rec)
        if abs(z) > abs(zmax):
            zmax, worst = z, label
    log(f"sweep169: {n169} rollouts/hand, max |z| = {abs(zmax):.2f} ({worst})")
    check(np.all(np.isfinite(eq169)) and eq169.shape == (169,),
          "sweep shape and finiteness")
    check(abs(zmax) < 5, "every hand within 5 sigma of data/sweep169.json")

    det_hands = int(ce.unpack_field(det_out, cfg, "hand_ct").sum())
    det_ovf = int(ce.unpack_field(det_out, cfg, "overflow").sum())
    log(f"K3 main path: {T_FULL} tables x {DET_STEPS} steps, {det_hands} "
        f"hands, {det_ovf} overflowed tables")
    check(det_hands > 0, "det engine completed hands")

    slots_per_hand = T_FULL * SP_SLOTS / max(sp_hands, 1)
    log(f"K4 self-play: {sp_hands} hands, overflow {sp_ovf}, "
        f"slots/hand {slots_per_hand:.4f}")
    check(sp_hands > 0 and sp_ovf == 0, "self-play hands > 0, no overflow")
    check(abs(slots_per_hand / SLOTS_PER_HAND - 1) < 0.02,
          "slots/hand within 2% of 33.1")
    sums, hands = ce.position_deltas(sp_state, cfg)
    pos_rec = json.loads((ROOT / "data" / "position_winrates.json")
                         .read_text())["reference_rules"]["positions"]
    for k in range(P):
        log(f"  position {k}: {sums[k] / hands / BB:+.5f} bb/hand"
            f" (record {pos_rec[str(k)]['bb_per_hand']:+.5f})")

    # ---- 3. agreement: each kernel call against its plain version -------
    err, plain_ms = {}, {}

    def agree(key, what, kernel_out, plain_out):
        k, p = (torch.as_tensor(x, dtype=torch.float64, device=dev)
                for x in (kernel_out, plain_out))
        check(k.shape == p.shape, f"{key} {what}: shapes agree")
        e = float((k - p).abs().max())
        err[key] = max(err.get(key, 0.0), e)
        log(f"{key} {what}: max |kernel - plain| = {e}")
        check(e == 0, f"{key} {what}: kernel equals its plain version")

    pre = cq._hand_masks(AKS, QQ, (), dev)
    flop = cq._hand_masks(AKS, QQ, FLOP, dev)

    def k1_plain(seed, masks, n):
        dead, hm, vm = (m.tolist() for m in masks)
        return cq._equity_counts_plain_philox(seed, dead, hm, vm, n, dev,
                                              chunk=PLAIN_CHUNK)

    p, plain_ms["K1"] = timed(lambda: k1_plain(SEED, pre, N_EQUITY))
    agree("K1", f"main path preflop, {N_EQUITY} rollouts",
          [r_pre.wins, r_pre.ties], p)
    p = k1_plain(SEED + 1, flop, N_FLOP)
    agree("K1", f"main path flop, {N_FLOP} rollouts",
          [r_flop.wins, r_flop.ties], p)

    p, plain_ms["K2"] = timed(lambda: cq._sweep_counts_plain_philox(
        SEED + 2, sdead, smask, N_SWEEP, chunk=PLAIN_CHUNK))
    w, t = p.cpu().numpy().astype(np.float64)
    # the wrapper's equities, from the plain counts by the wrapper's formula
    agree("K2", f"main path, 169 x {N_SWEEP} rollouts", eq169,
          (w + 0.5 * t) / N_SWEEP)

    p, plain_ms["K3"] = timed(lambda: ce._run_det_plain(
        st_full, acts_full, cards_full, P, DET_STEPS, SB, BB))
    agree("K3", f"main path, {T_FULL} tables x {DET_STEPS} steps",
          det_out, p)
    del p

    st_sp = ce.pack_state(cfg, ce.first_deal(SEED, T_FULL, P, dev))
    p, plain_ms["K4"] = timed(lambda: ce._run_prng_plain_philox(
        SEED, st_sp, P, SP_SLOTS, SB, BB))
    agree("K4", f"main path, {T_FULL} tables x {SP_SLOTS} slots",
          sp_state, p)
    del p

    # the words option: injected words instead of Philox
    dead, hm, vm = pre
    words = cq.random_words(g, (5, PLAIN_CHUNK), dev)
    agree("K1", f"injected words, {PLAIN_CHUNK} rollouts",
          cq.equity_counts(0, dead, hm, vm, PLAIN_CHUNK, words=words),
          cq._equity_counts_plain(words, dead.tolist(), hm.tolist(),
                                  vm.tolist()))
    words = cq.random_words(g, (7, 169, 1 << 16), dev)
    agree("K2", "injected words, 169 x 65536 rollouts",
          cq.sweep_counts(0, sdead, smask, 1 << 16, words=words),
          cq._sweep_counts_plain(words, sdead, smask))
    words = cq.random_words(g, ce.prng_words_shape(T_FULL, P, 32), dev)
    agree("K4", f"injected words, {T_FULL} tables x 32 slots",
          ce.run_perpetual_prng(0, st_sp, P, 32, SB, BB, words=words),
          ce._run_prng_plain(st_sp, words, P, 32, SB, BB))
    del words

    # ---- 4. timing ------------------------------------------------------
    dead, hm, vm = pre
    times = {
        "K1": cuda_ms(lambda: cq.equity_counts(SEED, dead, hm, vm,
                                               N_EQUITY)),
        "K2": cuda_ms(lambda: cq.sweep_counts(SEED + 2, sdead, smask,
                                              N_SWEEP), reps=2),
        "K3": cuda_ms(lambda: ce.run_perpetual_det(
            st_full, acts_full, cards_full, P, DET_STEPS, SB, BB)),
        "K4": cuda_ms(lambda: ce.run_perpetual_prng(SEED, st_sp, P, SP_SLOTS,
                                                    SB, BB)),
    }
    t0 = time.perf_counter()
    cq.equity_sweep_kernel(SEED + 5, heroes, N_SWEEP, dev)
    sweep_warm_s = time.perf_counter() - t0

    work = {  # (work of one call, unit); the kernel and plain alike
        "K1": (N_EQUITY, "rollouts"),
        "K2": (169 * N_SWEEP, "rollouts"),
        "K3": (T_FULL * DET_STEPS, "table-steps"),
        "K4": (T_FULL * SP_SLOTS, "table-slots"),
    }
    for key, (n, unit) in work.items():
        log(f"{key}: kernel {times[key]:.3f} ms, plain {plain_ms[key]:.3f} "
            f"ms for {n} {unit} ({times[key] * 1e6 / n:.4f} / "
            f"{plain_ms[key] * 1e6 / n:.4f} ns each)")
    rates = {
        "equity_rollouts_per_sec": N_EQUITY / (times["K1"] / 1e3),
        "sweep169_seconds_warm": sweep_warm_s,
        "betting_hands_per_sec": sp_hands / (times["K4"] / 1e3),
        "betting_steps_per_hand": slots_per_hand,
        "betting_ns_per_table_step": times["K4"] * 1e6 / (T_FULL * SP_SLOTS),
        "det_ns_per_table_step": times["K3"] * 1e6 / (T_FULL * DET_STEPS),
    }
    log(json.dumps({"card": smi, **rates}))

    src = "montecarlo_tpu_torch/csrc/"
    meta = [
        ("K1", "equity_rollouts", src + "equity.cu",
         "montecarlo_tpu/ops/pallas_equity.py:125"),
        ("K2", "sweep169", src + "equity.cu",
         "montecarlo_tpu/ops/pallas_equity.py:182"),
        ("K3", "engine_det", src + "engine.cu",
         "montecarlo_tpu/ops/pallas_engine.py:716"),
        ("K4", "engine_prng", src + "engine.cu",
         "montecarlo_tpu/ops/pallas_engine.py:716"),
    ]
    kernels = [{
        "name": f"{key} {name}", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[key],
        "max_abs_err": err[key], "ms": times[key],
        "plain_ms": plain_ms[key], "work": work[key][0],
        "unit": work[key][1],
    } for key, name, source, replaces in meta]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
