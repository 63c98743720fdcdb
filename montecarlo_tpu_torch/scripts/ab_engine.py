"""A/B of the port's kernels against another build of ``csrc/``.

Run from the repository root on a machine with a card, with another
commit's sources unpacked somewhere (``git archive <commit>
montecarlo_tpu_torch/csrc | tar -x -C DIR``):

    python -m montecarlo_tpu_torch.scripts.ab_engine \\
        --parent DIR/montecarlo_tpu_torch/csrc [--runs 5] [--also DIR2] \\
        [--variants MC_DET_SETTLE_MIN=4,MC_DET_SETTLE_MIN=16] [--time-only] \\
        [--calls K1,K1f,B3,B3f,K2]

Each source tree is built with ``_build.NVCC_FLAGS`` into a temporary
directory (the six-seat library of ``engine.cu`` and ``net.cu``, the one
of the other sources but the probes', and one stage-probe library a
stage; one nvcc per source), and every build is loaded into this process. Each
kernel call of the main paths runs on every tree in turn, ``runs``
times, the order reversed every other run (parent, this tree, this tree,
parent, ...), each call timed with CUDA events; the medians and their
ratios are printed, and the trees' outputs must be equal bit for bit.
The calls, at ``chip_smoke.py``'s sizes: K1 (AKs vs QQ preflop, 2^30
rollouts; K1f on the flop 2c 7h Kd, 2^28), K2 (169 hands x 10^7
rollouts), B3 (AA/KK/76o preflop, 2^30 rollouts; B3f AhKh/QsQd/JcTc on
9h 8s 2h, 2^28), K4 under reference and standard rules (2^20 tables x 512
slots) and tournament rules (2^20 6-max tournaments, the completion
run's first, fifth and last launches of 1024 slots), K3 under each rule
set (2^20 x 64 injected steps; tournament with 20-chip stacks), the stage
probe's six stages (2^20 tables x 256 steps from K3's output state), K5
(2^18 x 64, one bot and two banks), K6 (2^18 x 256, es3 at seat 0), B7
(2^16 x 256, two banks), B8 (32 candidates x 2^14 x 256, one and two
banks) and the net probe (2^18 tables, es3).

``--also DIR2`` adds a further source tree to the same turns.
``--variants`` builds this tree again once per ``NAME=VALUE``, with the
``#define NAME`` of ``csrc/`` set to VALUE (``MC_ENGINE_THREADS``, the
engine kernels' block size in ``engine.cuh``; ``MC_DET_SETTLE_MIN``, the
waiting tables at which a K3 warp runs its settle pass, in ``engine.cuh``
(``--calls K3,K3s,K3t`` times only K3); ``MC_NET_CHUNK``, the net
kernels' hidden rows a chunk, in ``net.cuh``; ``MC_NET_MIN_BLOCKS``,
K5's and K6's launch bound, in ``net.cu``), and times every call on each
against this tree: the measurement behind those constants
(``MC_EQUITY_CUT``, in ``equity.cuh``, stops K1's and B3's rollouts
early: a probe whose outputs differ by design, so it takes
``--time-only``, which times the variants without comparing their
outputs; this tree and the parent are compared all the same). Constants that
must change together (``MC_NET_THREADS`` with the net launch bound) take a
copy of ``csrc/`` edited by hand, through ``--also``. A library that lacks
a C entry of this tree (an older commit's) is loaded without it.
``--calls`` times only the named calls; when they are all equity calls
(K1, K1f, K2, B3, B3f) only the library without a seat count is built.

Each library's ptxas report (registers, stack frame and spills per kernel)
is printed first. The last line is one JSON object with every median; with
``--out FILE`` the whole report is written there too.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from montecarlo_tpu_torch.device import cuda_device
from montecarlo_tpu_torch.engine.state import TableConfig
from montecarlo_tpu_torch.models import bots
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.ops import _build
from montecarlo_tpu_torch.ops import cuda_engine as ce
from montecarlo_tpu_torch.ops import cuda_equity as cq
from montecarlo_tpu_torch.ops import cuda_net as cn
from montecarlo_tpu_torch.ops import cuda_stages as cs
from montecarlo_tpu_torch.rollout import equity as teq

P, SB, BB, SS = 6, 5, 10, 100
SEED = 20261016
T_FULL = 1 << 20
SP_SLOTS = 512
DET_STEPS, HMAX = 64, 12
TOUR_LAUNCH, TOUR_STACK = 1024, 20
TOUR_TIMED = (0, 4, -1)   # completion launches timed (the last: -1)
T_NET, NET_DET_STEPS, NET_HMAX, NET_LAUNCH = 1 << 18, 64, 16, 256
T_LEAGUE = 1 << 16
TRAIN_POP, T_TRAIN, TRAIN_SLOTS, TRAIN_SEED = 32, 1 << 14, 256, 13
N_EQUITY, N_FLOP, N_SWEEP = 1 << 30, 1 << 28, 10_000_000
STAGE_STEPS = 256
EQUITY_CALLS = ("K1", "K1f", "K2", "B3", "B3f")


def _load(path, signatures):
    """``_build.load_library`` with the entries the library has."""
    lib = ctypes.CDLL(str(path))
    return _build.load_library(path, {k: v for k, v in signatures.items()
                                      if hasattr(lib, k)})


def build(csrc: Path, out_dir: Path, equity_only: bool = False):
    """Build ``csrc``'s library without a seat count and, unless
    ``equity_only``, its seat library (P = 6) and the stage probe's into
    ``out_dir``; returns the loaded libraries (None for those not built),
    the ptxas report of the first two and the seconds of each."""
    common = [f for f in sorted(csrc.glob("*.cu"))
              if f.name not in (*_build.SEAT_SOURCES, *_build.PROBE_SOURCES)]
    common_path, common_s = _build.compile_library(
        common, [], out_dir / "common", csrc)
    paths, seconds = [common_path], {"common": common_s}
    seat_lib, stage_libs = None, None
    if not equity_only:
        seat_path, seconds["p6"] = _build.compile_library(
            [csrc / name for name in _build.SEAT_SOURCES],
            [f"-DMC_SEATS={P}"], out_dir / "p6", csrc)
        paths.append(seat_path)
        seat_lib = _load(seat_path, _build.SEAT_SIGNATURES)
        stage_libs = {stage: _build.ProbeBuild(stage, _load(
            _build.compile_library(
                [csrc / "probe_stages.cu"],
                [f"-DMC_SEATS={P}", f"-DMC_STAGE=MC_STAGE_{stage.upper()}"],
                out_dir / f"stage-{stage}", csrc)[0],
            _build.STAGE_SIGNATURES), 0.0, {}) for stage in cs.STAGES}
    report = {}
    for lib_path in paths:
        report.update(_build.ptxas_report(
            (lib_path.parent / "build.log").read_text()))
    libs = (seat_lib, _load(common_path, _build.SIGNATURES), stage_libs)
    return libs, report, seconds


@contextlib.contextmanager
def using(libs):
    """The wrappers of ``ops/`` launch on ``libs`` (the seat library, the
    one without a seat count, the stage probe's builds) inside the block."""
    saved = _build.library, cs.stage_library
    _build.library = lambda seats=None: libs[0] if seats else libs[1]
    cs.stage_library = lambda stage, seats=P, fresh=False: libs[2][stage]
    try:
        yield
    finally:
        _build.library, cs.stage_library = saved


def equity_calls(dev):
    """K1, K2 and B3's main-path calls (and the flop's) as a dict of
    thunks, on inputs made once."""
    mk = teq.make_card
    aks, qq = [mk(0, 14), mk(0, 13)], [mk(1, 12), mk(2, 12)]
    dead, hm, vm = cq._hand_masks(aks, qq, (), dev)
    fdead, fhm, fvm = cq._hand_masks(aks, qq, [mk(3, 2), mk(1, 7), mk(2, 13)],
                                     dev)
    heroes = torch.tensor([list(c) for _, c in teq.canonical_hands()],
                          dtype=torch.int32)
    sdead = torch.sort(heroes, dim=1).values.to(dev)
    smask = torch.stack(cq.suit_masks_from_cards(heroes), dim=1).to(dev)
    mw_dead, mw_hm = cq._multiway_masks(
        [[mk(0, 14), mk(1, 14)], [mk(2, 13), mk(3, 13)], [mk(0, 7), mk(1, 6)]],
        (), dev)
    mwf_dead, mwf_hm = cq._multiway_masks(
        [[mk(0, 14), mk(0, 13)], [mk(2, 12), mk(1, 12)],
         [mk(3, 11), mk(3, 10)]], [mk(0, 9), mk(2, 8), mk(0, 2)], dev)
    return {
        "K1": lambda: cq.equity_counts(SEED, dead, hm, vm, N_EQUITY),
        "K1f": lambda: cq.equity_counts(SEED + 1, fdead, fhm, fvm, N_FLOP),
        "K2": lambda: cq.sweep_counts(SEED + 2, sdead, smask, N_SWEEP),
        "B3": lambda: cq.multiway_shares(SEED + 3, mw_dead, mw_hm, N_EQUITY),
        "B3f": lambda: cq.multiway_shares(SEED + 4, mwf_dead, mwf_hm, N_FLOP),
    }


def inputs(dev, libs):
    """The main-path calls of the engine and net kernels as a dict of
    thunks, on inputs made once (the completion run's launch states by
    ``libs``)."""
    cfg = TableConfig(num_seats=P, bets_impl="levels")
    std = TableConfig(num_seats=P, rules="standard", bets_impl="levels")
    tour = TableConfig(num_seats=P, rules="tournament", bets_impl="levels")
    tour_short = TableConfig(num_seats=P, rules="tournament",
                             starting_stack=TOUR_STACK, bets_impl="levels")
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.rand((DET_STEPS, T_FULL), generator=g, device=dev)
    raises = torch.randint(1, 21, (DET_STEPS, T_FULL), generator=g,
                           device=dev)
    acts = torch.where(u < 0.20, -1, torch.where(u < 0.92, 0, raises)) \
        .to(torch.int32).reshape(DET_STEPS, T_FULL // 1024, 8, 128) \
        .permute(1, 0, 2, 3).contiguous()
    del u, raises
    deal = torch.rand((T_FULL, HMAX, 52), generator=g, device=dev) \
        .argsort(dim=-1)[..., :2 * P + 5].to(torch.int32)
    cards = deal.reshape(T_FULL // 1024, 1024, HMAX, 2 * P + 5) \
        .permute(0, 2, 3, 1).reshape(T_FULL // 1024, HMAX, 2 * P + 5, 8,
                                     128).contiguous()
    det_in = {rules: ce.pack_state(c, deal[:, 0]) for rules, c in
              (("reference", cfg), ("standard", std),
               ("tournament", tour_short))}
    del deal
    fd = ce.first_deal(SEED, T_FULL, P, dev)
    sp_in = {"reference": ce.pack_state(cfg, fd),
             "standard": ce.pack_state(std, fd)}
    # the completion run's launch states (this tree's kernels; every
    # launch's state is the same on both, which the A/B checks)
    tour_states, state, done = [], ce.pack_state(tour, fd), 0
    while True:
        tour_states.append(((SEED + done * 7919) & 0x7FFFFFFF, state))
        with using(libs):
            state = ce.run_perpetual_prng(tour_states[-1][0], state, P,
                                          TOUR_LAUNCH, SB, BB, "tournament")
        done += TOUR_LAUNCH
        if int((ce.unpack_field(state, tour, "order") == 0).sum()) == T_FULL:
            break
    del state, fd
    es3 = tpn.load_params("data/policy_6max_es3.npz")
    p200 = tpn.load_params("data/policy_6max_200.npz")
    panel = bots.panel()
    w_es3 = cn.net_weights(es3, dev)
    w_bot = cn.net_weights(panel["fof_raise"], dev)
    w_det_banks = cn.bank_weights([panel["jam_tight"], panel["fof_call"]],
                                  dev)
    stash = cn.deal_stash(SEED, T_NET, P, NET_HMAX, dev)
    st_net_det = ce.pack_state(std, ce._stash_rows(stash)[0].T)
    st_net0 = cn.initial_packed_state(SEED, std, T_NET, dev)
    st_league0 = cn.initial_packed_state(SEED, std, T_LEAGUE, dev)
    probe_words = ce.table_words(SEED + 9, T_NET, 0, 4, dev)
    w7 = cn.bank_weights([es3, p200], dev)
    rng = np.random.default_rng(0)
    cands = [tpn.params_from_numpy([
        x.numpy() + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        for x in es3]) for _ in range(TRAIN_POP)]
    st_train0 = cn.initial_packed_state(TRAIN_SEED, std, T_TRAIN, dev)
    pop0 = st_train0[None].expand(TRAIN_POP, *st_train0.shape).contiguous()
    w8 = cn.pop_weights(cands, dev)
    w8l = cn.pop_weights(cands, dev, es3)
    all_seats = (1 << P) - 1
    parity = tuple(k % 2 for k in range(P))
    seat0 = (0,) + (1,) * (P - 1)

    calls = {
        "K4": lambda: ce.run_perpetual_prng(
            SEED, sp_in["reference"], P, SP_SLOTS, SB, BB),
        "K4s": lambda: ce.run_perpetual_prng(
            SEED, sp_in["standard"], P, SP_SLOTS, SB, BB, "standard"),
    }
    n_tour = len(tour_states)
    for i in TOUR_TIMED:
        seed, st = tour_states[i]
        calls[f"K4t launch {i % n_tour + 1}/{n_tour}"] = (
            lambda seed=seed, st=st: ce.run_perpetual_prng(
                seed, st, P, TOUR_LAUNCH, SB, BB, "tournament"))
    for key, rules in (("K3", "reference"), ("K3s", "standard"),
                       ("K3t", "tournament")):
        calls[key] = lambda rules=rules: ce.run_perpetual_det(
            det_in[rules], acts, cards, P, DET_STEPS, SB, BB, rules)
    with using(libs):  # the stages start from K3's mid-hand state
        stage_in = ce.run_perpetual_det(det_in["reference"], acts, cards, P,
                                        DET_STEPS, SB, BB)
    for stage in cs.STAGES:
        calls[f"stage {stage}"] = lambda stage=stage: cs.run_stage(
            stage, SEED, stage_in, P, STAGE_STEPS, SB, BB)
    calls.update({
        "K5": lambda: cn.run_net_det(st_net_det, stash, w_bot, P,
                                     NET_DET_STEPS, SB, BB, "standard"),
        "K5b": lambda: cn.run_net_det(st_net_det, stash, w_det_banks, P,
                                      NET_DET_STEPS, SB, BB, "standard",
                                      seat0),
        "K6": lambda: cn.run_net_eval(SEED, st_net0, w_es3, P, NET_LAUNCH,
                                      SB, BB, SS, "standard", 1),
        "B7": lambda: cn.run_net_league(SEED, st_league0, w7, P, NET_LAUNCH,
                                        SB, BB, SS, "standard", all_seats,
                                        parity),
        "B8": lambda: cn.run_net_eval_pop(TRAIN_SEED, pop0, w8, P,
                                          TRAIN_SLOTS, SB, BB, SS,
                                          "standard", 1),
        "B8l": lambda: cn.run_net_eval_pop(TRAIN_SEED, pop0, w8l, P,
                                           TRAIN_SLOTS, SB, BB, SS,
                                           "standard", all_seats, seat0),
        "probe": lambda: cn.net_probe(st_net0, probe_words, w_es3, P, BB,
                                      "standard"),
    })
    return calls


def timed(fn):
    """(output, ms) of one call of ``fn`` on the card (CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def ab(calls, libs, runs, log, compare=True):
    """Per call, the median ms on each library over ``runs`` alternating
    runs; the libraries' outputs must be equal (unless not ``compare``)."""
    result = {}
    names = list(libs)
    for key, fn in calls.items():
        ms = {name: [] for name in names}
        outs = {}
        for name in names:  # warm-up, and the output
            with using(libs[name]):
                outs[name] = fn()
        torch.cuda.synchronize()
        ref = outs[names[0]]
        for name in names[1:] if compare else ():
            if not torch.equal(outs[name], ref):
                raise RuntimeError(f"{key}: {name} differs from "
                                   f"{names[0]}")
        del outs, ref
        for r in range(runs):
            order = names if r % 2 == 0 else names[::-1]
            for name in order:
                with using(libs[name]):
                    ms[name].append(timed(fn)[1])
        result[key] = {name: float(np.median(v)) for name, v in ms.items()}
        log(json.dumps({"call": key, "median_ms": result[key],
                        "runs_ms": ms}))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="another commit's montecarlo_tpu_torch/csrc")
    ap.add_argument("--also", type=Path, action="append", default=[],
                    help="a further csrc/ tree, timed in the same turns")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--variants", default="",
                    help="comma-separated NAME=VALUE defines of csrc/")
    ap.add_argument("--time-only", action="store_true",
                    help="time the variants without comparing outputs")
    ap.add_argument("--calls", default="",
                    help="comma-separated calls to time (default: all)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    wanted = [c for c in args.calls.split(",") if c]
    equity_only = bool(wanted) and set(wanted) <= set(EQUITY_CALLS)
    dev = cuda_device()
    lines = []

    def log(line):
        print(line, flush=True)
        lines.append(line)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    variants = [v.split("=") for v in args.variants.split(",") if v]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        trees = {"parent": args.parent.resolve(), "this": _build.CSRC,
                 **{f"also:{d}": d.resolve() for d in args.also}}
        for name, value in variants:
            tree = tmp / f"src-{name}={value}"
            shutil.copytree(_build.CSRC, tree)
            define = re.compile(rf"^#define {name} \d+$", re.M)
            hits = 0
            for f in tree.iterdir():
                text, k = define.subn(f"#define {name} {value}",
                                      f.read_text())
                f.write_text(text)
                hits += k
            if hits != 1:
                raise RuntimeError(f"csrc/: {hits} definitions of {name}")
            trees[f"{name}={value}"] = tree
        libs = {}
        with ThreadPoolExecutor(len(trees)) as pool:
            builds = pool.map(
                lambda kv: build(kv[1], tmp / kv[0], equity_only),
                trees.items())
            for name, (lib, report, seconds) in zip(trees, builds):
                libs[name] = lib
                log(json.dumps({"build": name, "nvcc_s": seconds,
                                "ptxas": report}))
        calls = equity_calls(dev)
        if not equity_only:
            calls.update(inputs(dev, libs["this"]))
        if wanted:
            calls = {k: calls[k] for k in wanted}
        main_libs = {k: v for k, v in libs.items() if k in ("parent", "this")
                     or k.startswith("also:")}
        res = ab(calls, main_libs, args.runs, log)
        res_v = ab(calls, {k: v for k, v in libs.items()
                           if k == "this" or "=" in k},
                   args.runs, log, not args.time_only) if variants else {}
    summary = {"card": smi, "runs": args.runs, "median_ms": res,
               "variants_median_ms": res_v,
               "ratio_over_this": {
                   k: {name: ms / v["this"] for name, ms in v.items()}
                   for k, v in res.items()}}
    log(json.dumps(summary))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
