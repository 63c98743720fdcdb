"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase is caught):

0. setup: require CUDA, print the card's name and power limit, build the
   kernels from ``montecarlo_tpu_torch/csrc`` (nvcc, sm_90a: the library
   without a seat count and the 6-seat one, every nvcc started at once),
   and hold the card's Philox4x32-10 against the Random123 known-answer
   vectors;
1. main paths, each with every launch counter reset just before it and
   read just after; every kernel of a path must have launched:
   a. equity rollouts (K1, AKs vs QQ preflop and on a flop), the 169-hand
      sweep (K2), deterministic engine steps at full width (K3) and
      random-policy perpetual self-play (K4), 6-max, reference rules;
   b. the policy-net evaluation path: K3 and K4 under standard rules, the
      deterministic net kernel (K5, every seat a packed rule bot), and
      net evaluation at ``bench.py``'s shape (K6: standard rules, 6-max,
      ``data/policy_6max_es3.npz`` at seat 0, random policy elsewhere,
      2^18 tables x 512 slots in launches of 256);
   c. the ES training path (standard rules, 6-max): one generation at
      ``bench.py``'s training shape (B8: 32 candidates, es3 + 0.05 N(0, 1)
      per leaf, 2^14 tables x 256 slots in one launch, the net at seat 0),
      the same candidates' league fitness against es3 (B8 with two banks),
      a league evaluation at ``scripts/league_eval.py``'s width (B7: es3
      and policy_6max_200 at alternate seats, 2^16 tables x 256 slots) and
      the deterministic net kernel with two banks (K5: jam_tight at seat 0,
      fof_call elsewhere);
   d. tournaments and multiway equity: multiway equity (B3) of
      ``scripts/validate_tpu.py``'s AA/KK/76o preflop at K1's size and of
      three hands on a fixed flop at the flop's size; K3 under tournament
      rules on the main path's injected stream with 20-chip stacks, so that
      seats bust, the blinds skip them and tables freeze; and 2^20 6-max
      tournaments run to completion (K4 relaunched in launches of 1024
      slots, ``validate_tpu.py``'s);
2. results: equity within 4 sigma of exact enumeration, the sweep within
   5 sigma of ``data/sweep169.json``, reference self-play with no overflow
   and slots/hand within 2% of 33.1; standard self-play with no overflow
   and every table's chips conserved; net evaluation with no overflow and
   every table's seat deltas summing to 0, and the validate gate (the
   trained ``data/policy_6max_200.npz`` at seat 0 beats each of four
   untrained nets with separated 2-sigma intervals, and 0); on the ES path
   no overflow and zero-sum seat deltas on every candidate's tables, each
   of the 32 candidates' meters equal to a single launch's, two identical
   banks equal to the single net, bank routing (reference rules: a call
   bot beats a pot-raise bot at seat 0 and loses with the banks swapped),
   and two generations of ``train_es`` equal through the population and
   the per-candidate evaluators (a three-generation run is logged); the
   multiway shares summing to exactly lcm(1..N) x rollouts and each
   equity within 4 sigma of exact enumeration; tournament K3 with busted
   seats and frozen tables; every tournament complete, winner takes all,
   chips conserved, placements total, no overflow; and the tournament
   seat-0 edge (ROADMAP C-1): the completion run again with the first
   button written to 3, with two more seeds, and from a first deal taken
   from a uniform permutation per table with the JAX engine's position
   mapping, each seat's win share and its z against 1/6 logged, and a
   chi-squared test of ``first_deal``'s cards per seat and per position;
3. agreement, tolerance 0: every kernel call of phase 1 against its plain
   PyTorch version on the card, on the same inputs at the same size (the
   plain versions compute the kernels' Philox words, ``ops/philox.py``),
   timed once with CUDA events (the engine's and the net kernels' plain
   versions replay their step or iteration from a CUDA graph of one,
   ``cuda_engine.plain_loop``); K6 and B7 launch by launch; B8 on four of
   its 32 candidates (the rest equal single K6 launches, phase 2); the
   net's float path (features, logits, Gumbel scores) bit for bit through
   the probe kernel; tournament K3; the first and last K4 launches of the
   completion run, which is replayed launch by launch (every launch timed
   with CUDA events, beside the tables still live); B3's flop call, and
   B3 preflop on 2^26 rollouts; then K1 (preflop, flop and turn: each of
   its forms), K2, K4 and B3 (preflop and flop) on injected words (their
   ``words`` option), and K1's turn form in Philox mode; F1, the first
   state (``cuda_engine.first_state``), against ``pack_state(first_deal(
   ...))`` on the card under each rule set at 2^20 tables and under the
   standard and tournament rules at the league's 2^16 (from table 0 and
   5 x 1024), one launch a call;
4. timing: each main-path kernel call again on the card (CUDA events; K1's
   and B3's flop calls too), the card's SM clock, power draw and
   temperature sampled by ``nvidia-smi`` every 100 ms over each call,
   each K1, K2 and B3 (at N = 3; the range over the rest) instantiation's
   ptxas registers, stack and spills (the common library's ``build.log``;
   K2's beside its blocks an SM and a hand) and each K3/K4
   instantiation's (the P = 6 library's) beside its time, K3's warp
   schedule in plain PyTorch (``cuda_engine._run_det_warps``) on the first
   2^14 tables of each K3 call (equal to K3's output there; its passes and
   settle passes a warp beside the plain schedule's steps with a settle
   pass), the rollout
   loop of K1 preflop and of both K2 forms in the SASS (instructions by
   opcode), K2 timed once more before the sampler starts and the host's
   share of ``sweep169_seconds_warm``,
   those of each net kernel
   instantiation, and per net form (K5, K5b, K6, B7, B8, B8l, the probe)
   the shared bytes a block and the blocks an SM that
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports;
   ``net_eval_hands_per_sec`` and ``train_hands_per_sec`` from the
   functions ``bench.py``'s net axis calls (the ported
   ``bench_net_throughput``),
   ``multiway_rollouts_per_sec`` and ``tournaments_per_sec`` (port only);
5. the probes (path e, after the timing so that the main paths' numbers
   are taken as before): the ported ``scripts/exp_carry_model.py`` at its
   sizes (2^20 tables x 512 steps; every carry form at each R it is built
   for), the 256-step run of ``carry_array`` at R = 141 and the SASS of
   every carry kernel's step loop (the adds, loads and stores a folded
   loop would lose); the ported ``scripts/debug_kernel_compile.py``: each
   stage built by its own nvcc (one at a time, in the background from the
   end of phase 0), then 256 steps from the main path's K3 state (mid-hand,
   pots on the table) at the script's 32 blocks and at 1024 blocks; every
   probe launch held against its plain version (the stages' graph-replayed
   step by step), tolerance 0, and timed;
6. range equity and push/fold (path f, plain PyTorch on the card, no
   kernel of its own; after the probes so that the main paths' numbers
   are taken as before): ``equity_exact_range_vs_range`` of eight hero
   representatives (AA, 72o and 76s among them) against all 1326 combos
   over all C(52, 5) boards, its class-aggregated rows equal to
   ``data/pushfold_eq169_cr.npz``'s; ``matchup_equity_matrix_exact``'s
   AA and 72o rows over all C(48, 5) boards equal to
   ``data/pushfold_eq169_exact.npz``'s; ``matchup_equity_matrix`` at
   2^12 boards a matchup within 4 sigma of the exact matrix in aggregate;
   ``equity_vs_range`` (AKs vs QQ+KK, 2^26 rollouts) within 4 sigma of
   ``equity_exact_vs_range``, and ``sample_distinct`` equal on the card
   and on the CPU; ``solve_push_fold_cr`` on the committed matrix at
   10 bb, jam and call fractions equal to
   ``data/pushfold_ranges_cr.json``'s (0.5825 / 0.3738); and the
   evaluator on the card over all C(52, 7) hands: 4,892 packed and 4,892
   cmp keys, a strictly increasing bijection between them, and the
   (packed, cmp) table's FNV-1a digest that
   ``native/certify_evaluator.cpp`` recorded (fc0295d3f7577d5b).
7. the table engine (path g, plain PyTorch on the card, no kernel of its
   own; after path f so that every earlier number is taken as before):
   ``engine/state.init_state``'s Philox decks at 2^20 tables (each a
   permutation, the first 1,024 equal to the CPU's, a chi-squared test of
   card by deck position), then under reference, standard and tournament
   rules (phase 1d's 20-chip stacks) at 2^20 6-max tables: ``init_state``
   + ``redeal`` on phase 1's first deals equal to ``pack_state`` field by
   field, 64 steps of phase 1's injected stream through ``clamp_action``
   and ``step_table`` (``engine/replay.replay_injected``) equal to phase
   1's K3 output on every table within capacity, with equal overflow
   sets (``replay.against_k3``), and the engine's ns per table-step (CUDA
   events) beside K3's, its seconds and its peak memory;
8. self-play and evaluation (path h, plain PyTorch on the card, after
   path g; K4, K5 and K6 launch only as yardsticks): (h1) random-policy
   ``play_hands_perpetual`` at 2^20 6-max tables x 256 steps under
   reference rules at K4's capacities, the first 1,024 tables equal to a
   CPU run field by field, no overflow, and steps per hand (hands ending
   over the second half) within 2% of K4's (its DEFER = 1 form, where a
   slot is an action; the DEFER = 16 form's idle slots logged); (h2)
   ``play_hands`` of one hand at 2^20 standard-rules tables, chips
   conserved on every table, each position's bb/hand within 4 sigma of
   ``data/position_winrates.json``; (h3) ``play_tournament`` at 2^20
   tables with 20-chip stacks until every table freezes, the winner
   holding every chip, placements permutations, the win shares by seat
   against a K4 completion run at the same stacks (chi-squared, p >
   1e-4); (h4) ``replay_net_det`` on phase 1b/1c's K5 inputs (2^18 tables
   x 64 steps, one rule bot and two banks) equal to K5 and K5b on every
   table within capacity, the overflow sets equal; (h5) es3 through
   ``net_policy`` and ``pinned_seat_policies`` against the random policy,
   one-hand runs at each position weighed by K6's hands there, within 4
   sigma of K6's seat-0 meters; (h6) duplicate matches: the calling
   station against itself exactly 0 and against the half-folder above 0.1
   bb/hand at 2^20 tables, ``policy_hu_300`` against random over 6 hands
   at 2^18 tables with a 95% interval above 0, negated exactly by the
   swap. It logs each gate's numbers, each self-play form's time (CUDA
   events), each part's seconds and the peak memory;
9. training and exploitability (path i, after path h; the ported scripts
   of ``montecarlo_tpu_torch/scripts/``, K6, B7, B8 and B8 with two banks
   each launched, no other kernel): (i1) ``league_eval``'s self-check
   (identical banks on B7 equal K6) and es9 against es8, es7 and distill
   at 2^16 tables x 512 slots, each edge within 4 sigma of
   ``data/league_es9_vs_*.json`` (se 2 A_stderr), ``train_br.league_eval``
   of ``data/br_vs_es9.npz`` and ``eval_attacker`` of
   ``data/br_solver_vs_es7.npz`` within 4 sigma of their result files;
   (i2) ``exploit_probe`` on es9 (both geometries): the same best bot and
   its bound within 4 sigma of ``data/exploitability_es9.json`` (every
   bot's z logged), the recorded CMA attacker of
   ``data/exploitability_opt_es9.json`` within 4 sigma of its record, one
   ``optimize_pair`` at ``opt_bot``'s defaults (logged); (i3)
   ``train_es_kernel`` from ``policy_6max_200`` (pool random and
   jam_loose, the fold leash), the start's anchor score equal to the
   CPU's, the saved center equal to the returned one; (i4) REINFORCE
   (``models/train.train_policy``) against the calling station improving
   by 0.05 bb/hand, one update's loss and gradient equal on the card and
   the CPU within 1e-5, ``train_br`` at its shape with no overflow; (i5)
   ``policy_diff`` at the records' 128 tables x 512 steps: the fold-gate
   statistics of its es9 self-play (``fold_gate_check``'s run) and the
   es9/es8 argmax disagreement within 4 sigma of
   ``data/fold_gate_es9.json`` and ``data/diff_es9_es8.json`` (sigma from
   batch means over 16 groups of tables, the record's scaled to its own
   decision count), ``fold_gate_check`` at 16 tables x 64 steps and
   ``make_fold_anchor`` at 64 steps logged (the latter beside
   ``data/fold_anchor.npz.json``);
10. the solvers (path j, after path i; plain PyTorch, TF32 checked off, no
   kernel may launch): (j1) ``river_gap`` at ``data/river_gap.json``'s
   6000 iterations over all 1081 combos of both boards, (j2) ``turn_gap``
   at ``data/turn_gap.json``'s 4000 iterations over 1128 combos x 48
   rivers, both with the records' subjects but ``untrained``: solver gap
   <= 0.0001 bb, Nash EV P1 within 0.0005 bb, each subject's gap and best
   responses within 0.0002 bb and its head-to-heads against Nash within
   0.001 bb, of JAX's CPU value (``tests/rehearse_solver_records.json``)
   and of the record where JAX reproduces it (other rows logged with
   their distance), each run twice: the subjects' strategies extracted in
   exact float32 (``matmul="f32"``) and as the TPU that scored the
   records computed them (``"tpu_bf16"``, ``policy_net.policy_logits``'
   bfloat16 inputs), each against the rehearsal's values of its own mode;
   a record value is held wherever the rehearsal reproduces it in that
   mode (the river and turn records in ``tpu_bf16``, the stride-4 rows in
   ``f32``), and the counts held in each mode are logged; (j3)
   ``data/policy_6max_distill.npz``'s and es7's gaps at stride 4 and the
   exact BR edge against es9 at stride 1 against their records (f32), the
   distillation record's ``gap_bb_start`` against es7 softened as
   ``train_es_kernel --soften 20`` softens it (``policy_net.softened``) in
   both modes, held in the mode that reproduces it; (j4) a
   fresh ``distill_nash --mode nash`` from es7 (1500 iterations, 2000
   of the record's 6000 steps, stride 4) lowering both boards' gap by 0.3
   bb, and ``--mode br`` against es9 (1000 of its 3000 steps) raising
   both edges. It logs each solve's
   and subject's seconds, a CFR+ iteration's ms (CUDA events) and the
   peak memory;
11. the server (path k, after path j; only K1 may launch, and must): (k1)
   the port's TCP server in-process on an ephemeral port, torch rooms on
   the card: a reference and a standard room driven over real sockets by
   a fixed script of calls, raises and folds, every client's transcript
   equal to the same script's with the rooms on the CPU (Philox decks are
   the same on both), and a tournament room jammed until it freezes with
   the winner holding every chip (transcripts equal too); (k2) a 6-max
   room with five house bots on ``data/policy_6max_es2.npz``: play
   returns to the human at each of 60 actions and hands complete; how
   many of the first 200 bot decisions differ from the CPU's is logged;
   (k3) ``TorchBackend.act`` on the card and on the CPU and
   ``NativeBackend.act``, median and p99 over 200 actions; (k4) the
   ported ``bench_server`` at 16 rooms x 3 players, torch rooms on the
   card and native, beside ``data/server_load_jax.json`` (a TPU round's
   host, not compared); (k5) ``ci_width_at_wallclock`` for AKs vs QQ at
   1 s on K1 (launched, the equity within 4 sigma of exact, the width
   logged) and a ``device_trace`` of five actions (its size logged);
   (k6) 2^16 standard tables saved after 16 steps and loaded, 32 more
   steps equal to the uninterrupted run (file size and seconds logged);
12. scale-out (path l, after path k; only K1, K2, K3, K4 and K5 may
   launch, each at least once): (l1) a world of one over NCCL that
   ``parallel/mesh.make_mesh`` starts in this process: the plain sharded
   rollouts on the card equal to the same through a gloo group on the CPU
   (AKs vs QQ at 2^20 near 0.460, AA > KQs > 72o), ``sharded_equity_pallas``
   at 2^30 equal to the single K1 call, the plain engine's shards
   (2^14 tables, 16 steps; 2^12 heads-up tournaments at 20-chip stacks)
   equal to the unsharded calls, ``sharded_selfplay_kernel`` at 2^20 x
   512 equal to ``selfplay_perpetual_kernel``'s launch, K3 and K5 (banked)
   sharded equal to phase 1's outputs, a data-parallel REINFORCE step
   at 256 tables equal to the update written without collectives, and
   ``solve_turn_river(mesh=)`` at ``turn_gap``'s width (1128 combos x 48
   rivers, 300 iterations, eager) equal to the CUDA-graph solve, each
   form's ms an iteration logged; (l2) K1 (2^30), K4 (2^20 x 512) and
   the dp step on a gloo world of two ranks on this card: the reduced
   counts equal to the sum of each rank's single call, the parameters
   equal on both ranks and, at 128 tables a rank, to W = 1 on 256 within
   1e-6; (l3) the
   ported ``run_configs`` at its full sizes (config 5 on K2), its lines
   printed. It logs the NCCL start's seconds, each part's and the peak
   memory.
13. the layers street form (path m, after path l; only K3 may launch, once
   under reference and once under standard rules): the plain engine's
   default ``bets_impl="layers"`` (every earlier path passes
   ``"levels"``). (m1) the ported ``exp_levels_ab`` at 2^20 6-max tables
   x 128 steps of ``play_hands_perpetual`` in each form (L = 8, PL = 16,
   reference rules), a warm-up and one timed run (CUDA events): overflow
   0, equal hand counts, the layers run's final state equal to the
   levels run's under ``bets_as_layers`` field by field; (m2) the layers
   engine on phase 1's injected stream (2^20 x 64) against K3 relaunched
   under reference and standard rules (equal to phase 1's K3): the first
   state equal to ``pack_state``'s, every compared field equal on every
   table within capacity, the overflow sets equal; (m3) zero-chip blinds
   (0/10 and 0/0, reference rules, which the levels form refuses) at 2^20
   tables x 64 steps, the first 1,024 tables equal to the same run on the
   CPU, zero-amount pot layers present; (m4) 2^16 layers-form tables
   saved mid-hand: the file says "layers", the loaded batch is equal and
   16 more steps equal the uninterrupted run. It logs each form's ns per
   table-step, each part's seconds and the peak memory.
14. the measurement entry points (path n, after path m): (n1) the ported
   ``bench.py`` (``python -m montecarlo_tpu_torch.scripts.bench``) at its
   full sizes, its one line logged: exactly the root ``bench.py``'s keys
   (read from its source), none null, the betting axis on K4, and K1,
   K2, K4, K6 and B8 each launched and nothing else; (n2) the K4 split
   (B-4, ``scripts/exp_step_split``: ``full``, ``stub_settle``,
   ``stub_eval``, ``stub_deal``, ``stub_policy``, ``stub_street`` and the
   controls ``settle_copy`` and ``street_copy``) and the K6 split (B-5,
   ``scripts/exp_net_split``: ``full``, ``stub_gumbel``,
   ``stub_feat_eval``, ``stub_features``, ``stub_net`` and the control
   ``feat_copy``), each variant built by its own nvcc in the background
   from the end of phase 0: every variant equal bit for bit to its plain
   version at one block x 64 slots from phase 1's mid-hand K3 output,
   ``full`` and the controls equal to K4's / K6's output on the same
   inputs (each stub's differing words logged); then every variant timed
   at its script's sizes (2^20 x 512 reference tables; 2^16 x 256
   standard tables, ``policy_6max_200`` at seat 0; a warm-up and the best
   of 3, CUDA events) with the counters reset just before and read just
   after, logged as ns per table-step with each stub's saving against
   its baseline (``full``, or the control that runs the same copy); then
   every timed output equal bit for bit to its plain version on the same
   inputs, ``full``'s and the controls' to one K4 / K6 launch, and its
   row in the ``kernels`` line (error and plain ms from that check).
15. the last ported scripts (path o, after path n): (o1) K1's variants
   (B-6, ``scripts/bench_kernel_variants``: ``current``, ``ms16``,
   ``ms16_packed``, ``old_packed``, ``ms16_noeval``, ``old_sampler``,
   ``two_noreject``, ``fallback_word``, ``ref_eval``,
   ``old_sampler_ref_eval``, ``no_eval``, ``one_eval``), each built by its
   own nvcc in the background from the end of phase 0, each equal to its
   plain version on 2^16 injected words (2% in the top range) and at 2^20
   Philox rollouts; then the script at its 2^29 rollouts and two launch
   shapes beside K1's 256x16 (a warm-up and the best of 3, CUDA events),
   the counters reset just before and read just after: the classes that
   compute the same function count alike, every exact-class variant
   within 4 sigma of the exact AKs vs QQ equity, and its row in the
   ``kernels`` line; (o2) ``exp_net_grid`` at its sizes (K6 and K4, both
   rule sets, 2^16-2^20 tables x 512 slots); (o3) ``bench_step_parts``
   (every kind and ablation) and ``exp_hands_levers`` on the plain engine
   at cut sizes, no kernel launched, no table overflowed; (o4)
   ``check_pop_kernel`` (B8's candidates equal single K6 launches, state
   and meters), ``check_league_routing`` (the bank routing by its margin)
   and ``eval_net_kernel`` (trained above untrained by 2 sigma each); (o5)
   ``validate_tpu`` in a process of its own, exit 0.

Each phase's host seconds are logged, and the run's total before the
result lines. The second-to-last line is ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import datetime
from concurrent.futures import ThreadPoolExecutor
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
K3_SCHEDULE_TABLES = 1 << 14  # phase 4: K3's schedule counted
SP_SLOTS = 512
# The net-evaluation path (bench.py's _run_net_axis): tables, slots, slots
# per launch; K5's tables, steps and deal-stash rows; the validate gate's
# tables and slots (scripts/validate_tpu.py).
T_NET = 1 << 18
NET_SLOTS = 512
NET_LAUNCH = 256
NET_DET_STEPS = 64
NET_HMAX = 16
VAL_TABLES = 1 << 14
VAL_SLOTS = 256
UNTRAINED_DRAWS = 4
# The ES training path (bench.py's _run_net_axis and
# scripts/bench_net_throughput.py:bench_es_generation): candidates (16
# antithetic pairs), their noise, tables, slots and seed of a generation,
# and the candidates held against the plain version; the league evaluation
# (scripts/league_eval.py's 2^16 tables; its 512 slots cut to one launch
# of 256 to keep the run's plain checks short); the tables and slots of
# the checks (scripts/validate_tpu.py:check_net_kernels) and their seed.
TRAIN_POP = 32
TRAIN_SIGMA = 0.05
T_TRAIN = 1 << 14
TRAIN_SLOTS = 256
TRAIN_SEED = 13
PLAIN_CANDIDATES = (0, 11, 22, 31)
T_LEAGUE = 1 << 16
LEAGUE_SLOTS = 256
T_CHECK = 4096
CHECK_SLOTS = 256
CHECK_SEED = 314
# Path d: tournaments (K3's 20-chip stacks; the completion run's launch
# length, scripts/validate_tpu.py:210) and multiway equity (the preflop
# rollouts held against the plain version; the TPU-era agreement bound of
# the XLA path, validate_tpu.py:501, logged as history).
TOUR_STACK = 20
TOUR_LAUNCH = 1024
N_MW_PLAIN = 1 << 26
TPU_MW_BOUND = 0.004
# Path e: the stage probe's steps and its small size
# (scripts/debug_kernel_compile.py's 256 steps and 32 blocks).
STAGE_STEPS = 256
STAGE_BLOCKS = 32
# Path f: the hero classes of the card-removal rows (AA, 72o, the suited
# connector 76s and five more), the rows of the exact matrix, the boards a
# matchup of the Monte Carlo matrix, the rollouts of equity_vs_range (AKs
# against QQ+KK) and of the sample_distinct comparison; the 10 bb
# equilibrium; and the evaluator certificate (native/certify_evaluator.cpp,
# recorded in the TPU rounds' PERF.md).
PF_CR_HEROES = ("AA", "72o", "76s", "KK", "AKs", "AKo", "T9s", "22")
PF_EXACT_HEROES = ("AA", "72o")
PF_MC_BOARDS = 1 << 12
N_RANGE = 1 << 26
N_DISTINCT = 1 << 20
PF_STACK_BB = 10
EVAL_HANDS = 133_784_560
EVAL_KEYS = 4892
EVAL_DIGEST = "fc0295d3f7577d5b"
# Path g: the tables whose decks are held against the CPU's, and the gate
# of the decks' chi-squared test (two-sided p).
DECK_CPU_TABLES = 1024
DECK_P = 1e-4
# Path h: the perpetual self-play's steps (K4's 512 slots cut to 256 to
# keep the path near 200 s), the tournaments' hand bound (every table
# freezes well before it at 20-chip stacks), the hands of the multi-hand
# duplicate match (tests/test_selfplay.py's 12) and the gate of the win
# shares' two-sample chi-squared test.
H_STEPS = 256
H_TOUR_HANDS = 200
H_DUP_HANDS = 12
H_P = 1e-4
# Path i: the gate against the recorded results, in sigma; the ES
# generations (train_es_kernel's 120 cut to 40 to keep the path near
# 150 s); REINFORCE's updates and tables (the JAX slow test's 60 at
# train_policy.py's 4096 tables) and train_br's updates (2 of its 300: a
# host-bound loop of ~2 s an update whose gates, no overflow and finite
# rewards, do not depend on its depth); the groups of tables whose batch
# means give the decision-point statistics' sigma.
I_SIGMA = 4.0
I_ES_GENERATIONS = 40
I_RL_UPDATES = 60
I_RL_TABLES = 4096
I_BR_UPDATES = 2
I_GROUPS = 16
# i5's cut: fold_gate_check's tables and steps and make_fold_anchor's steps
# (both logged, not gated; the records' 128 x 512 and 192 x 512).
I5_CUT = (16, 64)
# Path k: the server. The script of k1's reference and standard rooms (the
# head's amounts, 3 seats); the tournament room's blinds and jam bound; the
# human actions of k2's bot room and the bot decisions compared between
# the card and the CPU; k3's timed actions; k4's bench_server size (socket
# and direct actions a room, torch chosen to keep k4 near 30 s at ~20 ms
# an action); k5's budget and the exact AKs vs QQ equity; k6's tables and
# steps before the save and after the load.
K_SCRIPT = [0, 20, 0, 0, -1, 0, 30, 0, 0, 0, 0, 500, 0, -1, 0, 10, 0, 0,
            0, 0, 0, -1, 40, 0, 0, 0, 0, 0, 15, 0, -1, 0, 0, 0, 60, 0, 0,
            0, 0, -1]
K_TOUR_BLINDS = {"small": 25, "big": 50}
K_TOUR_ACTIONS = 200
K_BOT_ACTIONS = 60
K_BOT_COMPARED = 200
K_TIMED_ACTIONS = 200
K_BENCH_ROOMS = 16
K_BENCH_PLAYERS = 3
K_BENCH_TORCH = (64, 200)     # socket actions a room, direct actions
K_BENCH_NATIVE = (200, 2000)
# Path j4: the fresh distillations' Adam steps (host-bound, ~6 ms a step):
# Nash from es7 at the record's 1500 iterations and a third of its 6000
# steps, BR against es9 at a third of distill_nash's 3000 (the losses
# flatten by step 2000; the gates ask the gap down by 0.3 bb and the edge
# up, which the full runs passed by 1.0-1.8 bb and 0.11-0.63 bb, the Nash
# run at 2000 steps by 0.58 bb and the BR run at 1500 by 0.11 bb)
J4_NASH_STEPS = 2000
J4_BR_STEPS = 1000
# Path j3: the distillation record's start, es7 with w3 and b3 divided by
# 20 (the {"softened": 20.0} that heads logs/distill_nash.log)
J3_SOFTEN = 20.0
K_CI_SECONDS = 1.0
K_EXACT_AKS_QQ = 0.458708
K_CKPT_TABLES = 1 << 16
K_CKPT_STEPS = (16, 32)       # before the save, after the load
# path l: the plain rows' rollouts (row 2 at one batch a chunk of 2^18,
# row 3 three heroes) and engine shards (cut: 2^14 tables x 16 steps,
# 2^12 heads-up tournaments at 20-chip stacks x 4 hands), the dp step's
# tables (l1 on one rank; l2 half of them a rank, against l1's run), seeds
# (one step: both ranks' and W = 1's parameters after it are compared)
# and tolerance (W ranks against W = 1: the float32 sums' order), the
# turn solve's iterations (a multiple of the chunk)
L_EQ_N, L_EQ_BATCH = 1 << 20, 1 << 18
L_SWEEP_N, L_SWEEP_BATCH = 1 << 16, 1 << 14
L_PLAIN_TABLES, L_PLAIN_STEPS = 1 << 14, 16
L_TOUR_TABLES, L_TOUR_HANDS = 1 << 12, 4
L_DP_TABLES, L_DP_SEEDS, L_DP_TOL = 256, (1,), 1e-6
L_TURN_ITERATIONS = 300
# Path m (the layers street form): the A/B's runs after its warm-up (the
# JAX script's best of 3 cut to 1 to pay for path o: its gates, equal
# hands and final states, do not read the time; its 2^20 tables x 128
# steps uncut), the
# rule sets of the K3 comparison, the zero-chip blinds and their run (2^20
# tables x 64 steps, the first DECK_CPU_TABLES against the CPU), the
# checkpoint's tables and its steps before the save and after the load
M_AB_RUNS = 1
M_K3_RULES = ("reference", "standard")
M_ZERO_BLINDS = ((0, 10), (0, 0))
M_ZERO_TABLES, M_ZERO_STEPS = 1 << 20, 64
M_CKPT_TABLES, M_CKPT_STEPS = 1 << 16, (16, 16)
# Path n (the measurement entry points): the split variants' check against
# their plain versions (one block x N_CHECK_STEPS slots; the timing runs
# the scripts' sizes), the K6 split's seat mask (the script's), and the
# background builds of the split variants (one nvcc each, N_BUILDERS at a
# time beside the stage probe's)
N_CHECK_STEPS = 64
N_NET_SEATS = 1
N_BUILDERS = 3
# Path o (the last ported scripts): B-6's check against the plain versions
# (injected words with 2% in the top range, and Philox rollouts at K1's
# 256x16 launch, ~5 trips of the grid-stride loop a thread; the timing
# runs bench_kernel_variants at its --n 2^29, each output then held
# against a launch at 256 threads x O_RESHAPE_WAVES, ~165 x 16 trips a
# thread, and current's against K1), the two launch shapes timed beside
# K1's 256x16, and the cuts of the plain engine's
# ablations: bench_step_parts at 2^18 tables x 8 steps (its 2^20 x 64
# cut, host-bound at ~30-50 ns a table-step: 12 kinds x 4 runs would take
# minutes) and exp_hands_levers at 2^18 tables x 8 steps (its 2^20 x
# 128), each a warm-up and one timed run (the scripts' best of 3); the
# other scripts run at their own sizes.
O_INJECT = 1 << 16
O_PHILOX = 1 << 24
O_RESHAPE_WAVES = 1
O_TILES = "512x16,256x64"
O_STEP_PARTS = (1 << 18, 8)
O_LEVERS = (1 << 18, 8)
O_RUNS = 1
O_VALIDATE_TIMEOUT = 600


# Rollouts per chunk of a plain version on the card.
PLAIN_CHUNK = 1 << 24
# Lower counts of the operations a kernel's work needs, for bound_ms,
# counted in the device code (csrc/). Integer operations: one
# Philox4x32-10 block (10 rounds of 2 wide multiplies, 2 three-way XORs, 2
# key additions), one 7-card hand key (evaluator.cuh: multiplicity masks,
# two run scans, the flush mask, the chosen payload), one betting step
# (engine.cuh:mc_step_nosettle: head scan, clamp, street algebra,
# membership), the 24 features of a decision, one random-policy decision
# (mc_policy: the head scan over 6 seats, the amount owed, the draw's
# compares), one 17-card deal past its Philox words (mc_sample_cards: a
# modulo per card and 3 operations per earlier card, 17 + 3 * 136). Float
# operations: the MLP's products and sums, each rounded once. Where a
# kernel's steps depend on the data, a hand counts one betting step (every
# hand has at least one). The carry probe: one add per word-step.
OPS = {"philox_block": 60, "hand_key": 60, "step": 100, "features": 100,
       "mlp_f32": 2 * (24 * 64 + 64 * 64 + 64 * 4), "policy": 50,
       "deal": 425}
# H100 SXM rates: HBM 3.35 TB/s; float32 67 TFLOP/s counts an FMA as two
# operations, so one rounded multiply or add per lane and clock is 33.5
# T/s. Integer operations issue to the INT32 lanes (64 an SM) and to the
# FP32 lanes (IMAD, and Hopper's VIADD), so their peak is also one a lane
# and clock, 33.5 T/s: the carry probe's adds run at 31 T/s (PERF.md, PR
# 6), above the INT32 lanes' 16.75.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
INT_OPS_PER_S = 33.5e12
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


def fnv1a_digest(table) -> str:
    """FNV-1a over the little-endian bytes of the words packed << 32 |
    cmp of a (packed, cmp) key table in packed order
    (``native/certify_evaluator.cpp``)."""
    digest = 1469598103934665603
    for packed, cmp in table:
        word = (int(packed) << 32) | int(cmp)
        for i in range(8):
            digest ^= (word >> (8 * i)) & 0xFF
            digest = (digest * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return f"{digest:016x}"


def chi2_sf(x, k):
    """P(X > x) for X chi-squared with ``k`` degrees of freedom (exact:
    the series for even and for odd ``k``)."""
    h = x / 2
    if k % 2 == 0:
        return math.exp(-h) * sum(h ** i / math.factorial(i)
                                  for i in range(k // 2))
    return math.erfc(math.sqrt(h)) + math.exp(-h) * sum(
        h ** (i - 0.5) / math.gamma(i + 0.5) for i in range(1, (k + 1) // 2))


def bound(n_bytes, int_ops, f32_ops=0):
    """(ms, what bounds it): the least time the card could take for this
    work, bytes at the memory rate or operations at their peak rate."""
    t = {"bytes": n_bytes / HBM_BYTES_PER_S,
         "operations": max(int_ops / INT_OPS_PER_S, f32_ops / F32_OPS_PER_S)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def pop_first_states(counts):
    """Takes F1's launches (``first_state_<rules>``) out of ``counts``:
    every path that builds a first state on the card launches it. Returns
    {rules: launches}."""
    return {k[len("first_state_"):]: counts.pop(k) for k in list(counts)
            if k.startswith("first_state_")}


def path_k(dev, smi):
    """Path k (phase 11): the port's server on the card. Returns (the
    results, each part's seconds, K1's launches in the path)."""
    import asyncio

    import torch

    from montecarlo_tpu_torch import native
    from montecarlo_tpu_torch.engine import state as tstate
    from montecarlo_tpu_torch.engine import step as tstep
    from montecarlo_tpu_torch.ops import cuda_carry as cc
    from montecarlo_tpu_torch.ops import cuda_engine as ce
    from montecarlo_tpu_torch.ops import cuda_equity as cq
    from montecarlo_tpu_torch.ops import cuda_net as cn
    from montecarlo_tpu_torch.ops import cuda_stages as cs
    from montecarlo_tpu_torch.ops import philox
    from montecarlo_tpu_torch.rollout import equity as teq
    from montecarlo_tpu_torch.scripts import bench_server as sbs
    from montecarlo_tpu_torch.server import backends as sb
    from montecarlo_tpu_torch.server.host import Registry
    from montecarlo_tpu_torch.server.tcp import start_server
    from montecarlo_tpu_torch.utils import checkpoint as uck
    from montecarlo_tpu_torch.utils import profiling as upr

    cpu = torch.device("cpu")
    mods = (cq, ce, cn, cc, cs, philox)
    for mod in mods:
        mod.reset_launches()
    k_s, kres, t_k = {}, {}, time.perf_counter()

    def sync():
        torch.cuda.synchronize(dev)

    def done(name, t0):
        sync()
        k_s[name] = time.perf_counter() - t0

    class Counting(Registry):
        """A registry that counts the requests it handled and the messages
        it sent to a client, so ``drive`` knows when both ends are idle."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.handled = self.sent = 0

        def dispatch(self, pid, req):
            super().dispatch(pid, req)
            self.handled += 1

        def send(self, pid, msg):
            if pid in self.sinks:
                self.sent += 1
            super().send(pid, msg)

    async def drive(device, rules, amounts, n=3, blinds=None,
                    until_frozen=False):
        """One room of ``n`` clients over TCP: create, join, then each
        amount played by the room's head (an in-process read), each
        request sent once the server handled the last. Returns (every
        client's messages in order, the stacks by join order, the room's
        last info)."""
        reg = Counting(backend="torch", device=device)
        server, _ = await start_server(reg, host="127.0.0.1", port=0)
        port = server.sockets[0].getsockname()[1]
        conns = [await asyncio.open_connection("127.0.0.1", port)
                 for _ in range(n)]
        got = [[] for _ in range(n)]

        async def read(i):
            while True:
                line = await conns[i][0].readline()
                if not line:
                    return
                got[i].append(json.loads(line.decode()))

        readers = [asyncio.ensure_future(read(i)) for i in range(n)]

        async def send(i, obj):
            want = reg.handled + 1
            conns[i][1].write((json.dumps(obj) + "\r\n").encode())
            await conns[i][1].drain()
            while reg.handled < want:
                await asyncio.sleep(0)

        for i in range(n):
            await send(i, {"type": "whoami"})
        room = {"type": "new_room", "name": "k", "n": n, "rules": rules}
        if blinds:
            room["blinds"] = blinds
        await send(0, room)
        for i in range(n):
            await send(i, {"type": "join_room", "name": "k"})
        while sum(map(len, got)) < reg.sent:
            await asyncio.sleep(0.001)
        pids = [m[0] for m in got]
        for amt in amounts:
            head = reg.rooms["k"].head_pid()
            if head is None:
                check(until_frozen, f"path k1 {rules}: the room has a head")
                break
            await send(pids.index(head), {"type": "play", "name": "k",
                                          "amt": amt})
        while sum(map(len, got)) < reg.sent:
            await asyncio.sleep(0.001)
        info = reg.rooms["k"].engine.info()
        stacks = [reg.stacks[p] for p in pids]
        for r in readers:
            r.cancel()
        for _, w in conns:
            w.close()
        server.close()
        await server.wait_closed()
        return got, stacks, info

    # (k1) reference and standard rooms over TCP: the card's transcripts
    # equal the CPU's (Philox decks are the same on both), cards included
    t0 = time.perf_counter()
    kres["k1"] = {}
    for rules in ("reference", "standard"):
        t1 = time.perf_counter()
        card = asyncio.run(drive(dev, rules, K_SCRIPT))
        card_s = time.perf_counter() - t1
        host = asyncio.run(drive(cpu, rules, K_SCRIPT))
        n_msgs = sum(map(len, card[0]))
        check(card == host, f"path k1 {rules}: the card's transcripts "
              f"equal the CPU's ({n_msgs} messages)")
        check(card[2]["hand_idx"] >= 2, f"path k1 {rules}: the script "
              f"crossed hands ({card[2]})")
        kres["k1"][rules] = {"messages": n_msgs, "actions": len(K_SCRIPT),
                             "info": card[2], "stacks": card[1],
                             "card_seconds": card_s}
        log(f"path k1 {rules}: {len(K_SCRIPT)} actions over TCP, {n_msgs} "
            f"messages, transcripts equal to the CPU's; {card[2]}, "
            f"{card_s:.2f} s on the card")
    card = asyncio.run(drive(dev, "tournament", [500] * K_TOUR_ACTIONS,
                             blinds=K_TOUR_BLINDS, until_frozen=True))
    host = asyncio.run(drive(cpu, "tournament", [500] * K_TOUR_ACTIONS,
                             blinds=K_TOUR_BLINDS, until_frozen=True))
    check(card == host, "path k1 tournament: the card's transcripts equal "
          "the CPU's")
    check(sorted(card[1]) == [0, 0, 300], f"path k1 tournament: the "
          f"winner holds every chip ({card[1]})")
    kres["k1"]["tournament"] = {"stacks": card[1], "info": card[2]}
    log(f"path k1 tournament: jams until frozen, stacks {card[1]}, "
        f"{card[2]}")
    done("k1", t0)

    # (k2) a 6-max room with five house bots on the default artifact
    t0 = time.perf_counter()

    def bot_room(device):
        reg = Registry(backend="torch", device=device)
        inbox = []
        pid = reg.add_player(inbox.append)
        reg.dispatch(pid, {"type": "new_room", "name": "b", "n": 6,
                           "bots": 5})
        check(inbox[-1] == {"status": 0, "msg": "OK"},
              f"path k2: the bot room opens ({inbox[-1]})")
        room = reg.rooms["b"]
        reg.dispatch(pid, {"type": "join_room", "name": "b"})
        check(room.started, "path k2: the room starts")
        decisions = []
        act = room.engine.bot_action

        def recording(fn, key):
            decisions.append(act(fn, key))
            return decisions[-1]

        room.engine.bot_action = recording
        for k in range(K_BOT_ACTIONS):
            check(room.head_pid() == pid, f"path k2: play returns to the "
                  f"human (action {k})")
            reg.dispatch(pid, {"type": "play", "name": "b", "amt": 0})
        return room.engine.info(), decisions, room

    t1 = time.perf_counter()
    info, dec_card, room = bot_room(dev)
    bot_s = time.perf_counter() - t1
    check(room.engine.device.type == "cuda", "path k2: the room runs on "
          "the card")
    check(info["hand_idx"] >= 2, f"path k2: hands complete ({info})")
    _, dec_cpu, _ = bot_room(cpu)
    k = min(K_BOT_COMPARED, len(dec_card), len(dec_cpu))
    differ = sum(a != b for a, b in zip(dec_card[:k], dec_cpu[:k]))
    first = next((i for i in range(k) if dec_card[i] != dec_cpu[i]), None)
    kres["k2"] = {"human_actions": K_BOT_ACTIONS, "info": info,
                  "bot_decisions": len(dec_card), "compared": k,
                  "differ": differ, "first_difference": first,
                  "card_seconds": bot_s}
    log(f"path k2: {K_BOT_ACTIONS} human actions against five es2 bots, "
        f"{len(dec_card)} bot decisions, {info}, {bot_s:.2f} s; of the "
        f"first {k} bot decisions {differ} differ between the card and "
        f"the CPU (first at {first})")
    done("k2", t0)

    # (k3) one action's time: TorchBackend on the card and on the CPU,
    # NativeBackend (3 seats, reference rules, every action a call)
    t0 = time.perf_counter()
    kres["k3"] = {}

    def timed_acts(engine, device):
        engine.act(0)  # warm
        lat = []
        for _ in range(K_TIMED_ACTIONS):
            t1 = time.perf_counter()
            engine.act(0)
            if device is not None and device.type == "cuda":
                sync()
            lat.append(time.perf_counter() - t1)
        lat.sort()
        return {"p50_ms": lat[len(lat) // 2] * 1e3,
                "p99_ms": lat[int(0.99 * len(lat))] * 1e3,
                "mean_ms": sum(lat) / len(lat) * 1e3}

    for name, engine, device in (
            ("torch_card", sb.TorchBackend(3, 5, 10, 0, [100] * 3,
                                           device=dev), dev),
            ("torch_cpu", sb.TorchBackend(3, 5, 10, 0, [100] * 3,
                                          device=cpu), cpu),
            ("native", sb.NativeBackend(3, 5, 10, 0, [100] * 3), None)):
        kres["k3"][name] = timed_acts(engine, device)
        log(f"path k3 {name}: act p50 {kres['k3'][name]['p50_ms']:.4f} ms, "
            f"p99 {kres['k3'][name]['p99_ms']:.4f} ms over "
            f"{K_TIMED_ACTIONS} actions ({smi})")
    done("k3", t0)

    # (k4) the ported bench_server: 16 rooms x 3 players over TCP
    t0 = time.perf_counter()
    k_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_k_"))
    atexit.register(shutil.rmtree, k_dir, True)
    kres["k4"] = {}
    for backend, (m, direct) in (("torch", K_BENCH_TORCH),
                                 ("native", K_BENCH_NATIVE)):
        kres["k4"][backend] = sbs.main([
            "--backend", backend, "--device", "cuda", "--rooms",
            str(K_BENCH_ROOMS), "--players", str(K_BENCH_PLAYERS),
            "--actions", str(m), "--direct-actions", str(direct),
            "--save", str(k_dir / "server_load.json")])
    with open(ROOT / "data" / "server_load_jax.json") as f:
        kres["k4"]["jax_record_tpu_round_host"] = json.load(f)["jax"]
    log(f"path k4: {json.dumps(kres['k4'])} (the JAX record is a TPU "
        f"round's host CPU, not compared; {smi})")
    done("k4", t0)

    # (k5) the equity CI95 width at 1 s on K1, and a profiler trace
    t0 = time.perf_counter()
    aks = [teq.make_card(0, 14), teq.make_card(0, 13)]
    qq = [teq.make_card(1, 12), teq.make_card(2, 12)]
    res, elapsed = upr.ci_width_at_wallclock(SEED, aks, qq, K_CI_SECONDS,
                                             device=dev)
    z = (res.equity - K_EXACT_AKS_QQ) / res.stderr
    lo, hi = res.ci95
    k1_launches = cq.LAUNCHES["equity"]
    check(k1_launches > 0, "path k5: K1 launched")
    check(abs(z) <= 4, f"path k5: equity {res.equity:.7f} within 4 sigma "
          f"of exact {K_EXACT_AKS_QQ} (z {z:+.2f})")
    kres["k5"] = {"rollouts": res.n, "elapsed": elapsed,
                  "equity": res.equity, "z": z, "ci95_width": hi - lo,
                  "k1_launches": k1_launches}
    log(f"path k5: CI95 width {hi - lo:.3e} at {elapsed:.3f} s "
        f"({res.n} rollouts, {k1_launches} K1 launches), equity "
        f"{res.equity:.7f}, z {z:+.2f} ({smi})")
    engine = sb.TorchBackend(3, 5, 10, 1, [100] * 3, device=dev)
    engine.act(0)
    with upr.device_trace(str(k_dir / "trace"), device=dev):
        t1 = time.perf_counter()
        for _ in range(5):
            engine.act(0)
        sync()
        traced_s = time.perf_counter() - t1
    trace = k_dir / "trace" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kinds = {}
    for e in events:
        kinds[e.get("cat", "")] = kinds.get(e.get("cat", ""), 0) + 1
    kernel_us = sum(e.get("dur", 0) for e in events
                    if e.get("cat") == "kernel")
    kres["k5"].update({"trace_bytes": trace.stat().st_size,
                       "trace_events": kinds, "kernel_us": kernel_us,
                       "traced_s": traced_s})
    log(f"path k5: device_trace over 5 actions: {trace.stat().st_size} "
        f"bytes, events by category {kinds}; kernels {kernel_us:.1f} us "
        f"of {traced_s * 1e6:.1f} us (traced, host clock)")
    done("k5", t0)

    # (k6) a checkpoint round trip at 2^16 tables on the card
    t0 = time.perf_counter()
    cfg6 = tstate.TableConfig(num_seats=6, rules="standard",
                              bets_impl="levels")
    gen = torch.Generator().manual_seed(SEED)
    n_steps = sum(K_CKPT_STEPS)
    u = torch.rand((n_steps, K_CKPT_TABLES), generator=gen)
    raises = torch.randint(1, 60, (n_steps, K_CKPT_TABLES), generator=gen)
    acts = torch.where(u < 0.2, -1, torch.where(u < 0.8, 0, raises)) \
        .to(torch.int32).to(dev)

    def steps(st, rows):
        for a in rows:
            st = tstep.step_table(st, tstep.clamp_action(st, a),
                                  rules=cfg6.rules)
        return st

    st = steps(tstate.init_state(SEED, cfg6, K_CKPT_TABLES, dev),
               acts[:K_CKPT_STEPS[0]])
    path = str(k_dir / "tables.npz")
    t1 = time.perf_counter()
    uck.save_states(path, st)
    save_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    back = uck.load_states(path, device=dev)
    load_s = time.perf_counter() - t1
    a = steps(st, acts[K_CKPT_STEPS[0]:])
    b = steps(back, acts[K_CKPT_STEPS[0]:])
    same = all(torch.equal(x, y) for x, y in zip(
        tstate._tree_map(lambda v: v, a), tstate._tree_map(lambda v: v, b))
        for x, y in (zip(x, y) if isinstance(x, tuple) else [(x, y)]))
    check(same, "path k6: the resumed batch equals the uninterrupted run")
    hands = int(a.hand_idx.sum())
    kres["k6"] = {"tables": K_CKPT_TABLES, "steps": list(K_CKPT_STEPS),
                  "file_bytes": os.path.getsize(path), "save_s": save_s,
                  "load_s": load_s, "hands_after": hands}
    log(f"path k6: {K_CKPT_TABLES} tables, save after {K_CKPT_STEPS[0]} "
        f"steps ({os.path.getsize(path)} bytes, {save_s:.2f} s), load "
        f"{load_s:.2f} s, {K_CKPT_STEPS[1]} more steps equal the "
        f"uninterrupted run ({hands} hands dealt in all)")
    done("k6", t0)

    kres["auto"] = type(sb.make_backend("auto", 3, 5, 10, 0, [100] * 3,
                                        device=dev)).__name__
    kres["native_available"] = native.available()
    log(f"path k: backend 'auto' chooses {kres['auto']}")
    others = {k: v for mod in mods for k, v in mod.LAUNCHES.items()
              if v and k != "equity"}
    check(not others, f"path k launches no kernel but K1 ({others})")
    k_s["path"] = time.perf_counter() - t_k
    return kres, k_s, k1_launches


def _dp_steps(mesh, params, tables):
    """``parallel/train_dp.make_dp_train_step`` on ``mesh`` (heads-up,
    standard rules, the JAX defaults) at the seeds ``L_DP_SEEDS`` in turn,
    from ``params`` (numpy leaves): each step's parameters (numpy) and
    mean reward."""
    from montecarlo_tpu_torch.engine.state import TableConfig
    from montecarlo_tpu_torch.models.policy_net import params_from_numpy
    from montecarlo_tpu_torch.parallel.train_dp import make_dp_train_step

    opt_init, step = make_dp_train_step(
        mesh, TableConfig(num_seats=2, rules="standard", bets_impl="levels"),
        tables_per_device=tables)
    p = params_from_numpy(params)
    opt, out = opt_init(p), []
    for seed in L_DP_SEEDS:
        p, opt, mean_r = step(p, opt, seed)
        out.append(([x.cpu().numpy() for x in p], mean_r))
    return out


def _l2_rank(mesh, n_k1, k4_tables, k4_slots, dp_tables, params):
    """Path l2 on one rank of a gloo world on one card: K1 and K4 sharded,
    each beside this rank's single call at its own seed, and two
    data-parallel REINFORCE steps. Returns what the parent compares."""
    import torch

    from montecarlo_tpu_torch.engine.state import TableConfig
    from montecarlo_tpu_torch.ops import cuda_engine as ce
    from montecarlo_tpu_torch.ops import cuda_equity as cq
    from montecarlo_tpu_torch.parallel import mesh as pm
    from montecarlo_tpu_torch.rollout.equity import make_card

    started = time.time()
    r, dev = mesh.rank, mesh.device
    aks = [make_card(0, 14), make_card(0, 13)]
    qq = [make_card(1, 12), make_card(2, 12)]
    out = {"rank": r, "size": mesh.size, "backend": mesh.backend,
           "device": str(dev)}
    k1 = pm.sharded_equity_pallas(mesh, SEED, aks, qq, n_k1)
    dead, hm, vm = cq._hand_masks(aks, qq, (), dev)
    single = cq.equity_counts((SEED + pm.K1_RANK_STRIDE * r) & 0xFFFFFFFF,
                              dead, hm, vm, n_k1 // mesh.size)
    out["k1"] = (tuple(k1), single.tolist())
    cfg = TableConfig(num_seats=6, bets_impl="levels")
    P, T = cfg.num_seats, k4_tables // mesh.size
    state, hands = pm.sharded_selfplay_kernel(
        mesh, SEED, cfg, T // ce.TABLES_PER_BLOCK, k4_slots)
    mine = ce.run_perpetual_prng(
        (SEED + pm.K4_RANK_STRIDE * r) & 0x7FFFFFFF,
        ce.pack_state(cfg, ce.first_deal(SEED, T, P, dev, r * T)), P,
        k4_slots, cfg.small_blind, cfg.big_blind)
    out["k4"] = (bool(torch.equal(state, mine)), hands,
                 int(ce.unpack_field(mine, cfg, "hand_ct").sum()))
    out["dp"] = _dp_steps(mesh, params, dp_tables)
    out["started"], out["work_s"] = started, time.time() - started
    return out


def path_l(dev, smi, phase1):
    """Path l (phase 12): the scale-out layer (``parallel/``), its sharded
    entries and ``solve_turn_river(mesh=)`` on a world of one over NCCL in
    this process (l1), K1, K4 and the data-parallel step on a gloo world
    of two ranks on this card (l2), and the ported ``run_configs`` at its
    full sizes (l3). ``phase1`` holds phase 1's K3 and K5b inputs and
    outputs. Returns (the results, each part's seconds, the launches in
    the path by kernel)."""
    import torch
    import torch.distributed as dist

    from montecarlo_tpu_torch.engine.state import TableConfig, init_state
    from montecarlo_tpu_torch.models import policy_net as tpn
    from montecarlo_tpu_torch.models import train as ttrain
    from montecarlo_tpu_torch.models import turn_solver as tts
    from montecarlo_tpu_torch.ops import cuda_carry as cc
    from montecarlo_tpu_torch.ops import cuda_engine as ce
    from montecarlo_tpu_torch.ops import cuda_equity as cq
    from montecarlo_tpu_torch.ops import cuda_net as cn
    from montecarlo_tpu_torch.ops import cuda_stages as cs
    from montecarlo_tpu_torch.ops import philox
    from montecarlo_tpu_torch.parallel import local
    from montecarlo_tpu_torch.parallel import mesh as pm
    from montecarlo_tpu_torch.parallel import train_dp
    from montecarlo_tpu_torch.rollout import equity as teq
    from montecarlo_tpu_torch.rollout import policy as tpol
    from montecarlo_tpu_torch.rollout import selfplay as tsp
    from montecarlo_tpu_torch.scripts import run_configs as src
    from montecarlo_tpu_torch.scripts import turn_gap as stg

    mods = (cq, ce, cn, cc, cs, philox)
    for mod in mods:
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    l_s, lres, t_l = {}, {}, time.perf_counter()
    cpu = torch.device("cpu")

    def sync():
        torch.cuda.synchronize(dev)

    def done(name, t0):
        sync()
        l_s[name] = time.perf_counter() - t0
        log(f"path {name}: {l_s[name]:.2f} s")

    def cuda_ms(fn):
        """(result, ms) of one run of ``fn`` (CUDA events)."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def equal_trees(a, b):
        if isinstance(a, tuple):
            return all(equal_trees(x, y) for x, y in zip(a, b))
        return bool(torch.equal(a, b))

    cfg = TableConfig(num_seats=6, bets_impl="levels")
    std = TableConfig(num_seats=6, rules="standard", bets_impl="levels")
    P, SB, BB = cfg.num_seats, cfg.small_blind, cfg.big_blind
    AKS = [teq.make_card(0, 14), teq.make_card(0, 13)]
    QQ = [teq.make_card(1, 12), teq.make_card(2, 12)]
    HEROES = [[teq.make_card(0, 14), teq.make_card(1, 14)],
              [teq.make_card(0, 13), teq.make_card(0, 12)],
              [teq.make_card(0, 7), teq.make_card(1, 2)]]

    # (l1) a world of one over NCCL in this process: make_mesh starts it
    # (the machine has no network: NCCL's bootstrap listens on loopback)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    check(not dist.is_initialized(), "path l1: no process group before")
    t0 = time.perf_counter()
    mesh = pm.make_mesh(dev)
    pm.all_reduce(mesh, torch.zeros(1, device=dev))  # the communicator
    done("l1 init", t0)
    check((mesh.rank, mesh.size, mesh.backend) == (0, 1, "nccl"),
          f"path l1: a world of one over NCCL ({mesh[1:]})")
    # the plain rollouts on the card against the same on the CPU, through
    # a gloo group of the same world
    host = pm.Mesh(dist.new_group(backend="gloo"), 0, 1, cpu, "gloo")
    t0 = time.perf_counter()
    r_card = pm.sharded_equity_vs_hand(mesh, SEED, AKS, QQ, L_EQ_N,
                                       L_EQ_BATCH)
    r_cpu = pm.sharded_equity_vs_hand(host, SEED, AKS, QQ, L_EQ_N,
                                      L_EQ_BATCH)
    check(r_card == r_cpu and abs(r_card.equity - 0.460) < 0.008,
          f"path l1 row 2: card {r_card} == CPU {r_cpu}, near 0.460")
    s_card = pm.equity_sweep(mesh, SEED, HEROES, L_SWEEP_N, L_SWEEP_BATCH)
    s_cpu = pm.equity_sweep(host, SEED, HEROES, L_SWEEP_N, L_SWEEP_BATCH)
    check(s_card[1] == s_cpu[1] and np.array_equal(s_card[0], s_cpu[0])
          and s_card[0][0] > s_card[0][1] > s_card[0][2],
          f"path l1 row 3: card {s_card} == CPU {s_cpu}, AA > KQs > 72o")
    lres["rows_2_3"] = {"equity": r_card.equity, "n": r_card.n,
                        "sweep": s_card[0].tolist(), "sweep_n": s_card[1]}
    done("l1 rows 2-3", t0)

    # row 4: K1 at 2^30 on one rank is the single K1 call
    t0 = time.perf_counter()
    k1 = pm.sharded_equity_pallas(mesh, SEED, AKS, QQ, N_EQUITY)
    w, t, n = cq.equity_vs_hand_kernel(SEED, AKS, QQ, N_EQUITY, device=dev)
    check((k1.wins, k1.ties, k1.n) == (w, t, n),
          f"path l1 row 4: sharded K1 {k1} == the single call")
    lres["row_4"] = {"equity": k1.equity, "n": k1.n}
    done("l1 row 4", t0)

    # row 5: the plain engine's sharded entries (cut: 2^14 tables,
    # L_PLAIN_STEPS steps; 2^12 heads-up tournaments at 20-chip stacks,
    # L_TOUR_HANDS hands)
    t0 = time.perf_counter()
    T5 = L_PLAIN_TABLES
    a = pm.sharded_selfplay(mesh, SEED, cfg, T5)
    check(equal_trees(a, tsp.play_hands(SEED, cfg, T5, device=dev))
          and bool(a.hand_over.all()),
          "path l1 row 5: sharded_selfplay == play_hands")
    a, hands = pm.sharded_selfplay_perpetual(mesh, SEED, cfg, T5,
                                             L_PLAIN_STEPS)
    b, b_hands = tsp.play_hands_perpetual(SEED, cfg, T5, L_PLAIN_STEPS,
                                          device=dev)
    check(equal_trees(a, b) and hands == int(b_hands) > 0,
          "path l1 row 5: sharded_selfplay_perpetual == the unsharded call")
    tour = TableConfig(num_seats=2, rules="tournament",
                       starting_stack=TOUR_STACK, bets_impl="levels")
    a = pm.sharded_tournaments(mesh, SEED, tour, L_TOUR_TABLES,
                               L_TOUR_HANDS)
    b = tsp.play_tournament(SEED, tour, L_TOUR_TABLES, L_TOUR_HANDS,
                            device=dev)
    check(equal_trees(a[0], b[0]) and torch.equal(a[1], b[1])
          and torch.equal(a[2], b[2])
          and bool((a[2].sum(1) == 2 * TOUR_STACK).all()),
          "path l1 row 5: sharded_tournaments == play_tournament, chips "
          "conserved")
    lres["row_5"] = {"perpetual_hands": hands,
                     "tournaments_done": float((a[2] > 0).sum(1).eq(1)
                                               .float().mean())}
    done("l1 row 5", t0)

    # rows 6-8: K4 at 2^20 x 512, K3 and K5b on phase 1's inputs
    t0 = time.perf_counter()
    k4, k4_hands = pm.sharded_selfplay_kernel(
        mesh, SEED, cfg, T_FULL // ce.TABLES_PER_BLOCK, SP_SLOTS)
    want, want_hands, _ = ce.selfplay_perpetual_kernel(
        SEED, cfg, T_FULL, SP_SLOTS, steps_per_launch=SP_SLOTS, device=dev)
    check(torch.equal(k4, want) and k4_hands == want_hands,
          "path l1 row 6: sharded K4 == selfplay_perpetual_kernel's launch")
    del k4, want
    k3, k3_hands = pm.sharded_selfplay_kernel_det(
        mesh, cfg, phase1["st_full"], phase1["acts_full"],
        phase1["cards_full"], DET_STEPS)
    check(torch.equal(k3, phase1["det_out"])
          and k3_hands == int(ce.unpack_field(k3, cfg, "hand_ct").sum()),
          "path l1 row 7: sharded K3 == phase 1's K3 output")
    k5, k5_hands = pm.sharded_net_kernel_det(
        mesh, std, phase1["st_net_det"], phase1["stash_net"],
        phase1["w_det_banks"], NET_DET_STEPS, (0,) + (1,) * (P - 1))
    check(torch.equal(k5, phase1["k5b_out"]),
          "path l1 row 8: sharded K5 (banked) == phase 1's K5b output")
    lres["rows_6_8"] = {"k4_hands": k4_hands, "k3_hands": k3_hands,
                        "k5_hands": k5_hands}
    del k3, k5
    done("l1 rows 6-8", t0)

    # row 9: data-parallel steps at 256 tables against the same update
    # written without collectives
    t0 = time.perf_counter()
    params = [x.numpy() for x in
              tpn.init_params(torch.Generator().manual_seed(SEED))]
    dp1 = _dp_steps(mesh, params, L_DP_TABLES)
    hu = TableConfig(num_seats=2, rules="standard", bets_impl="levels")
    leaves = [torch.tensor(x, device=dev).requires_grad_(True)
              for x in params]
    opt = torch.optim.Adam(leaves, lr=3e-3)
    row9 = []
    for seed, (got, mean_r) in zip(L_DP_SEEDS, dp1):
        st = init_state(seed, hu, L_DP_TABLES, dev)
        pos = (torch.arange(L_DP_TABLES, device=dev) % 2).to(torch.int32)
        rewards, rec, _ = ttrain._play_hand_collect(
            tpn.MLPParams(*leaves), st,
            tpol.policy_key(seed, L_DP_TABLES, ttrain.SUB_TRAIN, dev), pos,
            tpol.random_policy, 48, hu.rules)
        r = rewards / hu.big_blind
        loss = train_dp.dp_loss(
            ttrain.log_prob_sums(tpn.MLPParams(*leaves), rec, L_DP_TABLES),
            r, r.mean(), ((r - r.mean()) ** 2).mean())
        opt.zero_grad()
        loss.backward()
        opt.step()
        diff = max(float(np.abs(x - y.detach().cpu().numpy()).max())
                   for x, y in zip(got, leaves))
        row9.append({"mean_r": mean_r, "max_abs_diff": diff})
        check(diff <= L_DP_TOL and abs(mean_r - float(r.mean())) <= L_DP_TOL,
              f"path l1 row 9: the dp step at seed {seed} == the update "
              f"without collectives ({diff})")
    lres["row_9"] = row9
    done("l1 row 9", t0)

    # row 10: the turn solver at turn_gap's width (1128 combos x 48
    # rivers), 300 iterations: eager over the mesh == the CUDA-graph solve
    check(not torch.backends.cuda.matmul.allow_tf32,
          "path l1 row 10: TF32 is off")
    t0 = time.perf_counter()
    tgame = stg.artifact_game(stg.BOARDS["Ks8h5d2c"], 1, dev)[0]
    sharded, mesh_ms = cuda_ms(lambda: tts.solve_turn_river(
        tgame, L_TURN_ITERATIONS, mesh=mesh))
    single, graph_ms = cuda_ms(lambda: tts.solve_turn_river(
        tgame, L_TURN_ITERATIONS))
    check(equal_trees(tuple(sharded), tuple(single)),
          "path l1 row 10: the mesh solve == the single solve")
    lres["row_10"] = {"mesh_ms_per_iteration": mesh_ms / L_TURN_ITERATIONS,
                      "graph_ms_per_iteration": graph_ms / L_TURN_ITERATIONS,
                      "gap": tts.exploitability_gap(tgame, single),
                      "combos": int(tgame.mask0.shape[0]),
                      "rivers": int(tgame.keys.shape[0])}
    log(f"path l1 row 10: {lres['row_10']}")
    del tgame, sharded, single
    done("l1 row 10", t0)

    # (l2) K1, K4 and the dp step on a gloo world of two ranks on this
    # card, against each rank's single calls and W = 1 on 2T tables (row
    # 9's run)
    t0, t_spawn = time.perf_counter(), time.time()
    ranks = local.spawn(_l2_rank, 2, "gloo", dev, N_EQUITY, T_FULL,
                        SP_SLOTS, L_DP_TABLES // 2, params)
    # process start, imports and the gloo group's start, to the last rank
    ready_s = max(x["started"] for x in ranks) - t_spawn
    log(f"path l2: ranks ready (process start, imports, gloo init) in "
        f"{ready_s:.2f} s, their work {[round(x['work_s'], 2) for x in ranks]}"
        f" s")
    check([x["rank"] for x in ranks] == [0, 1]
          and all(x["backend"] == "gloo" for x in ranks),
          "path l2: two gloo ranks")
    counts = [x["k1"][1] for x in ranks]
    w, t = (sum(c[i] for c in counts) for i in range(2))
    check(all(x["k1"][0] == (w, t, N_EQUITY - w - t, N_EQUITY)
              for x in ranks),
          "path l2: sharded K1 == the sum of each rank's single call")
    check(all(x["k4"][0] for x in ranks)
          and all(x["k4"][1] == sum(y["k4"][2] for y in ranks)
                  for x in ranks),
          "path l2: each rank's K4 == its single launch, hands summed")
    l2_dp = []
    for step, one in enumerate(dp1):
        a, b = ranks[0]["dp"][step], ranks[1]["dp"][step]
        check(all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
              and a[1] == b[1], f"path l2: both ranks' step {step} equal")
        diff = max(float(np.abs(x - y).max()) for x, y in zip(a[0], one[0]))
        l2_dp.append({"mean_r": a[1], "w1_mean_r": one[1],
                      "max_abs_diff": diff})
        check(diff <= L_DP_TOL and abs(a[1] - one[1]) <= L_DP_TOL,
              f"path l2: dp step {step} on 2 x {L_DP_TABLES // 2} tables == "
              f"W = 1 on {L_DP_TABLES} within {L_DP_TOL} ({diff})")
    lres["l2"] = {"k1_equity": (w + 0.5 * t) / N_EQUITY,
                  "k4_hands": ranks[0]["k4"][1], "dp": l2_dp,
                  "ranks_ready_s": ready_s,
                  "rank_work_s": [x["work_s"] for x in ranks]}
    done("l2", t0)

    # (l3) the ported run_configs at its full sizes (config 5 on K2)
    t0 = time.perf_counter()
    rc = src.main([], device=dev)
    check(rc["config4"][0] == 1.0 and rc["config5"][1] == 10_000_000,
          "path l3: run_configs completes every table and sweeps 10^7")
    lres["l3"] = {"config3_equity": rc["config3"].equity,
                  "config4_stats": rc["config4"][1],
                  "config5_top": float(rc["config5"][0].max())}
    done("l3", t0)
    dist.destroy_process_group()

    counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}
    path_launches = {"K1": counts.pop("equity", 0),
                     "K2": counts.pop("sweep", 0),
                     "K3": counts.pop("engine_det_reference", 0),
                     "K4": counts.pop("engine_prng_reference", 0),
                     "K5b": counts.pop("net_det_banked_standard", 0)}
    f1 = pop_first_states(counts)
    log(f"path l: F1 launches {f1}")
    check(not counts, f"path l launches only K1-K5 and F1 ({counts})")
    check(all(path_launches.values()),
          f"path l launched K1, K2, K3, K4 and K5 ({path_launches})")
    lres["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    l_s["path"] = time.perf_counter() - t_l
    return lres, l_s, path_launches


def path_m(dev, smi, phase1):
    """Path m (phase 13): the plain engine's layers street form
    (``bets_impl="layers"``, the default; ``engine/bets.py``) on the card.
    (m1) the ported ``exp_levels_ab`` at full width, both forms; (m2) the
    layers engine on K3's injected stream against K3, relaunched once per
    rule set of ``M_K3_RULES``; (m3) zero-chip blinds under reference rules
    against the same run on the CPU; (m4) a layers-form checkpoint round
    trip. ``phase1`` holds phase 1's K3 inputs and outputs. Returns (the
    results, each part's seconds, the launches in the path by kernel)."""
    import torch

    from montecarlo_tpu_torch.engine import replay as erp
    from montecarlo_tpu_torch.engine import state as tstate
    from montecarlo_tpu_torch.engine import step as tstep
    from montecarlo_tpu_torch.engine.bets import Layers
    from montecarlo_tpu_torch.engine.state import TableConfig
    from montecarlo_tpu_torch.engine.street import Street, bets_as_layers
    from montecarlo_tpu_torch.ops import cuda_carry as cc
    from montecarlo_tpu_torch.ops import cuda_engine as ce
    from montecarlo_tpu_torch.ops import cuda_equity as cq
    from montecarlo_tpu_torch.ops import cuda_net as cn
    from montecarlo_tpu_torch.ops import cuda_stages as cs
    from montecarlo_tpu_torch.ops import philox
    from montecarlo_tpu_torch.rollout import selfplay as tsp
    from montecarlo_tpu_torch.scripts import exp_levels_ab as ela
    from montecarlo_tpu_torch.utils import checkpoint as uck

    mods = (cq, ce, cn, cc, cs, philox)
    for mod in mods:
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    m_s, mres, t_m = {}, {}, time.perf_counter()

    def done(name, t0):
        torch.cuda.synchronize(dev)
        m_s[name] = time.perf_counter() - t0
        log(f"path {name}: {m_s[name]:.2f} s")

    def equal_states(a, b, what, n=None):
        """Every field of two states equal (the first ``n`` tables of
        ``a`` against ``b`` on the CPU when ``n`` is given)."""
        for name, x, y in zip(tstate.TableState._fields, a, b):
            pairs = zip(x, y) if isinstance(x, tuple) else [(x, y)]
            for u, v in pairs:
                u = u if n is None else u[:n].cpu()
                check(u.dtype == v.dtype and torch.equal(u, v),
                      f"{what}: {name} equal")

    # (m1) the ported exp_levels_ab: both forms at 2^20 x 128, a warm-up
    # and the best of M_AB_RUNS (CUDA events); overflow 0 and equal hands
    # asserted there; the final states equal under bets_as_layers
    t0 = time.perf_counter()
    base = dict(num_seats=6, max_layers=8, max_pot_layers=16)
    ab = {impl: ela.run(impl, TableConfig(bets_impl=impl, **base), dev,
                        ela.N_TABLES, ela.N_STEPS, M_AB_RUNS)
          for impl in ("layers", "levels")}
    (ly_line, ly), (lv_line, lv) = ab["layers"], ab["levels"]
    check(isinstance(ly.bets, Layers) and isinstance(lv.bets, Street),
          "path m1: each run holds its street form")
    check(ly_line["hands"] == lv_line["hands"] > 0,
          f"path m1: equal hand counts ({ly_line['hands']}, "
          f"{lv_line['hands']})")
    equal_states(lv._replace(bets=bets_as_layers(lv.bets, lv.folded)), ly,
                 "path m1: the layers run's final state == the levels "
                 "run's under bets_as_layers")
    mres["m1"] = {"layers": ly_line, "levels": lv_line,
                  "layers_over_levels": ly_line["ns_per_table_step"]
                  / lv_line["ns_per_table_step"]}
    log(f"path m1: {ela.N_TABLES} tables x {ela.N_STEPS} steps, "
        f"{ly_line['hands']} hands in each form, overflow 0, final states "
        f"equal; ns per table-step layers "
        f"{ly_line['ns_per_table_step']:.3f}, levels "
        f"{lv_line['ns_per_table_step']:.3f} ({smi})")
    del ab, ly, lv
    done("m1", t0)

    # (m2) the layers engine on K3's injected stream, K3 relaunched
    t0 = time.perf_counter()
    acts_full, cards_full = phase1["acts_full"], phase1["cards_full"]
    n_steps, T = acts_full.shape[1], acts_full.shape[0] * 1024
    acts_rows = acts_full.permute(1, 0, 2, 3).reshape(n_steps, T)
    deals = ce._stash_rows(cards_full).permute(2, 0, 1).contiguous()
    P, cfg0 = 6, TableConfig(num_seats=6)
    mres["m2"] = {}
    for rules in M_K3_RULES:
        L = ce._L_for(rules)
        cfg = TableConfig(num_seats=P, rules=rules, max_layers=L,
                          max_pot_layers=4 * L)
        packed0, det0 = phase1[rules]
        det = ce.run_perpetual_det(packed0, acts_full, cards_full, P,
                                   n_steps, cfg0.small_blind,
                                   cfg0.big_blind, rules=rules)
        check(torch.equal(det, det0),
              f"path m2 {rules}: K3 relaunched == phase 1's K3")
        st0 = tstate.redeal(tstate.init_state(SEED, cfg, T, dev),
                            erp.decks_from_deals(deals[:, 0]))
        check(isinstance(st0.bets, Layers), f"path m2 {rules}: a Layers "
              f"street")
        bad = erp.against_pack_state(packed0, cfg, st0)
        check(not bad, f"path m2 {rules}: init_state + redeal equals "
                       f"pack_state (differs in {bad})")
        t1 = time.perf_counter()
        rep = erp.replay_injected(cfg, st0, acts_rows, deals)
        torch.cuda.synchronize(dev)
        replay_s = time.perf_counter() - t1
        agree = erp.against_k3(det, cfg, rep)
        check(torch.equal(agree.k3_overflow, rep.overflow),
              f"path m2 {rules}: the overflow sets are equal")
        clean = float((~agree.k3_overflow).float().mean())
        check(clean > 0.9, f"path m2 {rules}: over 90% of tables within "
                           f"capacity")
        for name, bad in agree.mismatch.items():
            check(not bool(bad.any()), f"path m2 {rules}: {name} equals "
                  f"K3's on every table within capacity")
        mres["m2"][rules] = {"tables": T, "steps": n_steps,
                             "hands": int(rep.hand_ct.sum()),
                             "overflowed": int(agree.k3_overflow.sum()),
                             "within_capacity": clean,
                             "replay_s": replay_s}
        log(f"path m2 {rules}: the layers engine equals K3 on the "
            f"{clean:.4%} of {T} tables within capacity over {n_steps} "
            f"steps, overflow sets equal ({int(agree.k3_overflow.sum())}), "
            f"{int(rep.hand_ct.sum())} hands; replay {replay_s:.2f} s")
        del det, st0, rep, agree
    del acts_rows, deals
    done("m2", t0)

    # (m3) zero-chip posts: reference rules, the levels form refuses them
    t0 = time.perf_counter()
    mres["m3"] = {}
    for sb, bb in M_ZERO_BLINDS:
        cfg = TableConfig(num_seats=6, small_blind=sb, big_blind=bb)
        card, hands = tsp.play_hands_perpetual(SEED, cfg, M_ZERO_TABLES,
                                               M_ZERO_STEPS, device=dev)
        cpu, cpu_hands = tsp.play_hands_perpetual(
            SEED, cfg, DECK_CPU_TABLES, M_ZERO_STEPS, device="cpu")
        equal_states(card, cpu, f"path m3 {sb}/{bb}: the first "
                     f"{DECK_CPU_TABLES} tables == the CPU run",
                     DECK_CPU_TABLES)
        live = torch.arange(card.pots.capacity, device=dev)[None] \
            < card.pots.count[:, None]
        zero_pots = int((live & (card.pots.amt == 0)).any(1).sum())
        check(int(hands) > 0 and zero_pots > 0,
              f"path m3 {sb}/{bb}: hands dealt, zero-amount pot layers")
        mres["m3"][f"{sb}/{bb}"] = {
            "tables": M_ZERO_TABLES, "steps": M_ZERO_STEPS,
            "hands": int(hands), "tables_with_zero_pot_layers": zero_pots,
            "overflow_frac": float((card.bets.overflow
                                    | card.pots.overflow).float().mean())}
        log(f"path m3 {sb}/{bb}: {M_ZERO_TABLES} tables x {M_ZERO_STEPS} "
            f"steps, {int(hands)} hands, {zero_pots} tables hold a "
            f"zero-amount pot layer; the first {DECK_CPU_TABLES} tables "
            f"equal the CPU run")
        del card, cpu
    try:
        tstate.init_state(SEED, TableConfig(num_seats=6, small_blind=0,
                                            bets_impl="levels"), 4, "cpu")
        refused = False
    except ValueError:
        refused = True
    check(refused, "path m3: the levels form refuses a zero blind")
    done("m3", t0)

    # (m4) a layers-form batch saved mid-hand, loaded, stepped on
    t0 = time.perf_counter()
    m_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_m_"))
    atexit.register(shutil.rmtree, m_dir, True)
    cfg = TableConfig(num_seats=6)
    gen = torch.Generator().manual_seed(SEED + 13)
    n = sum(M_CKPT_STEPS)
    u = torch.rand((n, M_CKPT_TABLES), generator=gen)
    raises = torch.randint(1, 60, (n, M_CKPT_TABLES), generator=gen)
    acts = torch.where(u < 0.2, -1, torch.where(u < 0.8, 0, raises)) \
        .to(torch.int32).to(dev)

    def steps(st, rows):
        for a in rows:
            st = tstep.step_table(st, tstep.clamp_action(st, a),
                                  rules=cfg.rules)
        return st

    st = steps(tstate.init_state(SEED, cfg, M_CKPT_TABLES, dev),
               acts[:M_CKPT_STEPS[0]])
    mid = int(((st.stage > 0) | (st.time > 0)).sum())
    check(isinstance(st.bets, Layers) and mid > 0,
          f"path m4: a layers batch mid-hand ({mid} tables)")
    path = str(m_dir / "layers.npz")
    uck.save_states(path, st)
    with np.load(path) as data:
        impl = str(data["bets_impl"])
    check(impl == "layers", f"path m4: the file says {impl!r}")
    back = uck.load_states(path, device=dev)
    equal_states(back, st, "path m4: the loaded batch == the saved one")
    equal_states(steps(back, acts[M_CKPT_STEPS[0]:]),
                 steps(st, acts[M_CKPT_STEPS[0]:]),
                 f"path m4: {M_CKPT_STEPS[1]} more steps == the "
                 f"uninterrupted run")
    mres["m4"] = {"tables": M_CKPT_TABLES, "steps": list(M_CKPT_STEPS),
                  "mid_hand": mid, "file_bytes": os.path.getsize(path)}
    log(f"path m4: {M_CKPT_TABLES} layers tables saved after "
        f"{M_CKPT_STEPS[0]} steps ({mid} mid-hand, "
        f"{os.path.getsize(path)} bytes, bets_impl {impl!r}), loaded "
        f"equal, {M_CKPT_STEPS[1]} more steps equal")
    done("m4", t0)

    counts = {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}
    path_launches = {"K3": counts.pop("engine_det_reference", 0),
                     "K3s": counts.pop("engine_det_standard", 0)}
    check(not counts, f"path m launches only K3 ({counts})")
    check(path_launches == {"K3": 1, "K3s": 1},
          f"path m launched K3 once per rule set ({path_launches})")
    mres["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    m_s["path"] = time.perf_counter() - t_m
    return mres, m_s, path_launches


def start_split_builds():
    """Each K4 and K6 split variant's nvcc and each of K1's variants' (B-6),
    in the background, N_BUILDERS at a time: (the pool, a future per
    (probe, variant)). Path n takes the splits' and path o K1's, and shuts
    the pool down."""
    from montecarlo_tpu_torch.ops import _build
    from montecarlo_tpu_torch.ops import cuda_k1_variants as kv
    from montecarlo_tpu_torch.ops import cuda_net_split as cns
    from montecarlo_tpu_torch.ops import cuda_split as csp

    from montecarlo_tpu_torch.scripts import bench_kernel_variants as bkv

    pool = ThreadPoolExecutor(N_BUILDERS)
    jobs = {(probe, v): pool.submit(_build.probe_library, probe, v, 6, True)
            for probe, mod in (("split", csp), ("net_split", cns), ("k1", kv))
            for v in mod.VARIANTS}
    jobs["k1 tiles", bkv.TILE_VARIANT] = pool.submit(
        _build.probe_library, "k1", bkv.TILE_VARIANT, 6, True, True)
    return pool, jobs


def path_n(dev, smi, phase1, split_builds):
    """Path n (phase 14): the measurement entry points. (n1) the ported
    ``bench.py`` (``montecarlo_tpu_torch/scripts/bench.py``) at its full
    sizes: one JSON line with exactly the root script's keys, none null,
    K1, K2, K4, K6 and B8 each launched; (n2) the K4 split (B-4,
    ``exp_step_split``) and the K6 split (B-5, ``exp_net_split``): each
    variant (built in the background from phase 0, ``split_builds``)
    equal bit for bit to its plain version on the card at one block x
    N_CHECK_STEPS slots, ``full`` and the controls equal to K4's / K6's
    output on the same inputs (``phase1``: phase 1's reference K3 and
    standard K3 outputs, mid-hand); then each timed at its script's sizes
    (2^20 x 512 and 2^16 x 256, a warm-up and the best of 3, CUDA events)
    with the counters reset just before and read just after, logged as ns
    per table-step beside each stub's saving against its baseline
    (``full``, or the control that runs the same copy); then each timed
    output held against its plain version on the same inputs and
    ``full``'s and the controls' against one K4 / K6 launch, the rows'
    error and plain ms taken from that check. Returns (the results, each
    part's seconds, the launches in n1 by kernel key, the split variants'
    rows of the ``kernels`` line)."""
    import torch

    from montecarlo_tpu_torch.engine.state import TableConfig
    from montecarlo_tpu_torch.models.policy_net import load_params
    from montecarlo_tpu_torch.ops import cuda_carry as cc
    from montecarlo_tpu_torch.ops import cuda_engine as ce
    from montecarlo_tpu_torch.ops import cuda_equity as cq
    from montecarlo_tpu_torch.ops import cuda_net as cn
    from montecarlo_tpu_torch.ops import cuda_net_split as cns
    from montecarlo_tpu_torch.ops import cuda_split as csp
    from montecarlo_tpu_torch.ops import cuda_stages as cs
    from montecarlo_tpu_torch.ops import philox
    from montecarlo_tpu_torch.scripts import bench as tbench
    from montecarlo_tpu_torch.scripts import exp_net_split as ens
    from montecarlo_tpu_torch.scripts import exp_step_split as ess

    mods = (cq, ce, cn, cc, cs, philox, csp, cns)

    def reset():
        for mod in mods:
            mod.reset_launches()

    def counts():
        return {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    n_s, nres, t_n = {}, {}, time.perf_counter()

    def done(name, t0):
        torch.cuda.synchronize(dev)
        n_s[name] = time.perf_counter() - t0
        log(f"path {name}: {n_s[name]:.2f} s")

    # (n1) the ported bench.py at its own sizes; its line goes to stdout
    t0 = time.perf_counter()
    reset()
    line = tbench.main([])
    n1 = counts()
    n1_launches = {"K1": n1.pop("equity", 0), "K2": n1.pop("sweep", 0),
                   "K4": n1.pop("engine_prng_reference", 0),
                   "K6": n1.pop("net_eval_standard", 0),
                   "B8": n1.pop("net_pop_standard", 0)}
    f1 = pop_first_states(n1)
    log(f"path n1: bench line {json.dumps(line)}; launches {n1_launches}, "
        f"F1 {f1}")
    keys = tbench.reference_keys(ROOT / "bench.py")
    check(set(line) == keys, f"path n1: the bench line has exactly "
          f"bench.py's keys (missing {keys - set(line)}, extra "
          f"{set(line) - keys})")
    check(all(v is not None for v in line.values()),
          "path n1: no key of the bench line is null")
    check(line["betting_backend"] == tbench.K4,
          "path n1: the betting axis ran K4")
    check(all(v > 0 for v in n1_launches.values()) and not n1
          and set(f1) == {"reference", "standard"},
          f"path n1: K1, K2, K4, K6 and B8 launched, their first states "
          f"from F1, nothing else ({n1_launches}, {f1}, {n1})")
    nres["n1"] = line
    done("n1", t0)

    # (n2) the splits: builds, checks at one block, timing at full size and
    # the check of the timed outputs
    t0 = time.perf_counter()
    _, jobs = split_builds
    builds = {key: job.result() for key, job in jobs.items()
              if key[0] != "k1"}
    for (probe, v), b in builds.items():
        log(f"{probe} {v}: nvcc {b.seconds:.2f} s (its own build), "
            f"ptxas {b.ptxas}")
    P, S = 6, N_CHECK_STEPS
    cfg = TableConfig(num_seats=P, bets_impl="levels")
    std = TableConfig(num_seats=P, rules="standard", bets_impl="levels")
    sb, bb, ss = cfg.small_blind, cfg.big_blind, cfg.starting_stack
    st_ref = phase1["det_out"][:1].clone()
    st_std = phase1["det_std"][:1].clone()
    T1 = ce.TABLES_PER_BLOCK
    w_net = cn.net_weights(load_params(ROOT / ens.ARTIFACT), dev)

    def split_plain(probe, v, state, seed, n_steps, decisions=None):
        """The plain version of split variant ``v`` on ``state`` with the
        kernel's Philox words: (its output, its ms). It is launch-bound
        (~1,000 small kernels a slot), so its iterations are replayed from
        a CUDA graph of one (``ce.plain_loop``). A control's plain version
        is ``full``'s (nothing stubbed)."""
        T = state.shape[0] * T1
        if probe == "split":
            return timed(lambda: csp._split_plain(
                v, state, lambda it: csp.split_words(
                    seed, T, v, P, n_steps, it, dev), P, n_steps, sb, bb))
        return timed(lambda: cns._split_plain(
            v, state, lambda it: cns.split_words(
                seed, T, v, P, n_steps, it, dev), w_net, P, n_steps, sb, bb,
            ss, N_NET_SEATS, True, decisions))

    def check_variants(where, probe, mod, state, seed, n_steps, whole,
                       kernel_out):
        """Each variant's kernel output ``kernel_out(v)`` (with its count
        of net decisions for K6) against its plain version on the same
        inputs, bit for bit, and ``full`` and the controls against
        ``whole`` (K4's / K6's output): (max abs error, plain ms) by
        variant."""
        res, plain = {}, {}
        for v in mod.VARIANTS:
            k, dk = kernel_out(v)
            dp = torch.zeros(1, dtype=torch.int64, device=dev)
            if v in mod.CONTROLS:
                p, p_ms = plain["full"]
            else:
                p, p_ms = split_plain(probe, v, state, seed, n_steps,
                                      dp if probe == "net_split" else None)
                plain[v] = (p, p_ms) if v == "full" else (None, p_ms)
                if probe == "net_split":
                    check(int(dk) == int(dp) > 0,
                          f"path n2 {where} {probe} {v}: the kernel counts "
                          f"the plain version's net decisions ({int(dk)}, "
                          f"{int(dp)})")
            e = float((k.double() - p.double()).abs().max())
            check(e == 0, f"path n2 {where} {probe} {v}: kernel equals its "
                  f"plain version")
            differ = int((k != whole).sum())
            check(v.startswith("stub_") or differ == 0,
                  f"path n2 {where} {probe} {v}: equal to "
                  f"{'K4' if probe == 'split' else 'K6'}'s output on the "
                  f"same inputs")
            log(f"path n2 {where} {probe} {v}: {differ} words of the state "
                f"differ from {'K4' if probe == 'split' else 'K6'}'s output; "
                f"plain {p_ms:.3f} ms"
                + (" (full's)" if v in mod.CONTROLS else ""))
            res[v] = (e, p_ms)
            del k, p
        return res

    def one_block(probe, mod, state, whole):
        def kernel_out(v):
            if probe == "split":
                return csp.run_split(v, SEED, state, P, S, sb, bb), None
            dk = torch.zeros(1, dtype=torch.int64, device=dev)
            return cns.run_net_split(v, SEED, state, w_net, P, S, sb, bb, ss,
                                     N_NET_SEATS, decisions=dk), dk
        return check_variants(f"one block x {S} slots", probe, mod, state,
                              SEED, S, whole, kernel_out)

    small = {"split": one_block(
        "split", csp, st_ref, ce.run_perpetual_prng(SEED, st_ref, P, S, sb,
                                                    bb)),
        "net_split": one_block(
        "net_split", cns, st_std, cn.run_net_eval(
            SEED, st_std, w_net, P, S, sb, bb, ss, "standard",
            N_NET_SEATS))}
    log(f"path n2: every split variant equals its plain version at one "
        f"block x {S} slots (plain ms {small})")
    done("n2 one-block checks", t0)

    # the scripts' main runs, the counters reset just before and read just
    # after
    t0 = time.perf_counter()
    reset()
    state4 = ess.build_state(cfg, dev)
    res4 = {v: ess.measure(cfg, state4, v) for v in csp.VARIANTS}
    state6 = ce.first_state(0, std, ens.N_TABLES, dev)
    res6 = {v: ens.measure(std, state6, w_net, v) for v in cns.VARIANTS}
    n2 = counts()
    f1 = pop_first_states(n2)
    launches = {f"split_{v}": n2.pop(f"split_{v}", 0) for v in csp.VARIANTS}
    launches.update({f"net_split_{v}": n2.pop(f"net_split_{v}", 0)
                     for v in cns.VARIANTS})
    check(all(x > 0 for x in launches.values()) and not n2
          and f1 == {"reference": 1, "standard": 1},
          f"path n2: every split variant launched, F1 once for each first "
          f"state, nothing else ({launches}, {f1}, {n2})")
    for name, probe, res, mod in (("K4 split", "split", res4, csp),
                                  ("K6 split", "net_split", res6, cns)):
        for v, r in res.items():
            base = mod.BASELINES.get(v, "full")
            b_ns = res[base]["ns_per_table_step"]
            log(f"path n2 {name} {v}: {r['ns_per_table_step']:.4f} ns a "
                f"table-step ({r['ms']:.3f} ms, {r['hands']} hands), saving "
                f"against {base} {b_ns - r['ns_per_table_step']:+.4f} ns "
                f"({1 - r['ns_per_table_step'] / b_ns:+.2%}); "
                f"ptxas {builds[(probe, v)].ptxas}")
    done("n2 timing", t0)

    # the timed outputs (the scripts' sizes and seeds) against their plain
    # versions on the same inputs, and full's against one K4 / K6 launch
    t0 = time.perf_counter()
    full = {
        "split": check_variants(
            "timed", "split", csp, state4, ess.SEED, ess.N_STEPS,
            ce.run_perpetual_prng(ess.SEED, state4, P, ess.N_STEPS, sb, bb),
            lambda v: (res4[v].pop("out"), None)),
        "net_split": check_variants(
            "timed", "net_split", cns, state6, ens.SEED, ens.N_STEPS,
            cn.run_net_eval(ens.SEED, state6, w_net, P, ens.N_STEPS, sb, bb,
                            ss, "standard", N_NET_SEATS),
            lambda v: (res6[v].pop("out"), torch.tensor(
                [res6[v]["net_decisions"]], device=dev)))}
    log(f"path n2: every timed split output equals its plain version on "
        f"the same inputs (plain ms {full})")
    nres["n2"] = {"k4": res4, "k6": res6, "plain_one_block": small,
                  "plain_timed": full}
    done("n2 timed checks", t0)

    # the kernels line's rows: bound from the work of the run, as the rows
    # of K4 and K6 count it (a hand one betting step and P hand keys, the
    # Philox blocks of the words drawn, a net decision its features and
    # the MLP's float operations), less what each stub removes
    rows = []
    for probe, res, state, mod, src, where in (
            ("split", res4, state4, csp, "probe_split.cu",
             "scripts/exp_step_split.py:51"),
            ("net_split", res6, state6, cns, "probe_net.cu",
             "scripts/exp_net_split.py:56")):
        T = state.shape[0] * ce.TABLES_PER_BLOCK
        n_steps = res["full"]["steps"]
        for v, r in res.items():
            key = f"{probe}_{v}"
            n_it, W, _ = mod.split_words_shape(v, 1, P, n_steps)
            hands = r["hands"]
            ops = hands * OPS["step"] \
                + T * -(-n_it * W // 4) * OPS["philox_block"]
            f32 = 0
            if v not in ("stub_settle", "stub_eval"):
                ops += hands * P * OPS["hand_key"]
            n_bytes = 2 * state.numel() * 4
            if probe == "net_split":
                dec = r["net_decisions"]
                n_bytes += cn.NUM_WEIGHTS * 4
                if v not in ("stub_features", "stub_net"):
                    ops += dec * OPS["features"]
                if v != "stub_net":
                    f32 = dec * OPS["mlp_f32"]
            b_ms, b_by = bound(n_bytes, ops, f32)
            label = "B-4 K4 split" if probe == "split" else "B-5 K6 split"
            rows.append({
                "name": f"{label} {v} ({T} tables x {n_steps} slots)",
                "route": "cuda", "source": "montecarlo_tpu_torch/csrc/" + src,
                "replaces": where, "launches": launches[key],
                "max_abs_err": full[probe][v][0], "ms": r["ms"],
                "plain_ms": full[probe][v][1], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None,
                "work": T * n_steps, "unit": "table-slots",
                "plain_work": T * n_steps})
    log(json.dumps({"path_n_kernels": rows, "card": smi}))
    del state4, state6
    n_s["path"] = time.perf_counter() - t_n
    return nres, n_s, n1_launches, rows


def path_o(dev, smi, split_builds, exact_equity):
    """Path o (phase 15): the last ported scripts. (o1) K1's variants
    (B-6, ``scripts/bench_kernel_variants``): each build (from phase 0,
    ``split_builds``) equal to its plain version on O_INJECT injected words
    (2% in the top range) and at O_PHILOX Philox rollouts at K1's launch
    shape (more than 4 trips of the grid-stride loop a thread); then the
    script at its full --n 2^29 and at the tiles O_TILES beside K1's, the
    counters reset just before and read just after: every run of a variant
    alike, the equal-count classes equal, ``current`` equal to one K1
    launch, each variant's timed counts equal to its launch at 256 threads
    x O_RESHAPE_WAVES (another thread for each rollout), every exact-class
    variant within 4 sigma of ``exact_equity``; (o2)
    ``exp_net_grid`` at its sizes; (o3) ``bench_step_parts`` and
    ``exp_hands_levers`` at their cuts (O_STEP_PARTS, O_LEVERS; no kernel,
    no overflow at the 6-layer caps); (o4) ``check_pop_kernel`` (exact),
    ``check_league_routing`` (its margin) and ``eval_net_kernel`` (the
    trained net above the untrained one by 2 sigma each); (o5)
    ``validate_tpu`` in a process of its own, exit 0. Returns (the
    results, each part's seconds, the launches by kernel key of o1's
    timed runs, B-6's rows of the ``kernels`` line)."""
    import torch

    from montecarlo_tpu_torch.ops import cuda_carry as cc
    from montecarlo_tpu_torch.ops import cuda_engine as ce
    from montecarlo_tpu_torch.ops import cuda_equity as cq
    from montecarlo_tpu_torch.ops import cuda_k1_variants as kv
    from montecarlo_tpu_torch.ops import cuda_net as cn
    from montecarlo_tpu_torch.ops import cuda_net_split as cns
    from montecarlo_tpu_torch.ops import cuda_split as csp
    from montecarlo_tpu_torch.ops import cuda_stages as cs
    from montecarlo_tpu_torch.ops import philox
    from montecarlo_tpu_torch.rollout import equity as teq
    from montecarlo_tpu_torch.scripts import bench_kernel_variants as bkv
    from montecarlo_tpu_torch.scripts import bench_step_parts as bsp
    from montecarlo_tpu_torch.scripts import check_league_routing as clr
    from montecarlo_tpu_torch.scripts import check_pop_kernel as cpk
    from montecarlo_tpu_torch.scripts import eval_net_kernel as enk
    from montecarlo_tpu_torch.scripts import exp_hands_levers as ehl
    from montecarlo_tpu_torch.scripts import exp_net_grid as eng

    mods = (cq, ce, cn, cc, cs, philox, csp, cns, kv)

    def reset():
        for mod in mods:
            mod.reset_launches()

    def counts():
        return {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}

    def timed(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    o_s, ores, t_o = {}, {}, time.perf_counter()

    def done(name, t0):
        torch.cuda.synchronize(dev)
        o_s[name] = time.perf_counter() - t0
        log(f"path {name}: {o_s[name]:.2f} s")

    # (o1) B-6: the builds, each variant against its plain version
    t0 = time.perf_counter()
    pool, jobs = split_builds
    builds = {v: jobs["k1", v].result() for v in kv.VARIANTS}
    tiles_build = jobs["k1 tiles", bkv.TILE_VARIANT].result()
    pool.shutdown()
    for v, b in builds.items():
        log(f"k1 {v}: nvcc {b.seconds:.2f} s (its own build), ptxas "
            f"{b.ptxas}")
    log(f"k1 {bkv.TILE_VARIANT} tile build: nvcc {tiles_build.seconds:.2f} "
        f"s, ptxas at 256 threads {tiles_build.ptxas}")
    aks = [teq.make_card(0, 14), teq.make_card(0, 13)]
    qq = [teq.make_card(1, 12), teq.make_card(2, 12)]
    dead, hm, vm = cq._hand_masks(aks, qq, (), dev)
    args = (dead.tolist(), hm.tolist(), vm.tolist())
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    check_err, check_ms = {}, {}
    for v in kv.VARIANTS:
        words = cq.random_words(g, (kv.n_words(v), O_INJECT), dev)
        top = torch.rand(words.shape, generator=g, device=dev) < 0.02
        words = torch.where(top, (1 << 32) - 1, words)
        k = kv.variant_counts(v, 0, dead, hm, vm, O_INJECT, words=words)
        p = kv._variant_counts_plain(v, words, *args)
        e1 = float((k - p).abs().max())
        blocks, _ = kv.variant_grid(v, O_PHILOX)
        trips = O_PHILOX / (blocks * kv.TILE[0])
        check(trips > 4, f"path o1 {v}: {trips:.2f} trips of the loop a "
              f"thread at {O_PHILOX} rollouts")
        k = kv.variant_counts(v, SEED, dead, hm, vm, O_PHILOX)
        p, check_ms[v] = timed(lambda: kv._variant_counts_plain_philox(
            v, SEED, *args, O_PHILOX, dev, chunk=PLAIN_CHUNK))
        check_err[v] = max(e1, float((k - p).abs().max()))
        log(f"path o1 {v}: kernel == plain on {O_INJECT} injected words "
            f"and {O_PHILOX} Philox rollouts at 256x16 ({blocks} blocks, "
            f"{trips:.2f} rollouts a thread; {k.tolist()}), max |kernel - "
            f"plain| {check_err[v]}, plain {check_ms[v]:.3f} ms")
        check(check_err[v] == 0, f"path o1 {v}: kernel equals its plain "
              f"version")
    done("o1 checks", t0)

    # the script's run at its --n, the counters reset just before
    t0 = time.perf_counter()
    reset()
    o1 = bkv.main(["--tiles", O_TILES])
    o1_launches = counts()
    check(set(o1_launches) == {f"k1_{v}" for v in kv.VARIANTS},
          f"path o1: every variant launched, nothing else ({o1_launches})")
    for label, r in o1["runs"].items():
        check(r["runs_agree"], f"path o1 {label}: every run counts alike")
    for labels, ok in o1["classes"]:
        check(ok, f"path o1: {labels} count alike at 2^29")
    # the timed counts against K1 and against another launch shape
    cur = o1["runs"]["current"]
    k1 = cq.equity_counts(bkv.SEED, dead, hm, vm, cur["n"]).tolist()
    k1_err = max(abs(a - b) for a, b in zip(k1, (cur["wins"],
                                                cur["ties"])))
    log(f"path o1: current at 2^29 {cur['wins'], cur['ties']}, K1 {k1}")
    check(k1_err == 0, "path o1: current's 2^29 counts equal K1's")
    check_err["current"] = max(check_err["current"], k1_err)
    for v in kv.VARIANTS:
        r = o1["runs"][v]
        tile = (kv.TILE[0], O_RESHAPE_WAVES)
        k = kv.variant_counts(v, bkv.SEED, dead, hm, vm, r["n"],
                              tile=tile).tolist()
        blocks, _ = kv.variant_grid(v, r["n"], tile)
        log(f"path o1 {v}: 2^29 at 256x16 {r['wins'], r['ties']}, at "
            f"256x{O_RESHAPE_WAVES} ({blocks} blocks) {k}")
        check(k == [r["wins"], r["ties"]], f"path o1 {v}: its 2^29 counts "
              f"do not depend on the launch shape")
    for label, r in o1["runs"].items():
        exact = r["variant"] in kv.EXACT_CLASS  # the stubs' eq is no equity
        z = (r["eq"] - exact_equity) / r["stderr"] if exact else None
        log(f"path o1 {label}: {r['grollouts_per_s']:.4f} Grollouts/s, "
            f"{r['ms']:.3f} ms, eq {r['eq']:.6f} (z {z} against exact "
            f"{exact_equity:.6f}), {r.get('blocks')} blocks, "
            f"{r.get('blocks_per_sm')} an SM")
        if exact:
            check(abs(z) < 4, f"path o1 {label}: within 4 sigma of exact")
    base = o1["runs"]["current"]["ms"]
    for label, r in o1["runs"].items():
        log(f"path o1 {label}: {r['ms'] / base:.4f} of current's time")
    ores["o1"] = o1
    done("o1 timing", t0)

    # (o2) exp_net_grid at its sizes
    t0 = time.perf_counter()
    reset()
    o2 = eng.main([])
    o2_launches = counts()
    check(list(o2) == eng.keys() and all(v > 0 for v in o2.values()),
          "path o2: every key of exp_net_grid timed")
    check(set(o2_launches) == {f"net_eval_{r}" for r in eng.RULES}
          | {f"engine_prng_{r}" for r in eng.RULES}
          | {f"first_state_{r}" for r in eng.RULES},
          f"path o2: K6, K4 and F1 (the first states) launched, nothing "
          f"else ({o2_launches})")
    ores["o2"] = o2
    done("o2", t0)

    # (o3) the plain engine's ablations, cut
    t0 = time.perf_counter()
    reset()
    T, S = O_STEP_PARTS
    o3a = bsp.main(["--tables", str(T), "--steps", str(S), "--runs",
                    str(O_RUNS), "--kinds", ",".join(bsp.KINDS
                                                     + bsp.ABLATIONS)])
    T, S = O_LEVERS
    o3b = ehl.main(["--tables", str(T), "--steps", str(S), "--runs",
                    str(O_RUNS)])
    check(not counts(), f"path o3: the plain engine launches no kernel "
          f"({counts()})")
    check(all(r["overflowed"] == 0 for r in o3b.values()),
          "path o3: no table overflowed, the 6-layer caps included")
    ores["o3"] = {"bench_step_parts": o3a, "exp_hands_levers": o3b}
    done("o3", t0)

    # (o4) the on-card checks
    t0 = time.perf_counter()
    o4a = cpk.main([])
    check(o4a["ok"], "path o4: B8's candidates equal single K6 launches, "
          "state and meters, bit for bit")
    o4b = clr.main([])
    check(o4b["ok"], "path o4: bank routing by the script's margin")
    o4c = enk.main([])
    tr, un = o4c["trained"], o4c["untrained"]
    check(all(r["hands"] > 0 and abs(sum(r["per_seat_bb"])) < 1e-9
              for r in (tr, un)), "path o4: eval_net_kernel zero-sum meters")
    check(tr["seat0_bb_per_hand"] - 2 * tr["seat0_stderr"]
          > un["seat0_bb_per_hand"] + 2 * un["seat0_stderr"],
          "path o4: the trained net beats the untrained one by 2 sigma each")
    ores["o4"] = {"check_pop_kernel": o4a, "check_league_routing": o4b,
                  "eval_net_kernel": o4c}
    done("o4", t0)

    # (o5) validate_tpu, as a user runs it
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "montecarlo_tpu_torch.scripts.validate_tpu"],
        cwd=ROOT, capture_output=True, text=True,
        timeout=O_VALIDATE_TIMEOUT)
    log(f"path o5: validate_tpu exit {run.returncode}\n{run.stdout}"
        f"{run.stderr[-4000:]}")
    check(run.returncode == 0, "path o5: validate_tpu exits 0")
    ores["o5"] = [json.loads(x) for x in run.stdout.splitlines()
                  if x.startswith("{")]
    done("o5", t0)

    # the kernels line's rows: the bound counts the variant's Philox blocks
    # and hand keys (K1's row counts two of each a rollout), the draws'
    # operations left out as K1's are
    rows = []
    for v in kv.VARIANTS:
        r = o1["runs"][v]
        key = kv.SPEC[v][2]
        keys = {"rank7": 2, "ref": 2, "one": 1, "none": 0}[key]
        ops = r["n"] * (-(-kv.n_words(v) // 4) * OPS["philox_block"]
                        + keys * OPS["hand_key"])
        b_ms, b_by = bound(0, ops)
        sampler, masks, _ = kv.SPEC[v]
        rows.append({
            "name": f"B-6 K1 variant {v} ({sampler}, {masks}, {key}; "
                    f"2^29 rollouts, 256x16)",
            "route": "cuda", "source": "montecarlo_tpu_torch/csrc/"
                                       "probe_k1.cu",
            "replaces": "scripts/bench_kernel_variants.py:137",
            "launches": o1_launches.get(f"k1_{v}", 0),
            "max_abs_err": check_err[v],
            "ms": r["ms"], "plain_ms": check_ms[v], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "work": r["n"],
            "unit": "rollouts", "plain_work": O_PHILOX,
            "ptxas": builds[v].ptxas})
    log(json.dumps({"path_o_kernels": rows, "card": smi}))
    o_s["path"] = time.perf_counter() - t_o
    return ores, o_s, o1_launches, rows


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from montecarlo_tpu_torch.device import cuda_device
    from montecarlo_tpu_torch.engine import replay as erp
    from montecarlo_tpu_torch.engine import state as tstate
    from montecarlo_tpu_torch.engine import step as tstep
    from montecarlo_tpu_torch.engine.state import TableConfig
    from montecarlo_tpu_torch.models import bots
    from montecarlo_tpu_torch.models import policy_net as tpn
    from montecarlo_tpu_torch.models import pushfold as pf
    from montecarlo_tpu_torch.models import train_es as tte
    from montecarlo_tpu_torch.ops import _build
    from montecarlo_tpu_torch.ops import cuda_carry as cc
    from montecarlo_tpu_torch.ops import cuda_engine as ce
    from montecarlo_tpu_torch.ops import cuda_equity as cq
    from montecarlo_tpu_torch.ops import cuda_net as cn
    from montecarlo_tpu_torch.ops import cuda_stages as cs
    from montecarlo_tpu_torch.ops import philox
    from montecarlo_tpu_torch.ops.evaluator import (
        eval_masks_cmp_impl,
        every_hand_keys,
    )
    from montecarlo_tpu_torch.rollout import equity as teq
    from montecarlo_tpu_torch.rollout import evaluate as tev
    from montecarlo_tpu_torch.rollout import policy as tpol
    from montecarlo_tpu_torch.rollout import selfplay as tsp
    from montecarlo_tpu_torch.scripts import bench_net_throughput as bnt
    from montecarlo_tpu_torch.scripts import debug_kernel_compile as dkc
    from montecarlo_tpu_torch.scripts import exp_carry_model as ecm

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

    def reset_counts():
        for mod in (cq, ce, cn, cc, cs, philox):
            mod.reset_launches()

    def field_sum(state, cfg, name, rows):
        return sum(ce.unpack_field(state, cfg, name, k) for k in range(rows))

    def flat(pop):
        """A population state [C, n_blocks, ...] as one state of C x T
        tables."""
        return pop.reshape(-1, *pop.shape[2:])

    def exact_multiway(hands, board):
        """Exact N-way equity: every board completion, each pot split
        fractionally among its winners, the plain evaluator on the card.
        Returns (equity float64 [N], boards)."""
        dead = sorted([c for h in hands for c in h] + list(board))
        live = teq.complement(dead).numpy()
        slots = np.fromiter(itertools.chain.from_iterable(
            itertools.combinations(range(live.shape[0]), 5 - len(board))),
            dtype=np.int32).reshape(-1, 5 - len(board))
        boards = np.concatenate([np.tile(np.asarray(board, np.int32),
                                         (len(slots), 1)), live[slots]],
                                axis=1)
        hm = cq._multiway_masks(hands, (), dev)[1]
        total = torch.zeros(len(hands), dtype=torch.float64, device=dev)
        for i in range(0, len(boards), PLAIN_CHUNK):
            bm = cq.suit_masks_from_cards(
                torch.from_numpy(boards[i:i + PLAIN_CHUNK]).to(dev))
            values = torch.stack([eval_masks_cmp_impl(
                *[b | m for b, m in zip(bm, row)]) for row in hm])
            win = (values == values.amax(0)).double()
            total += (win / win.sum(0)).sum(1)
        return (total / len(boards)).cpu().numpy(), len(boards)

    def clean_and_zero_sum(state, what, tables):
        check(int(ce.unpack_field(state, std, "overflow").sum()) == 0,
              f"{what}: no overflow")
        seat = field_sum(state, std, "seat_delta", P)
        check(bool((seat == 0).all()),
              f"{what}: every table's seat deltas sum to 0")
        log(f"{what}: overflow 0; seat deltas sum to 0 on all {tables} "
            f"tables")

    phase_s, t_phase = {}, [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    # ---- 0. setup ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # the libraries this run uses: no seat count (K1, K2, Philox) and P = 6
    # (K3-K6); the two builds, one nvcc per source, run at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = list(pool.map(_build.build, (None, 6)))
    log(f"build: {time.perf_counter() - t0:.1f} s (compile seconds per "
        f"library: {[round(s, 1) for _, s in builds]})")
    for lib_path, _ in builds:
        log(f"{lib_path}\n" + (lib_path.parent / "build.log").read_text())
    _build.library()
    _build.library(6)
    # the stage probe's builds, one nvcc per stage, one at a time, in the
    # background while the main paths run on the card (phase 5 uses them)
    stage_pool = ThreadPoolExecutor(1)
    stage_job = stage_pool.submit(lambda: [
        cs.stage_library(stage, dkc.P, fresh=True) for stage in cs.STAGES])
    # the K4 and K6 splits' builds, one nvcc per variant, in the background
    # likewise (path n uses them)
    split_builds = start_split_builds()

    kat = philox.philox_blocks(torch.tensor([c for c, _ in PHILOX_KAT],
                                            dtype=torch.int64, device=dev))
    check(kat.tolist() == [w for _, w in PHILOX_KAT],
          "the card's Philox4x32-10 gives the known answers")
    log("Philox4x32-10 on the card: known answers match")

    AKS = [teq.make_card(0, 14), teq.make_card(0, 13)]
    QQ = [teq.make_card(1, 12), teq.make_card(2, 12)]
    FLOP = [teq.make_card(3, 2), teq.make_card(1, 7), teq.make_card(2, 13)]
    cfg = TableConfig(num_seats=6, bets_impl="levels")
    std = TableConfig(num_seats=6, rules="standard", bets_impl="levels")
    P, SB, BB, SS = cfg.num_seats, cfg.small_blind, cfg.big_blind, \
        cfg.starting_stack
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
    st_full_std = ce.pack_state(std, deal_full[:, 0])
    tour_short = TableConfig(num_seats=6, rules="tournament",
                             starting_stack=TOUR_STACK, bets_impl="levels")
    tour = TableConfig(num_seats=6, rules="tournament", bets_impl="levels")
    st_full_tour = ce.pack_state(tour_short, deal_full[:, 0])
    del u, raises, deal_full
    exact_pre = teq.equity_exact(AKS, QQ, device=dev)
    exact_flop = teq.equity_exact(AKS, QQ, FLOP, device=dev)
    # path d's hands: validate_tpu.py's AA/KK/76o preflop, and AhKh (nut
    # flush draw), QsQd (overpair) and JcTc (open-ended) on 9h 8s 2h
    mk = teq.make_card
    MW_TRIO = [[mk(0, 14), mk(1, 14)], [mk(2, 13), mk(3, 13)],
               [mk(0, 7), mk(1, 6)]]
    MW_FLOP_HANDS = [[mk(0, 14), mk(0, 13)], [mk(2, 12), mk(1, 12)],
                     [mk(3, 11), mk(3, 10)]]
    MW_FLOP = [mk(0, 9), mk(2, 8), mk(0, 2)]
    exact_mw = {"preflop": exact_multiway(MW_TRIO, ()),
                "flop": exact_multiway(MW_FLOP_HANDS, MW_FLOP)}
    # the net path's inputs: K5's deal stash and first state, K6's first
    # state (built once, outside the evaluation, as bench.py does)
    es3 = tpn.load_params(ROOT / "data" / "policy_6max_es3.npz")
    w_es3 = cn.net_weights(es3, dev)
    panel = bots.panel()
    w_bot = cn.net_weights(panel["fof_raise"], dev)
    stash_net = cn.deal_stash(SEED, T_NET, P, NET_HMAX, dev)
    st_net_det = ce.pack_state(std, ce._stash_rows(stash_net)[0].T)
    st_net0 = cn.initial_packed_state(SEED, std, T_NET, dev)
    # the ES path's inputs: the generation's candidates (as
    # bench_es_generation draws them), its first state, the league's nets
    # and first state, K5's two banks
    rng = np.random.default_rng(0)
    cands = [tpn.params_from_numpy([
        x.numpy() + TRAIN_SIGMA * rng.standard_normal(x.shape)
        .astype(np.float32) for x in es3]) for _ in range(TRAIN_POP)]
    p200 = tpn.load_params(ROOT / "data" / "policy_6max_200.npz")
    st_train0 = cn.initial_packed_state(TRAIN_SEED, std, T_TRAIN, dev)
    st_league0 = cn.initial_packed_state(SEED, std, T_LEAGUE, dev)
    parity = tuple(k % 2 for k in range(P))
    seat0 = (0,) + (1,) * (P - 1)
    all_seats = (1 << P) - 1
    w_det_banks = cn.bank_weights([panel["jam_tight"], panel["fof_call"]],
                                  dev)
    sync()
    phase_done("0 setup")

    # ---- 1a. main path: equity, sweep, engine (reference rules) --------
    reset_counts()
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
                "K3": ce.LAUNCHES["engine_det_reference"],
                "K4": ce.LAUNCHES["engine_prng_reference"]}
    log(f"main path (equity, sweep, engine): {main_s:.2f} s, launches "
        f"{launches}")
    check(all(v > 0 for v in launches.values()),
          "every kernel of the path launched")

    # ---- 1b. main path: policy-net evaluation (standard rules) ----------
    reset_counts()
    t0 = time.perf_counter()
    det_std = ce.run_perpetual_det(st_full_std, acts_full, cards_full, P,
                                   DET_STEPS, SB, BB, rules="standard")
    sp_std, sp_std_hands, sp_std_ovf = ce.selfplay_perpetual_kernel(
        SEED, std, T_FULL, SP_SLOTS, steps_per_launch=SP_SLOTS, device=dev)
    k5_out = cn.run_net_det(st_net_det, stash_net, w_bot, P, NET_DET_STEPS,
                            SB, BB, "standard")
    net_means, net_errs, net_hands = cn.selfplay_net_eval_kernel(
        SEED, std, es3, 1, T_NET, NET_SLOTS, NET_LAUNCH, state0=st_net0)
    sync()
    net_s = time.perf_counter() - t0
    launches.update({"K3s": ce.LAUNCHES["engine_det_standard"],
                     "K4s": ce.LAUNCHES["engine_prng_standard"],
                     "K5": cn.LAUNCHES["net_det_standard"],
                     "K6": cn.LAUNCHES["net_eval_standard"]})
    log(f"main path (policy-net evaluation): {net_s:.2f} s, launches "
        f"{ {k: launches[k] for k in ('K3s', 'K4s', 'K5', 'K6')} }")
    check(all(launches[k] > 0 for k in ("K3s", "K4s", "K5", "K6")),
          "every kernel of the net path launched")

    # ---- 1c. main path: the ES training path (standard rules) -----------
    reset_counts()
    t0 = time.perf_counter()
    pop_m, pop_e, pop_h = cn.selfplay_net_eval_pop(
        TRAIN_SEED, std, cands, 1, T_TRAIN, TRAIN_SLOTS, state0=st_train0)
    lpop_m, lpop_e, lpop_h = cn.selfplay_net_league_pop(
        TRAIN_SEED, std, cands, es3, T_TRAIN, TRAIN_SLOTS, state0=st_train0)
    lg_m, lg_e, lg_h = cn.selfplay_net_league(
        SEED, std, [es3, p200], parity, T_LEAGUE, LEAGUE_SLOTS,
        steps_per_launch=NET_LAUNCH, state0=st_league0)
    k5b_out = cn.run_net_det(st_net_det, stash_net, w_det_banks, P,
                             NET_DET_STEPS, SB, BB, "standard", seat0)
    sync()
    es_s = time.perf_counter() - t0
    launches.update({"K5b": cn.LAUNCHES["net_det_banked_standard"],
                     "B7": cn.LAUNCHES["net_league_standard"],
                     "B8": cn.LAUNCHES["net_pop_standard"],
                     "B8l": cn.LAUNCHES["net_league_pop_standard"]})
    log(f"main path (ES training): {es_s:.2f} s, launches "
        f"{ {k: launches[k] for k in ('K5b', 'B7', 'B8', 'B8l')} }")
    check(all(launches[k] > 0 for k in ("K5b", "B7", "B8", "B8l")),
          "every kernel of the ES path launched")

    # ---- 1d. main path: tournaments and multiway equity -----------------
    reset_counts()
    t0 = time.perf_counter()
    mw = {"preflop": teq.equity_multiway(SEED + 3, MW_TRIO, N_EQUITY,
                                         device=dev),
          "flop": teq.equity_multiway(SEED + 4, MW_FLOP_HANDS, N_FLOP,
                                      MW_FLOP, device=dev)}
    det_tour = ce.run_perpetual_det(st_full_tour, acts_full, cards_full, P,
                                    DET_STEPS, SB, BB, rules="tournament")
    t_tour = time.perf_counter()
    tour_state, tour_steps = ce.tournaments_to_completion(
        SEED, tour, T_FULL, steps_per_launch=TOUR_LAUNCH, device=dev)
    sync()
    tour_s = time.perf_counter() - t_tour
    tour_path_s = time.perf_counter() - t0
    launches.update({"B3": cq.LAUNCHES["multiway"],
                     "K3t": ce.LAUNCHES["engine_det_tournament"],
                     "K4t": ce.LAUNCHES["engine_prng_tournament"]})
    log(f"main path (tournaments, multiway equity): {tour_path_s:.2f} s "
        f"(the completion run {tour_s:.2f} s), launches "
        f"{ {k: launches[k] for k in ('B3', 'K3t', 'K4t')} }")
    check(all(launches[k] > 0 for k in ("B3", "K3t", "K4t")),
          "every kernel of the tournament and multiway path launched")
    phase_done("1 main paths")

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

    # standard rules: K3 on the injected stream; chips conserve on a table
    # within capacity unless the stream folded free to a shorter all-in
    # (the reference rules' dead money, PERF.md), so this is logged
    det_std_hands = int(ce.unpack_field(det_std, std, "hand_ct").sum())
    clean = ce.unpack_field(det_std, std, "overflow") == 0
    chips = field_sum(det_std, std, "delta_sum", P)
    log(f"K3 standard rules: {T_FULL} tables x {DET_STEPS} steps, "
        f"{det_std_hands} hands, {int((~clean).sum())} overflowed tables, "
        f"{int((clean & (chips != 0)).sum())} tables within capacity that "
        f"lost dead money")
    check(det_std_hands > 0, "standard det engine completed hands")
    sp_std_sph = T_FULL * SP_SLOTS / max(sp_std_hands, 1)
    chips = field_sum(sp_std, std, "delta_sum", P)
    log(f"K4 standard rules: {sp_std_hands} hands, overflow {sp_std_ovf}, "
        f"slots/hand {sp_std_sph:.4f}, tables with chips not conserved "
        f"{int((chips != 0).sum())}")
    check(sp_std_hands > 0 and sp_std_ovf == 0,
          "standard self-play hands > 0, no overflow")
    check(bool((chips == 0).all()), "standard rules conserve every "
          "table's chips")

    k5_hands = int(ce.unpack_field(k5_out, std, "hand_ct").sum())
    log(f"K5 rule bot at every seat: {T_NET} tables x {NET_DET_STEPS} "
        f"steps, {k5_hands} hands, overflow "
        f"{int(ce.unpack_field(k5_out, std, 'overflow').sum())}")
    check(k5_hands > 0, "the net det kernel completed hands")

    log(f"K6 net evaluation (es3 at seat 0): {net_hands} hands, seat 0 "
        f"{net_means[0]:+.4f} +- {net_errs[0]:.4f} bb/hand; seats "
        f"{np.array2string(net_means, precision=4)}")
    check(net_hands > 0 and np.all(np.isfinite(net_means)),
          "net evaluation finite, hands > 0")
    check(abs(float(net_means.sum())) < 1e-9, "the seat means sum to 0")

    # The validate gate: the trained artifact against untrained nets at
    # seat 0. An untrained net's own edge depends on its random draw (the
    # TPU-era draw was positive), so each of UNTRAINED_DRAWS draws is
    # logged and the trained net must beat every one of them.
    mt, et, _ = cn.selfplay_net_eval_kernel(11, std, p200, 1, VAL_TABLES,
                                            VAL_SLOTS, device=dev)
    log(f"validate gate ({VAL_TABLES} tables x {VAL_SLOTS} slots, seat 0): "
        f"trained policy_6max_200 {mt[0]:+.3f} +- {et[0]:.3f} bb/hand "
        f"(TPU-era record, bf16 matmul inputs, history only: +3.81 +- 0.06 "
        f"vs untrained +1.82 +- 0.05)")
    for draw in range(UNTRAINED_DRAWS):
        untrained = tpn.init_params(torch.Generator().manual_seed(draw))
        mu, eu, _ = cn.selfplay_net_eval_kernel(
            11, std, untrained, 1, VAL_TABLES, VAL_SLOTS, device=dev)
        log(f"  untrained draw {draw}: {mu[0]:+.3f} +- {eu[0]:.3f} bb/hand")
        check(mt[0] - 2 * et[0] > mu[0] + 2 * eu[0],
              f"trained - 2 sigma > untrained draw {draw} + 2 sigma")
    check(mt[0] - 2 * et[0] > 0, "trained - 2 sigma > 0")

    # The ES path. The generation's B8 launches again from the same first
    # state (the main path's one launch each) give the states behind the
    # meters, and the kernels' counts of net decisions (for the bounds).
    w8 = cn.pop_weights(cands, dev)
    w8l = cn.pop_weights(cands, dev, es3)
    pop0 = st_train0[None].expand(TRAIN_POP, *st_train0.shape).contiguous()
    decisions = {k: torch.zeros(1, dtype=torch.int64, device=dev)
                 for k in ("B8", "B8l", "B7")}
    k8 = cn.run_net_eval_pop(TRAIN_SEED, pop0, w8, P, TRAIN_SLOTS, SB, BB,
                             SS, "standard", 1, decisions=decisions["B8"])
    k8l = cn.run_net_eval_pop(TRAIN_SEED, pop0, w8l, P, TRAIN_SLOTS, SB, BB,
                              SS, "standard", all_seats, seat0,
                              decisions=decisions["B8l"])
    for key, k, meters in (("B8", k8, (pop_m, pop_e, pop_h)),
                           ("B8l", k8l, (lpop_m, lpop_e, lpop_h))):
        check(all(np.array_equal(a, b) for a, b in
                  zip(cn.pop_meters(k, std), meters)),
              f"{key}: the launch replayed gives the main path's meters")
        check(np.all(meters[2] > 0) and np.all(np.isfinite(meters[0])),
              f"{key}: hands > 0 and finite meters on every candidate")
        clean_and_zero_sum(flat(k), f"{key} ({TRAIN_POP} candidates)",
                           TRAIN_POP * T_TRAIN)
    log(f"B8 generation: {int(pop_h.sum())} hands over {TRAIN_POP} "
        f"candidates; seat 0 bb/hand {pop_m[:, 0].min():+.4f} .. "
        f"{pop_m[:, 0].max():+.4f} (stderr ~{pop_e[:, 0].mean():.4f})")
    log(f"B8 league fitness against es3: {int(lpop_h.sum())} hands; seat 0 "
        f"bb/hand {lpop_m[:, 0].min():+.4f} .. {lpop_m[:, 0].max():+.4f}")

    # pop equals singles: each candidate alone, from the same first state
    for c, params in enumerate(cands):
        single = cn.selfplay_net_eval_kernel(TRAIN_SEED, std, params, 1,
                                             T_TRAIN, TRAIN_SLOTS,
                                             state0=st_train0)
        check(all(np.array_equal(a, b[c]) for a, b in
                  zip(single, (pop_m, pop_e, pop_h))),
              f"candidate {c}: B8 equals a single K6 launch")
        single = cn.selfplay_net_league(TRAIN_SEED, std, [params, es3],
                                        seat0, T_TRAIN, TRAIN_SLOTS,
                                        state0=st_train0)
        check(all(np.array_equal(a, b[c]) for a, b in
                  zip(single, (lpop_m, lpop_e, lpop_h))),
              f"candidate {c}: B8 with two banks equals a single B7 launch")
    log(f"pop equals singles: all {TRAIN_POP} candidates' meters and hands "
        f"equal single K6 (and B7) launches exactly")

    # two identical banks are the single net at every seat
    st_chk = cn.initial_packed_state(CHECK_SEED, std, T_CHECK, dev)
    m1, _, h1 = cn.selfplay_net_eval_kernel(CHECK_SEED, std, es3, all_seats,
                                            T_CHECK, CHECK_SLOTS,
                                            state0=st_chk)
    m2, _, h2 = cn.selfplay_net_league(CHECK_SEED, std, [es3, es3], parity,
                                       T_CHECK, CHECK_SLOTS, state0=st_chk)
    check(np.array_equal(m1, m2) and h1 == h2,
          "identical banks equal the single net at every seat")
    log(f"identical banks: {h2} hands, meters equal the single net's")

    # bank routing, reference rules: a pot-raise bot jams every hand and,
    # all-in seats being left out of showdown, loses its stack, so seat 0's
    # sign says which bank it played
    rst = cn.initial_packed_state(CHECK_SEED, cfg, T_CHECK, dev)
    callbot, raisebot = bots.action_bot(1), bots.action_bot(3)
    ma = cn.selfplay_net_league(CHECK_SEED, cfg, [callbot, raisebot], seat0,
                                T_CHECK, CHECK_SLOTS, state0=rst)[0]
    mb = cn.selfplay_net_league(CHECK_SEED, cfg, [raisebot, callbot], seat0,
                                T_CHECK, CHECK_SLOTS, state0=rst)[0]
    mp = cn.selfplay_net_league_pop(CHECK_SEED, cfg, [callbot, raisebot],
                                    raisebot, T_CHECK, CHECK_SLOTS,
                                    seat_to_bank=seat0, state0=rst)[0]
    log(f"routing (reference rules, seat 0): callbot {ma[0]:+.3f}, raisebot "
        f"{mb[0]:+.3f} bb/hand; pop candidates {mp[0, 0]:+.3f} / "
        f"{mp[1, 0]:+.3f} (TPU-era record, history only: +2.84 / -10.0)")
    check(ma[0] > 0 > mb[0], "routing: callbot at seat 0 > 0 > raisebot")
    check(mp[0, 0] > mp[1, 0] and np.array_equal(mp[0], ma),
          "routing: the population's candidates route likewise")

    # the trainer: two generations through the population evaluator and
    # through the per-candidate one give the same result
    es_kw = dict(generations=2, pop=4, sigma=TRAIN_SIGMA, lr=0.03)
    a = tte.train_es(TRAIN_SEED, es3, eval_pop_fn=tte.kernel_eval_pop_fn(
        std, 1, T_CHECK, CHECK_SLOTS), **es_kw)
    b = tte.train_es(TRAIN_SEED, es3, tte.kernel_eval_fn(
        std, 1, T_CHECK, CHECK_SLOTS), **es_kw)
    check(all(torch.equal(tte._flatten(x)[0], tte._flatten(y)[0])
              for x, y in ((a.params, b.params),
                           (a.final_params, b.final_params)))
          and np.array_equal(a.fitness_history, b.fitness_history)
          and a.hands_total == b.hands_total
          and a.best_fitness == b.best_fitness,
          "train_es: the population and per-candidate evaluators agree")
    log(f"train_es, 2 generations x 4 pairs at {T_CHECK} tables: fitness "
        f"{np.array2string(a.fitness_history, precision=4)}, "
        f"{a.hands_total} hands, both evaluators exactly equal")
    t0 = time.perf_counter()
    r3 = tte.train_es(TRAIN_SEED, es3, eval_pop_fn=tte.kernel_eval_pop_fn(
        std, 1, T_TRAIN, TRAIN_SLOTS), generations=3, pop=TRAIN_POP // 2,
        sigma=TRAIN_SIGMA, lr=0.03)
    log(f"train_es from es3, 3 generations x {TRAIN_POP} candidates at "
        f"{T_TRAIN} tables x {TRAIN_SLOTS} slots: fitness "
        f"{np.array2string(r3.fitness_history, precision=4)}, "
        f"{r3.hands_total} hands, {time.perf_counter() - t0:.2f} s")

    # path d: multiway shares are exact integers (recovered from the
    # equities: shares < 2^53), each equity within 4 sigma of enumeration
    for case, hands in (("preflop", MW_TRIO), ("flop", MW_FLOP_HANDS)):
        eq, n = mw[case]
        exact, n_boards = exact_mw[case]
        scale = cq.multiway_scale(len(hands))
        shares = np.rint(eq * scale * n).astype(np.int64)
        z = (eq - exact) / np.sqrt(exact * (1 - exact) / n)
        log(f"B3 {case}: {np.array2string(eq, precision=6)} over {n} "
            f"rollouts, exact {np.array2string(exact, precision=6)} "
            f"({n_boards} boards), z {np.array2string(z, precision=2)}; "
            f"max |eq - exact| {np.abs(eq - exact).max():.2e} (TPU-era "
            f"bound on the XLA path, history only: {TPU_MW_BOUND})")
        check(eq.shape == (len(hands),) and np.all(np.isfinite(eq)),
              f"B3 {case}: shape and finiteness")
        check(int(shares.sum()) == scale * n,
              f"B3 {case}: the shares sum to lcm(1..N) x rollouts")
        check(np.all(np.abs(z) < 4), f"B3 {case}: every equity within 4 "
              f"sigma of exact enumeration")

    # tournament K3 on the injected stream: seats bust, the blinds skip
    # them, tables freeze; the stream folds free, so chips may vanish
    # (ROADMAP.md section C): logged, not gated
    busted = field_sum(det_tour, tour_short, "bust_at", P) > -P
    frozen3 = ((ce.unpack_field(det_tour, tour_short, "order") == 0)
               & (ce.unpack_field(det_tour, tour_short, "wait") == 0))
    det_tour_hands = int(ce.unpack_field(det_tour, tour_short,
                                         "hand_ct").sum())
    chips = field_sum(det_tour, tour_short, "delta_sum", P)
    log(f"K3 tournament ({TOUR_STACK}-chip stacks): {T_FULL} tables x "
        f"{DET_STEPS} steps, {det_tour_hands} hands, {int(busted.sum())} "
        f"tables with a busted seat, {int(frozen3.sum())} frozen, "
        f"{int((chips != 0).sum())} that lost dead money, overflow "
        f"{int(ce.unpack_field(det_tour, tour_short, 'overflow').sum())}")
    check(int(busted.sum()) > 0 and int(frozen3.sum()) > 0,
          "K3 tournament: seats busted and tables froze")

    # tournaments to completion (validate_tpu.py:212-226)
    places, tour_frozen = ce.tournament_results(tour_state, tour)
    stacks = torch.stack([ce.unpack_field(tour_state, tour, "stacks", k)
                          for k in range(P)])
    tour_hands = ce.unpack_field(tour_state, tour, "hand_ct")
    check(int(ce.unpack_field(tour_state, tour, "overflow").sum()) == 0,
          "tournaments: no overflow")
    check(bool(tour_frozen.all()), "tournaments: every table frozen")
    check(bool((stacks.amax(0) == P * SS).all())
          and bool((stacks.sum(0) == P * SS).all()),
          "tournaments: the winner holds every chip, chips conserved")
    check(places.shape == (T_FULL, P)
          and bool((np.sort(places, axis=1) == np.arange(1, P + 1)).all()),
          "tournaments: placements are a permutation on every table")
    wins = np.bincount(np.argmin(places, axis=1), minlength=P) / T_FULL
    log(f"tournaments: {T_FULL}/{T_FULL} complete in {tour_steps} slots "
        f"({tour_steps // TOUR_LAUNCH} launches), "
        f"{float(tour_hands.double().mean()):.2f} hands a tournament, "
        f"max {int(tour_hands.max())}; winner takes all, chips conserved, "
        f"total placements, overflow 0; seat win shares "
        f"{np.array2string(wins, precision=4)} (1/6 = {1 / 6:.4f})")

    # ROADMAP C-1, seat 0's win share. (1) The first button written to 3:
    # the positions play the same hands on the same words, so a positional
    # edge moves to seat 3 (a seat-view fault would keep it at seat 0).
    # (2) Two more seeds. (3) The first deal from a uniform permutation of
    # the deck per table (argsort of float64 uniforms) with the JAX
    # engine's position mapping (pallas_engine.py:1693-1696), in place of
    # first_deal; and a chi-squared test of first_deal's cards.
    sd = np.sqrt(1 / 6 * 5 / 6 / T_FULL)

    def c1_shares(what, state, steps, first_sb):
        places, frozen = ce.tournament_results(state, tour)
        check(bool(frozen.all()), f"C-1 {what}: every table frozen")
        w = np.bincount(np.argmin(places, axis=1), minlength=P) / T_FULL
        z = (w - 1 / 6) / sd
        log(f"C-1 {what}: {steps} slots; seat win shares "
            f"{np.array2string(w, precision=4)}, z "
            f"{np.array2string(z, precision=1)}; the first small blind "
            f"(seat {first_sb}) z = {z[first_sb]:+.1f}")
        return w

    c1 = {"seed 0, button 0": c1_shares("the main run (button 0)",
                                        tour_state, tour_steps, 0)}
    button_row = ce._field_layout(P, "tournament")[0]["button"][0]
    st_b3 = ce.pack_state(tour, ce.first_deal(SEED, T_FULL, P, dev))
    st_b3[:, button_row] = 3
    c1["seed 0, button 3"] = c1_shares(
        "first button 3", *ce.run_to_completion(SEED, st_b3, tour,
                                                TOUR_LAUNCH), 3)
    check(np.array_equal(np.roll(c1["seed 0, button 0"], 3),
                         c1["seed 0, button 3"]),
          "C-1: with the first button at 3 every win moves to seat + 3")
    for k in (1, 2):
        c1[f"seed {k}, button 0"] = c1_shares(
            f"seed {SEED + k}", *ce.tournaments_to_completion(
                SEED + k, tour, T_FULL, steps_per_launch=TOUR_LAUNCH,
                device=dev), 0)
    deck = torch.rand((T_FULL, 52), generator=g, dtype=torch.float64,
                      device=dev).argsort(dim=1)
    jax_pos = list(range(2 * P)) + [2 * P + k for k in (1, 2, 3, 5, 7)]
    c1["permutation deal"] = c1_shares(
        "first deal from a permutation", *ce.run_to_completion(
            SEED, ce.pack_state(tour, deck[:, jax_pos]), tour, TOUR_LAUNCH),
        0)
    del deck, st_b3
    fsb = np.array([c1[k][0] for k in c1 if "button 0" in k]
                   + [c1["permutation deal"][0]])
    log(f"C-1: the first small blind's win share over the "
        f"{len(fsb)} independent button-0 runs: {fsb.mean():.5f} "
        f"(z = {(fsb.mean() - 1 / 6) / (sd / np.sqrt(len(fsb))):+.1f})")
    fd = ce.first_deal(SEED, T_FULL, P, dev)

    def chi2_z(cols):
        """Chi-squared of the cards in ``cols`` over the 52 cards, 51
        degrees of freedom, as a Wilson-Hilferty z."""
        n = torch.bincount(fd[:, cols].reshape(-1), minlength=52).double()
        e = len(cols) * T_FULL / 52
        x2, k = float(((n - e) ** 2 / e).sum()), 51
        return x2, ((x2 / k) ** (1 / 3) - (1 - 2 / (9 * k))) \
            / np.sqrt(2 / (9 * k))
    seat_chi = [chi2_z([p, P + p]) for p in range(P)]
    col_chi = [chi2_z([c]) for c in range(2 * P + 5)]
    log(f"C-1: first_deal chi-squared (51 dof) per position's two hole "
        f"cards {[round(x, 1) for x, _ in seat_chi]}, per card slot max "
        f"{max(x for x, _ in col_chi):.1f}; max z "
        f"{max(z for _, z in seat_chi + col_chi):+.2f}")
    check(max(z for _, z in seat_chi + col_chi) < 5,
          "C-1: first_deal's cards are uniform per position and slot")
    del fd
    phase_done("2 results")

    # ---- 3. agreement: each kernel call against its plain version -------
    # The engine's and the net kernels' plain versions are launch-bound
    # loops of small kernels: on the card each replays its step (or
    # iteration) from a CUDA graph of one (ce.plain_loop), the same kernels
    # on the same inputs.
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
    p, plain_ms["K3s"] = timed(lambda: ce._run_det_plain(
        st_full_std, acts_full, cards_full, P, DET_STEPS, SB, BB,
        "standard"))
    agree("K3s", f"standard rules, {T_FULL} tables x {DET_STEPS} steps",
          det_std, p)
    del p

    st_sp = ce.pack_state(cfg, ce.first_deal(SEED, T_FULL, P, dev))
    p, plain_ms["K4"] = timed(lambda: ce._run_prng_plain_philox(
        SEED, st_sp, P, SP_SLOTS, SB, BB))
    agree("K4", f"main path, {T_FULL} tables x {SP_SLOTS} slots",
          sp_state, p)
    st_sp_std = ce.pack_state(std, ce.first_deal(SEED, T_FULL, P, dev))
    p, plain_ms["K4s"] = timed(lambda: ce._run_prng_plain_philox(
        SEED, st_sp_std, P, SP_SLOTS, SB, BB, "standard"))
    agree("K4s", f"standard rules, {T_FULL} tables x {SP_SLOTS} slots",
          sp_std, p)
    del p

    # F1 against its plain version on the same seed and tables: the random
    # cell's size under every rule set, the league's under the standard and
    # tournament rules; one launch a call, no other kernel
    for c, T, t_0 in ((cfg, T_FULL, 0), (std, T_FULL, 0), (tour, T_FULL, 0),
                      (std, T_LEAGUE, 0), (tour, T_LEAGUE, 0),
                      (std, T_LEAGUE, 5 * 1024)):
        reset_counts()
        k = ce.first_state(SEED, c, T, dev, t_0)
        n = {key: v for mod in (cq, ce, cn, cc, cs, philox)
             for key, v in mod.LAUNCHES.items() if v}
        check(n == {f"first_state_{c.rules}": 1},
              f"F1 {c.rules}, {T} tables: one launch and no other ({n})")
        if c is std and T == T_FULL:
            launches["F1"] = n[f"first_state_{c.rules}"]
        agree("F1", f"{c.rules} rules, {T} tables from table {t_0}", k,
              ce.pack_state(c, ce.first_deal(SEED, T, P, dev, t_0)))
        del k
    p, plain_ms["F1"] = timed(lambda: ce.pack_state(
        std, ce.first_deal(SEED, T_FULL, P, dev)))
    del p

    p, plain_ms["K5"] = timed(lambda: cn._run_net_det_plain(
        st_net_det, stash_net, w_bot, P, NET_DET_STEPS, SB, BB, "standard"))
    agree("K5", f"{T_NET} tables x {NET_DET_STEPS} steps", k5_out, p)
    del p

    # K6 launch by launch from the main path's first state: the kernel
    # again (the same launches as the main path) against the plain version
    # on the same input state
    state = st_net0
    decisions["K6"] = torch.zeros(1, dtype=torch.int64, device=dev)
    for done in range(0, NET_SLOTS, NET_LAUNCH):
        seed = (SEED + done * 7919) & 0x7FFFFFFF
        k = cn.run_net_eval(seed, state, w_es3, P, NET_LAUNCH, SB, BB, SS,
                            "standard", 1)
        p, ms = timed(lambda: cn._run_net_eval_plain_philox(
            seed, state, w_es3, P, NET_LAUNCH, SB, BB, SS, "standard", 1,
            True, decisions=decisions["K6"] if done == 0 else None))
        plain_ms.setdefault("K6", ms)
        agree("K6", f"launch at slot {done}, {T_NET} tables x {NET_LAUNCH} "
              f"slots", k, p)
        if done == 0:
            k6_first = k
            k6_decisions = int(decisions["K6"])
        state = k
    del p
    check(all(np.array_equal(a, b) for a, b in
              zip(cn.seat_meters(state, std), (net_means, net_errs,
                                               net_hands))),
          "K6: the launches replayed give the main path's meters")
    clean_and_zero_sum(state, f"K6 net evaluation ({k6_decisions} net "
                       f"decisions in the first launch)", T_NET)
    words = ce.table_words(SEED + 9, T_NET, 0, 4, dev)
    probe = cn.net_probe(state, words, w_es3, P, BB, "standard")
    want = cn._net_probe_plain(state, words, w_es3, P, BB, "standard")
    check(torch.equal(probe.view(torch.int32), want.view(torch.int32)),
          "features, logits and Gumbel scores equal the plain version's, "
          "bit for bit")
    log(f"K6 probe: {T_NET} tables x {cn.PROBE_ROWS} floats (features, "
        f"masked logits, Gumbel scores) bit for bit")
    del probe, want

    # the ES path: banked K5; B7 launch by launch from the main path's
    # first state (the first launch counts its net decisions); B8 on four
    # of the 32 candidates of the replayed launches
    p, plain_ms["K5b"] = timed(lambda: cn._run_net_det_plain(
        st_net_det, stash_net, w_det_banks, P, NET_DET_STEPS, SB, BB,
        "standard", seat0))
    agree("K5b", f"two banks, {T_NET} tables x {NET_DET_STEPS} steps",
          k5b_out, p)
    w7 = cn.bank_weights([es3, p200], dev)
    state = st_league0
    for done in range(0, LEAGUE_SLOTS, NET_LAUNCH):
        seed = (SEED + done * 7919) & 0x7FFFFFFF
        k = cn.run_net_league(seed, state, w7, P, NET_LAUNCH, SB, BB, SS,
                              "standard", all_seats, parity,
                              decisions=decisions["B7"] if done == 0
                              else None)
        p, ms = timed(lambda: cn._run_net_eval_plain_philox(
            seed, state, w7, P, NET_LAUNCH, SB, BB, SS, "standard",
            all_seats, True, parity))
        plain_ms.setdefault("B7", ms)
        agree("B7", f"launch at slot {done}, {T_LEAGUE} tables x "
              f"{NET_LAUNCH} slots", k, p)
        if done == 0:
            b7_first = k
        state = k
    check(all(np.array_equal(a, b) for a, b in
              zip(cn.seat_meters(state, std), (lg_m, lg_e, lg_h))),
          "B7: the launches replayed give the main path's meters")
    clean_and_zero_sum(state, "B7 league evaluation", T_LEAGUE)
    log(f"B7 league (es3 at even seats, policy_6max_200 at odd): {lg_h} "
        f"hands, seats {np.array2string(lg_m, precision=4)} bb/hand, es3's "
        f"seat mean {lg_m[0::2].mean():+.4f}")
    idx = torch.tensor(PLAIN_CANDIDATES, device=dev)
    for key, k, w, seats, stb in (("B8", k8, w8, 1, None),
                                  ("B8l", k8l, w8l, all_seats, seat0)):
        p, plain_ms[key] = timed(lambda: cn._run_net_eval_plain_philox(
            TRAIN_SEED, pop0[idx], w[idx], P, TRAIN_SLOTS, SB, BB, SS,
            "standard", seats, True, stb))
        agree(key, f"candidates {PLAIN_CANDIDATES} of {TRAIN_POP}, "
              f"{T_TRAIN} tables x {TRAIN_SLOTS} slots", k[idx], p)
    del p

    # path d: tournament K3; the completion run replayed launch by launch
    # from its first state (the main path's launches), its first and last
    # launch against the plain version on the same input state; B3's flop
    # call at full size (through the wrapper's formula), and preflop on
    # N_MW_PLAIN rollouts (its first rollouts: a rollout's words depend on
    # its index alone)
    p, plain_ms["K3t"] = timed(lambda: ce._run_det_plain(
        st_full_tour, acts_full, cards_full, P, DET_STEPS, SB, BB,
        "tournament"))
    agree("K3t", f"tournament rules, {TOUR_STACK}-chip stacks, {T_FULL} "
          f"tables x {DET_STEPS} steps", det_tour, p)
    del p
    n_tour = tour_steps // TOUR_LAUNCH
    st_tour0 = ce.pack_state(tour, ce.first_deal(SEED, T_FULL, P, dev))
    state = st_tour0
    # every launch of the replay timed (CUDA events), with the tables
    # still live when it starts
    tour_launch_ms, tour_live = [], []
    for i in range(n_tour):
        seed = (SEED + i * TOUR_LAUNCH * 7919) & 0x7FFFFFFF
        tour_live.append(int(((ce.unpack_field(state, tour, "order") != 0)
                              | (ce.unpack_field(state, tour, "wait") != 0))
                             .sum()))
        k, ms = timed(lambda: ce.run_perpetual_prng(
            seed, state, P, TOUR_LAUNCH, SB, BB, rules="tournament"))
        tour_launch_ms.append(ms)
        if i in (0, n_tour - 1):
            p, ms = timed(lambda: ce._run_prng_plain_philox(
                seed, state, P, TOUR_LAUNCH, SB, BB, "tournament"))
            plain_ms.setdefault("K4t", ms)
            agree("K4t", f"completion launch {i + 1} of {n_tour}, {T_FULL} "
                  f"tables x {TOUR_LAUNCH} slots", k, p)
            del p
        if i == 0:
            k4t_first = k
        if i == n_tour - 1:
            tour_last = (seed, state)
        state = k
    check(torch.equal(state, tour_state),
          "K4t: the launches replayed give the main path's final state")
    log(f"K4t: the completion run's {n_tour} launches (CUDA events, ms): "
        f"{[round(x, 3) for x in tour_launch_ms]}, sum "
        f"{sum(tour_launch_ms):.3f} ms; live tables at each launch "
        f"{tour_live}")
    del state, k
    mw_masks = {"preflop": cq._multiway_masks(MW_TRIO, (), dev),
                "flop": cq._multiway_masks(MW_FLOP_HANDS, MW_FLOP, dev)}
    dead, hm = mw_masks["flop"]
    p = cq._multiway_shares_plain_philox(SEED + 4, dead.tolist(),
                                         hm.tolist(), N_FLOP, dev,
                                         chunk=PLAIN_CHUNK)
    agree("B3", f"main path flop, {N_FLOP} rollouts", mw["flop"][0],
          p.cpu().numpy() / (cq.multiway_scale(3) * N_FLOP))
    dead, hm = mw_masks["preflop"]
    p, plain_ms["B3"] = timed(lambda: cq._multiway_shares_plain_philox(
        SEED + 3, dead.tolist(), hm.tolist(), N_MW_PLAIN, dev,
        chunk=PLAIN_CHUNK))
    agree("B3", f"preflop, the main path's first {N_MW_PLAIN} rollouts",
          cq.multiway_shares(SEED + 3, dead, hm, N_MW_PLAIN), p)
    del p

    # the words option: injected words instead of Philox
    dead, hm = mw_masks["preflop"]
    words = cq.random_words(g, (5, PLAIN_CHUNK), dev)
    agree("B3", f"injected words, {PLAIN_CHUNK} rollouts",
          cq.multiway_shares(0, dead, hm, PLAIN_CHUNK, words=words),
          cq._multiway_shares_plain(words, dead.tolist(), hm.tolist()))
    dead, hm = mw_masks["flop"]
    words = cq.random_words(g, (2, PLAIN_CHUNK), dev)
    agree("B3", f"flop, injected words, {PLAIN_CHUNK} rollouts",
          cq.multiway_shares(0, dead, hm, PLAIN_CHUNK, words=words),
          cq._multiway_shares_plain(words, dead.tolist(), hm.tolist()))
    # K1 in each of its forms (NDRAW 5, 2, 1) on injected words, and the
    # turn's form (on no main path) in Philox mode too
    turn = cq._hand_masks(AKS, QQ, FLOP + [teq.make_card(0, 9)], dev)
    for name, (dead, hm, vm) in (("preflop", pre), ("flop", flop),
                                 ("turn", turn)):
        words = cq.random_words(g, (9 - dead.shape[0], PLAIN_CHUNK), dev)
        agree("K1", f"{name}, injected words, {PLAIN_CHUNK} rollouts",
              cq.equity_counts(0, dead, hm, vm, PLAIN_CHUNK, words=words),
              cq._equity_counts_plain(words, dead.tolist(), hm.tolist(),
                                      vm.tolist()))
    agree("K1", f"turn, {PLAIN_CHUNK} rollouts",
          cq.equity_counts(SEED + 6, *turn, PLAIN_CHUNK),
          k1_plain(SEED + 6, turn, PLAIN_CHUNK))
    words = cq.random_words(g, (7, 169, 1 << 16), dev)
    agree("K2", "injected words, 169 x 65536 rollouts",
          cq.sweep_counts(0, sdead, smask, 1 << 16, words=words),
          cq._sweep_counts_plain(words, sdead, smask))
    words = cq.random_words(g, ce.prng_words_shape(T_FULL, P, 32), dev)
    agree("K4", f"injected words, {T_FULL} tables x 32 slots",
          ce.run_perpetual_prng(0, st_sp, P, 32, SB, BB, words=words),
          ce._run_prng_plain(st_sp, words, P, 32, SB, BB))
    del words
    phase_done("3 agreement")

    # ---- 4. timing ------------------------------------------------------
    # K2 timed once more before the sampler starts, as the A/B times it
    # (median of 5): the gap between this script's K2 time and the A/B's
    k2_quiet_ms = cuda_ms(
        lambda: cq.sweep_counts(SEED + 2, sdead, smask, N_SWEEP), 5)
    # the card's SM clock, power draw and temperature, sampled every 100 ms
    # while the calls are timed (each call's window logged below); the
    # sampler is killed at exit if a check fails first
    smi_out = tempfile.TemporaryFile("w+")
    smi_proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=smi_out, stderr=subprocess.DEVNULL, text=True)
    atexit.register(smi_proc.kill)
    windows = {}
    dead, hm, vm = pre
    timings = {
        "K1": lambda: cq.equity_counts(SEED, dead, hm, vm, N_EQUITY),
        "K1f": lambda: cq.equity_counts(SEED + 1, *flop, N_FLOP),
        "K2": (lambda: cq.sweep_counts(SEED + 2, sdead, smask, N_SWEEP), 2),
        "K3": lambda: ce.run_perpetual_det(
            st_full, acts_full, cards_full, P, DET_STEPS, SB, BB),
        "K4": lambda: ce.run_perpetual_prng(SEED, st_sp, P, SP_SLOTS, SB,
                                            BB),
        "K3s": lambda: ce.run_perpetual_det(
            st_full_std, acts_full, cards_full, P, DET_STEPS, SB, BB,
            rules="standard"),
        "K4s": lambda: ce.run_perpetual_prng(
            SEED, st_sp_std, P, SP_SLOTS, SB, BB, rules="standard"),
        "K5": lambda: cn.run_net_det(
            st_net_det, stash_net, w_bot, P, NET_DET_STEPS, SB, BB,
            "standard"),
        "K6": lambda: cn.run_net_eval(
            SEED, st_net0, w_es3, P, NET_LAUNCH, SB, BB, SS, "standard", 1),
        "K5b": lambda: cn.run_net_det(
            st_net_det, stash_net, w_det_banks, P, NET_DET_STEPS, SB, BB,
            "standard", seat0),
        "B7": lambda: cn.run_net_league(
            SEED, st_league0, w7, P, NET_LAUNCH, SB, BB, SS, "standard",
            all_seats, parity),
        "B8": lambda: cn.run_net_eval_pop(
            TRAIN_SEED, pop0, w8, P, TRAIN_SLOTS, SB, BB, SS, "standard", 1),
        "B8l": lambda: cn.run_net_eval_pop(
            TRAIN_SEED, pop0, w8l, P, TRAIN_SLOTS, SB, BB, SS, "standard",
            all_seats, seat0),
        "B3": lambda: cq.multiway_shares(
            SEED + 3, *mw_masks["preflop"], N_EQUITY),
        "B3f": lambda: cq.multiway_shares(
            SEED + 4, *mw_masks["flop"], N_FLOP),
        "K3t": lambda: ce.run_perpetual_det(
            st_full_tour, acts_full, cards_full, P, DET_STEPS, SB, BB,
            rules="tournament"),
        "K4t": lambda: ce.run_perpetual_prng(
            SEED, st_tour0, P, TOUR_LAUNCH, SB, BB, rules="tournament"),
        "F1": lambda: ce.first_state(SEED, std, T_FULL, dev),
    }
    times = {}
    for key, job in timings.items():
        fn, reps = job if isinstance(job, tuple) else (job, 3)
        t0 = time.time()
        times[key] = cuda_ms(fn, reps)
        windows[key] = (t0, time.time())
    k4t_last_ms = cuda_ms(lambda: ce.run_perpetual_prng(
        tour_last[0], tour_last[1], P, TOUR_LAUNCH, SB, BB,
        rules="tournament"))
    log(f"K4t: the completion run's last launch (most tables frozen) "
        f"{k4t_last_ms:.3f} ms against the first's {times['K4t']:.3f} ms")
    # ptxas per instantiation of the engine kernels (the p6 library's
    # build.log) beside the main path's time of the call
    ptxas = _build.ptxas_report((builds[1][0].parent / "build.log")
                                .read_text())
    rule_key = {"0": "", "1": "s", "2": "t"}
    for name, rep in sorted(ptxas.items()):
        m = re.search(r"mc_engine_(det|prng)_kernelILi6ELi(\d)E(Lb(\d)E)?",
                      name)
        f = re.search(r"mc_first_state_kernelILi6ELi(\d)E", name)
        if f:
            log(f"ptxas F1 {ce.RULES[int(f.group(1))]}: {rep['registers']} "
                f"registers, {rep['stack']} B stack, {rep['spill_stores']} "
                f"B spill stores, {rep['spill_loads']} B spill loads")
        if not m:
            continue
        key = ("K3" if m.group(1) == "det" else "K4") + rule_key[m.group(2)]
        form = "" if m.group(1) == "det" else (
            " (injected words)" if m.group(4) == "1" else " (Philox)")
        shown = f"{times[key]:.3f} ms" if m.group(4) != "1" else "-"
        log(f"ptxas {key}{form}: {rep['registers']} registers, "
            f"{rep['stack']} B stack, {rep['spill_stores']} B spill stores, "
            f"{rep['spill_loads']} B spill loads; main-path call {shown}")
    # K3's warp schedule (csrc/engine.cuh, mc_run_det) in plain PyTorch on
    # the first K3_SCHEDULE_TABLES tables of each K3 call: its state equals
    # K3's there, and its counts a warp (the passes that step a table, the
    # settle passes) stand beside the plain schedule's steps with a settle
    # pass and the kernel's time
    nb = K3_SCHEDULE_TABLES // 1024
    for key, st_in, rules, k3_out in (
            ("K3", st_full, "reference", det_out),
            ("K3s", st_full_std, "standard", det_std),
            ("K3t", st_full_tour, "tournament", det_tour)):
        twin, c = ce._run_det_warps(st_in[:nb], acts_full[:nb],
                                    cards_full[:nb], P, DET_STEPS, SB, BB,
                                    rules)
        check(torch.equal(twin, k3_out[:nb]),
              f"{key}: the warp schedule in plain PyTorch equals K3 on the "
              f"first {K3_SCHEDULE_TABLES} tables")
        w = c["warps"]
        log(f"{key} schedule, MC_DET_SETTLE_MIN {ce.DET_SETTLE_MIN}, "
            f"{K3_SCHEDULE_TABLES} tables: a warp {c['iterations'] / w:.2f} "
            f"passes that step and {c['settle_passes'] / w:.2f} settle "
            f"passes, where the plain schedule takes {DET_STEPS} steps, "
            f"{c['plain_settle_steps'] / w:.2f} with a settle pass; kernel "
            f"{times[key]:.3f} ms")
    # ptxas per instantiation of the equity kernels (the common library's
    # build.log): K1's forms and K2 beside their main-path calls, B3's at
    # N = 3, and the range over all of B3's
    eq_ptxas = _build.ptxas_report((builds[0][0].parent / "build.log")
                                   .read_text())

    def ptxas_line(rep):
        return (f"{rep['registers']} registers, {rep['stack']} B stack, "
                f"{rep['spill_stores']} B spill stores, "
                f"{rep['spill_loads']} B spill loads")

    main_call = {("K1", 5): "K1", ("K1", 2): "K1f", ("B3", 5): "B3",
                 ("B3", 2): "B3f"}
    b3 = []
    for name, rep in sorted(eq_ptxas.items()):
        m = re.search(
            r"mc_(equity|multiway)_kernelI(?:Li(\d+)E)?Li(\d)ELb(\d)E", name)
        k2 = re.search(r"mc_sweep_kernelILb(\d)E", name)
        if k2:
            inject = k2.group(1) == "1"
            shown = "-" if inject else f"{times['K2']:.3f} ms"
            blocks, per_sm = cq.sweep_grid(169, N_SWEEP if not inject
                                           else 1 << 16, inject)
            log(f"ptxas K2 ({'injected words' if inject else 'Philox'}): "
                f"{ptxas_line(rep)}; {per_sm} blocks an SM, {blocks} blocks "
                f"a hand at 169 x {1 << 16 if inject else N_SWEEP}; "
                f"main-path call {shown}")
        if not m:
            continue
        kernel = "K1" if m.group(1) == "equity" else "B3"
        if kernel == "B3":
            b3.append(rep)
            if m.group(2) != "3":
                continue
        key = main_call.get((kernel, int(m.group(3))))
        shown = f"{times[key]:.3f} ms" if key and m.group(4) == "0" else "-"
        hands = f"N = {m.group(2)}, " if m.group(2) else ""
        log(f"ptxas {kernel} ({hands}NDRAW {m.group(3)}, "
            f"{'injected words' if m.group(4) == '1' else 'Philox'}): "
            f"{ptxas_line(rep)}; main-path call {shown}")
    log(f"ptxas B3, all {len(b3)} instantiations: "
        f"{min(r['registers'] for r in b3)}-"
        f"{max(r['registers'] for r in b3)} registers, at most "
        f"{max(r['stack'] for r in b3)} B stack and "
        f"{max(r['spill_stores'] for r in b3)} B spill stores")
    # the net kernels' block phase: ptxas per instantiation, and per form
    # the shared bytes a block and the blocks an SM
    for name, rep in sorted(ptxas.items()):
        m = re.search(r"mc_net_(det|eval|probe)_kernelILi6ELi(\d)E", name)
        if m:
            log(f"ptxas net_{m.group(1)} ({cn.RULES[int(m.group(2))]} "
                f"rules): {rep['registers']} registers, {rep['stack']} B "
                f"stack, {rep['spill_stores']} B spill stores, "
                f"{rep['spill_loads']} B spill loads")
    for key, kernel, n_banks, n_cand in (
            ("K5", "det", 1, 1), ("K5b", "det", 2, 1), ("K6", "eval", 1, 1),
            ("B7", "eval", 2, 1), ("B8", "eval", 1, TRAIN_POP),
            ("B8l", "eval", 2, TRAIN_POP), ("probe", "probe", 1, 1)):
        smem, blocks = cn.net_occupancy(kernel, P, "standard", n_banks)
        shown = f"{times[key]:.3f} ms" if key in times else "-"
        log(f"{key} (B = {n_banks}, C = {n_cand}): {smem} B of shared "
            f"memory a block, {blocks} blocks an SM; main-path call {shown}")
    # the rollout loop of K2 (both forms) and of K1 preflop in the SASS:
    # its instructions by opcode (the largest backward-branch loop)
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = ecm.sass_loops(subprocess.run(
        [str(cuobjdump), "-sass", str(builds[0][0])], capture_output=True,
        text=True, check=True).stdout)
    for name, loops in sorted(sass.items()):
        m = re.search(r"mc_sweep_kernelILb(\d)E|mc_equity_kernelILi5ELb0E",
                      name)
        if m and loops:
            loop = max(loops, key=lambda c: c["instructions"])
            top = sorted(loop["opcodes"].items(), key=lambda kv: -kv[1])
            form = "injected words" if m.group(1) == "1" else "Philox"
            kernel = ("K1 (NDRAW 5, Philox)" if m.group(1) is None
                      else f"K2 ({form})")
            log(f"SASS {kernel}: rollout loop {loop['instructions']} "
                f"instructions, LDL {loop['ldl']}, STL {loop['stl']}; "
                f"{dict(top)}")
    t0 = time.perf_counter()
    cq.equity_sweep_kernel(SEED + 5, heroes, N_SWEEP, dev)
    sweep_warm_s = time.perf_counter() - t0
    host_ms = sweep_warm_s * 1e3 - times["K2"]
    log(f"sweep169_seconds_warm {sweep_warm_s:.4f} s: K2's kernel "
        f"{times['K2']:.3f} ms, the host {host_ms:.3f} ms; K2 with the "
        f"sampler off (median of 5) {k2_quiet_ms:.3f} ms, on "
        f"{times['K2']:.3f} ms (x{times['K2'] / k2_quiet_ms:.4f})")
    # bench.py's net_eval_hands_per_sec and train_hands_per_sec, from the
    # functions bench.py's net axis calls (the ported
    # bench_net_throughput): hands / host seconds of one 2 x 256-slot
    # evaluation and of one generation of the 32 candidates, each from a
    # state built once (phase 0's), best of 2 after one warm-up
    net_r = bnt.bench_net_eval(std, es3, T_NET, NET_SLOTS, seed=SEED,
                               reps=2, device=dev)
    train_r = bnt.bench_es_generation(std, es3, T_TRAIN, TRAIN_SLOTS,
                                      pop=TRAIN_POP // 2, seed=TRAIN_SEED,
                                      reps=2, device=dev)

    k6_hands = int(ce.unpack_field(k6_first, std, "hand_ct").sum())
    k5_state = T_NET * ce._field_layout(P, "standard")[1] * 4
    work = {  # key: (work of one call, unit, bytes, int ops, f32 ops)
        "K1": (N_EQUITY, "rollouts", 0,
               N_EQUITY * (2 * OPS["philox_block"] + 2 * OPS["hand_key"]), 0),
        "K2": (169 * N_SWEEP, "rollouts", 0,
               169 * N_SWEEP * (2 * OPS["philox_block"]
                                + 2 * OPS["hand_key"]), 0),
    }
    for key, state_in, rules, hands in (
            ("K3", st_full, "reference", det_hands),
            ("K3s", st_full_std, "standard", det_std_hands)):
        work[key] = (T_FULL * DET_STEPS, "table-steps",
                     2 * state_in.numel() * 4 + acts_full.numel() * 4
                     + cards_full.numel() * 4,
                     T_FULL * DET_STEPS * OPS["step"]
                     + hands * P * OPS["hand_key"], 0)
    blocks = -(-SP_SLOTS // ce.DEFER * ce.prng_words_shape(1, P, SP_SLOTS)[1]
               // 4)
    for key, state_in, hands in (("K4", st_sp, sp_hands),
                                 ("K4s", st_sp_std, sp_std_hands)):
        work[key] = (T_FULL * SP_SLOTS, "table-slots",
                     2 * state_in.numel() * 4,
                     hands * OPS["step"]
                     + T_FULL * blocks * OPS["philox_block"]
                     + hands * P * OPS["hand_key"], 0)
    work["K5"] = (T_NET * NET_DET_STEPS, "table-steps",
                  2 * k5_state + stash_net.numel() * 4 + cn.NUM_WEIGHTS * 4,
                  T_NET * NET_DET_STEPS * (OPS["step"] + OPS["features"])
                  + k5_hands * P * OPS["hand_key"],
                  T_NET * NET_DET_STEPS * OPS["mlp_f32"])
    blocks = -(-NET_LAUNCH // ce.DEFER * cn.net_words_shape(
        1, P, NET_LAUNCH)[1] // 4)
    work["K6"] = (T_NET * NET_LAUNCH, "table-slots",
                  2 * k5_state + cn.NUM_WEIGHTS * 4,
                  k6_hands * OPS["step"]
                  + T_NET * blocks * OPS["philox_block"]
                  + k6_hands * P * OPS["hand_key"]
                  + k6_decisions * OPS["features"],
                  k6_decisions * OPS["mlp_f32"])
    k5b_hands = int(ce.unpack_field(k5b_out, std, "hand_ct").sum())
    work["K5b"] = (T_NET * NET_DET_STEPS, "table-steps",
                   2 * k5_state + stash_net.numel() * 4
                   + w_det_banks.numel() * 4,
                   T_NET * NET_DET_STEPS * (OPS["step"] + OPS["features"])
                   + k5b_hands * P * OPS["hand_key"],
                   T_NET * NET_DET_STEPS * OPS["mlp_f32"])
    # B7 and B8: the timed launch is the main path's first (B8: only)
    # launch; its hands and the net decisions the kernel counted. Every
    # candidate's table t derives the same words, counted once.
    state_bytes = ce._field_layout(P, "standard")[1] * 4
    b7_hands = int(ce.unpack_field(b7_first, std, "hand_ct").sum())
    b7_dec = int(decisions["B7"])
    work["B7"] = (T_LEAGUE * NET_LAUNCH, "table-slots",
                  2 * T_LEAGUE * state_bytes + w7.numel() * 4,
                  b7_hands * OPS["step"]
                  + T_LEAGUE * blocks * OPS["philox_block"]
                  + b7_hands * P * OPS["hand_key"]
                  + b7_dec * OPS["features"], b7_dec * OPS["mlp_f32"])
    for key, hands, w in (("B8", int(pop_h.sum()), w8),
                          ("B8l", int(lpop_h.sum()), w8l)):
        dec = int(decisions[key])
        work[key] = (TRAIN_POP * T_TRAIN * TRAIN_SLOTS, "table-slots",
                     2 * TRAIN_POP * T_TRAIN * state_bytes + w.numel() * 4,
                     hands * OPS["step"]
                     + T_TRAIN * blocks * OPS["philox_block"]
                     + hands * P * OPS["hand_key"] + dec * OPS["features"],
                     dec * OPS["mlp_f32"])
    # path d. B3: per rollout N hand keys and the Philox blocks of its
    # 5 - K words; K3t as K3; K4t: the timed first launch of the
    # completion run, with the hands it completed
    work["B3"] = (N_EQUITY, "rollouts", 0,
                  N_EQUITY * (len(MW_TRIO) * OPS["hand_key"]
                              + 2 * OPS["philox_block"]), 0)
    work["K3t"] = (T_FULL * DET_STEPS, "table-steps",
                   2 * st_full_tour.numel() * 4 + acts_full.numel() * 4
                   + cards_full.numel() * 4,
                   T_FULL * DET_STEPS * OPS["step"]
                   + det_tour_hands * P * OPS["hand_key"], 0)
    k4t_hands = int(ce.unpack_field(k4t_first, tour, "hand_ct").sum())
    blocks_t = -(-TOUR_LAUNCH // ce.DEFER
                 * ce.prng_words_shape(1, P, TOUR_LAUNCH)[1] // 4)
    work["K4t"] = (T_FULL * TOUR_LAUNCH, "table-slots",
                   2 * st_tour0.numel() * 4,
                   k4t_hands * OPS["step"]
                   + T_FULL * blocks_t * OPS["philox_block"]
                   + k4t_hands * P * OPS["hand_key"], 0)
    # F1: the state written once; per table the Philox blocks of its 2P+5
    # words and one deal (P = 6: 17 cards)
    work["F1"] = (T_FULL, "tables",
                  T_FULL * ce._field_layout(P, "standard")[1] * 4,
                  T_FULL * (-(-(2 * P + 5) // 4) * OPS["philox_block"]
                            + OPS["deal"]), 0)
    # the plain versions' work where it is not the kernel call's: B8's on
    # four candidates, B3's preflop on N_MW_PLAIN rollouts
    plain_work = {k: len(PLAIN_CANDIDATES) * T_TRAIN * TRAIN_SLOTS
                  for k in ("B8", "B8l")}
    plain_work["B3"] = N_MW_PLAIN
    log(f"net decisions counted by the kernels: K6 {k6_decisions}, B7 "
        f"{b7_dec}, B8 {int(decisions['B8'])}, B8 two banks "
        f"{int(decisions['B8l'])}")
    bounds = {key: bound(*w[2:]) for key, w in work.items()}
    for key, (n, unit, *_rest) in work.items():
        log(f"{key}: kernel {times[key]:.3f} ms, plain {plain_ms[key]:.3f} "
            f"ms, bound {bounds[key][0]:.3f} ms ({bounds[key][1]}) for {n} "
            f"{unit} ({times[key] * 1e6 / n:.4f} / "
            f"{plain_ms[key] * 1e6 / plain_work.get(key, n):.4f} ns each)")
    rates = {
        "equity_rollouts_per_sec": N_EQUITY / (times["K1"] / 1e3),
        "sweep169_seconds_warm": sweep_warm_s,
        "betting_hands_per_sec": sp_hands / (times["K4"] / 1e3),
        "betting_steps_per_hand": slots_per_hand,
        "betting_ns_per_table_step": times["K4"] * 1e6 / (T_FULL * SP_SLOTS),
        "det_ns_per_table_step": times["K3"] * 1e6 / (T_FULL * DET_STEPS),
        "standard_betting_steps_per_hand": sp_std_sph,
        **{k: net_r[k] for k in (
            "net_eval_hands_per_sec", "net_eval_ns_per_table_step",
            "net_eval_seconds", "net_eval_hands")},
        **{k: train_r[k] for k in (
            "train_hands_per_sec", "train_pop", "train_seconds",
            "train_hands")},
        # port only: B3 preflop, 3 hands, one launch of 2^30 rollouts; 2^20
        # 6-max tournaments from 100-chip stacks run to completion, host
        # seconds of tournaments_to_completion (first deal included)
        "multiway_rollouts_per_sec": N_EQUITY / (times["B3"] / 1e3),
        "tournaments_per_sec": T_FULL / tour_s,
        "tournament_seconds": tour_s,
        "tournament_slots": tour_steps,
    }
    log(json.dumps({"card": smi, **rates}))
    smi_proc.terminate()
    smi_proc.wait(timeout=60)
    smi_out.seek(0)
    samples = []
    for line in smi_out:
        stamp, *fields = line.split(",")
        try:  # a field nvidia-smi could not read is left out
            t = datetime.strptime(stamp.strip(), "%Y/%m/%d %H:%M:%S.%f")
            samples.append((t.timestamp(), [float(x) for x in fields]))
        except ValueError:
            continue
    smi_out.close()
    log(f"nvidia-smi: {len(samples)} samples of SM clock, power and "
        f"temperature over the timing")
    for key, (t0, t1) in windows.items():
        rows = [v for t, v in samples if t0 <= t <= t1]
        if rows:
            clk, pw, temp = np.asarray(rows).T
            log(f"nvidia-smi over {key}'s timing ({len(rows)} samples): SM "
                f"clock {clk.min():.0f}/{np.median(clk):.0f}/{clk.max():.0f} "
                f"MHz (min/median/max), power {np.median(pw):.1f}/"
                f"{pw.max():.1f} W (median/max), temperature "
                f"{temp.max():.0f} C")
    phase_done("4 timing")

    # ---- 5. the probes (path e): carry model and engine stages ----------
    builds = stage_job.result()
    stage_pool.shutdown()
    for b in builds:
        log(f"stage {b.variant}: nvcc {b.seconds:.2f} s (its own build), "
            f"ptxas {b.ptxas}")
    g5 = torch.Generator(device=dev).manual_seed(SEED + 5)
    stage_in = {STAGE_BLOCKS: det_out[:STAGE_BLOCKS].clone(),
                T_FULL // 1024: det_out}
    reset_counts()
    t0 = time.perf_counter()
    carry_ns, carry_x, carry_out = {}, {}, {}
    for form in cc.FORMS:
        for R in cc.R_OF[form]:
            # words that wrap, so that the plain version's int32 wrap is
            # held too
            x = torch.randint(-2**31, 2**31, (ecm.N_BLOCKS, R, 8, 128),
                              generator=g5, dtype=torch.int64,
                              device=dev).to(torch.int32)
            carry_ns[form, R], out = ecm.time_call(form, x, ecm.N_STEPS)
            if R == 141:
                carry_x[form], carry_out[form] = x, out
            else:
                p = cc._carry_plain(x, ecm.N_STEPS)
                agree(f"carry_{form}_R{R}", f"{ecm.N_BLOCKS} blocks x "
                      f"{ecm.N_STEPS} steps", out, p)
                del p
            del x, out
    # a folded step loop takes the same time at any step count
    half = ecm.N_STEPS // 2
    ns_half, out_half = ecm.time_call("array", carry_x["array"], half)
    stage_res = {(name, nb): dkc.compile_variant(
        name, STAGE_STEPS, nb, state=st_in, seed=SEED, rebuild=False)
        for name in cs.STAGES for nb, st_in in stage_in.items()}
    sync()
    probe_s = time.perf_counter() - t0
    probe_launches = {**cc.LAUNCHES, **cs.LAUNCHES}
    log(f"main path (the probes): {probe_s:.2f} s, launches "
        f"{probe_launches}")
    check(all(v > 0 for v in probe_launches.values()),
          "every probe kernel launched")

    carry_ms = {k: ns * 1e-6 * T_FULL * ecm.N_STEPS
                for k, ns in carry_ns.items()}
    for form in cc.FORMS:
        key = f"carry_{form}_R141"
        p, plain_ms[key] = timed(lambda: cc._carry_plain(carry_x[form],
                                                         ecm.N_STEPS))
        agree(key, f"{ecm.N_BLOCKS} blocks x {ecm.N_STEPS} steps",
              carry_out[form], p)
        del p
    agree("carry_array_R141", f"{half} steps", out_half,
          cc._carry_plain(carry_x["array"], half))
    ratio = ns_half * half / (carry_ns["array", 141] * ecm.N_STEPS)
    log(f"carry_array R = 141: {half} steps take {ratio:.4f} of "
        f"{ecm.N_STEPS} steps' time")
    check(0.4 <= ratio <= 0.6, "carry_array: the time follows the steps "
          "(the step loop is not folded)")
    sass = ecm.sass_check()
    for name, loops in sorted(sass.items()):
        m = re.search(r"mc_carry_(array|dict|ref)_kernelILi(\d+)E", name)
        if not m:
            continue
        form, R = m.group(1), int(m.group(2))
        step = max(loops, key=lambda c: c["adds"])  # the step loop
        log(f"SASS {form} R = {R}: step loop {step}")
        check(step["adds"] >= (1 if form == "dict" else R)
              and (form != "ref" or step["ldg"] >= R <= step["stg"])
              and (form != "dict" or step["ldl"] >= 1 <= step["stl"]),
              f"SASS {form} R = {R}: the step loop keeps its adds and "
              f"memory operations")
    lib_x = carry_x["array"]
    _, library_ms = timed(lambda: lib_x + ecm.N_STEPS)
    log(f"library: x + {ecm.N_STEPS} (the output only, none of the "
        f"carried steps) {library_ms:.3f} ms")
    carry_rows = {f"{f}_R{R}": carry_ns[f, R] for f, R in carry_ns}
    log(json.dumps({"carry_ns_per_table_step": carry_rows,
                    "card": smi}))
    spills = [R for R in cc.R_ARRAY if _build.ptxas_report(
        (_build.carry_library_path().parent / "build.log").read_text())
        [f"_Z21mc_carry_array_kernelILi{R}EEvPKiPiii"]["spill_stores"] > 0]
    log(f"carry_array spills from R = {min(spills) if spills else None}")
    del carry_x, carry_out, out_half, lib_x

    k3_ns = times["K3"] * 1e6 / (T_FULL * DET_STEPS)
    stage_rows = {}
    for (name, nb), r in stage_res.items():
        T = nb * 1024
        key = f"stage_{name}_{nb}"
        st_in = stage_in[nb]
        p, plain_ms[key] = timed(lambda: cs._run_stage_plain(
            name, st_in, lambda i: cs.stage_words(SEED, T, name, P, i, dev),
            P, STAGE_STEPS, SB, BB))
        agree(key, f"{nb} blocks x {STAGE_STEPS} steps", r["out"], p)
        check(not torch.equal(r["out"], st_in), f"{key}: the stage changed "
              f"the state")
        stage_rows[key] = {k: r.get(k) for k in (
            "nvcc_s", "registers", "stack", "spill_stores", "spill_loads",
            "ms", "ns_per_table_step")}
        del p
    log(json.dumps({"stages": stage_rows, "card": smi}))
    full_ns = stage_res["full", T_FULL // 1024]["ns_per_table_step"]
    log(f"stage full {full_ns:.4f} ns/table-step against K3 reference "
        f"{k3_ns:.4f} (x {full_ns / k3_ns:.2f})")
    paid = field_sum(stage_res["settle", T_FULL // 1024]["out"], cfg,
                     "stacks", P) - field_sum(det_out, cfg, "stacks", P)
    log(f"stage settle: {int((paid != 0).sum())} of {T_FULL} tables paid "
        f"out chips")
    check(int((paid != 0).sum()) > 0, "stage settle paid out chips")

    # bounds: carry R adds per table-step against the words once each way;
    # a stage's operations per table-step (full: plus the hands it
    # settled) against the state once each way
    def stage_ops(name, out, st_in):
        W = cs.words_per_step(name, P) / 4 * OPS["philox_block"]
        per_step = {"carry": 1, "policy": OPS["policy"],
                    "street": OPS["policy"] + 6, "deal": OPS["deal"],
                    "settle": P * OPS["hand_key"] + 4 * 6 * P,
                    "full": OPS["policy"] + OPS["deal"] + OPS["step"]}[name]
        hands = int((ce.unpack_field(out, cfg, "hand_ct")
                     - ce.unpack_field(st_in, cfg, "hand_ct")).sum()) \
            if name == "full" else 0
        return (W + per_step) * st_in.shape[0] * 1024 * STAGE_STEPS \
            + hands * P * OPS["hand_key"]

    for form in cc.FORMS:
        key = f"carry_{form}_R141"
        times[key] = carry_ms[form, 141]
        work[key] = (T_FULL * ecm.N_STEPS, "table-steps",
                     2 * 141 * 4 * T_FULL, 141 * ecm.N_STEPS * T_FULL, 0)
        launches[key] = probe_launches[key]
    for name in cs.STAGES:
        nb = T_FULL // 1024
        key = f"stage_{name}_{nb}"
        r = stage_res[name, nb]
        times[key] = r["ms"]
        work[key] = (T_FULL * STAGE_STEPS, "table-steps",
                     2 * stage_in[nb].numel() * 4,
                     stage_ops(name, r["out"], stage_in[nb]), 0)
        launches[key] = probe_launches[f"stage_{name}"]
    bounds = {key: bound(*w[2:]) for key, w in work.items()}
    for key in [k for k in work if k.startswith(("carry_", "stage_"))]:
        log(f"{key}: kernel {times[key]:.3f} ms, plain {plain_ms[key]:.3f} "
            f"ms, bound {bounds[key][0]:.3f} ms ({bounds[key][1]})")
    check(times["carry_array_R141"] >= bounds["carry_array_R141"][0],
          "carry_array R = 141 takes at least its operation bound")
    del stage_res, stage_in
    phase_done("5 probes")

    # ---- 6. range equity and push/fold (path f) ---------------------------
    # plain PyTorch on the card: no kernel launches
    reset_counts()
    labels, hero_reps, _, _ = pf._representatives()
    combos, cls = pf._all_combos()
    with np.load(ROOT / "data" / "pushfold_eq169_cr.npz") as d:
        cr_eq, cr_pairs = d["equity"], d["n_pairs"]
    with np.load(ROOT / "data" / "pushfold_eq169_exact.npz") as d:
        exact_eq = d["equity"]
    f_s = {}
    t0 = time.perf_counter()
    rows = [labels.index(x) for x in PF_CR_HEROES]
    res = teq.equity_exact_range_vs_range(hero_reps[rows], combos,
                                          elem_budget=1 << 27, device=dev)
    cr_rows = pf._class_equity(res, cls)
    f_s["cr_rows"] = time.perf_counter() - t0
    diff = np.abs(cr_rows - cr_eq[rows]).max()
    log(f"path f: card-removal rows {PF_CR_HEROES} vs all 1326 combos over "
        f"{res.n_boards} boards a pair (all C(52, 5) masked): "
        f"{f_s['cr_rows']:.2f} s, max |diff| against "
        f"data/pushfold_eq169_cr.npz {diff!r}")
    check(np.array_equal(cr_rows, cr_eq[rows]),
          "path f: the card-removal rows equal data/pushfold_eq169_cr.npz's")
    check(np.array_equal(pf.matchup_pair_counts(), cr_pairs),
          "path f: the pair counts equal data/pushfold_eq169_cr.npz's")
    t0 = time.perf_counter()
    rows = [labels.index(x) for x in PF_EXACT_HEROES]
    ex_rows = pf._exact_rows(rows, device=dev)
    f_s["exact_rows"] = time.perf_counter() - t0
    diff = np.abs(ex_rows - exact_eq[rows]).max()
    log(f"path f: exact matrix rows {PF_EXACT_HEROES} x 169 over all "
        f"C(48, 5) boards: {f_s['exact_rows']:.2f} s, max |diff| against "
        f"data/pushfold_eq169_exact.npz {diff!r}")
    check(np.array_equal(ex_rows, exact_eq[rows]),
          "path f: the exact rows equal data/pushfold_eq169_exact.npz's")
    t0 = time.perf_counter()
    mc_eq = pf.matchup_equity_matrix(SEED, n_per=PF_MC_BOARDS, device=dev)
    f_s["mc_matrix"] = time.perf_counter() - t0
    # Each matchup draws boards of its own, so each entry is an independent
    # estimate, its variance at most p (1 - p) / n (ties lower it): the sum
    # of the entries' z^2 sees every entry, the z of the strict upper
    # triangle's sum a bias between hero and villain.
    z_e = (mc_eq - exact_eq) / np.sqrt(
        exact_eq * (1 - exact_eq) / PF_MC_BOARDS)
    chi2, n_e = float((z_e ** 2).sum()), z_e.size
    up = z_e[np.triu_indices(169, 1)]
    z_up = up.sum() / np.sqrt(up.size)
    log(f"path f: Monte Carlo matrix, {PF_MC_BOARDS} boards a matchup: "
        f"{f_s['mc_matrix']:.2f} s, sum of z^2 {chi2:.1f} over {n_e} "
        f"entries (limit {n_e + 4 * np.sqrt(2 * n_e):.1f}), max |z| "
        f"{np.abs(z_e).max():.3f}, upper-triangle z {z_up:+.3f}, max |diff| "
        f"{np.abs(mc_eq - exact_eq).max():.4f}")
    check(chi2 < n_e + 4 * np.sqrt(2 * n_e) and abs(z_up) < 4,
          "path f: every entry of the Monte Carlo matrix within its noise "
          "of the exact one (sum of z^2 within 4 sigma), no bias")
    aks = [teq.make_card(0, 14), teq.make_card(0, 13)]
    qk = teq.expand_range(["QQ", "KK"])
    t0 = time.perf_counter()
    mc = teq.equity_vs_range(SEED, aks, qk, N_RANGE, device=dev)
    f_s["vs_range"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = teq.equity_exact_vs_range(aks, qk, device=dev)
    f_s["exact_vs_range"] = time.perf_counter() - t0
    log(f"path f: AKs vs QQ+KK, equity_vs_range {mc.equity:.6f} +- "
        f"{mc.stderr:.6f} ({N_RANGE} rollouts, {f_s['vs_range']:.2f} s), "
        f"exact {ex.equity:.6f} ({f_s['exact_vs_range']:.2f} s), z "
        f"{(mc.equity - ex.equity) / mc.stderr:+.3f}")
    check(mc.n == N_RANGE and abs(mc.equity - ex.equity) < 4 * mc.stderr,
          "path f: equity_vs_range within 4 sigma of equity_exact_vs_range")
    slots = teq.sample_distinct(SEED, 48, 5, N_DISTINCT, device=dev)
    check(torch.equal(slots.cpu(), teq.sample_distinct(
        SEED, 48, 5, N_DISTINCT, device="cpu")),
        "path f: sample_distinct gives the same slots on the card and on "
        "the CPU")
    with open(ROOT / "data" / "pushfold_ranges_cr.json") as f:
        book = json.load(f)["stacks_bb"][str(PF_STACK_BB)]
    sol = pf.solve_push_fold_cr(cr_eq, cr_pairs, PF_STACK_BB)
    log(f"path f: {PF_STACK_BB} bb card-removal Nash: jam "
        f"{sol.jam_fraction!r}, call {sol.call_fraction!r} (the committed "
        f"ranges: {book['jam_fraction']!r}, {book['call_fraction']!r})")
    check(sol.jam_fraction == book["jam_fraction"]
          and sol.call_fraction == book["call_fraction"]
          and round(sol.jam_fraction, 4) == 0.5825
          and round(sol.call_fraction, 4) == 0.3738
          and sol.jam_range() == book["jam"]
          and sol.call_range() == book["call"],
          f"path f: the {PF_STACK_BB} bb equilibrium equals "
          f"data/pushfold_ranges_cr.json's")
    t0 = time.perf_counter()
    hands, table = every_hand_keys(device=dev)
    table = table.cpu().numpy()
    f_s["every_hand"] = time.perf_counter() - t0
    n_packed = len(np.unique(table[:, 0]))
    n_cmp = len(np.unique(table[:, 1]))
    digest = fnv1a_digest(table)
    log(f"path f: evaluator on the card, {hands} hands "
        f"({f_s['every_hand']:.2f} s): {n_packed} packed keys, {n_cmp} cmp "
        f"keys, {len(table)} pairs, digest {digest}")
    check(hands == EVAL_HANDS and n_packed == n_cmp == len(table) == EVAL_KEYS
          and bool((np.diff(table[:, 1]) > 0).all())
          and digest == EVAL_DIGEST,
          "path f: every hand's keys form the certified table")
    f_launches = {**cq.LAUNCHES, **ce.LAUNCHES, **cn.LAUNCHES, **cc.LAUNCHES,
                  **cs.LAUNCHES, **philox.LAUNCHES}
    check(not any(f_launches.values()), "path f launches no kernel")
    log(json.dumps({"path_f_seconds": f_s, "card": smi}))
    del res, cr_rows, mc_eq, slots, table
    phase_done("6 range equity and push/fold")
    # ---- 7. the table engine (path g) ------------------------------------
    # plain PyTorch on the card (the port of the XLA engine): no kernel
    # launches. Its decks, then under each rule set its first state and 64
    # steps of K3's injected stream against phase 1's K3 outputs.
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    g_s, t_g = {}, time.perf_counter()
    t0 = time.perf_counter()
    decks = tstate.init_state(SEED, cfg, T_FULL, dev).deck
    sync()
    g_s["init_state"] = time.perf_counter() - t0
    check(torch.equal(decks.sort(1).values, torch.arange(
        52, dtype=torch.int32, device=dev).expand(T_FULL, 52)),
        "path g: every deck is a permutation of the 52 cards")
    check(torch.equal(decks[:DECK_CPU_TABLES].cpu(), tstate.init_state(
        SEED, cfg, DECK_CPU_TABLES, "cpu").deck),
        f"path g: the first {DECK_CPU_TABLES} tables' decks equal the CPU's")
    # card by deck position: 52 x 52 counts, uniform under the null;
    # chi-squared with 51^2 degrees of freedom, p by Wilson-Hilferty
    pos = torch.arange(52, device=dev)[None] * 52
    counts = torch.bincount((pos + decks).reshape(-1), minlength=52 * 52)
    want = T_FULL / 52
    chi2 = float(((counts.double() - want) ** 2 / want).sum())
    dof = 51 * 51
    z = ((chi2 / dof) ** (1 / 3) - (1 - 2 / (9 * dof))) \
        / (2 / (9 * dof)) ** 0.5
    p_deck = math.erfc(abs(z) / 2 ** 0.5)
    log(f"path g: decks of {T_FULL} tables (Philox sub-stream "
        f"{tstate.DECK_SUB}), card by position chi^2 {chi2:.1f} over {dof} "
        f"dof, z {z:+.3f}, two-sided p {p_deck:.4f} (gate p > {DECK_P})")
    check(p_deck > DECK_P, "path g: the decks are uniform (chi^2)")
    del decks, counts
    acts_rows = acts_full.permute(1, 0, 2, 3).reshape(DET_STEPS, T_FULL)
    deals = ce._stash_rows(cards_full).permute(2, 0, 1).contiguous()
    g_rows = []
    for rules, packed0, det, stack in (
            ("reference", st_full, det_out, SS),
            ("standard", st_full_std, det_std, SS),
            ("tournament", st_full_tour, det_tour, TOUR_STACK)):
        L = ce._L_for(rules)
        gcfg = TableConfig(num_seats=P, rules=rules, starting_stack=stack,
                           max_layers=L, max_pot_layers=4 * L,
                           bets_impl="levels")
        st0 = tstate.redeal(tstate.init_state(SEED, gcfg, T_FULL, dev),
                            erp.decks_from_deals(deals[:, 0]))
        bad = erp.against_pack_state(packed0, gcfg, st0)
        check(not bad, f"path g {rules}: init_state + redeal equals "
                       f"pack_state (differs in {bad})")
        t0 = time.perf_counter()
        rep = erp.replay_injected(gcfg, st0, acts_rows, deals)
        sync()
        replay_s = time.perf_counter() - t0
        agree = erp.against_k3(det, gcfg, rep)
        parted = (agree.k3_overflow != rep.overflow).nonzero()
        if len(parted):
            t = int(parted[0])
            log(f"path g {rules}: the overflow sets part at table {t}: K3 "
                f"{bool(agree.k3_overflow[t])}, the engine's first overflow "
                f"at step {int(rep.overflow_at[t])} (-1: none)")
        check(not len(parted), f"path g {rules}: the overflow sets are equal")
        clean = float((~agree.k3_overflow).float().mean())
        check(clean > 0.9, f"path g {rules}: over 90% of tables within "
                           f"capacity")
        for name, bad in agree.mismatch.items():
            check(not bool(bad.any()), f"path g {rules}: {name} equals K3's "
                  f"on every table within capacity")
        n_fresh = int(agree.frozen_fresh.sum())
        frozen = int(rep.state.hand_over.sum())
        check(rules == "tournament" or n_fresh == 0,
              f"path g {rules}: no frozen table")
        # the engine alone: DET_STEPS steps of clamp_action + step_table
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        st = st0
        a.record()
        for i in range(DET_STEPS):
            st = tstep.step_table(st, tstep.clamp_action(st, acts_rows[i]),
                                  rules=rules)
        b.record()
        b.synchronize()
        engine_ms = a.elapsed_time(b)
        k3_key = {"reference": "K3", "standard": "K3s",
                  "tournament": "K3t"}[rules]
        row = {"rules": rules, "tables": T_FULL, "steps": DET_STEPS,
               "hands": int(rep.hand_ct.sum()),
               "overflowed": int(agree.k3_overflow.sum()),
               "within_capacity": clean, "frozen": frozen,
               "frozen_fresh_fields": n_fresh, "replay_s": replay_s,
               "engine_ms": engine_ms,
               "engine_ns_per_table_step":
                   engine_ms * 1e6 / (T_FULL * DET_STEPS),
               "det_ns_per_table_step":
                   times[k3_key] * 1e6 / (T_FULL * DET_STEPS)}
        g_rows.append(row)
        log(f"path g {rules}: {T_FULL} tables x {DET_STEPS} steps equal K3 "
            f"on the {clean:.4%} within capacity, overflow sets equal "
            f"({row['overflowed']}), {row['hands']} hands, {frozen} frozen "
            f"({n_fresh} with K3's fresh street_raises/last_raiser, ROADMAP "
            f"C-5); replay {replay_s:.2f} s, step_table "
            f"{row['engine_ns_per_table_step']:.2f} ns per table-step "
            f"(K3 {row['det_ns_per_table_step']:.4f})")
        del st0, st, rep, agree
    g_launches = {**cq.LAUNCHES, **ce.LAUNCHES, **cn.LAUNCHES,
                  **cc.LAUNCHES, **cs.LAUNCHES, **philox.LAUNCHES}
    check(not any(g_launches.values()), "path g launches no kernel")
    sync()
    g_s["path"] = time.perf_counter() - t_g
    log(json.dumps({"path_g": g_rows, "path_g_seconds": g_s,
                    "path_g_peak_bytes": torch.cuda.max_memory_allocated(dev),
                    "card": smi}))
    del acts_rows, deals
    phase_done("7 table engine")

    # ---- 8. self-play and evaluation (path h) ----------------------------
    # plain PyTorch on the card (the port of the XLA self-play and
    # evaluation modules): random perpetual self-play, independent hands,
    # tournaments, the net pipeline and duplicate matches at the engine's
    # and the net kernels' main-path widths. K4, K5 and K6 run here only as
    # the yardsticks the new code is held to; no other kernel launches.
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    h_s, h, t_h = {}, {}, time.perf_counter()

    def sub_done(name, t0):
        sync()
        h_s[name] = time.perf_counter() - t0

    def same_tables(card, cpu, what):
        """The first tables of a state on the card equal a CPU state,
        field by field."""
        n = cpu.n_tables
        for name, a, b in zip(tstate.TableState._fields, card, cpu):
            pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
            for x, y in pairs:
                check(torch.equal(x[:n].cpu(), y), f"{what}: {name} of the "
                      f"first {n} tables equals the CPU run's")

    # (h1) random perpetual self-play, reference rules, K4's capacities
    t0 = time.perf_counter()
    L = ce._L_for("reference")
    h1cfg = TableConfig(num_seats=P, max_layers=L, max_pot_layers=4 * L,
                        bets_impl="levels")
    (h1_final, h1_hands), h1_ms = timed(lambda: tsp.play_hands_perpetual(
        SEED, h1cfg, T_FULL, H_STEPS, device=dev))
    h1_hands = int(h1_hands)
    stats = {k: (v if isinstance(v, int) else v.item())
             for k, v in tsp.selfplay_stats(h1_final).items()}
    log(f"path h1: play_hands_perpetual {T_FULL} tables x {H_STEPS} steps, "
        f"{h1_hands} hands, {h1_ms:.1f} ms, selfplay_stats {stats}")
    check(stats["bet_overflow_frac"] == 0 and stats["pot_overflow_frac"] == 0,
          "path h1: no overflow at K4's capacities")
    h1_cpu, _ = tsp.play_hands_perpetual(SEED, h1cfg, DECK_CPU_TABLES,
                                         H_STEPS, device="cpu")
    same_tables(h1_final, h1_cpu, "path h1")
    del h1_final, h1_cpu
    # steps per hand over the run's second half: the count of hands ending
    # in a window, renewal-theorem exact (a table's partial first and last
    # hands cancel between the two counts), both sides alike
    _, half = tsp.play_hands_perpetual(SEED, h1cfg, T_FULL, H_STEPS // 2,
                                       device=dev)
    port_sph = T_FULL * (H_STEPS - H_STEPS // 2) / (h1_hands - int(half))
    # K4's betting steps per hand. A hand starts at a settle pass, which
    # K4 runs once every DEFER slots, so a hand of L actions holds
    # DEFER * ceil(L / DEFER) slots; with DEFER = 1 (K4's form for a step
    # count that is not a multiple of 16) a slot is an action, as in
    # step_table. Both forms from the first deal, hands counted over a
    # second launch.
    def k4_window(first, second):
        st = ce.pack_state(h1cfg, ce.first_deal(SEED, T_FULL, P, dev))
        a = ce.run_perpetual_prng(SEED, st, P, first, SB, BB)
        b = ce.run_perpetual_prng(SEED + 1, a, P, second, SB, BB)
        n = int(ce.unpack_field(b, h1cfg, "hand_ct").sum()
                - ce.unpack_field(a, h1cfg, "hand_ct").sum())
        return T_FULL * second / n

    k4_steps = k4_window(H_STEPS // 2 + 1, H_STEPS // 2 - 1)  # DEFER 1
    k4_slots = k4_window(H_STEPS, H_STEPS)                     # DEFER 16
    h["h1"] = {"hands": h1_hands, "ms": h1_ms,
               "ns_per_table_step": h1_ms * 1e6 / (T_FULL * H_STEPS),
               "stats": stats, "steps_per_hand": port_sph,
               "k4_steps_per_hand": k4_steps, "k4_slots_per_hand": k4_slots,
               "k4_idle_slots_per_hand": k4_slots - k4_steps,
               "k4_phase_1a_slots_per_hand": slots_per_hand,
               "phase_1a_less_7.5": slots_per_hand - (ce.DEFER - 1) / 2}
    log(f"path h1: steps per hand {port_sph:.4f}; K4 {k4_steps:.4f} with "
        f"DEFER 1, {k4_slots:.4f} slots with DEFER {ce.DEFER} (idle "
        f"{k4_slots - k4_steps:.4f} slots a hand, (DEFER - 1)/2 = "
        f"{(ce.DEFER - 1) / 2}); phase 1a's {slots_per_hand:.4f} slots less "
        f"7.5 = {slots_per_hand - 7.5:.4f}")
    check(abs(port_sph / k4_steps - 1) < 0.02,
          "path h1: steps per hand within 2% of K4's")
    sub_done("h1", t0)

    # (h2) independent hands, standard rules
    t0 = time.perf_counter()
    (h2_final, h2_d), h2_ms = timed(lambda: tsp.play_hands(
        SEED, std, T_FULL, num_hands=1, collect_deltas=True, device=dev))
    check(not bool(h2_d.sum(2).any()), "path h2: chips conserved on every "
          "table")
    h2_actions = int(h2_final.time.sum())
    mean_bb, se_bb = tsp.position_winrates(h2_d.cpu().numpy(), BB)
    rec = json.loads((ROOT / "data" / "position_winrates.json").read_text())[
        "standard_rules_iid_hands"]["positions"]
    zs = [(mean_bb[k] - rec[str(k)]["bb_per_hand"])
          / math.hypot(se_bb[k], rec[str(k)]["stderr"]) for k in range(P)]
    h["h2"] = {"ms": h2_ms, "actions": h2_actions,
               "ns_per_table_action": h2_ms * 1e6 / h2_actions,
               "bb_per_hand": mean_bb.tolist(), "stderr": se_bb.tolist(),
               "z": zs}
    log(f"path h2: play_hands {T_FULL} tables x 1 hand, {h2_ms:.1f} ms, "
        f"{h2_actions / T_FULL:.4f} actions a hand; bb/hand by position "
        f"{np.array2string(mean_bb, precision=4)}, z against "
        f"data/position_winrates.json {np.array2string(np.array(zs), precision=2)}")
    check(max(abs(z) for z in zs) < 4, "path h2: every position within 4 "
          "sigma of data/position_winrates.json")
    del h2_final, h2_d
    sub_done("h2", t0)

    # (h3) tournaments at phase 1d's 20-chip stacks, against K4's
    t0 = time.perf_counter()
    (h3_final, h3_bust, h3_seats), h3_ms = timed(
        lambda: tsp.play_tournament(SEED, tour_short, T_FULL, H_TOUR_HANDS,
                                    device=dev))
    h3_hands = int(h3_final.hand_idx.sum()) + T_FULL
    del h3_final
    seats_np = h3_seats.cpu().numpy()
    check(bool(((seats_np > 0).sum(1) == 1).all()), "path h3: every table "
          "froze")
    check(bool((seats_np.max(1) == P * TOUR_STACK).all()), "path h3: the "
          f"winner holds {P * TOUR_STACK} chips")
    h3_places = tsp.tournament_placements(h3_bust.cpu().numpy(), seats_np)
    check(bool((np.sort(h3_places, 1) == np.arange(1, P + 1)).all()),
          "path h3: placements a permutation of 1..P on every table")
    k4_tour, _ = ce.tournaments_to_completion(
        SEED, tour_short, T_FULL, steps_per_launch=TOUR_LAUNCH, device=dev)
    k4_places, k4_frozen = ce.tournament_results(k4_tour, tour_short)
    del k4_tour
    check(bool(k4_frozen.all()), "path h3: K4's tournaments all complete")
    wins = np.stack([np.bincount((h3_places == 1).argmax(1), minlength=P),
                     np.bincount((k4_places == 1).argmax(1), minlength=P)])
    chi2 = float((((wins - wins.sum(0) * wins.sum(1)[:, None]
                    / wins.sum()) ** 2)
                  / (wins.sum(0) * wins.sum(1)[:, None] / wins.sum())).sum())
    p_wins = chi2_sf(chi2, P - 1)
    h["h3"] = {"ms": h3_ms, "hands": h3_hands,
               "last_bust_hand": int(h3_bust[h3_bust <= H_TOUR_HANDS].max()),
               "win_share": (wins[0] / T_FULL).tolist(),
               "k4_win_share": (wins[1] / T_FULL).tolist(),
               "chi2": chi2, "p": p_wins}
    log(f"path h3: play_tournament {T_FULL} tables, {TOUR_STACK}-chip "
        f"stacks, {h3_hands} hands, the last bust at hand "
        f"{h['h3']['last_bust_hand']}, {h3_ms:.1f} ms; win share by seat "
        f"{np.array2string(wins[0] / T_FULL, precision=4)}, K4's "
        f"{np.array2string(wins[1] / T_FULL, precision=4)}: chi^2 "
        f"{chi2:.2f} over {P - 1} dof, p {p_wins:.4f}")
    check(p_wins > H_P, "path h3: the win shares agree with K4's")
    del h3_bust, h3_seats
    sub_done("h3", t0)

    # (h4) the net pipeline against K5 and K5b, bit for bit, on phase
    # 1b/1c's inputs
    t0 = time.perf_counter()
    L = ce._L_for("standard")
    h4cfg = TableConfig(num_seats=P, rules="standard", max_layers=L,
                        max_pot_layers=4 * L, bets_impl="levels")
    rows = ce._stash_rows(stash_net).permute(2, 0, 1)
    h4_decks = erp.decks_from_deals(rows.reshape(-1, 2 * P + 5)).reshape(
        T_NET, NET_HMAX, 52)
    del rows
    st0 = tstate.redeal(tstate.init_state(SEED, h4cfg, T_NET, dev),
                        h4_decks[:, 0])
    bad = erp.against_pack_state(st_net_det, h4cfg, st0)
    check(not bad, f"path h4: init_state + redeal equals pack_state "
                   f"(differs in {bad})")
    h["h4"] = {}
    for key, banks, stb, weights in (
            ("K5", [panel["fof_raise"]], None, w_bot),
            ("K5b", [panel["jam_tight"], panel["fof_call"]], seat0,
             w_det_banks)):
        k5 = cn.run_net_det(st_net_det, stash_net, weights, P,
                            NET_DET_STEPS, SB, BB, "standard", stb)
        check(torch.equal(k5, {"K5": k5_out, "K5b": k5b_out}[key]),
              f"path h4: {key} relaunched gives phase 1's output")
        (rep, ms) = timed(lambda: erp.replay_net_det(
            h4cfg, st0, banks, stb, h4_decks, NET_DET_STEPS))
        agree = erp.against_k5(k5, h4cfg, rep)
        parted = (agree.k3_overflow != rep.overflow).nonzero()
        if len(parted):
            t = int(parted[0])
            log(f"path h4 {key}: the overflow sets part at table {t}: "
                f"{key} {bool(agree.k3_overflow[t])}, the engine's first "
                f"overflow at step {int(rep.overflow_at[t])} (-1: none)")
        check(not len(parted), f"path h4 {key}: the overflow sets are equal")
        for name, bad in agree.mismatch.items():
            if bool(bad.any()):
                log(f"path h4 {key}: {name} parts first at table "
                    f"{int(bad.nonzero()[0])}")
            check(not bool(bad.any()), f"path h4 {key}: {name} equals "
                  f"{key}'s on every table within capacity")
        clean = float((~agree.k3_overflow).float().mean())
        check(clean > 0.9, f"path h4 {key}: over 90% of tables within "
                           f"capacity")
        h["h4"][key] = {"hands": int(rep.hand_ct.sum()),
                        "overflowed": int(agree.k3_overflow.sum()),
                        "within_capacity": clean, "ms": ms,
                        "ns_per_table_step":
                            ms * 1e6 / (T_NET * NET_DET_STEPS)}
        log(f"path h4: replay_net_det ({key}: "
            f"{'jam_tight / fof_call' if stb else 'fof_raise'}) {T_NET} "
            f"tables x {NET_DET_STEPS} steps equals {key} on the "
            f"{clean:.4%} within capacity, overflow sets equal "
            f"({h['h4'][key]['overflowed']}), {h['h4'][key]['hands']} hands, "
            f"{ms:.1f} ms")
        del rep, agree, k5
    del h4_decks, st0
    sub_done("h4", t0)

    # (h5) es3 against the random policy through pinned_seat_policies and
    # net_policy, against K6's seat-0 meters. K6 starts every hand from
    # full stacks, es3 at seat 0, the button moving one seat a hand: seat 0
    # plays position (-h) mod P in hand h. So the port plays one-hand runs
    # (full stacks, button 0) with es3 at each position p, and weighs
    # position p by K6's share of hands there (from K6's per-table hand
    # counts).
    t0 = time.perf_counter()
    state = st_net0
    for done in range(0, NET_SLOTS, NET_LAUNCH):
        state = cn.run_net_eval((SEED + done * 7919) & 0x7FFFFFFF, state,
                                w_es3, P, NET_LAUNCH, SB, BB, SS,
                                "standard", 1)
    k6_meters = cn.seat_meters(state, std)
    check(all(np.array_equal(a, b) for a, b in
              zip(k6_meters, (net_means, net_errs, net_hands))),
          "path h5: K6 relaunched gives phase 1b's meters")
    n_t = ce.unpack_field(state, std, "hand_ct").cpu().numpy()
    del state
    share = np.array([((n_t[:, None] - 1 - ((-p) % P)) // P + 1).clip(0)
                      .sum() for p in range(P)], np.float64) / n_t.sum()
    pos_means, pos_errs, h5_ms = [], [], 0.0
    for p in range(P):
        pol = tpol.pinned_seat_policies(
            [tpn.net_policy(es3) if s == p else tpol.random_policy
             for s in range(P)])
        (_, d), ms = timed(lambda: tsp.play_hands(
            SEED + 10 + p, std, T_NET, num_hands=1, policy=pol,
            collect_deltas=True, device=dev))
        h5_ms += ms
        x = d[:, 0, p].double().cpu().numpy() / BB
        pos_means.append(x.mean())
        pos_errs.append(x.std(ddof=1) / math.sqrt(len(x)))
    h5_mean = float(np.dot(share, pos_means))
    h5_err = float(np.sqrt(np.dot(share ** 2, np.square(pos_errs))))
    z5 = (h5_mean - net_means[0]) / math.hypot(h5_err, net_errs[0])
    h["h5"] = {"position_share": share.tolist(),
               "bb_per_hand_by_position": pos_means,
               "stderr_by_position": pos_errs, "bb_per_hand": h5_mean,
               "stderr": h5_err, "k6_bb_per_hand": float(net_means[0]),
               "k6_stderr": float(net_errs[0]), "z": z5, "ms": h5_ms}
    log(f"path h5: es3 by position (one-hand runs, {T_NET} tables each) "
        f"{np.array2string(np.array(pos_means), precision=4)}; weighed by "
        f"K6's position shares {np.array2string(share, precision=4)}: "
        f"{h5_mean:+.4f} +- {h5_err:.4f} bb/hand against K6's seat 0 "
        f"{net_means[0]:+.4f} +- {net_errs[0]:.4f}, z {z5:+.2f}; "
        f"{h5_ms:.1f} ms")
    check(abs(z5) < 4, "path h5: the net's bb/hand within 4 sigma of K6's")
    sub_done("h5", t0)

    # (h6) duplicate matches, heads-up standard rules
    t0 = time.perf_counter()
    self_match = tev.duplicate_match(SEED, tpol.always_call,
                                     tpol.always_call, T_FULL, device=dev)
    check(self_match.bb_per_hand == 0.0,
          "path h6: the calling station against itself scores exactly 0")
    edge, h6_ms = timed(lambda: tev.duplicate_match(
        SEED, tpol.always_call, tpol.tight_policy, T_FULL, device=dev))
    check(edge.bb_per_hand > 0.1, "path h6: the calling station beats the "
          "half-folder by more than 0.1 bb/hand")
    hu = tpn.net_policy(tpn.load_params(ROOT / "data" / "policy_hu_300.npz"))
    multi = tev.duplicate_match_multihand(SEED, hu, tpol.random_policy,
                                          T_NET, H_DUP_HANDS, device=dev)
    swapped = tev.duplicate_match_multihand(SEED, tpol.random_policy, hu,
                                            T_NET, H_DUP_HANDS, device=dev)
    check(multi.ci95[0] > 0, "path h6: policy_hu_300 beats random, 95% "
          "interval above 0")
    check(multi.bb_per_hand + swapped.bb_per_hand == 0.0,
          "path h6: swapping the policies negates the estimate exactly")
    h["h6"] = {"self_match": self_match.bb_per_hand,
               "call_vs_tight": [edge.bb_per_hand, edge.stderr],
               "call_vs_tight_ms": h6_ms,
               "hu_300_vs_random": [multi.bb_per_hand, multi.stderr],
               "swapped": swapped.bb_per_hand}
    log(f"path h6: self-match {self_match.bb_per_hand}; call vs tight "
        f"{edge.bb_per_hand:+.4f} +- {edge.stderr:.4f} ({T_FULL} tables, "
        f"{h6_ms:.1f} ms); policy_hu_300 vs random over {H_DUP_HANDS} "
        f"hands {multi.bb_per_hand:+.4f} +- {multi.stderr:.4f} ({T_NET} "
        f"tables), swapped {swapped.bb_per_hand:+.4f}")
    sub_done("h6", t0)

    h_launches = {"K4": ce.LAUNCHES["engine_prng_reference"],
                  "K4t": ce.LAUNCHES["engine_prng_tournament"],
                  "K5": cn.LAUNCHES["net_det_standard"],
                  "K5b": cn.LAUNCHES["net_det_banked_standard"],
                  "K6": cn.LAUNCHES["net_eval_standard"]}
    log(f"path h launches: {h_launches}")
    check(all(v > 0 for v in h_launches.values()),
          "path h: K4, K5 and K6 each launched")
    others = {k: v for k, v in {**cq.LAUNCHES, **ce.LAUNCHES, **cn.LAUNCHES,
                                **cc.LAUNCHES, **cs.LAUNCHES,
                                **philox.LAUNCHES}.items()
              if k not in ("engine_prng_reference", "engine_prng_tournament",
                           "net_det_standard", "net_det_banked_standard",
                           "net_eval_standard")
              and not k.startswith("first_state_")}
    check(not any(others.values()), f"path h launches no other kernel "
          f"({ {k: v for k, v in others.items() if v} })")
    sync()
    h_s["path"] = time.perf_counter() - t_h
    log(json.dumps({"path_h": h, "path_h_seconds": h_s,
                    "path_h_launches": h_launches,
                    "path_h_peak_bytes": torch.cuda.max_memory_allocated(dev),
                    "card": smi}))
    phase_done("8 self-play and evaluation")

    # ---- 9. training and exploitability (path i) --------------------------
    # the ported scripts at their own sizes against the recorded results of
    # data/ (league edges, exploitability, the learned and solver best
    # responses) and CPU-made records (fold gate, policy diff); REINFORCE
    # and ES training. K6, B7, B8 and B8 with two banks launch; no other
    # kernel.
    from montecarlo_tpu_torch.models import leash as tleash
    from montecarlo_tpu_torch.models import train as ttr
    from montecarlo_tpu_torch.scripts import eval_attacker as sea
    from montecarlo_tpu_torch.scripts import exploit_probe as sep
    from montecarlo_tpu_torch.scripts import exp_leak_anatomy as sela
    from montecarlo_tpu_torch.scripts import fold_gate_check as sfg
    from montecarlo_tpu_torch.scripts import league_eval as sle
    from montecarlo_tpu_torch.scripts import make_fold_anchor as smfa
    from montecarlo_tpu_torch.scripts import opt_bot as sob
    from montecarlo_tpu_torch.scripts import policy_diff as spd
    from montecarlo_tpu_torch.scripts import train_br as stb
    from montecarlo_tpu_torch.scripts import train_es_kernel as stek
    from montecarlo_tpu_torch.scripts import train_policy as stp

    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    i_s, ires, t_i = {}, {}, time.perf_counter()
    i_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_i_"))
    atexit.register(shutil.rmtree, i_dir, True)
    os.chdir(ROOT)  # the scripts name data/ relative to the root

    def record(name):
        with open(ROOT / "data" / name) as f:
            return json.load(f)

    def gate(what, port, se_port, rec, se_rec):
        """|port - record| <= I_SIGMA sqrt(se_port^2 + se_rec^2)."""
        z = (port - rec) / math.sqrt(se_port ** 2 + se_rec ** 2)
        log(f"path {what}: {port:+.4f} +- {se_port:.4f} against the record "
            f"{rec:+.4f} +- {se_rec:.4f}, z {z:+.2f}")
        check(abs(z) <= I_SIGMA, f"path {what}: within {I_SIGMA:g} sigma "
              f"of the record (z {z:+.2f})")
        return {"port": port, "se": se_port, "record": rec,
                "record_se": se_rec, "z": z}

    def i_done(name, t0):
        sync()
        i_s[name] = time.perf_counter() - t0

    std6 = TableConfig(num_seats=6, rules="standard", bets_impl="levels")
    es9 = tpn.load_params(ROOT / "data" / "policy_6max_es9.npz")

    # (i1) the league (B7) against the records
    t0 = time.perf_counter()
    ires["i1"] = {}
    for k, other in enumerate(("es8", "es7", "distill")):
        rec = record(f"league_es9_vs_{other}.json")
        res = sle.main(["--a", "data/policy_6max_es9.npz", "--b",
                        f"data/policy_6max_{other}.npz"]
                       + (["--skip-selfcheck"] if k else []))
        if not k:
            check(res["selfcheck_exact"], "path i1: league_eval's "
                  "self-check, identical banks (B7) equal the single net "
                  "(K6) exactly")
        ires["i1"][f"es9_vs_{other}"] = gate(
            f"i1 es9 vs {other} edge", res["edge_A_minus_B"],
            2 * res["A_stderr"], rec["edge_A_minus_B"], 2 * rec["A_stderr"])
        ires["i1"][f"es9_vs_{other}"]["hands"] = res["hands"]
    rec = record("br_vs_es9.npz.result.json")
    bb, se, hands = stb.league_eval(
        std6, tpn.load_params(ROOT / "data" / "br_vs_es9.npz"), es9)
    ires["i1"]["br_vs_es9"] = gate("i1 learned BR vs es9", bb, se,
                                   rec["learned_br_bb_per_hand"],
                                   rec["stderr"])
    rec = record("solver_br_vs_es7.result.json")
    res = sea.main(["--attacker", "data/br_solver_vs_es7.npz", "--subject",
                    "es7=data/policy_6max_es7.npz", "--save",
                    str(i_dir / "solver_br_vs_es7.json")])
    ires["i1"]["solver_br_vs_es7"] = gate(
        "i1 solver BR vs es7", res["solver_br_bb_per_hand"], res["stderr"],
        rec["solver_br_bb_per_hand"], rec["stderr"])
    i_done("i1", t0)

    # (i2) exploitability: the panel probe, the recorded CMA attacker, one
    # CMA run at opt_bot's defaults (logged)
    t0 = time.perf_counter()
    rec = record("exploitability_es9.json")["subjects"]["es9"]
    doc = sep.main(["--subjects", "es9=data/policy_6max_es9.npz",
                    "--geometry", "both", "--save",
                    str(i_dir / "exploitability_es9.json")])
    got = doc["subjects"]["es9"]
    best = got["best_bot"]
    check(best == rec["best_bot"], f"path i2: the best bot is the "
          f"record's {rec['best_bot']} (got {best})")
    row = got["per_bot"][best]
    lone = row["max_bb"] == row["bot_bb_per_hand"]
    ires["i2"] = {"lb": gate(
        f"i2 exploitability LB ({best}, {'lone' if lone else 'five'})",
        got["exploitability_lb_bb"],
        row["stderr"] if lone else row["stderr_five"],
        rec["exploitability_lb_bb"], rec["per_bot"][best]["stderr"]),
        "per_bot": {}}
    for name, row in got["per_bot"].items():
        want = rec["per_bot"][name]
        zs = {}
        for key, se_key in (("bot_bb_per_hand", "stderr"),
                            ("bot_bb_per_hand_five", "stderr_five")):
            se2 = math.hypot(row[se_key], want[se_key])
            zs[key] = [row[key], (row[key] - want[key]) / max(se2, 1e-12)]
        ires["i2"]["per_bot"][name] = zs
        log(f"path i2: {name}: lone {zs['bot_bb_per_hand'][0]:+.4f} (z "
            f"{zs['bot_bb_per_hand'][1]:+.2f}), five "
            f"{zs['bot_bb_per_hand_five'][0]:+.4f} (z "
            f"{zs['bot_bb_per_hand_five'][1]:+.2f})")
    rec = record("exploitability_opt_es9.json")["subjects"]["es9"]
    pair = rec["best_pair"]
    acts = tuple(int(v) for v in pair.split(":"))
    bb, se, hands = sob.final_eval(es9, std6, rec["per_pair"][pair]["x"],
                                   acts, 1 << 16, 512)
    ires["i2"]["cma_record"] = gate(
        f"i2 the recorded CMA attacker {pair}", bb, se,
        rec["per_pair"][pair]["bot_bb_per_hand"],
        rec["per_pair"][pair]["stderr"])
    t1 = time.perf_counter()
    cma_args = sob.parser().parse_args(
        ["--save", str(i_dir / "unused.json")])
    cma = sob.optimize_pair(es9, std6, acts, cma_args,
                            lambda d: log(f"path i2 CMA: {json.dumps(d)}"))
    sync()
    ires["i2"]["cma_run"] = {k: v for k, v in cma.items() if k != "x"}
    ires["i2"]["cma_run"]["seconds"] = time.perf_counter() - t1
    log(f"path i2: optimize_pair({pair}) at opt_bot's defaults "
        f"({cma_args.generations} x {cma_args.popsize}, "
        f"{cma_args.tables} x {cma_args.steps}): "
        f"{cma['bot_bb_per_hand']:+.4f} +- {cma['stderr']:.4f} (the "
        f"record's run {rec['per_pair'][pair]['bot_bb_per_hand']:+.4f}), "
        f"{ires['i2']['cma_run']['seconds']:.1f} s")
    i_done("i2", t0)

    # (i3) ES training from policy_6max_200 with the fold leash and a pool
    t0 = time.perf_counter()
    es_save = str(i_dir / "es.npz")
    es_out = stek.main(["--start", "data/policy_6max_200.npz", "--opponents",
                        "random,bot:jam_loose", "--fold-anchor",
                        "data/fold_anchor.npz", "--generations",
                        str(I_ES_GENERATIONS), "--save", es_save])
    anchor = tleash.anchor_log_pfold(
        tpn.load_params(ROOT / "data" / "policy_6max_200.npz"),
        tleash.load_anchor(ROOT / "data" / "fold_anchor.npz"))
    check(es_out["start_anchor_logp"] == anchor, "path i3: the start's "
          "anchor score equals the CPU's numpy value exactly")
    check(all(torch.equal(a, b) for a, b in zip(
        tpn.load_params(es_save), es_out["result"].params)),
        "path i3: the saved center reloads equal to the returned one")
    ires["i3"] = {"generations": es_out["generations"],
                  "seconds": es_out["training_seconds"],
                  "seconds_per_generation": es_out["training_seconds"]
                  / es_out["generations"],
                  "start_anchor_logp": anchor,
                  "hands": es_out["result"].hands_total,
                  "final": es_out["final"]}
    log(f"path i3: {es_out['generations']} generations of pop "
        f"{2 * 8} at 2^14 x 256 in {es_out['training_seconds']:.1f} s "
        f"({ires['i3']['seconds_per_generation']:.3f} s a generation), "
        f"final {es_out['final']}")
    i_done("i3", t0)

    # (i4) REINFORCE: the JAX slow test's setting at train_policy.py's
    # tables, one update's loss and gradient on the CPU, train_br's shape
    t0 = time.perf_counter()
    hu2 = TableConfig(num_seats=2, rules="standard", bets_impl="levels")
    sync()
    t1 = time.perf_counter()
    rl = ttr.train_policy(3, cfg=hu2, opponent=tpol.always_call,
                          tables=I_RL_TABLES, steps=I_RL_UPDATES, lr=5e-3)
    sync()
    rl_s = time.perf_counter() - t1
    hist = rl.mean_reward_bb.numpy()
    first, last = float(hist[:15].mean()), float(hist[-15:].mean())
    log(f"path i4: train_policy vs always_call, {I_RL_TABLES} tables x "
        f"{I_RL_UPDATES} updates in {rl_s:.1f} s "
        f"({rl_s / I_RL_UPDATES:.3f} s an update): first 15 {first:+.4f}, "
        f"last 15 {last:+.4f} bb/hand")
    check(np.isfinite(hist).all() and last > first + 0.05,
          "path i4: REINFORCE's last 15 updates beat its first 15 by more "
          "than 0.05 bb/hand")
    params = tpn.init_params(torch.Generator().manual_seed(5))
    st = tstate.init_state(SEED, hu2, I_RL_TABLES, dev)
    pos = (torch.arange(I_RL_TABLES, device=dev) % 2).to(torch.int32)
    rewards, recs, _ = ttr._play_hand_collect(
        params, st, tpol.policy_key(SEED, I_RL_TABLES, ttr.SUB_TRAIN, dev),
        pos, tpol.always_call, 48, "standard")

    def loss_grad(p, recs, rewards):
        leaves = [x.detach().clone().requires_grad_(True) for x in p]
        loss = ttr.reinforce_loss(tpn.MLPParams(*leaves), recs,
                                  rewards / 10.0)
        loss.backward()
        return float(loss.detach()), [x.grad.cpu() for x in leaves]

    card_l, card_g = loss_grad([x.to(dev) for x in params], recs, rewards)
    cpu_l, cpu_g = loss_grad(params, ttr.Records(*(x.cpu() for x in recs)),
                             rewards.cpu())
    rel = max(abs(card_l - cpu_l) / abs(cpu_l), *(
        float((a - b).abs().max() / b.abs().max())
        for a, b in zip(card_g, cpu_g)))
    log(f"path i4: one update's {len(recs.table)} records: loss card "
        f"{card_l:.8f}, CPU {cpu_l:.8f}; largest relative difference of "
        f"the loss and gradients {rel:.3g}")
    check(rel <= 1e-5, "path i4: the card's loss and gradient equal the "
          "CPU's within 1e-5 relative")
    br = stb.main(["--opponent", "es9=data/policy_6max_es9.npz", "--start",
                   "data/policy_6max_200.npz", "--updates",
                   str(I_BR_UPDATES), "--eval-every", str(I_BR_UPDATES),
                   "--save", str(i_dir / "br.npz")])
    check(br["overflowed_tables"] == 0, "path i4: train_br at max_layers "
          "8 / max_pot_layers 16 overflows no table")
    check(np.isfinite(br["train_bb"]).all() and all(
        np.isfinite(h[1]) for h in br["holdout"]), "path i4: train_br's "
          "rewards and holdout finite")
    ires["i4"] = {"train_policy_seconds": rl_s,
                  "train_policy_s_per_update": rl_s / I_RL_UPDATES,
                  "first15": first, "last15": last,
                  "records": len(recs.table), "loss_rel_diff": rel,
                  "train_br_s_per_update": float(np.mean(
                      br["update_seconds"])),
                  "train_br_s_first_update": br["update_seconds"][0],
                  "train_br_holdout": br["holdout"],
                  "train_br_final": br["learned_br_bb_per_hand"]}
    log(f"path i4: train_br {I_BR_UPDATES} updates (6-max, 4096 tables x "
        f"72 steps, es9 frozen): {ires['i4']['train_br_s_per_update']:.3f}"
        f" s an update (first {br['update_seconds'][0]:.3f} s), holdout "
        f"{br['holdout']}, final {br['learned_br_bb_per_hand']:+.4f}")
    i_done("i4", t0)

    # (i5) decision points against the CPU-made records. policy_diff runs
    # at the records' size (128 tables x 512 steps): the statistics drift
    # with the steps of perpetual play (es9's fold-argmax share is 0.51 at
    # 128 steps, 0.71 at 512), so fewer steps would move them. Its es9
    # self-play is fold_gate_check's (seed 7, 128 x 512, standard 6-max),
    # so the fold-gate gates read its records, and fold_gate_check and
    # make_fold_anchor (not gated) run cut to I5_CUT. Sigma: batch means
    # over I_GROUPS groups of tables, and the record's the same scaled to
    # its own decision count.
    t0 = time.perf_counter()

    def batch_sigma(fn, recs_flat, n_tables, steps):
        feats, _, free, _, _ = recs_flat
        per = n_tables // I_GROUPS * steps
        vals = [fn(feats[g * per:(g + 1) * per], free[g * per:(g + 1) * per])
                for g in range(I_GROUPS)]
        return float(np.std(vals, ddof=1) / math.sqrt(I_GROUPS))

    def gate_sized(what, port, sig, n_port, rec_value, n_rec):
        return gate(what, port, sig, rec_value,
                    sig * math.sqrt(n_port / n_rec))

    drec = record("diff_es9_es8.json")["on_es9_selfplay"]
    doc = spd.main(["--a", "es9=data/policy_6max_es9.npz", "--b",
                    "es8=data/policy_6max_es8.npz", "--save",
                    str(i_dir / "diff_es9_es8.json")])
    flat = doc["records"]["es9"]
    feats, _, free, _, _ = flat
    n_dec = len(feats)
    got = sela.margin_stats(es9, feats, free)[2]
    got["fold_gate"] = sela.fold_gate(es9, feats, free)
    rec = record("fold_gate_es9.json")["subjects"]["es9"]
    ires["i5"] = {}
    for key, fn, want in (
            ("fold_argmax_frac", lambda f, fr: sela.fold_gate(
                es9, f, fr)["fold_argmax_frac"], got["fold_gate"]),
            ("mean_p_fold", lambda f, fr: sela.fold_gate(
                es9, f, fr)["mean_p_fold"], got["fold_gate"]),
            ("frac_margin_lt_4.6", lambda f, fr: sela.margin_stats(
                es9, f, fr)[2]["frac_margin_lt_4.6"], got)):
        sig = batch_sigma(fn, flat, doc["tables"], doc["steps"])
        ref = rec["fold_gate"][key] if key != "frac_margin_lt_4.6" \
            else rec[key]
        ires["i5"][key] = gate_sized(f"i5 fold gate {key}", want[key], sig,
                                     n_dec, ref, rec["decisions"])
    es8 = tpn.load_params(ROOT / "data" / "policy_6max_es8.npz")
    sig = batch_sigma(lambda f, fr: float((
        sela.masked_argmax(sela.np_logits(es9, f), fr)[0]
        != sela.masked_argmax(sela.np_logits(es8, f), fr)[0]).mean()),
        flat, doc["tables"], doc["steps"])
    ires["i5"]["argmax_disagree"] = gate_sized(
        "i5 es9 vs es8 argmax disagreement on es9's self-play",
        doc["on_es9_selfplay"]["argmax_disagree"], sig, n_dec,
        drec["argmax_disagree"], drec["decisions"])
    cut = ["--tables", str(I5_CUT[0]), "--steps", str(I5_CUT[1])]
    small = sfg.main(["--subjects", "es9=data/policy_6max_es9.npz",
                      "--save", str(i_dir / "fold_gate_es9.json")] + cut)
    ires["i5"]["fold_gate_check_cut"] = {
        "tables": I5_CUT[0], "steps": I5_CUT[1],
        "fold_argmax_frac": small["subjects"]["es9"]["fold_gate"]
        ["fold_argmax_frac"]}
    log(f"path i5: fold_gate_check at {I5_CUT[0]} tables x {I5_CUT[1]} "
        f"steps: fold-argmax share "
        f"{ires['i5']['fold_gate_check_cut']['fold_argmax_frac']:.4f} "
        f"(logged; the gates read policy_diff's 128 x 512 es9 records)")
    meta = smfa.main(["--subject", "data/policy_6max_es8.npz", "--save",
                      str(i_dir / "fold_anchor.npz"), "--steps",
                      str(I5_CUT[1])])
    anc = record("fold_anchor.npz.json")
    ires["i5"]["fold_anchor"] = {"rows": meta["rows"],
                                 "steps": I5_CUT[1],
                                 "p_fold_ref_mean": meta["p_fold_ref_mean"],
                                 "record_rows": anc["rows"],
                                 "record_p_fold_ref_mean":
                                     anc["p_fold_ref_mean"]}
    log(f"path i5: make_fold_anchor at {I5_CUT[1]} steps: {meta['rows']} "
        f"rows, p_fold_ref_mean {meta['p_fold_ref_mean']} (the record, "
        f"512 steps: {anc['rows']}, {anc['p_fold_ref_mean']})")
    i_done("i5", t0)

    i_launches = {"K6": cn.LAUNCHES["net_eval_standard"],
                  "B7": cn.LAUNCHES["net_league_standard"],
                  "B8": cn.LAUNCHES["net_pop_standard"],
                  "B8l": cn.LAUNCHES["net_league_pop_standard"]}
    log(f"path i launches: {i_launches}")
    check(all(v > 0 for v in i_launches.values()),
          "path i: K6, B7, B8 and B8 with two banks each launched")
    others = {k: v for k, v in {**cq.LAUNCHES, **ce.LAUNCHES, **cn.LAUNCHES,
                                **cc.LAUNCHES, **cs.LAUNCHES,
                                **philox.LAUNCHES}.items()
              if k not in ("net_eval_standard", "net_league_standard",
                           "net_pop_standard", "net_league_pop_standard")
              and not k.startswith("first_state_")}
    check(not any(others.values()), f"path i launches no other kernel "
          f"({ {k: v for k, v in others.items() if v} })")
    sync()
    i_s["path"] = time.perf_counter() - t_i
    log(json.dumps({"path_i": ires, "path_i_seconds": i_s,
                    "path_i_launches": i_launches,
                    "path_i_peak_bytes": torch.cuda.max_memory_allocated(dev),
                    "card": smi}, default=float))
    phase_done("9 training and exploitability")

    # ---- 10. the solvers (path j) ------------------------------------------
    # the ported river_gap, turn_gap and distill_nash at the records' widths
    # (plain PyTorch on the card, no kernel: every launch count stays 0),
    # each row against its data/ record where the JAX package reproduces
    # that record on the CPU (tests/rehearse_solver_records.json) in the
    # row's matmul mode, and every rehearsed row against the JAX CPU value
    # of that mode: f32 as JAX on the CPU, tpu_bf16 as the TPU made the
    # records (policy_net.policy_logits' bfloat16 inputs).
    from montecarlo_tpu_torch.models import distill as tdi
    from montecarlo_tpu_torch.models import river_solver as trs
    from montecarlo_tpu_torch.models import turn_solver as tts
    from montecarlo_tpu_torch.scripts import distill_nash as sdn
    from montecarlo_tpu_torch.scripts import river_gap as srg
    from montecarlo_tpu_torch.scripts import turn_gap as stg

    check(not torch.backends.cuda.matmul.allow_tf32,
          "path j: TF32 is off for the solvers' float32 products")
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    j_s, jres, t_j = {}, {}, time.perf_counter()
    j_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_j_"))
    atexit.register(shutil.rmtree, j_dir, True)
    with open(ROOT / "tests" / "rehearse_solver_records.json") as f:
        rehearsal = json.load(f)

    def rehearsed(part, board, subject=None):
        """The JAX CPU row of the rehearsal, or None."""
        for row in rehearsal:
            if (row["part"], row.get("board"), row.get("subject")) == (
                    part, board, subject) and "record" in row:
                return row
        return None

    def j_gate(what, port, rec, tol, jax_cpu=None, reproduced=True,
               mode="f32"):
        """|port - JAX CPU| <= tol where JAX was rehearsed; |port - record|
        <= tol where the record is reproduced (by JAX on the CPU in
        ``mode`` within 1e-4, the record's last digit, or as
        ``reproduced`` says where no JAX value exists). Logged either
        way."""
        row = {"port": port, "record": rec, "tol": tol,
               "to_record": port - rec}
        if jax_cpu is not None:
            reproduced = abs(jax_cpu - rec) <= 1e-4 + 1e-9
            row.update(jax_cpu=jax_cpu, to_jax=port - jax_cpu)
            check(abs(port - jax_cpu) <= tol + 1e-9,
                  f"path {what}: {port} within {tol} of the JAX CPU value "
                  f"{jax_cpu} ({mode})")
        row["reproduced"] = reproduced
        if reproduced:
            check(abs(port - rec) <= tol + 1e-9,
                  f"path {what}: {port} within {tol} of the record {rec}")
        else:
            log(f"path {what}: the record {rec} is not reproduced by JAX "
                f"on the CPU in {mode} ({jax_cpu}"
                + (f", {abs(jax_cpu - rec):.4f} off" if jax_cpu is not None
                   else "") + f"); the port's {port} is not held to it")
        return row

    def j_done(name, t0):
        sync()
        j_s[name] = time.perf_counter() - t0

    def iteration_ms(solve, game, n):
        """ms of one CFR+ iteration: ``n`` iterations after a warm-up of
        ``n // 10``, CUDA events."""
        solve(game, max(1, n // 10))
        sync()
        return timed(lambda: solve(game, n))[1] / n

    no_solve = ("gap_bb", "br_vs_net_p1_bb", "br_vs_net_p2_bb")
    vs_nash = ("net_p1_vs_nash_bb", "net_p2_vs_nash_bb")

    def in_mode(jx, mode):
        """A rehearsal row's values in ``mode``."""
        return jx if mode == "f32" or jx is None else jx[mode]

    def record_rows(part, rec, res, what, mode="f32"):
        """Gate every board and subject row of a river_gap / turn_gap
        result ``res`` (subjects extracted in ``mode``) against the
        record ``rec`` and the rehearsal's values of ``mode``. A row that
        needs the solve (``net_p*_vs_nash_bb``) and has no JAX value (the
        turn rehearsal solves nothing) is held to the record where the
        subject's no-solve rows are reproduced."""
        out = {}
        for bname, row in res["boards"].items():
            rrow = rec["boards"][bname]
            check(row["solver_gap_bb"] <= 1e-4, f"path {what} {bname}: "
                  f"solver gap {row['solver_gap_bb']} <= 0.0001 bb")
            jx = in_mode(rehearsed(part, bname), mode)
            out[bname] = {"nash_ev_p1_bb": j_gate(
                f"{what} {bname} Nash EV P1", row["nash_ev_p1_bb"],
                rrow["nash_ev_p1_bb"], 5e-4, jx and jx["nash_ev_p1_bb"],
                mode=mode),
                "solver_gap_bb": row["solver_gap_bb"],
                "solve_seconds": row["solve_seconds"]}
            for name, srow in row["subjects"].items():
                jrow = rehearsed(part, bname, name)
                jx = in_mode(jrow, mode)
                same = all(abs(jx[k] - jrow["record"][k]) <= 1e-4 + 1e-9
                           for k in no_solve)
                out[bname][name] = {k: j_gate(
                    f"{what} {bname} {name} {k}", srow[k],
                    rrow["subjects"][name][k],
                    2e-4 if k in no_solve else 1e-3, jx.get(k), same, mode)
                    for k in no_solve + vs_nash}
        return out

    def held(part, keys, boards, modes):
        """Count the subject values of ``record_rows``' results ``modes``
        ({mode: result}) held to their record: in each mode and in
        either, into ``j_counts[part]``."""
        cells = [{m: r[b][n][k]["reproduced"] for m, r in modes.items()}
                 for b in boards for n in j_names for k in keys]
        j_counts[part] = {"of": len(cells), "either": sum(
            any(c.values()) for c in cells), **{
            m: sum(c[m] for c in cells) for m in modes}}

    j_subjects = [f"{n}=data/policy_6max_{n}.npz"
                  for n in ("es2", "es3", "es4", "es5", "es6", "es7", "es8",
                            "es9", "distill")] + [
        "reinforce=data/policy_6max_200.npz"]
    j_names = [s.split("=")[0] for s in j_subjects]
    j_counts = {}

    # (j1) river_gap at the record's settings: 6000 iterations, all 1081
    # combos, both boards, the record's subjects but untrained
    t0 = time.perf_counter()
    rg_rec = record("river_gap.json")
    rg = srg.main(["--iterations", str(rg_rec["iterations"]), "--subjects",
                   *j_subjects, "--save", str(j_dir / "river_gap.json")])
    j_done("j1", t0)
    jres["j1"] = record_rows("river", rg_rec, rg, "j1")
    board = srg.BOARDS["Ks8h5d2cQs"]
    _, sizes = trs.river_node_states(board)
    rgame, _, _ = trs.make_river_game(board, pot=sizes["pot"],
                                      bet=sizes["bet"],
                                      raise_=sizes["raise_"])
    jres["j1"]["cfr_iteration_ms"] = iteration_ms(trs.solve_cfr_plus,
                                                  rgame, 500)
    jres["j1"]["subject_seconds"] = (
        j_s["j1"] - sum(r["solve_seconds"] for r in rg["boards"].values())
    ) / (len(j_subjects) * len(rg["boards"]))
    log(f"path j1: {j_s['j1']:.1f} s, solves "
        f"{[r['solve_seconds'] for r in rg['boards'].values()]} s, "
        f"{jres['j1']['subject_seconds']:.2f} s a subject, "
        f"{jres['j1']['cfr_iteration_ms']:.3f} ms a CFR+ iteration")
    # the same solves and subjects with the subjects' strategies extracted
    # as the TPU computed the record (matmul="tpu_bf16")
    t0 = time.perf_counter()
    rg16 = srg.main(["--iterations", str(rg_rec["iterations"]),
                     "--subjects", *j_subjects,
                     "--save", str(j_dir / "river_gap_tpu_bf16.json")],
                    matmul="tpu_bf16")
    j_done("j1_tpu_bf16", t0)
    jres["j1_tpu_bf16"] = record_rows("river", rg_rec, rg16,
                                      "j1 tpu_bf16", "tpu_bf16")
    for part, keys in (("river", no_solve), ("river vs Nash", vs_nash)):
        held(part, keys, rg["boards"], {"f32": jres["j1"],
                                        "tpu_bf16": jres["j1_tpu_bf16"]})
    log(f"path j1 tpu_bf16: {j_s['j1_tpu_bf16']:.1f} s")

    # (j2) turn_gap at the record's settings: stride 1 (1128 combos x 48
    # rivers), 4000 iterations, both boards, the record's subjects but
    # untrained
    t0 = time.perf_counter()
    tg_rec = record("turn_gap.json")
    tg = stg.main(["--iterations", str(tg_rec["iterations"]),
                   "--combo-stride", str(tg_rec["combo_stride"]),
                   "--subjects", *j_subjects,
                   "--save", str(j_dir / "turn_gap.json")])
    j_done("j2", t0)
    jres["j2"] = record_rows("turn", tg_rec, tg, "j2")
    tgame, tcombos, tturn, triver = stg.artifact_game(
        stg.BOARDS["Ks8h5d2c"], 1, dev)
    jres["j2"]["cfr_iteration_ms"] = iteration_ms(tts.solve_turn_river,
                                                  tgame, 100)
    jres["j2"]["subject_seconds"] = {
        b: {n: r["eval_seconds"] for n, r in row["subjects"].items()}
        for b, row in tg["boards"].items()}
    log(f"path j2: {j_s['j2']:.1f} s, solves "
        f"{[r['solve_seconds'] for r in tg['boards'].values()]} s, "
        f"{jres['j2']['cfr_iteration_ms']:.3f} ms a CFR+ iteration")
    t0 = time.perf_counter()
    tg16 = stg.main(["--iterations", str(tg_rec["iterations"]),
                     "--combo-stride", str(tg_rec["combo_stride"]),
                     "--subjects", *j_subjects,
                     "--save", str(j_dir / "turn_gap_tpu_bf16.json")],
                    matmul="tpu_bf16")
    j_done("j2_tpu_bf16", t0)
    jres["j2_tpu_bf16"] = record_rows("turn", tg_rec, tg16, "j2 tpu_bf16",
                                      "tpu_bf16")
    for part, keys in (("turn", no_solve), ("turn vs Nash", vs_nash)):
        held(part, keys, tg["boards"], {"f32": jres["j2"],
                                        "tpu_bf16": jres["j2_tpu_bf16"]})
    log(f"path j2 tpu_bf16: {j_s['j2_tpu_bf16']:.1f} s")

    # (j3) the committed distilled artifacts on their records' games: the
    # Nash-distilled net's gap at stride 4, the exact BR edge against es9
    # at stride 1 (the stride whose dataset rows equal the record's)
    t0 = time.perf_counter()
    dis_rec = record("policy_6max_distill.npz.result.json")
    br_rec = record("br_solver_vs_es9.npz.result.json")
    s4_rec = record("turn_gap_stride4.json")
    distilled = tpn.load_params(ROOT / "data" / "policy_6max_distill.npz")
    es7 = tpn.load_params(ROOT / "data" / "policy_6max_es7.npz")
    es7_soft = tpn.softened(es7, J3_SOFTEN)
    jres["j3"] = {}
    j3_held = {"of": 0, "either": 0, "f32": 0, "tpu_bf16": 0}
    j3_soft_s = 0.0
    for bname, board4 in stg.BOARDS.items():
        g4, c4, ts4, rs4 = stg.artifact_game(board4, 4, dev)
        jx = rehearsed("stride4", bname, "distill")
        gap = round(tts.exploitability_gap(g4, tts.net_turn_river_strategy(
            distilled, ts4, rs4, c4)) / srg.BB, 4)
        start = round(tts.exploitability_gap(g4, tts.net_turn_river_strategy(
            es7, ts4, rs4, c4)) / srg.BB, 4)
        jres["j3"][bname] = {
            "distilled_gap_bb": j_gate(
                f"j3 {bname} distilled gap (stride 4)", gap,
                dis_rec["boards"][bname]["gap_bb_distilled"], 2e-4,
                jx["gap_bb"]),
            "es7_gap_bb": j_gate(
                f"j3 {bname} es7 gap (stride 4)", start,
                s4_rec["boards"][bname]["subjects"]["es7"]["gap_bb"], 2e-4,
                rehearsed("stride4", bname, "es7")["gap_bb"]),
            "distill_record_gap_bb_start": dis_rec["boards"][bname][
                "gap_bb_start"]}
        log(f"path j3 {bname}: es7 at stride 4 {start} (the distillation "
            f"record's gap_bb_start "
            f"{dis_rec['boards'][bname]['gap_bb_start']}, not reproduced "
            f"by JAX either)")
        # the record's start: es7 softened, in each matmul mode
        t1 = time.perf_counter()
        jd = rehearsed("stride4", bname)
        soft = {}
        for mode in ("f32", "tpu_bf16"):
            gap = round(tts.exploitability_gap(
                g4, tts.net_turn_river_strategy(es7_soft, ts4, rs4, c4,
                                                mode)) / srg.BB, 4)
            soft[mode] = j_gate(
                f"j3 {bname} softened es7 gap (stride 4, {mode})", gap,
                dis_rec["boards"][bname]["gap_bb_start"], 2e-4,
                in_mode(jd, mode)["distill_result"]["gap_bb_start_softened"],
                mode=mode)
            j3_held[mode] += soft[mode]["reproduced"]
        jres["j3"][bname]["softened_start_gap_bb"] = soft
        j3_held["of"] += 1
        j3_held["either"] += any(r["reproduced"] for r in soft.values())
        if not any(r["reproduced"] for r in soft.values()):
            log(f"path j3 {bname}: the distillation record's gap_bb_start "
                f"is reproduced by JAX in neither mode ({soft}); the "
                f"port's softened start is not held to it")
        sync()
        j3_soft_s += time.perf_counter() - t1
        g1, c1, ts1, rs1 = (tgame, tcombos, tturn, triver) \
            if bname == "Ks8h5d2c" else stg.artifact_game(board4, 1, dev)
        br1, _ = tts.best_response_values(g1, tts.net_turn_river_strategy(
            es9, ts1, rs1, c1))
        edge = round((br1 - g1.pot / 2.0) / srg.BB, 4)
        jx = [r for r in rehearsal if r["part"] == "br"
              and r["subject"] == "es9"
              and r["dataset_rows"] == br_rec["dataset_rows"]][0]
        jres["j3"][bname]["es9_exact_br_edge_bb"] = j_gate(
            f"j3 {bname} exact BR edge vs es9 (stride 1)", edge,
            br_rec["boards"][bname]["exact_br_edge_bb"], 2e-4,
            jx["exact_br_edge_bb"][bname])
    j_done("j3", t0)
    j_s["j3_softened"] = j3_soft_s
    j_counts["softened start"] = j3_held
    jres["record_values_held"] = j_counts
    log("path j: record values held " + ", ".join(
        f"{part} {c['either']}/{c['of']} (f32 {c['f32']}, tpu_bf16 "
        f"{c['tpu_bf16']})" for part, c in j_counts.items())
        + f"; the tpu_bf16 re-scoring and the softened start took "
        f"{j_s['j1_tpu_bf16'] + j_s['j2_tpu_bf16'] + j3_soft_s:.1f} s")

    # (j4) fresh distillations: Nash from es7 at the record's 1500
    # iterations and J4_NASH_STEPS steps at stride 4, and BR against es9
    # at J4_BR_STEPS steps at stride 1
    t0 = time.perf_counter()
    _, nres = sdn.main(["--mode", "nash", "--start",
                        "data/policy_6max_es7.npz", "--combo-stride", "4",
                        "--iterations", str(dis_rec["iterations"]),
                        "--steps", str(J4_NASH_STEPS),
                        "--save", str(j_dir / "distill_nash.npz")])
    j_done("j4_nash", t0)
    jres["j4"] = {"nash": nres}
    for bname, row in nres["boards"].items():
        log(f"path j4 nash {bname}: gap {row['gap_bb_start']} -> "
            f"{row['gap_bb_distilled']} (solver {row['gap_bb_solver']}); "
            f"the record's distilled gap "
            f"{dis_rec['boards'][bname]['gap_bb_distilled']}")
        check(row["gap_bb_distilled"] <= row["gap_bb_start"] - 0.3,
              f"path j4 nash {bname}: the distilled gap is at least 0.3 bb "
              f"below the start's")
    t0 = time.perf_counter()
    _, bres = sdn.main(["--mode", "br", "--subject",
                        "data/policy_6max_es9.npz", "--start",
                        "data/policy_6max_es9.npz", "--steps",
                        str(J4_BR_STEPS),
                        "--save", str(j_dir / "distill_br.npz")])
    j_done("j4_br", t0)
    jres["j4"]["br"] = bres
    log(f"path j4 br: {bres['dataset_rows']} dataset rows (the record's "
        f"and JAX's on the CPU {br_rec['dataset_rows']})")
    for bname, row in bres["boards"].items():
        log(f"path j4 br {bname}: edge {row['start_edge_bb']} -> "
            f"{row['distilled_edge_bb']} of {row['exact_br_edge_bb']}, "
            f"captured {row['captured_frac']} (the record's "
            f"{br_rec['boards'][bname]['captured_frac']})")
        check(row["distilled_edge_bb"] > row["start_edge_bb"],
              f"path j4 br {bname}: the distilled edge is above the start's")

    launched = {k: v for k, v in {**cq.LAUNCHES, **ce.LAUNCHES,
                                  **cn.LAUNCHES, **cc.LAUNCHES,
                                  **cs.LAUNCHES, **philox.LAUNCHES}.items()
                if v}
    check(not launched, f"path j launches no kernel ({launched})")
    sync()
    j_s["path"] = time.perf_counter() - t_j
    log(json.dumps({"path_j": jres, "path_j_seconds": j_s,
                    "path_j_peak_bytes": torch.cuda.max_memory_allocated(dev),
                    "card": smi}, default=float))
    phase_done("10 solvers")

    # ---- 11. the server (path k) -------------------------------------------
    # the port's TCP server, TorchBackend on the card against the CPU and
    # the native table, bench_server, the CI meter on K1, a checkpoint
    kres, k_s, k1_path_k = path_k(dev, smi)
    launches["K1"] += k1_path_k
    log(json.dumps({"path_k": kres, "path_k_seconds": k_s,
                    "path_k_launches": {"K1": k1_path_k}, "card": smi},
                   default=float))
    phase_done("11 server")

    # ---- 12. scale-out (path l) --------------------------------------------
    # the parallel/ layer: every sharded entry on a world of one over NCCL
    # against its unsharded call (K3 and K5b against phase 1's outputs),
    # K1, K4 and the dp step on two gloo ranks on this card, run_configs
    lres, l_s, l_launches = path_l(dev, smi, {
        "st_full": st_full, "acts_full": acts_full,
        "cards_full": cards_full, "det_out": det_out,
        "st_net_det": st_net_det, "stash_net": stash_net,
        "w_det_banks": w_det_banks, "k5b_out": k5b_out})
    for key, n in l_launches.items():
        launches[key] += n
    log(json.dumps({"path_l": lres, "path_l_seconds": l_s,
                    "path_l_launches": l_launches, "card": smi},
                   default=float))
    phase_done("12 scale-out")

    # ---- 13. the layers street form (path m) -------------------------------
    # the plain engine's default bets_impl: the A/B against the levels
    # form, the layers engine against K3 (relaunched once per rule set),
    # zero-chip blinds against the CPU, a layers-form checkpoint
    mres, m_s, m_launches = path_m(dev, smi, {
        "acts_full": acts_full, "cards_full": cards_full,
        "reference": (st_full, det_out), "standard": (st_full_std, det_std)})
    for key, n in m_launches.items():
        launches[key] += n
    log(json.dumps({"path_m": mres, "path_m_seconds": m_s,
                    "path_m_launches": m_launches, "card": smi},
                   default=float))
    phase_done("13 layers street form")

    # ---- 14. the measurement entry points (path n) -------------------------
    # the ported bench.py at its full sizes; the K4 and K6 splits, each
    # variant against its plain version and timed at its script's sizes
    nres, n_s, n1_launches, split_rows = path_n(dev, smi, {
        "det_out": det_out, "det_std": det_std}, split_builds)
    for key, n in n1_launches.items():
        launches[key] += n
    log(json.dumps({"path_n": nres, "path_n_seconds": n_s,
                    "path_n1_launches": n1_launches, "card": smi},
                   default=float))
    phase_done("14 measurement entry points")

    # ---- 15. the last ported scripts (path o) -------------------------------
    # K1's variants (B-6) against their plain versions and timed at the
    # script's 2^29; exp_net_grid; the plain engine's ablations, cut; the
    # on-card checks; validate_tpu in a process of its own
    ores, o_s, o1_launches, k1_rows = path_o(dev, smi, split_builds,
                                             exact_pre.equity)
    log(json.dumps({"path_o": ores, "path_o_seconds": o_s,
                    "path_o1_launches": o1_launches, "card": smi},
                   default=float))
    phase_done("15 last ported scripts")
    log(f"run: {time.perf_counter() - t_start:.1f} s in main() "
        f"({ {k: round(v, 1) for k, v in phase_s.items()} })")

    src = "montecarlo_tpu_torch/csrc/"
    engine = "montecarlo_tpu/ops/pallas_engine.py:"
    meta = [
        ("K1", "K1 equity_rollouts", src + "equity.cu",
         "montecarlo_tpu/ops/pallas_equity.py:125"),
        ("K2", "K2 sweep169", src + "equity.cu",
         "montecarlo_tpu/ops/pallas_equity.py:182"),
        ("K3", "K3 engine_det reference", src + "engine.cu", engine + "716"),
        ("K4", "K4 engine_prng reference", src + "engine.cu",
         engine + "716"),
        ("K3s", "K3 engine_det standard", src + "engine.cu", engine + "716"),
        ("K4s", "K4 engine_prng standard", src + "engine.cu",
         engine + "716"),
        ("K5", "K5 net_det standard", src + "net.cu", engine + "1171"),
        ("K6", "K6 net_eval standard", src + "net.cu", engine + "1171"),
        ("K5b", "K5 net_det banked (B = 2) standard", src + "net.cu",
         engine + "1340"),
        ("B7", "B7 net_league (B = 2) standard", src + "net.cu",
         engine + "1302"),
        ("B8", "B8 net_eval_pop (C = 32, B = 1) standard", src + "net.cu",
         engine + "1470"),
        ("B8l", "B8 net_eval_pop league (C = 32, B = 2) standard",
         src + "net.cu", engine + "1470"),
        ("K3t", "K3 engine_det tournament", src + "engine.cu",
         engine + "716"),
        ("K4t", "K4 engine_prng tournament (completion run, first launch)",
         src + "engine.cu", engine + "716"),
        ("B3", "B3 equity_multiway (N = 3, preflop)", src + "multiway.cu",
         "montecarlo_tpu/ops/pallas_equity.py:268"),
        ("F1", "F1 first_state standard", src + "engine.cu",
         "montecarlo_tpu_torch/ops/cuda_engine.py first_deal + pack_state"),
    ]
    carry_script = "scripts/exp_carry_model.py:"
    meta += [(f"carry_{form}_R141", f"B-1 {name} (R = 141, {where})",
              src + "probe_carry.cu", carry_script + line)
             for form, name, where, line in (
                 ("array", "carry_array", "registers", "56"),
                 ("dict", "carry_dict", "local memory", "75"),
                 ("ref", "ref_resident", "global memory", "95"))]
    meta += [(f"stage_{name}_{T_FULL // 1024}",
              f"B-2 stage {name} ({T_FULL // 1024} blocks x {STAGE_STEPS} "
              f"steps)",
              src + "probe_stages.cu", "scripts/debug_kernel_compile.py:36")
             for name in cs.STAGES]
    # the carry rows: x + n_steps gives the output alone, not the carried
    # steps the probe prices (timed above as library)
    library = {f"carry_{form}_R141": library_ms for form in cc.FORMS}
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[key],
        "max_abs_err": err[key], "ms": times[key],
        "plain_ms": plain_ms[key], "bound_ms": bounds[key][0],
        "bound_by": bounds[key][1], "library_ms": library.get(key),
        "work": work[key][0], "unit": work[key][1],
        "plain_work": plain_work.get(key, work[key][0]),
    } for key, name, source, replaces in meta] + split_rows + k1_rows
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
