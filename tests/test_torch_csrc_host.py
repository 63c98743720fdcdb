"""The kernels' device code, compiled for the CPU, against the plain versions.

The headers in ``montecarlo_tpu_torch/csrc`` are host C++ as well (``MC_HD``
expands to ``inline`` outside nvcc). A small harness built with the host
C++ compiler runs the kernels' bodies (one rollout of K1/K2/B3, one table
of K3/K4 under every rule set, the table's cold rows in the per-thread
form and, for K4, also in the kernel's shared-column form over a host
buffer; the play-order head of every (order, cursor); whole blocks of the
net kernels K5, K6 and the probe, their block phase run as loops over the
block's lanes, with banks and, for K6, a grid of candidates at the
kernel's state and weight offsets; the dense MLP phase alone; one thread
of each carry-probe form and one table of each stage-probe body) in
Philox mode, the way the kernels key their streams, and the results must
equal the plain versions fed ``ops/philox.py``'s words. The equity
kernels' parts are held on their own too: the draw modulus, the suit
planes, the deck's draws, ``mc_rank7``'s order over every 7-card hand and
the grid rule that keeps their 32-bit counters from overflowing. The same
walk of all C(52, 7) hands certifies the device keys ``mc_eval_key`` and
``mc_eval_cmp`` as ``native/certify_evaluator.cpp`` certified the
reference evaluator (4,892 keys, a strictly increasing bijection, the
recorded digest), and the torch evaluator is held hand for hand against
that evaluator's C++ twin (``native/mcpoker.cpp``, built here). This checks the
device code's arithmetic before it meets a card; the launch geometry is
checked on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Skips without a host C++ compiler.
"""

import ctypes
import ctypes.util
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

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
from montecarlo_tpu_torch.ops import evaluator as tev
from test_torch_philox import PHILOX_KAT

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include <utility>
#include <vector>

#include <cstdlib>

#include "engine.cuh"
#include "equity.cuh"
#include "net.cuh"
#include "probe_carry.cuh"
#include "probe_net.cuh"
#include "probe_split.cuh"
#include "probe_stages.cuh"

typedef std::vector<long long> Out;

// K1: in = seed, start (hi, lo), n, inject, n_dead, dead..., hero and
// villain masks (4 each), then with inject the words [9 - n_dead, n].
template <int NDRAW>
static void k1_run(const int* in, const MCEquityParams& p, Out& out) {
  uint32_t seed = in[0];
  long long start = ((long long)in[1] << 32) | (uint32_t)in[2];
  int n = in[3];
  const int* words = in[4] ? in + 14 + in[5] : nullptr;
  uint32_t wins = 0, ties = 0;
  for (long long r = start; r < start + n; ++r) {
    int res = words ? mc_rollout_vs_hand<NDRAW, true>(p, p.deck.live, words,
                                                       n, r - start, seed)
                    : mc_rollout_vs_hand<NDRAW, false>(p, p.deck.live,
                                                        nullptr, n, r, seed);
    wins += res > 0;
    ties += res == 0;
  }
  out.push_back(wins);
  out.push_back(ties);
}

static void k1(const int* in, Out& out) {
  int n_dead = in[5];
  MCEquityParams p;
  mc_make_deck(in + 6, n_dead, &p.deck);
  mc_masks_to_planes(in + 6 + n_dead, p.hero);
  mc_masks_to_planes(in + 10 + n_dead, p.villain);
  switch (n_dead) {
    case 4: k1_run<5>(in, p, out); break;
    case 7: k1_run<2>(in, p, out); break;
    default: k1_run<1>(in, p, out); break;
  }
}

// B3: in = seed, start (hi, lo), n, inject, N, n_dead, dead..., masks
// [N, 4], then with inject the words [5 - K, n]. One thread's 32-bit
// shares, as the kernel keeps them.
template <int N, int NDRAW>
static void mw_run(const int* in, const MCMultiwayParams& p, Out& out) {
  uint32_t seed = in[0];
  long long start = ((long long)in[1] << 32) | (uint32_t)in[2];
  int n = in[3];
  const int* words = in[4] ? in + 7 + in[6] + 4 * N : nullptr;
  uint32_t shares[N] = {};
  for (long long r = start; r < start + n; ++r) {
    if (words)
      mc_rollout_multiway<N, NDRAW, true>(p, p.deck.live, words, n,
                                          r - start, seed, shares);
    else
      mc_rollout_multiway<N, NDRAW, false>(p, p.deck.live, nullptr, n, r,
                                           seed, shares);
  }
  out.insert(out.end(), shares, shares + N);
}

template <int N>
static void mw_n(const int* in, const MCMultiwayParams& p, Out& out) {
  switch (5 - (in[6] - 2 * N)) {
    case 0: mw_run<N, 0>(in, p, out); break;
    case 1: mw_run<N, 1>(in, p, out); break;
    case 2: mw_run<N, 2>(in, p, out); break;
    case 3: mw_run<N, 3>(in, p, out); break;
    case 4: mw_run<N, 4>(in, p, out); break;
    default: mw_run<N, 5>(in, p, out); break;
  }
}

static void mw(const int* in, Out& out) {
  int n_hands = in[5], n_dead = in[6];
  MCMultiwayParams p;
  mc_make_deck(in + 7, n_dead, &p.deck);
  for (int h = 0; h < n_hands; ++h)
    mc_masks_to_planes(in + 7 + n_dead + 4 * h, p.hand[h]);
  switch (n_hands) {
    case 2: mw_n<2>(in, p, out); break;
    case 3: mw_n<3>(in, p, out); break;
    case 4: mw_n<4>(in, p, out); break;
    case 6: mw_n<6>(in, p, out); break;
    case 7: mw_n<7>(in, p, out); break;
    default: mw_n<12>(in, p, out); break;
  }
}

// The draw rule's modulus: in = words; out = mc_draw_mod<D>(word) for each
// word and each D in 1..52.
template <int... D>
static void mods(uint32_t w, Out& out, std::integer_sequence<int, D...>) {
  (out.push_back(mc_draw_mod<D + 1>(w)), ...);
}

// The plane helper against mc_add_card: in = cards (any count); out = the
// four suit masks by mc_add_card, then those of mc_card_bit64's planes.
static void bits(const int* in, size_t n, Out& out) {
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  uint64_t b = 0u;
  for (size_t i = 0; i < n; ++i) {
    mc_add_card(m, in[i]);
    b |= mc_card_bit64(in[i]);
  }
  out.insert(out.end(), m, m + 4);
  const uint32_t lo = (uint32_t)b, hi = (uint32_t)(b >> 32);
  for (uint32_t x : {lo & 0xFFFFu, lo >> 16, hi & 0xFFFFu, hi >> 16})
    out.push_back(x);
}

// Every 7-card hand, in lexicographic order, through mc_rank7, mc_eval_cmp
// and mc_eval_key. out = the hands; for mc_rank7 against mc_eval_cmp: the
// distinct mc_eval_cmp keys, the hands whose mc_rank7 differs from that of
// an earlier hand with the same mc_eval_cmp key, and the distinct
// mc_eval_cmp keys (ascending) whose mc_rank7 is not above the previous
// one's; then native/certify_evaluator.cpp's certificate of the (packed,
// cmp) key table: the distinct packed and cmp keys, the hands whose key
// maps to another key than an earlier hand's (either way), the packed keys
// (ascending) whose cmp key is not above the previous one's, and the
// FNV-1a digest of the (packed << 32 | cmp) words in packed order.
static void every_hand(Out& out) {
  std::vector<uint32_t> seen((size_t)9 << 19, 0u);  // cmp key -> rank + 1
  std::vector<int32_t> p2c((size_t)1 << 24, -1), c2p((size_t)1 << 23, -1);
  long long hands = 0, clashes = 0, iso = 0;
  uint64_t bit[52];
  for (int c = 0; c < 52; ++c) bit[c] = mc_card_bit64(c);
  int c[7];
  uint64_t b[8] = {0u};
  // the hands in lexicographic order, their planes built incrementally
  for (int i = 0; i < 7; ++i) c[i] = i;
  while (true) {
    for (int i = 0; i < 7; ++i) b[i + 1] = b[i] | bit[c[i]];
    const uint32_t lo = (uint32_t)b[7], hi = (uint32_t)(b[7] >> 32);
    const uint32_t m0 = lo & 0xFFFFu, m1 = lo >> 16;
    const uint32_t m2 = hi & 0xFFFFu, m3 = hi >> 16;
    const int key = mc_eval_cmp(m0, m1, m2, m3);
    const int packed = mc_eval_key(m0, m1, m2, m3);
    const uint32_t r = mc_rank7(m0, m1, m2, m3) + 1u;
    ++hands;
    if (!seen[key]) seen[key] = r;
    clashes += seen[key] != r;
    int32_t& pc = p2c[packed];
    if (pc < 0) pc = key;
    iso += pc != key;
    int32_t& cp = c2p[key];
    if (cp < 0) cp = packed;
    iso += cp != packed;
    int i = 6;
    while (i >= 0 && c[i] == 45 + i) --i;
    if (i < 0) break;
    ++c[i];
    for (int j = i + 1; j < 7; ++j) c[j] = c[j - 1] + 1;
  }
  long long distinct = 0, disorders = 0;
  uint32_t prev = 0u;
  for (uint32_t r : seen)
    if (r) {
      ++distinct;
      disorders += r <= prev;
      prev = r;
    }
  long long n_packed = 0, n_cmp = 0, order = 0;
  long long last = -1;
  uint64_t digest = 1469598103934665603ull;
  for (uint32_t pk = 0; pk < (1u << 24); ++pk) {
    const int32_t ck = p2c[pk];
    if (ck < 0) continue;
    ++n_packed;
    order += ck <= last;
    last = ck;
    const uint64_t word = ((uint64_t)pk << 32) | (uint32_t)ck;
    for (int k = 0; k < 8; ++k) {
      digest ^= (word >> (8 * k)) & 0xFFu;
      digest *= 1099511628211ull;
    }
  }
  for (int32_t pk : c2p) n_cmp += pk >= 0;
  out.insert(out.end(), {hands, distinct, clashes, disorders, n_packed, n_cmp,
                         iso, order, (long long)digest});
}

// Words from an array, for mc_sample_cards.
struct ArrayWords {
  const int* w;
  int i;
  uint32_t next() { return (uint32_t)w[i++]; }
};

// The draws' cards against insertion plus the walk (mc_sample_cards): in
// = ND, then cases of ND ascending dead cards and 5 words; out per case =
// the two planes of mc_draw_planes, then those of mc_sample_cards' cards.
template <int ND>
static void draws(const int* in, size_t n, Out& out) {
  for (size_t i = 1; i + ND + 5 <= n; i += ND + 5) {
    MCDeck deck;
    mc_make_deck(in + i, ND, &deck);
    uint32_t w[5];
    for (int t = 0; t < 5; ++t) w[t] = (uint32_t)in[i + ND + t];
    uint32_t lo, hi, cut = 0u;
    mc_draw_planes<52 - ND, 5>(w, deck.live, lo, hi, cut);
    out.push_back(lo);
    out.push_back(hi);
    ArrayWords src{in + i + ND, 0};
    int cards[5];
    mc_sample_cards<5>(src, in + i, ND, cards);
    uint64_t b = 0u;
    for (int c : cards) b |= mc_card_bit64(c);
    out.push_back((uint32_t)b);
    out.push_back((uint32_t)(b >> 32));
  }
}

// draws<ND> for ND = in[0], 4..29.
template <int... ND>
static void draws_nd(const int* in, size_t n, Out& out,
                     std::integer_sequence<int, ND...>) {
  ((in[0] == ND + 4 ? draws<ND + 4>(in, n, out) : void()), ...);
}

// K2: in = seed, H, n, inject, dead [H, 2], hmask [H, 4], then with
// inject the words [7, H, n]; out = wins [H], ties [H]. Each hand as a
// block of the kernel: its deck from mc_hero_live, its planes, its row of
// the words; one thread's 32-bit counters.
static void k2(const int* in, Out& out) {
  uint32_t seed = in[0];
  int H = in[1], n = in[2];
  const int* dead = in + 4;
  const int* hmask = dead + 2 * H;
  const int* words = in[3] ? hmask + 4 * H : nullptr;
  Out wins(H), ties(H);
  for (int h = 0; h < H; ++h) {
    uint64_t live[50];
    for (int i = 0; i < 50; ++i)
      live[i] = mc_hero_live(i, dead[2 * h], dead[2 * h + 1]);
    uint32_t hero[2];
    mc_masks_to_planes(hmask + 4 * h, hero);
    uint32_t w = 0u, t = 0u;
    for (long long r = 0; r < n; ++r) {
      const int res =
          words ? mc_rollout_sweep<true>(hero, live, words + (long long)h * n,
                                         (long long)H * n, r, seed, h + 1u)
                : mc_rollout_sweep<false>(hero, live, nullptr,
                                          (long long)H * n, r, seed, h + 1u);
      w += res > 0;
      t += res == 0;
    }
    wins[h] = w;
    ties[h] = t;
  }
  out.insert(out.end(), wins.begin(), wins.end());
  out.insert(out.end(), ties.begin(), ties.end());
}

// K2's deck: in = pairs of ascending holes; out per pair = the 50 entries
// of mc_hero_live.
static void hero_deck(const int* in, size_t n, Out& out) {
  for (size_t i = 0; i + 2 <= n; i += 2)
    for (int k = 0; k < 50; ++k)
      out.push_back((long long)mc_hero_live(k, in[i], in[i + 1]));
}

// K2's draws: in = cases of 2 ascending holes and 7 words; out per case =
// the villain's planes (lo, hi), then the board's, of mc_draw_step<50, 7,
// 2, 0> through the hero's deck.
static void sweep_draws(const int* in, size_t n, Out& out) {
  for (size_t i = 0; i + 9 <= n; i += 9) {
    uint64_t live[50];
    for (int k = 0; k < 50; ++k) live[k] = mc_hero_live(k, in[i], in[i + 1]);
    uint32_t w[7];
    for (int t = 0; t < 7; ++t) w[t] = (uint32_t)in[i + 2 + t];
    int chosen[7];
    uint64_t vm = 0u, bm = 0u;
    uint32_t cut = 0u;
    mc_draw_step<50, 7, 2, 0>(w, live, chosen, vm, bm, cut);
    for (uint64_t m : {vm, bm}) {
      out.push_back((uint32_t)m);
      out.push_back((uint32_t)(m >> 32));
    }
  }
}

// The carry probe: in = form, R, n_steps, n_blocks, then the words
// [n_blocks, R, 8, 128]; out = the words after the steps.
static void carry(const int* in, Out& out) {
  int form = in[0], R = in[1], n_steps = in[2], nb = in[3];
  const int* x = in + 4;
  std::vector<int> res((size_t)nb * R * MC_CARRY_TABLES);
  for (long long t = 0; t < (long long)nb * MC_CARRY_TABLES; ++t) {
    switch (form * 1000 + R) {
      case 16: mc_carry_array<16>(x, res.data(), t, n_steps); break;
      case 141: mc_carry_array<141>(x, res.data(), t, n_steps); break;
      case 1141: mc_carry_dict<141>(x, res.data(), t, n_steps); break;
      case 1166: mc_carry_dict<166>(x, res.data(), t, n_steps); break;
      case 2141: mc_carry_ref<141>(x, res.data(), t, n_steps); break;
      case 2166: mc_carry_ref<166>(x, res.data(), t, n_steps); break;
      default: exit(2);
    }
  }
  out.insert(out.end(), res.begin(), res.end());
}

// rows: the packed state as [F, T] (row f of table t at f * T + t).
template <int P, int R, class Rows>
static void load_rows(MCTable<P, R, Rows>& s, const int* rows, int T, int t) {
  mc_load(s, rows + t, T);
}

template <int P, int R, class Rows>
static void store_rows(const MCTable<P, R, Rows>& s, std::vector<int>& res,
                       int T, int t) {
  mc_store(s, res.data() + t, T);
}

// The first unmasked position (mc_head) of every (order, cursor) pair:
// in = P, then the pairs.
template <int P>
static void head(const int* in, size_t n, Out& out) {
  for (size_t i = 1; i + 2 <= n; i += 2) out.push_back(mc_head<P>(in[i], in[i + 1]));
}

static const float* as_floats(const int* p) {
  return reinterpret_cast<const float*>(p);
}

// One block of the net kernels on the host: its lanes and its shared
// memory (zeroed), the shared banks' weights copied in as mc_load_weights
// does; banks past them are read from w.
template <class Lane>
struct Block {
  std::vector<Lane> lanes;
  float* smem;
  MCNetShared sh;
  Block(int n_banks, const float* w)
      : smem((float*)calloc(mc_net_smem_floats(n_banks), sizeof(float))),
        sh(mc_net_shared(smem, n_banks, w)) {
    lanes.reserve(MC_NET_THREADS);
    memcpy(sh.w, w, sizeof(float) * mc_smem_banks(n_banks) * MC_NET_WEIGHTS);
  }
  ~Block() { free(smem); }
  MCLanes<Lane> view() { return MCLanes<Lane>{lanes.data()}; }
};

// Phase (b) alone: in = n_banks, the rows of each bank, the weights, then
// the staged features [n, 24] grouped by bank; out = the logits [n, 4].
// The counts go to the warps in turn, bank b's rows split over them.
static void mlp(const int* in, Out& out) {
  int n_banks = in[0];
  const int* per_bank = in + 1;
  const float* w = as_floats(in + 1 + n_banks);
  const float* feats = w + (size_t)n_banks * MC_NET_WEIGHTS;
  Block<MCNetLane<MCTableLocal<6, MC_STANDARD>, int>> blk(n_banks, w);
  int n = 0;
  for (int b = 0; b < n_banks; ++b) {
    for (int k = 0; k < MC_NET_WARPS; ++k)
      blk.sh.cnt[k * MC_MAX_BANKS + b] =
          per_bank[b] / MC_NET_WARPS + (k < per_bank[b] % MC_NET_WARPS);
    n += per_bank[b];
  }
  for (int r = 0; r < n; ++r)
    for (int i = 0; i < MC_NUM_FEATURES; ++i)
      blk.sh.x[r * MC_NET_X_STRIDE + i] = feats[r * MC_NUM_FEATURES + i];
  mc_mlp_rows(blk.sh, n_banks);
  for (int r = 0; r < n; ++r)
    for (int a = 0; a < MC_NUM_ACTIONS; ++a) {
      int32_t bits;
      memcpy(&bits, &blk.sh.x[r * MC_NET_X_STRIDE + a], 4);
      out.push_back(bits);
    }
}

// in: P, rules, then the mode's arguments (see the Python side).
template <int P, int R>
static void engine(const char* mode, const int* in, Out& out) {
  constexpr int F = mc_fields<P, R>(), NC = 2 * P + 5;
  in += 2;
  if (!strcmp(mode, "probe")) {
    // the probe kernel's blocks: the logits through the block phase
    int bb = in[0], T = in[1];
    const float* w = as_floats(in + 2);
    const int* rows = in + 2 + MC_NET_WEIGHTS;
    const int* words = rows + (size_t)F * T;
    std::vector<float> o((size_t)MC_PROBE_ROWS * T);
    for (int t0 = 0; t0 < T; t0 += MC_NET_THREADS) {
      Block<MCNetLane<MCTableLocal<P, R>, int>> blk(1, w);
      for (int t = 0; t < MC_NET_THREADS; ++t) {
        blk.lanes.emplace_back(0);
        load_rows(blk.lanes[t].s, rows, T, t0 + t);
      }
      mc_run_net_probe<P, R>(blk.view(), blk.sh, words, o.data(), t0, T, bb);
    }
    for (float x : o) {
      int32_t bits;
      memcpy(&bits, &x, 4);
      out.push_back(bits);
    }
    return;
  }
  // the engine modes return the final rows
  int T;
  const int* rows;
  std::vector<int> res;
  if (!strcmp(mode, "k3")) {
    int n_steps = in[0], hmax = in[1], sb = in[2], bb = in[3];
    T = in[4];
    rows = in + 5;
    const int* acts = rows + (size_t)F * T;
    const int* stash = acts + (size_t)n_steps * T;
    res.resize((size_t)F * T);
    for (int t = 0; t < T; ++t) {
      MCTableLocal<P, R> s;
      load_rows(s, rows, T, t);
      mc_run_det(s, acts + t, stash + t, T, n_steps, hmax, sb, bb);
      store_rows(s, res, T, t);
    }
  } else if (!strcmp(mode, "k4") || !strcmp(mode, "k4shared")) {
    // K4 in Philox mode; k4shared keeps the cold rows as the kernel does,
    // in columns of a block's buffer (MCRowsShared, 64 tables a block)
    uint32_t seed = in[0], fold = in[5], raise = in[6];
    int n_steps = in[1], defer = in[2], sb = in[3], bb = in[4];
    T = in[7];
    rows = in + 8;
    res.resize((size_t)F * T);
    std::vector<int> block((size_t)MCCold<P, R>::N * 64);
    for (int t = 0; t < T; ++t) {
      MCPhiloxWords src(seed, (uint32_t)t, 0u, 0u);
      if (!strcmp(mode, "k4")) {
        MCTableLocal<P, R> s;
        load_rows(s, rows, T, t);
        mc_run_prng(s, src, n_steps, defer, sb, bb, fold, raise);
        store_rows(s, res, T, t);
      } else {
        MCTable<P, R, MCRowsShared<64>> s;
        s.rows.col = block.data() + t % 64;
        load_rows(s, rows, T, t);
        mc_run_prng(s, src, n_steps, defer, sb, bb, fold, raise);
        store_rows(s, res, T, t);
      }
    }
  } else if (!strcmp(mode, "stage")) {
    // the stage probe in Philox mode: stage, seed, n_steps, sb, bb, fold,
    // raise, T, rows
    int stage = in[0], n_steps = in[2], sb = in[3], bb = in[4];
    uint32_t seed = in[1], fold = in[5], raise = in[6];
    T = in[7];
    rows = in + 8;
    res.resize((size_t)F * T);
    for (int t = 0; t < T; ++t) {
      MCTableLocal<P, R> s;
      load_rows(s, rows, T, t);
      MCPhiloxWords src(seed, (uint32_t)t, 0u, MC_SUB_PROBE);
      for (int i = 0; i < n_steps; ++i) {
        switch (stage) {
#define MC_STAGE_CASE(ID) \
  case ID: mc_stage_step<ID>(s, src, sb, bb, fold, raise); break;
          MC_STAGE_CASE(MC_STAGE_CARRY) MC_STAGE_CASE(MC_STAGE_POLICY)
          MC_STAGE_CASE(MC_STAGE_STREET) MC_STAGE_CASE(MC_STAGE_DEAL)
          MC_STAGE_CASE(MC_STAGE_SETTLE) MC_STAGE_CASE(MC_STAGE_FULL)
#undef MC_STAGE_CASE
          default: exit(2);
        }
      }
      store_rows(s, res, T, t);
    }
  } else if (!strcmp(mode, "split")) {
    // the K4 split in Philox mode (6 seats, reference rules): variant,
    // seed, n_steps, defer, sb, bb, fold, raise, shared, T, rows; with
    // shared the cold rows in columns of a block buffer, as the kernel's
    if constexpr (P == 6 && R == MC_REFERENCE) {
      int variant = in[0], n_steps = in[2], defer = in[3], sb = in[4],
          bb = in[5];
      uint32_t seed = in[1], fold = in[6], raise = in[7];
      bool shared = in[8];
      T = in[9];
      rows = in + 10;
      res.resize((size_t)F * T);
      std::vector<int> block((size_t)MCCold<P, R>::N * 64);
      for (int t = 0; t < T; ++t) {
        MCPhiloxWords src(seed, (uint32_t)t, 0u, 0u);
        MCTableLocal<P, R> sl;
        MCTable<P, R, MCRowsShared<64>> ss;
        ss.rows.col = block.data() + t % 64;
        if (shared)
          load_rows(ss, rows, T, t);
        else
          load_rows(sl, rows, T, t);
        switch (variant) {
#define MC_SPLIT_CASE(ID)                                                \
  case ID:                                                               \
    if (shared)                                                          \
      mc_split_run<ID>(ss, src, n_steps, defer, sb, bb, fold, raise);    \
    else                                                                 \
      mc_split_run<ID>(sl, src, n_steps, defer, sb, bb, fold, raise);    \
    break;
          MC_SPLIT_CASE(MC_SPLIT_FULL) MC_SPLIT_CASE(MC_SPLIT_STUB_SETTLE)
          MC_SPLIT_CASE(MC_SPLIT_STUB_EVAL) MC_SPLIT_CASE(MC_SPLIT_STUB_DEAL)
          MC_SPLIT_CASE(MC_SPLIT_STUB_POLICY)
          MC_SPLIT_CASE(MC_SPLIT_STUB_STREET)
          MC_SPLIT_CASE(MC_SPLIT_SETTLE_COPY)
          MC_SPLIT_CASE(MC_SPLIT_STREET_COPY)
#undef MC_SPLIT_CASE
          default: exit(2);
        }
        if (shared)
          store_rows(ss, res, T, t);
        else
          store_rows(sl, res, T, t);
      }
    } else {
      exit(2);
    }
  } else if (!strcmp(mode, "net_split")) {
    // the K6 split's blocks in Philox mode (6 seats, standard rules, one
    // net): variant, seed, n_steps, defer, sb, bb, ss, net_seats, reset,
    // fold, raise, T, the weights, rows; the final rows, then the count
    // of net decisions
    if constexpr (P == 6 && R == MC_STANDARD) {
      int variant = in[0], n_steps = in[2], defer = in[3], sb = in[4],
          bb = in[5], ss = in[6], net_seats = in[7];
      bool reset = in[8];
      uint32_t seed = in[1], fold = in[9], raise = in[10];
      T = in[11];
      const float* w = as_floats(in + 12);
      rows = in + 12 + MC_NET_WEIGHTS;
      res.resize((size_t)F * T);
      long long n_net = 0;
      for (int t0 = 0; t0 < T; t0 += MC_NET_THREADS) {
        Block<MCNetLane<MCTableLocal<P, R>, MCWords>> blk(1, w);
        for (int t = 0; t < MC_NET_THREADS; ++t) {
          blk.lanes.emplace_back(MCWords(nullptr, T, t0 + t, seed,
                                         (uint32_t)(t0 + t), 0u, 0u));
          load_rows(blk.lanes[t].s, rows, T, t0 + t);
        }
        switch (variant) {
#define MC_NET_SPLIT_CASE(ID)                                            \
  case ID:                                                               \
    mc_split_run_net_eval<ID, P, R>(blk.view(), blk.sh, n_steps, defer,  \
                                    sb, bb, ss, net_seats, reset, fold,  \
                                    raise, 1, 0ull);                     \
    break;
          MC_NET_SPLIT_CASE(MC_NET_SPLIT_FULL)
          MC_NET_SPLIT_CASE(MC_NET_SPLIT_STUB_GUMBEL)
          MC_NET_SPLIT_CASE(MC_NET_SPLIT_STUB_FEAT_EVAL)
          MC_NET_SPLIT_CASE(MC_NET_SPLIT_STUB_FEATURES)
          MC_NET_SPLIT_CASE(MC_NET_SPLIT_STUB_NET)
          MC_NET_SPLIT_CASE(MC_NET_SPLIT_FEAT_COPY)
#undef MC_NET_SPLIT_CASE
          default: exit(2);
        }
        for (int t = 0; t < MC_NET_THREADS; ++t) {
          store_rows(blk.lanes[t].s, res, T, t0 + t);
          n_net += blk.lanes[t].n_net;
        }
      }
      out.insert(out.end(), res.begin(), res.end());
      out.push_back(n_net);
      return;
    } else {
      exit(2);
    }
  } else if (!strcmp(mode, "k5")) {
    // K5's blocks of MC_NET_THREADS tables
    int n_steps = in[0], hmax = in[1], sb = in[2], bb = in[3];
    T = in[4];
    int n_banks = in[5];
    unsigned long long bank_map =
        (unsigned long long)(uint32_t)in[6] | (unsigned long long)in[7] << 32;
    const float* w = as_floats(in + 8);
    rows = in + 8 + (size_t)n_banks * MC_NET_WEIGHTS;
    const int* stash = rows + (size_t)F * T;
    res.resize((size_t)F * T);
    for (int t0 = 0; t0 < T; t0 += MC_NET_THREADS) {
      Block<MCNetLane<MCTableLocal<P, R>, const int*>> blk(n_banks, w);
      for (int t = 0; t < MC_NET_THREADS; ++t) {
        blk.lanes.emplace_back(stash + t0 + t);
        load_rows(blk.lanes[t].s, rows, T, t0 + t);
      }
      mc_run_net_det<P, R>(blk.view(), blk.sh, T, n_steps, hmax, sb, bb,
                           n_banks, bank_map);
      for (int t = 0; t < MC_NET_THREADS; ++t)
        store_rows(blk.lanes[t].s, res, T, t0 + t);
    }
  } else if (!strcmp(mode, "k6")) {
    // a population launch, grid (candidates, blocks of MC_NET_THREADS
    // tables), on the packed state [C, n_blocks, F, 8, 128] at the
    // kernel's offsets: the final state, then the count of net decisions
    uint32_t seed = in[0], fold = in[8], raise = in[9];
    int n_steps = in[1], defer = in[2], sb = in[3], bb = in[4], ss = in[5];
    int net_seats = in[6];
    bool reset = in[7];
    T = in[10];
    int C = in[11], n_banks = in[12];
    unsigned long long bank_map = (unsigned long long)(uint32_t)in[13] |
                                  (unsigned long long)in[14] << 32;
    const float* weights = as_floats(in + 15);
    const int* state = in + 15 + (size_t)C * n_banks * MC_NET_WEIGHTS;
    res.assign(state, state + (size_t)C * T * F);
    long long n_net = 0;
    for (long long c = 0; c < C; ++c) {
      int* cand = res.data() + mc_candidate_state<P, R>(c, T);
      for (int t0 = 0; t0 < T; t0 += MC_NET_THREADS) {
        Block<MCNetLane<MCTableLocal<P, R>, MCWords>> blk(
            n_banks, weights + mc_candidate_weights(c, n_banks));
        for (int t = 0; t < MC_NET_THREADS; ++t) {
          blk.lanes.emplace_back(MCWords(nullptr, T, t0 + t, seed,
                                         (uint32_t)(t0 + t), 0u, 0u));
          mc_load(blk.lanes[t].s, mc_table_rows<P, R>(cand, t0 + t),
                  MC_TABLES_PER_BLOCK);
        }
        mc_run_net_eval<P, R>(blk.view(), blk.sh, n_steps, defer, sb, bb,
                              ss, net_seats, reset, fold, raise, n_banks,
                              bank_map);
        for (int t = 0; t < MC_NET_THREADS; ++t) {
          mc_store(blk.lanes[t].s, mc_table_rows<P, R>(cand, t0 + t),
                   MC_TABLES_PER_BLOCK);
          n_net += blk.lanes[t].n_net;
        }
      }
    }
    out.insert(out.end(), res.begin(), res.end());
    out.push_back(n_net);
    return;
  } else {
    exit(2);
  }
  (void)NC;
  out.insert(out.end(), res.begin(), res.end());
}

// The first-state kernel's tables, one at a time, at their offsets in a
// packed state [n_blocks, F, 8, 128]: in = P, rules, seed, first_table
// (hi, lo), n_tables, sb, bb, ss.
template <int P, int R>
static void first_state(const int* in, Out& out) {
  uint32_t seed = in[2];
  long long first = ((long long)in[3] << 32) | (uint32_t)in[4];
  int n = in[5];
  std::vector<int> state((size_t)n * mc_fields<P, R>(), 0x5A5A5A5A);
  for (int t = 0; t < n; ++t)
    mc_first_state_rows<P, R>(mc_table_rows<P, R>(state.data(), t),
                              MC_TABLES_PER_BLOCK, seed,
                              (uint32_t)(first + t), in[6], in[7], in[8]);
  out.insert(out.end(), state.begin(), state.end());
}

static int first_state_any(const int* in, Out& out) {
  switch (in[1] * 100 + in[0]) {
#define MC_FS(N)                                                    \
  case N: first_state<N, MC_REFERENCE>(in, out); return 0;          \
  case 100 + N: first_state<N, MC_STANDARD>(in, out); return 0;     \
  case 200 + N: first_state<N, MC_TOURNAMENT>(in, out); return 0;
    MC_FS(2) MC_FS(3) MC_FS(4) MC_FS(5) MC_FS(6) MC_FS(7) MC_FS(8)
    MC_FS(9) MC_FS(10)
#undef MC_FS
    default: return 2;
  }
}

int main(int argc, char** argv) {
  if (argc != 4) return 2;
  std::vector<int> in;
  FILE* f = fopen(argv[2], "rb");
  int x;
  while (fread(&x, sizeof x, 1, f) == 1) in.push_back(x);
  fclose(f);
  Out out;
  if (!strcmp(argv[1], "kat")) {
    for (size_t i = 0; i + 6 <= in.size(); i += 6) {
      uint32_t c[4] = {(uint32_t)in[i], (uint32_t)in[i + 1],
                       (uint32_t)in[i + 2], (uint32_t)in[i + 3]};
      mc_philox4x32_10(c, in[i + 4], in[i + 5]);
      for (int j = 0; j < 4; ++j) out.push_back(c[j]);
    }
  } else if (!strcmp(argv[1], "k1")) {
    k1(in.data(), out);
  } else if (!strcmp(argv[1], "mod")) {
    for (int x : in)
      mods((uint32_t)x, out, std::make_integer_sequence<int, 52>());
  } else if (!strcmp(argv[1], "grid")) {
    for (size_t i = 0; i + 4 <= in.size(); i += 4)
      out.push_back(mc_rollout_grid(
          ((long long)in[i] << 32) | (uint32_t)in[i + 1], in[i + 2],
          in[i + 3]));
  } else if (!strcmp(argv[1], "every_hand")) {
    every_hand(out);
  } else if (!strcmp(argv[1], "bits")) {
    bits(in.data(), in.size(), out);
  } else if (!strcmp(argv[1], "draws")) {
    draws_nd(in.data(), in.size(), out,
             std::make_integer_sequence<int, 26>());
  } else if (!strcmp(argv[1], "k2")) {
    k2(in.data(), out);
  } else if (!strcmp(argv[1], "hero_deck")) {
    hero_deck(in.data(), in.size(), out);
  } else if (!strcmp(argv[1], "sweep_draws")) {
    sweep_draws(in.data(), in.size(), out);
  } else if (!strcmp(argv[1], "sweep_grid")) {
    // K2's blocks a hand: in = n (hi, lo), H, wave
    for (size_t i = 0; i + 4 <= in.size(); i += 4)
      out.push_back(mc_rollout_grid(
          ((long long)in[i] << 32) | (uint32_t)in[i + 1], 1u, in[i + 3],
          in[i + 2]));
  } else if (!strcmp(argv[1], "mw")) {
    mw(in.data(), out);
  } else if (!strcmp(argv[1], "carry")) {
    carry(in.data(), out);
  } else if (!strcmp(argv[1], "mlp")) {
    mlp(in.data(), out);
  } else if (!strcmp(argv[1], "head")) {
    switch (in[0]) {
      case 2: head<2>(in.data(), in.size(), out); break;
      case 3: head<3>(in.data(), in.size(), out); break;
      case 4: head<4>(in.data(), in.size(), out); break;
      case 5: head<5>(in.data(), in.size(), out); break;
      case 6: head<6>(in.data(), in.size(), out); break;
      default: return 2;
    }
  } else if (!strcmp(argv[1], "first_state")) {
    if (first_state_any(in.data(), out)) return 2;
  } else if (!strcmp(argv[1], "det_settle_min")) {
    out.push_back(MC_DET_SETTLE_MIN);
  } else if (!strcmp(argv[1], "key")) {
    for (size_t i = 1; i + 4 <= in.size(); i += 4)
      out.push_back(mc_eval_key(in[i], in[i + 1], in[i + 2], in[i + 3]));
  } else {
    switch (in[1] * 100 + in[0]) {
      case 2: engine<2, MC_REFERENCE>(argv[1], in.data(), out); break;
      case 3: engine<3, MC_REFERENCE>(argv[1], in.data(), out); break;
      case 6: engine<6, MC_REFERENCE>(argv[1], in.data(), out); break;
      case 102: engine<2, MC_STANDARD>(argv[1], in.data(), out); break;
      case 103: engine<3, MC_STANDARD>(argv[1], in.data(), out); break;
      case 106: engine<6, MC_STANDARD>(argv[1], in.data(), out); break;
      case 202: engine<2, MC_TOURNAMENT>(argv[1], in.data(), out); break;
      case 203: engine<3, MC_TOURNAMENT>(argv[1], in.data(), out); break;
      case 206: engine<6, MC_TOURNAMENT>(argv[1], in.data(), out); break;
      default: return 2;
    }
  }
  f = fopen(argv[3], "wb");
  fwrite(out.data(), sizeof(long long), out.size(), f);
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the device code "
                    "for the CPU")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "harness.cc").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I",
                    str(_build.CSRC),
                    str(d / "harness.cc"), "-o", str(exe)], check=True,
                   capture_output=True, timeout=600)

    def run(mode, ints):
        src, dst = d / f"{mode}.in", d / f"{mode}.out"
        (np.asarray(ints, np.int64) & 0xFFFFFFFF).astype(np.uint32) \
            .view(np.int32).tofile(src)
        subprocess.run([str(exe), mode, str(src), str(dst)], check=True,
                       timeout=600)
        return np.fromfile(dst, np.int64)
    return run


def test_philox_header_known_answers(harness):
    got = harness("kat", [v for ck, _ in PHILOX_KAT for v in ck])
    assert got.reshape(-1, 4).tolist() == [w for _, w in PHILOX_KAT]


@pytest.mark.parametrize("board,start", [
    ((), 0), ((5, 6, 7), (1 << 32) - 1000), ((5, 6, 7, 44), 77)])
def test_equity_rollout_device_code_equals_plain(harness, board, start):
    seed, n = 0x9E3779B9, 3000
    dead, hm, vm = (m.tolist() for m in cq._hand_masks(
        [0, 12], [25, 38], board, "cpu"))
    got = harness("k1", [seed, start >> 32, start & 0xFFFFFFFF, n, 0,
                         len(dead), *dead, *hm, *vm])
    words = cq.equity_words(seed, 9 - len(dead), start, n, "cpu")
    assert got.tolist() == cq._equity_counts_plain(words, dead, hm,
                                                   vm).tolist()


@pytest.mark.parametrize("board", [(), (5, 6, 7), (5, 6, 7, 44),
                                   (13, 26, 51, 0)])
def test_equity_rollout_injected_device_code_equals_plain(harness, board):
    """K1 on injected words (its INJECT form), at every NDRAW."""
    n = 2000
    dead, hm, vm = (m.tolist() for m in cq._hand_masks(
        [1, 14], [27, 40], board, "cpu"))
    words = torch.from_numpy(np.random.default_rng(len(board)).integers(
        0, 1 << 32, (9 - len(dead), n), dtype=np.int64))
    got = harness("k1", [0, 0, 0, n, 1, len(dead), *dead, *hm, *vm,
                         *words.reshape(-1).tolist()])
    assert got.tolist() == cq._equity_counts_plain(words, dead, hm,
                                                   vm).tolist()


@pytest.mark.parametrize("d", range(1, 53))
def test_draw_mod_equals_remainder(harness, d):
    """mc_draw_mod<D> (a draw modulo the compile-time live count) against
    %, on edge words and seeded random words, for every D in 1..52."""
    rng = np.random.default_rng(d)
    words = np.concatenate([[0, 1, d - 1, d, d + 1, (1 << 32) - 1,
                             (1 << 32) - d, (1 << 31) + d],
                            rng.integers(0, 1 << 32, 256)]).astype(np.int64)
    got = harness("mod", words.tolist()).reshape(-1, 52)[:, d - 1]
    assert got.tolist() == (words % d).tolist()


@pytest.mark.parametrize("seed", range(4))
def test_card_planes_equal_add_card(harness, seed):
    """mc_card_bit64's packed planes, unpacked, equal mc_add_card's suit
    masks and the plain version's, for seeded card sets of 0 to 52
    cards."""
    rng = np.random.default_rng(seed)
    for k in (0, 1, 2, 5, 7, 13, 52):
        cards = rng.permutation(52)[:k].tolist()
        got = harness("bits", cards)
        plain = [int(m) for m in tev.suit_masks_from_cards(
            torch.tensor(cards, dtype=torch.int32).reshape(1, -1))] \
            if k else [0] * 4
        assert got[:4].tolist() == plain
        assert got[4:].tolist() == plain


@pytest.mark.parametrize("n_hands", [1, 2, 3, 7, 12])
def test_rollout_grid_keeps_counters_in_32_bits(harness, n_hands):
    """mc_rollout_grid, K1's and B3's block count: a thread's rollouts x
    lcm(1..N) (its 32-bit counters' largest value; 1 for K1) stay below
    2^32 for any n; the grid is MC_EQUITY_WAVES waves of resident blocks,
    fewer for a small n, more where the counters need it."""
    per = 1 if n_hands == 1 else cq.multiway_scale(n_hands)
    wave = 132 * 6
    ns = [0, 1, 255, 256, 257, 10**6, 1 << 30, (1 << 32) + 1, 10**12,
          (1 << 40) + 7, (1 << 62) - 1]
    got = harness("grid", [x for n in ns for x in (n >> 32, n & 0xFFFFFFFF,
                                                    per, wave)])
    per_thread = 0xFFFFFFFF // per
    for n, b in zip(ns, got.tolist()):
        need = -(-(-(-n // per_thread)) // 256)
        assert b == max(min(-(-n // 256), 16 * wave), need, 1)
        assert -(-n // (b * 256)) * per <= 0xFFFFFFFF


@pytest.fixture(scope="module")
def every_hand(harness):
    """The harness's walk of all C(52, 7) hands (mode ``every_hand``)."""
    return harness("every_hand", []).tolist()


def test_rank7_orders_every_hand_as_eval_cmp(every_hand):
    """mc_rank7 (the equity kernels' key) orders all C(52, 7) hands as
    mc_eval_cmp does: one mc_rank7 value per mc_eval_cmp key, increasing
    with it, over all 4,892 keys. Hand against hand, every comparison and
    tie of K1 and B3 is then mc_eval_cmp's."""
    hands, distinct, clashes, disorders = every_hand[:4]
    assert hands == 133_784_560 and distinct == 4892
    assert clashes == 0 and disorders == 0


def test_device_evaluator_certified_on_every_hand(every_hand):
    """native/certify_evaluator.cpp's certificate, for the device keys: on
    all C(52, 7) hands mc_eval_key (the packed key) and mc_eval_cmp take
    4,892 values each, the map between them is a bijection and strictly
    increasing, and the (packed, cmp) table has the digest that the
    certification of the reference evaluator recorded."""
    hands, *_, n_packed, n_cmp, iso, order, digest = every_hand
    assert hands == 133_784_560
    assert n_packed == n_cmp == 4892
    assert iso == 0 and order == 0
    assert f"{digest & (2**64 - 1):016x}" == "fc0295d3f7577d5b"


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """``native/mcpoker.cpp``'s batch evaluators (the C++ twin of the JAX
    evaluator that ``native/certify_evaluator.cpp`` certified), built here
    into a temporary directory, never in ``native/``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build native/mcpoker.cpp")
    d = tmp_path_factory.mktemp("mcpoker")
    lib = d / "libmcpoker_twin.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-shared",
                    str(_build.CSRC.parents[1] / "native" / "mcpoker.cpp"),
                    "-o", str(lib)], check=True, capture_output=True,
                   timeout=600)
    so = ctypes.CDLL(str(lib))
    fns = {}
    for name in ("mc_eval7_batch", "mc_eval7_cmp_batch"):
        fn = getattr(so, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_uint32)]
        fns[name] = fn

    def run(name, hands):
        a = np.ascontiguousarray(hands, np.int32)
        out = np.empty(a.shape[0], np.uint32)
        fns[name](a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                  a.shape[0], out.ctypes.data_as(
                      ctypes.POINTER(ctypes.c_uint32)))
        return out.astype(np.int64)
    run.so = so  # the library stays loaded while the fixture lives
    return run


def _structured_hands():
    """7-card hands of every category and its edges: high card, a pair,
    trips, straight flushes at every top (and the ace-low run that is no
    straight), quads, two trips,
    trips over two pairs, three pairs, six and seven of a suit, straights
    with pairs, a seeded fill for the rest."""
    rng = np.random.default_rng(2)
    card = lambda s, r: s * 13 + (r - 2)  # noqa: E731
    hands = []

    def fill(base):
        rest = [c for c in rng.permutation(52).tolist() if c not in base]
        return base + rest[:7 - len(base)]
    for s in range(4):
        for top in range(6, 15):
            hands.append(fill([card(s, r) for r in range(top - 4, top + 1)]))
        hands.append(fill([card(s, r) for r in (14, 2, 3, 4, 5)]))
        hands.append([card(s, r) for r in (2, 4, 6, 8, 10, 12, 14)])
        hands.append(fill([card(s, r) for r in (3, 5, 7, 9, 11, 13)]))
    for r in range(2, 15):
        # high card, a pair, trips: ranks two apart, suits mixed
        spread = [2 + (r - 2 + 2 * k) % 13 for k in range(7)]
        hands.append([card(k % 4, x) for k, x in enumerate(spread)])
        hands.append([card(0, r)] + [card((k + 1) % 4, x)
                                     for k, x in enumerate(spread[:6])])
        hands.append([card(1, r), card(2, r)] + [card(k % 4, x) for k, x
                                                 in enumerate(spread[:5])])
        hands.append(fill([card(s, r) for s in range(4)]))
        r2 = 2 + (r - 1) % 13
        hands.append(fill([card(s, r) for s in range(3)]
                          + [card(s, r2) for s in range(3)]))
        r3 = 2 + (r + 3) % 13
        hands.append([card(s, r) for s in range(3)]
                     + [card(s, r2) for s in range(2)]
                     + [card(s, r3) for s in (1, 2)])
        hands.append([card(0, r), card(1, r), card(2, r2), card(3, r2),
                      card(0, r3), card(1, r3), card(2, 2 + (r + 6) % 13)])
        if r <= 10:
            hands.append([card(s % 4, r + s) for s in range(5)]
                         + [card(1, r), card(2, r + 1)])
    return np.array(hands, np.int32)


@pytest.mark.parametrize("kind", ["random", "structured"])
def test_evaluator_equals_native_twin(twin, kind):
    """ops/evaluator.py's two keys against native/mcpoker.cpp's
    mc_eval7_batch (packed) and mc_eval7_cmp_batch (cmp), hand for
    hand."""
    if kind == "random":
        rng = np.random.default_rng(11)
        hands = np.argsort(rng.random((200_000, 52)), axis=1)[:, :7] \
            .astype(np.int32)
    else:
        hands = _structured_hands()
        assert all(len(set(h)) == 7 for h in hands.tolist())
    masks = tev.suit_masks_from_cards(torch.from_numpy(hands))
    packed = tev.eval_masks_impl(*masks).numpy().astype(np.int64)
    cmp = tev.eval_masks_cmp_impl(*masks).numpy().astype(np.int64)
    np.testing.assert_array_equal(packed, twin("mc_eval7_batch", hands))
    np.testing.assert_array_equal(cmp, twin("mc_eval7_cmp_batch", hands))
    if kind == "structured":  # every category is reached
        assert set((packed >> 20).tolist()) == set(range(9))


@pytest.mark.parametrize("n_dead", range(4, 30))
def test_deck_draws_equal_insertion_and_walk(harness, n_dead):
    """The draws' cards through the deck (mc_draw_planes) equal bubble
    insertion then the walk past the dead cards (mc_sample_cards) and the
    plain version's, for seeded dead sets of 4 to 29 cards."""
    rng = np.random.default_rng(n_dead)
    cases, dead_sets, word_rows = [n_dead], [], []
    for i in range(64):
        dead = np.sort(rng.permutation(52)[:n_dead])
        words = rng.integers(0, 1 << 32, 5)
        if i == 0:  # the first and the last live card
            words[:2] = [0, (1 << 32) - 1]
        dead_sets.append(dead)
        word_rows.append(words)
        cases += [*dead.tolist(), *words.tolist()]
    got = harness("draws", cases).reshape(-1, 4)
    assert got[:, :2].tolist() == got[:, 2:].tolist()
    for row, dead, words in zip(got, dead_sets, word_rows):
        cards = cq._sample_cards(torch.tensor(words, dtype=torch.int64),
                                 dead.tolist())
        b = sum(1 << (c + 3 * (c // 13) + 2) for c in map(int, cards))
        assert row[:2].tolist() == [b & 0xFFFFFFFF, b >> 32]


def _sweep_heroes(heroes):
    """(dead [H, 2] ascending, hero masks [H, 4]) of [H, 2] hero holes."""
    heroes = torch.as_tensor(heroes, dtype=torch.int32).reshape(-1, 2)
    return (torch.sort(heroes, dim=1).values,
            torch.stack(cq.suit_masks_from_cards(heroes), dim=1))


def test_sweep_rollout_device_code_equals_plain(harness):
    dead, hm = _sweep_heroes([[0, 13], [5, 40], [12, 51], [20, 21]])
    got = harness("k2", [17, 4, 2000, 0, *dead.reshape(-1).tolist(),
                         *hm.reshape(-1).tolist()])
    want = cq._sweep_counts_plain_philox(17, dead, hm, 2000)
    assert got.reshape(2, 4).tolist() == want.tolist()


@pytest.mark.parametrize("inject", [False, True])
def test_sweep_rollout_169_heroes_equals_plain(harness, inject):
    """K2's rollout (mc_rollout_sweep, each hero's deck, one thread's 32-bit
    counters) over the 169 canonical heroes equals the plain version: in
    Philox mode the kernel's streams (hand h's sub-stream h + 1), and on
    injected words hand h's row of words [7, H, n]."""
    from montecarlo_tpu_torch.rollout import equity as teq
    dead, hm = _sweep_heroes([list(c) for _, c in teq.canonical_hands()])
    n = 301 if inject else 1001
    ints = [23, 169, n, int(inject), *dead.reshape(-1).tolist(),
            *hm.reshape(-1).tolist()]
    if inject:
        words = torch.from_numpy(np.random.default_rng(10).integers(
            0, 1 << 32, (7, 169, n), dtype=np.int64))
        want = cq._sweep_counts_plain(words, dead, hm)
        ints += words.reshape(-1).tolist()
    else:
        want = cq._sweep_counts_plain_philox(23, dead, hm, n)
    assert harness("k2", ints).reshape(2, 169).tolist() == want.tolist()


@pytest.mark.parametrize("holes", [(0, 1), (50, 51), (0, 51), (12, 13),
                                   (25, 26)])
def test_hero_deck_equals_sample_cards_shift(harness, holes):
    """K2's deck (mc_hero_live) maps live index i to the card that
    _sample_cards' shift past the hero's two ascending holes gives, as its
    plane bit, at the deck's edges."""
    got = harness("hero_deck", list(holes))
    cards = cq._sample_cards(torch.arange(50, dtype=torch.int64)[None],
                             list(holes))[0]
    assert sorted(set(cards.tolist()) | set(holes)) == list(range(52))
    assert got.tolist() == [1 << (c + 3 * (c // 13) + 2)
                            for c in cards.tolist()]


@pytest.mark.parametrize("seed", range(4))
def test_sweep_draws_planes_equal_sample_cards(harness, seed):
    """K2's draws (mc_draw_step<50, 7, 2, 0> through the hero's deck): the
    villain's planes (draws 0-1) and the board's (draws 2-6) equal
    _sample_cards + _masks_of on seeded words and hero holes."""
    rng = np.random.default_rng(seed)
    cases, rows = [], []
    for i in range(64):
        holes = np.sort(rng.permutation(52)[:2])
        words = rng.integers(0, 1 << 32, 7)
        if i == 0:  # the first and the last live card
            words[:2] = [0, (1 << 32) - 1]
        cases += [*holes.tolist(), *words.tolist()]
        rows.append((holes, words))
    got = harness("sweep_draws", cases).reshape(-1, 4)
    for (lo_v, hi_v, lo_b, hi_b), (holes, words) in zip(got.tolist(), rows):
        cards = cq._sample_cards(torch.tensor(words, dtype=torch.int64),
                                 holes.tolist())
        for (lo, hi), part in (((lo_v, hi_v), cards[:2]),
                               ((lo_b, hi_b), cards[2:])):
            masks = [int(m) for m in cq._masks_of(part)]
            assert [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16] == masks


@pytest.mark.parametrize("H", [1, 169, 65535])
def test_sweep_grid_keeps_counters_in_32_bits(harness, H):
    """K2's blocks a hand (mc_rollout_grid over H rows): at least 1,
    MC_EQUITY_WAVES waves of resident blocks over all hands, fewer for a
    small n, and enough that a thread's rollouts (its 32-bit counters'
    largest value) stay below 2^32 for any n per hand up to 2^40."""
    wave = 132 * 6
    ns = [0, 1, 255, 256, 257, 10**6, 10**7, 1 << 30, (1 << 32) + 1,
          10**12, 1 << 40]
    got = harness("sweep_grid", [x for n in ns for x in (
        n >> 32, n & 0xFFFFFFFF, H, wave)])
    for n, b in zip(ns, got.tolist()):
        need = -(-(-(-n // 0xFFFFFFFF)) // 256)
        assert b == max(min(-(-n // 256), -(-16 * wave // H)), need, 1)
        assert -(-n // (b * 256)) < 1 << 32


def _flat(x):
    return x.reshape(-1).tolist()


def _weights_as_ints(weights):
    return _flat(weights.view(torch.int32))


def _check_rows(got, want_state, cfg):
    want = ce._to_rows(want_state)
    np.testing.assert_array_equal(got.astype(np.int32).reshape(want.shape),
                                  want.numpy())
    assert int(ce.unpack_field(want_state, cfg, "hand_ct").sum()) > 0


@pytest.mark.parametrize("P,n_steps", [(6, 64), (2, 24)])
def test_engine_prng_device_code_equals_plain(harness, P, n_steps):
    cfg = TableConfig(num_seats=P)
    T = ce.TABLES_PER_BLOCK
    state = ce.pack_state(cfg, ce.first_deal(3, T, P, "cpu"))
    got = harness("k4", [P, 0, 31, n_steps, ce._defer_for(n_steps), 5, 10,
                         ce.FOLD_P_BITS, ce.RAISE_P_BITS, T,
                         *_flat(ce._to_rows(state))])
    _check_rows(got, ce.run_perpetual_prng(31, state, P, n_steps, 5, 10),
                cfg)


@pytest.mark.parametrize("P,n_steps", [(6, 64), (2, 24)])
def test_engine_prng_device_code_equals_plain_standard_rules(harness, P,
                                                             n_steps):
    cfg = TableConfig(num_seats=P, rules="standard")
    T = ce.TABLES_PER_BLOCK
    state = ce.pack_state(cfg, ce.first_deal(4, T, P, "cpu"))
    got = harness("k4", [P, 1, 32, n_steps, ce._defer_for(n_steps), 5, 10,
                         ce.FOLD_P_BITS, ce.RAISE_P_BITS, T,
                         *_flat(ce._to_rows(state))])
    _check_rows(got, ce.run_perpetual_prng(32, state, P, n_steps, 5, 10,
                                           rules="standard"), cfg)


@pytest.mark.parametrize("P,n_steps,stack", [(6, 128, 20), (2, 48, 30)])
def test_engine_prng_device_code_equals_plain_tournament_rules(
        harness, P, n_steps, stack):
    """Short stacks: seats bust, the blinds skip them, and tables freeze
    and then sit through settle passes."""
    cfg = TableConfig(num_seats=P, rules="tournament", starting_stack=stack)
    T = ce.TABLES_PER_BLOCK
    state = ce.pack_state(cfg, ce.first_deal(5, T, P, "cpu"))
    got = harness("k4", [P, 2, 33, n_steps, ce._defer_for(n_steps), 5, 10,
                         ce.FOLD_P_BITS, ce.RAISE_P_BITS, T,
                         *_flat(ce._to_rows(state))])
    want = ce.run_perpetual_prng(33, state, P, n_steps, 5, 10,
                                 rules="tournament")
    _check_rows(got, want, cfg)
    assert int((ce.unpack_field(want, cfg, "order") == 0).sum()) > 0
    assert int((ce.unpack_field(want, cfg, "bust_at", 1) >= 0).sum()) > 0


def _freeze(state, cfg, every):
    """Every ``every``-th table frozen before the launch: an empty play
    order and no settle pending, a fixed point under every rule set."""
    layout = ce._field_layout(cfg.num_seats, cfg.rules)[0]
    rows = ce._to_rows(state).clone()
    for name in ("order", "wait"):
        rows[layout[name][0], ::every] = 0
    return ce._to_blocks(rows)


def _k4_harness(harness, mode, state, cfg, seed, n_steps):
    return harness(mode, [cfg.num_seats, ce.RULES.index(cfg.rules), seed,
                          n_steps, ce._defer_for(n_steps), 5, 10,
                          ce.FOLD_P_BITS, ce.RAISE_P_BITS,
                          state.shape[0] * ce.TABLES_PER_BLOCK,
                          *_flat(ce._to_rows(state))])


@pytest.mark.parametrize("mode", ["k4", "k4shared"])
@pytest.mark.parametrize("rules", ce.RULES)
def test_engine_prng_freezing_tables_device_code_equals_plain(harness, mode,
                                                              rules):
    """K4 where some tables are frozen before the launch (every 7th) and,
    under tournament rules, whole blocks of 12- and 20-chip stacks end
    their tournaments within it while the others play on; a frozen table
    leaves the loop (mc_frozen). ``k4shared`` keeps the cold rows in
    columns of a block buffer, as the kernel's shared memory does."""
    P, n_steps = 6, 64
    T = ce.TABLES_PER_BLOCK
    fd = ce.first_deal(6, 2 * T, P, "cpu")
    cfgs = [TableConfig(num_seats=P, rules=rules,
                        starting_stack=12 if rules == "tournament" else 100),
            TableConfig(num_seats=P, rules=rules,
                        starting_stack=20 if rules == "tournament" else 100)]
    state = _freeze(torch.cat([ce.pack_state(c, fd[k * T:(k + 1) * T])
                               for k, c in enumerate(cfgs)]), cfgs[0], 7)
    got = _k4_harness(harness, mode, state, cfgs[0], 34, n_steps)
    want = ce.run_perpetual_prng(34, state, P, n_steps, 5, 10, rules=rules)
    _check_rows(got, want, cfgs[0])

    def frozen(st):
        return ((ce.unpack_field(st, cfgs[0], "order") == 0)
                & (ce.unpack_field(st, cfgs[0], "wait") == 0))
    before, after = frozen(state), frozen(want)
    assert bool(after[before].all()) and int(before.sum()) > 0
    froze = after & ~before
    if rules == "tournament":  # more of the 12-chip block, and not all
        assert int(froze[:T].sum()) > int(froze[T:].sum()) > 0
        assert int((~after).sum()) > 0
    else:
        assert int(froze.sum()) == 0


@pytest.mark.parametrize("rules,P,n_steps", [
    ("reference", 6, 64), ("standard", 3, 64), ("tournament", 6, 8),
    ("standard", 2, 12)])
def test_engine_prng_word_offsets_device_code_equals_plain(harness, rules, P,
                                                           n_steps):
    """K4's iterations start their 2 defer + 2P + 5 words on each of the
    four word offsets of a Philox block (defer 16 and defer 1), so slot and
    deal words straddle blocks in every phase (MCPhiloxWords)."""
    W = ce.prng_words_shape(1, P, n_steps)[1]
    assert {it * W % 4 for it in range(n_steps // ce._defer_for(n_steps))} \
        == {0, 1, 2, 3}
    cfg = TableConfig(num_seats=P, rules=rules)
    state = ce.pack_state(cfg, ce.first_deal(7, ce.TABLES_PER_BLOCK, P,
                                             "cpu"))
    got = _k4_harness(harness, "k4", state, cfg, 35, n_steps)
    _check_rows(got, ce.run_perpetual_prng(35, state, P, n_steps, 5, 10,
                                           rules=rules), cfg)


# (starting stack, small blind, big blind, first table): blinds all-in
# (5 and 10 chips at 5/10: the big blind capped, all_in; 3 chips: both
# capped, to equal blinds), equal blinds (one street level), blinds in
# the other order, and table indices up to 2^32 - 1.
FIRST_STATES = [(100, 5, 10, 0), (5, 5, 10, 5 * 1024), (10, 5, 10, 0),
                (3, 5, 10, 1024), (10, 10, 10, 1 << 31),
                (200, 10, 5, (1 << 32) - 1024)]


@pytest.mark.parametrize("rules", ce.RULES)
@pytest.mark.parametrize("P", range(2, 11))
def test_first_state_device_code_equals_pack_state(harness, P, rules):
    """The first-state kernel's tables (``mc_first_state_rows``, one
    thread's table at its offset in the packed state) equal
    ``pack_state(cfg, first_deal(...))`` bit for bit, every row written."""
    T = ce.TABLES_PER_BLOCK
    for ss, sb, bb, first in FIRST_STATES:
        cfg = TableConfig(num_seats=P, rules=rules, starting_stack=ss,
                          small_blind=sb, big_blind=bb)
        seed = 0x9E3779B9 + P
        got = harness("first_state", [P, ce.RULES.index(rules), seed,
                                      first >> 32, first & 0xFFFFFFFF, T,
                                      sb, bb, ss])
        want = ce.pack_state(cfg, ce.first_deal(seed, T, P, "cpu", first))
        np.testing.assert_array_equal(
            got.astype(np.int32).reshape(want.shape), want.numpy())
        if rules != "reference":
            all_in = ce.unpack_field(want, cfg, "all_in")
            assert bool((all_in != 0).all()) == (ss <= bb)


@pytest.mark.parametrize("P", [2, 3, 4, 5, 6])
def test_head_device_code_equals_scan(harness, P):
    """mc_head (the order mask rotated by the cursor, its lowest set bit)
    against the plain scan (_head_info: min over set bits of (p - cursor)
    mod P) for every order mask and cursors in [-P, 2P)."""
    order, cursor = np.meshgrid(np.arange(1 << P), np.arange(-P, 2 * P),
                                indexing="ij")
    order, cursor = order.reshape(-1), cursor.reshape(-1)
    got = harness("head", [P, *np.stack([order, cursor], 1).reshape(-1)])
    want = ce._head_info({"order": torch.from_numpy(order).to(torch.int32),
                          "cursor": torch.from_numpy(cursor)
                          .to(torch.int32)}, P)[0]
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("n_hands,board,start", [
    (3, (), 0), (2, (5, 6, 7), (1 << 32) - 700), (6, (5, 6, 7, 44), 9),
    (12, (), 3), (4, (5, 6, 7, 44, 50), 0)])
def test_multiway_rollout_device_code_equals_plain(harness, n_hands, board,
                                                   start):
    seed, n = 0x7F4A7C15, 1500
    hands = [[8 + 2 * h, 9 + 2 * h] for h in range(n_hands)]
    dead, hm = (m.tolist() for m in cq._multiway_masks(hands, board, "cpu"))
    got = harness("mw", [seed, start >> 32, start & 0xFFFFFFFF, n, 0,
                         n_hands, len(dead), *dead,
                         *[x for row in hm for x in row]])
    words = cq.multiway_words(seed, 5 - len(board), start, n, "cpu")
    assert got.tolist() == cq._multiway_shares_plain(words, dead,
                                                     hm).tolist()


@pytest.mark.parametrize("n_hands", [2, 3, 7, 12])
@pytest.mark.parametrize("n_draw", range(6))
def test_multiway_every_form_device_code_equals_plain(harness, n_hands,
                                                      n_draw):
    """B3 at every NDRAW for N = 2, 3, 7 and 12 (each its own
    instantiation), in Philox mode and on injected words."""
    rng = np.random.default_rng(100 * n_hands + n_draw)
    deal = rng.permutation(52)[:2 * n_hands + 5 - n_draw].tolist()
    hands = [deal[2 * h:2 * h + 2] for h in range(n_hands)]
    board = deal[2 * n_hands:]
    dead, hm = (m.tolist() for m in cq._multiway_masks(hands, board, "cpu"))
    masks = [x for row in hm for x in row]
    n, seed = 600, 31 + n_draw
    got = harness("mw", [seed, 0, 5, n, 0, n_hands, len(dead), *dead,
                         *masks])
    words = cq.multiway_words(seed, n_draw, 5, n, "cpu")
    assert got.tolist() == cq._multiway_shares_plain(words, dead,
                                                     hm).tolist()
    words = torch.from_numpy(rng.integers(0, 1 << 32, (n_draw, n)))
    got = harness("mw", [0, 0, 0, n, 1, n_hands, len(dead), *dead, *masks,
                         *words.reshape(-1).tolist()])
    assert got.tolist() == cq._multiway_shares_plain(words, dead,
                                                     hm).tolist()
    assert int(got.sum()) == cq.multiway_scale(n_hands) * n


@pytest.mark.parametrize("rules", ce.RULES)
def test_engine_det_device_code_equals_plain(harness, rules):
    """K3 on an injected stream that folds, calls and raises without the
    random policy's limits (under reference rules some tables overflow
    L = 6: compared too)."""
    P, n_steps, hmax = 6, 48, 12
    T = ce.TABLES_PER_BLOCK
    rng = np.random.default_rng(19)
    u = rng.random((n_steps, T))
    acts = np.where(u < 0.2, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    stash = np.argsort(rng.random((hmax, T, 52)), axis=-1)[..., :2 * P + 5] \
        .transpose(0, 2, 1).astype(np.int32)           # [hmax, 2P+5, T]
    cfg = TableConfig(num_seats=P, rules=rules)
    state = ce.pack_state(cfg, torch.from_numpy(stash[0].T.copy()))
    got = harness("k3", [P, ce.RULES.index(rules), n_steps, hmax, 5, 10, T,
                         *_flat(ce._to_rows(state)), *acts.reshape(-1),
                         *stash.reshape(-1)])
    want = ce.run_perpetual_det(
        state, torch.from_numpy(acts.reshape(1, n_steps, *ce.TILE)),
        torch.from_numpy(stash.reshape(1, hmax, 2 * P + 5, *ce.TILE)), P,
        n_steps, 5, 10, rules=rules)
    _check_rows(got, want, cfg)
    if rules == "reference":
        assert int(ce.unpack_field(want, cfg, "overflow").sum()) > 0


def _waiting_at_entry(state, P, rules, share, seed):
    """``state`` with a ``share`` of its tables folded down to one player
    and not settled: they wait at entry, their play order empty."""
    T = ce.TABLES_PER_BLOCK * state.shape[0]
    layout, _ = ce._field_layout(P, rules)
    st = ce._unpack(ce._to_rows(state), layout)
    ended = st
    fold = torch.full((T,), -1, dtype=torch.int32, device=state.device)
    for _ in range(P - 1):
        ended = ce._step_nosettle(ended, fold, P, rules)
    assert bool((ended["wait"] == 1).all())
    pick = torch.from_numpy(np.random.default_rng(seed).random(T) < share) \
        .to(state.device)
    return ce._to_blocks(ce._pack(ce._where_fields(pick, ended, st), layout))


@pytest.mark.parametrize("rules,P,stack,n_steps,share", [
    ("reference", 2, 100, 1, 0.5), ("standard", 6, 100, 23, 0.25),
    ("tournament", 6, 10, 29, 0.0), ("tournament", 2, 20, 17, 0.5)])
def test_engine_det_edges_device_code_equals_plain(harness, rules, P, stack,
                                                    n_steps, share):
    """K3's step cursor at its edges, one table at a time (on the host a
    warp is one lane): tables waiting at entry (settled before their
    first step), one step, and tournaments that freeze within the run."""
    hmax = 4
    T = ce.TABLES_PER_BLOCK
    rng = np.random.default_rng(P + n_steps)
    u = rng.random((n_steps, T))
    acts = np.where(u < 0.2, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    stash = np.argsort(rng.random((hmax, T, 52)), axis=-1)[..., :2 * P + 5] \
        .transpose(0, 2, 1).astype(np.int32)           # [hmax, 2P+5, T]
    cfg = TableConfig(num_seats=P, rules=rules, starting_stack=stack)
    state = ce.pack_state(cfg, torch.from_numpy(stash[0].T.copy()))
    if share:
        state = _waiting_at_entry(state, P, rules, share, n_steps)
    got = harness("k3", [P, ce.RULES.index(rules), n_steps, hmax, 5, 10, T,
                         *_flat(ce._to_rows(state)), *acts.reshape(-1),
                         *stash.reshape(-1)])
    want = ce.run_perpetual_det(
        state, torch.from_numpy(acts.reshape(1, n_steps, *ce.TILE)),
        torch.from_numpy(stash.reshape(1, hmax, 2 * P + 5, *ce.TILE)), P,
        n_steps, 5, 10, rules=rules)
    _check_rows(got, want, cfg)
    if stack == 10:
        assert int((ce.unpack_field(want, cfg, "order") == 0).sum()) > T // 2


def test_det_settle_min_equals_the_define(harness):
    """The host constant of K3's warp schedule (``ops/cuda_engine.py``,
    the plain twin's) is the one the kernel is built with, and the
    ``#define`` is written once, as ``scripts/ab_engine.py --variants``
    rewrites it."""
    defines = [m for f in sorted(_build.CSRC.glob("*.cu*"))
               for m in re.findall(r"^#define MC_DET_SETTLE_MIN (\d+)$",
                                   f.read_text(), re.M)]
    assert defines == [str(ce.DET_SETTLE_MIN)]
    assert harness("det_settle_min", []).tolist() == [ce.DET_SETTLE_MIN]


def test_packed_key_device_code_equals_plain(harness):
    rng = np.random.default_rng(23)
    cards = np.argsort(rng.random((6000, 52)), axis=1)[:, :7]
    masks, want = [], []
    for k in range(0, 8):  # 0..7 cards, as the features reveal them
        m = tev.suit_masks_from_cards(torch.from_numpy(cards[:, :k]))
        masks.append(torch.stack(m, dim=1))
        want.append(tev.eval_masks_impl(*m))
    masks = torch.cat(masks)
    got = harness("key", [len(masks), *_flat(masks)])
    assert got.tolist() == torch.cat(want).tolist()


ES3 = "data/policy_6max_es3.npz"


@pytest.fixture(scope="module")
def es3():
    return cn.net_weights(tpn.load_params(ES3), "cpu")


def _bank_map_ints(seat_to_bank, P, n_banks):
    bank_map = cn._banks(seat_to_bank, P, n_banks)[1]
    return [bank_map & 0xFFFFFFFF, bank_map >> 32]


# Tables of a CUDA block of the net kernels (csrc/net.cuh MC_NET_THREADS).
NET_BLOCK = 256


def _block_buttons(state, cfg):
    """``state`` with the button of every table at (its CUDA block) mod P:
    at the first decision every table of a block has the same seat acting,
    so a bank's segment is empty in some blocks and full in others."""
    rows = ce._to_rows(state).clone()
    off = ce._field_layout(cfg.num_seats, cfg.rules)[0]["button"][0]
    rows[off] = (torch.arange(rows.shape[1]) // NET_BLOCK) % cfg.num_seats
    return ce._to_blocks(rows)


def _net_det_harness(harness, weights, seat_to_bank, rules, P,
                     block_buttons=False):
    n_steps, hmax = 40, 16
    T = ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules=rules)
    stash = cn.deal_stash(5, T, P, hmax, "cpu")
    state = ce.pack_state(cfg, ce._stash_rows(stash)[0].T)
    if block_buttons:
        state = _block_buttons(state, cfg)
    banks = weights.reshape(-1, cn.NUM_WEIGHTS)
    got = harness("k5", [P, ce.RULES.index(rules), n_steps, hmax, 5, 10, T,
                         len(banks),
                         *_bank_map_ints(seat_to_bank, P, len(banks)),
                         *_weights_as_ints(banks),
                         *_flat(ce._to_rows(state)),
                         *_flat(ce._stash_rows(stash))])
    _check_rows(got, cn.run_net_det(state, stash, weights, P, n_steps, 5, 10,
                                    rules, seat_to_bank), cfg)


@pytest.mark.parametrize("rules,P", [("reference", 6), ("standard", 6),
                                     ("standard", 2)])
def test_net_det_device_code_equals_plain(harness, es3, rules, P):
    _net_det_harness(harness, es3, None, rules, P)


@pytest.mark.parametrize("stb", [(0, 1, 1, 1, 1, 1), (1, 0, 2, 0, 2, 1),
                                 (7, 1, 2, 8, 4, 0)])
def test_net_det_banked_device_code_equals_plain(harness, stb):
    """The banked decision (seat -> bank, four bits a seat) on distinct
    banks, so a wrong bank changes the play; with nine banks, seats 0 and 3
    play the two that the kernel reads from global memory."""
    panel = bots.panel()
    nets = [panel["jam_tight"], panel["fof_call"], tpn.load_params(ES3),
            *(panel[k] for k in ("fof_raise", "nit_ladder", "made_ladder",
                                 "jam_loose", "minraisebot", "potraisebot"))]
    weights = cn.bank_weights(nets[:1 + max(stb)], "cpu")
    _net_det_harness(harness, weights, stb, "standard", 6)


def _net_eval_harness(harness, state, weights, rules, P, net_seats,
                      reset_stacks, seat_to_bank=None):
    """The device code of a K6 launch (every form, whole blocks of the
    block phase) against the plain version in Philox mode: the final state
    and the count of net decisions (> 0 when a seat plays a net)."""
    n_steps = 32
    grid, w3 = cn._grid(state, weights)
    C, nb = grid.shape[:2]
    T = nb * ce.TABLES_PER_BLOCK
    got = harness("k6", [P, ce.RULES.index(rules), 77, n_steps,
                         ce._defer_for(n_steps), 5, 10, 100, net_seats,
                         int(reset_stacks), ce.FOLD_P_BITS, ce.RAISE_P_BITS,
                         T, C, w3.shape[1],
                         *_bank_map_ints(seat_to_bank, P, w3.shape[1]),
                         *_weights_as_ints(w3), *_flat(grid)])
    decisions = torch.zeros(1, dtype=torch.int64)
    want = cn._run_net_eval_plain_philox(77, state, weights, P, n_steps, 5,
                                         10, 100, rules, net_seats,
                                         reset_stacks, seat_to_bank,
                                         decisions)
    np.testing.assert_array_equal(got[:-1].astype(np.int32),
                                  _flat(want))
    assert got[-1] == int(decisions)
    assert (int(decisions) > 0) == (net_seats != 0)
    return want


@pytest.mark.parametrize("rules,P,net_seats,reset_stacks", [
    ("standard", 6, 1, True), ("standard", 6, 0b101101, False),
    ("reference", 6, 0b010010, True), ("standard", 2, 0b10, True)])
def test_net_eval_device_code_equals_plain(harness, es3, rules, P, net_seats,
                                           reset_stacks):
    """K6 in Philox mode. The host's libm logf and PyTorch's CPU log can
    differ in the last bit; at es3's logit gaps no Gumbel pick here lands
    within one ulp of a tie, so the states agree."""
    T = ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules=rules)
    state = cn.initial_packed_state(6, cfg, T, "cpu")
    want = _net_eval_harness(harness, state, es3, rules, P, net_seats,
                             reset_stacks)
    assert int(ce.unpack_field(want, cfg, "hand_ct").sum()) > 0


@pytest.mark.parametrize("n_banks,stb", [(1, None), (2, (0, 1, 1, 1, 1, 1)),
                                         (3, (2, 0, 1, 1, 0, 2))])
def test_net_pop_device_code_equals_plain(harness, es3, n_banks, stb):
    """B8 (and B7 within it): the candidate offsets of state and weights
    (mc_candidate_state, mc_candidate_weights), the Philox keying by the
    table within its candidate, and the banked decision."""
    P, nb, C = 6, 1, 3
    cfg = TableConfig(num_seats=P, rules="standard")
    first = cn.initial_packed_state(8, cfg, nb * ce.TABLES_PER_BLOCK, "cpu")
    state = first[None].expand(C, *first.shape).contiguous()
    nets = [tpn.load_params(ES3), *bots.panel().values()]
    weights = torch.stack([cn.bank_weights(nets[c:c + n_banks], "cpu")
                           for c in range(C)])
    _net_eval_harness(harness, state, weights, "standard", P, 0b100111,
                      True, stb)


def _libm_logf():
    """The C library's ``logf`` (the one the harness links), by ctypes."""
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.logf.argtypes = [ctypes.c_float]
    libm.logf.restype = ctypes.c_float
    return libm.logf


def test_net_probe_device_code_equals_plain(harness, es3):
    """Features and masked logits bit for bit (same operations, same
    order, no FMA). The Gumbel scores z = logit - g, g = log(-log(u)), bit
    for bit against the masked logits minus g computed with the C
    library's logf, the harness's own (on the card both sides use
    libdevice's logf and chip_smoke.py holds the scores bit for bit).

    The plain version takes g from PyTorch's CPU log (SLEEF, whose code
    path depends on the CPU), so its g and its scores are held to the
    libm ones by an error bound. Each logf is within 1 ulp of the exact
    value, so the two inner logs y = -log(u) differ by at most 2 ulp(y),
    which the outer log turns into 2 ulp(y) / y, and the two outer logs
    add 2 ulp(g); the subtraction from the logit adds at most 1 ulp(z).
    Where y is near 1, g is near 0 and this is many ulps of g, so no
    fixed count of ulps of g, or of z, holds on every CPU."""
    P = 6
    T = ce.TABLES_PER_BLOCK
    cfg = TableConfig(num_seats=P, rules="standard")
    state = cn.initial_packed_state(9, cfg, T, "cpu")
    state = cn.run_net_eval(9, state, es3, P, 24, 5, 10, 100, "standard",
                            0b111111)
    words = ce.table_words(123, T, 0, 4, "cpu")
    got = harness("probe", [P, 1, 10, T, *_weights_as_ints(es3),
                            *_flat(ce._to_rows(state)), *_flat(words)])
    got = torch.from_numpy(got.astype(np.int32).reshape(cn.PROBE_ROWS, T)) \
        .view(torch.float32)
    want = cn.net_probe(state, words, es3, P, 10, "standard")
    n = tpn.NUM_ACTIONS
    assert torch.equal(got[:-n].view(torch.int32), want[:-n].view(torch.int32))

    logf = _libm_logf()
    u = ((words >> 8).to(torch.float32) * 2.0 ** -24).clamp(min=1e-12)
    y = np.array([-logf(x) for x in u.reshape(-1).tolist()], np.float32)
    g = np.array([logf(x) for x in y.tolist()], np.float32).reshape(u.shape)
    logits = want[-2 * n:-n]
    z = logits - torch.from_numpy(g)
    assert torch.equal(got[-n:].view(torch.int32), z.view(torch.int32))

    g_plain = torch.log(-torch.log(u)).numpy().astype(np.float64)
    y = y.reshape(u.shape).astype(np.float64)
    ulp_g = np.spacing(np.abs(g).astype(np.float32)).astype(np.float64)
    ulp_y = np.spacing(y.astype(np.float32)).astype(np.float64)
    ulps = np.abs(g_plain - g) / ulp_g
    assert np.all(ulps <= 2 + 2 * ulp_y / (y * ulp_g)), ulps.max()

    # the plain version's own scores against the libm ones, by that bound
    z_plain = want[-n:].numpy().astype(np.float64)
    z_libm = z.numpy().astype(np.float64)
    finite = np.isfinite(z_libm)
    assert np.array_equal(z_plain[~finite], z_libm[~finite])
    ulp_z = np.spacing(np.maximum(np.abs(z_plain), np.abs(z_libm))
                       .astype(np.float32)).astype(np.float64)
    bound = 2 * ulp_g + 2 * ulp_y / y + ulp_z
    err = np.abs(z_plain - z_libm)
    assert np.all(err[finite] <= bound[finite]), (err / bound)[finite].max()
    assert int(ce.unpack_field(state, cfg, "stage").ne(0).sum()) > 0


@pytest.mark.parametrize("form,R", [("array", 16), ("array", 141),
                                    ("dict", 141), ("dict", 166),
                                    ("ref", 141), ("ref", 166)])
def test_carry_device_code_equals_plain(harness, form, R):
    """One thread of each carry form per table, words that wrap included."""
    rng = np.random.default_rng(R)
    x = rng.integers(-2**31, 2**31, (1, R, *ce.TILE)).astype(np.int32)
    x[0, 0, 0, :4] = [2**31 - 1, 2**31 - 5, -1, -2**31]
    got = harness("carry", [cc.FORMS.index(form), R, 9, 1, *x.reshape(-1)])
    want = cc.carry(form, torch.from_numpy(x), 9)
    np.testing.assert_array_equal(got.astype(np.int32), _flat(want))


def _mid_hand_state(P, n_steps=20, seed=37):
    """Reference-rules tables after ``n_steps`` K3 steps on the injected
    stream: hands under way, pots on the table."""
    T = ce.TABLES_PER_BLOCK
    rng = np.random.default_rng(seed)
    u = rng.random((n_steps, T))
    acts = np.where(u < 0.2, -1, np.where(u < 0.92, 0, rng.integers(
        1, 21, u.shape))).astype(np.int32)
    deal = np.argsort(rng.random((T, 4, 52)), axis=-1)[..., :2 * P + 5]
    cards = deal.transpose(1, 2, 0).reshape(1, 4, 2 * P + 5, *ce.TILE)
    cfg = TableConfig(num_seats=P)
    state = ce.pack_state(cfg, torch.from_numpy(deal[:, 0]))
    state = ce.run_perpetual_det(
        state, torch.from_numpy(acts.reshape(1, n_steps, *ce.TILE)),
        torch.from_numpy(np.ascontiguousarray(cards).astype(np.int32)), P,
        n_steps, 5, 10)
    assert int(ce.unpack_field(state, cfg, "pot_amt", 0).ne(0).sum()) > 0
    return state


@pytest.mark.parametrize("stage", cs.STAGES)
def test_stage_device_code_equals_plain(harness, stage):
    """One table of each stage body (mc_stage_step) in Philox mode, from a
    mid-hand state, against the plain stage on ops/philox.py's words."""
    P = 6
    state = _mid_hand_state(P)
    got = harness("stage", [P, 0, cs.STAGES.index(stage), 41, 12, 5, 10,
                            ce.FOLD_P_BITS, ce.RAISE_P_BITS,
                            ce.TABLES_PER_BLOCK, *_flat(ce._to_rows(state))])
    want = cs.run_stage(stage, 41, state, P, 12, 5, 10)
    _check_rows(got, want, TableConfig(num_seats=P))
    assert not torch.equal(want, state)


# The block phase (net.cuh): whole blocks of 256 tables, the net decisions
# of a slot staged in rows grouped by bank and run through the dense MLP.

@pytest.mark.parametrize("net_seats", [0b000001, 0b010101, 0b111111, 0])
@pytest.mark.parametrize("rules", cn.RULES)
def test_net_eval_block_phase_equals_plain(harness, es3, rules, net_seats):
    """K6's blocks with one net seat, alternate seats, every seat, and no
    net seat (the MLP phase never runs; the random policy alone)."""
    P = 6
    cfg = TableConfig(num_seats=P, rules=rules)
    state = cn.initial_packed_state(12, cfg, ce.TABLES_PER_BLOCK, "cpu")
    want = _net_eval_harness(harness, state, es3, rules, P, net_seats,
                             True)
    assert int(ce.unpack_field(want, cfg, "hand_ct").sum()) > 0


@pytest.mark.parametrize("stb,net_seats", [
    ((0, 1, 0, 1, 0, 1), 0b111111), ((0, 1, 1, 1, 1, 1), 0b000001),
    ((1, 1, 1, 1, 1, 1), 0b100110)])
def test_net_league_block_phase_equals_plain(harness, es3, stb, net_seats):
    """Two banks (es3, policy_6max_200): both staged in every slot, bank 1
    absent from every slot (its seats play the random policy), and bank 0
    absent (every net seat plays bank 1, whose segment then starts at row
    0)."""
    P = 6
    cfg = TableConfig(num_seats=P, rules="standard")
    state = cn.initial_packed_state(13, cfg, ce.TABLES_PER_BLOCK, "cpu")
    weights = cn.bank_weights([tpn.load_params(ES3),
                               tpn.load_params("data/policy_6max_200.npz")],
                              "cpu")
    _net_eval_harness(harness, state, weights, "standard", P, net_seats,
                      True, stb)


def test_net_pop_block_phase_equals_plain(harness):
    """A three-candidate grid with two banks each, the candidate at seat 0
    and the opponent elsewhere: every seat's decision staged, bank 0's
    segment one row in six."""
    P, C = 6, 3
    cfg = TableConfig(num_seats=P, rules="standard")
    first = cn.initial_packed_state(14, cfg, ce.TABLES_PER_BLOCK, "cpu")
    state = first[None].expand(C, *first.shape).contiguous()
    panel = list(bots.panel().values())
    weights = cn.pop_weights(panel[:C], "cpu", tpn.load_params(ES3))
    _net_eval_harness(harness, state, weights, "standard", P, 0b111111,
                      True, (0, 1, 1, 1, 1, 1))


@pytest.mark.parametrize("rules", cn.RULES)
def test_net_det_block_phase_bank_absent_equals_plain(harness, rules):
    """K5's blocks with two banks of which only bank 1 plays (bank 0's
    segment is empty in every step): argmax, a settle every step."""
    panel = bots.panel()
    weights = cn.bank_weights([panel["jam_tight"], panel["fof_call"]], "cpu")
    _net_det_harness(harness, weights, (1,) * 6, rules, 6)


@pytest.mark.parametrize("n,n_bank0", [(0, 0), (1, 0), (17, 5), (128, 77),
                                       (256, 200)])
def test_mlp_rows_device_code_equals_plain(harness, es3, n, n_bank0):
    """The dense MLP phase alone (mc_mlp_rows) on seeded features, n rows
    split over two banks (bank 0's rows first), against the plain
    ``_bank_logits`` bit for bit: chunks of the hidden rows, tiles that
    straddle a bank's end, a bank with no row."""
    rng = np.random.default_rng(n)
    feats = rng.uniform(-1.5, 1.5, (n, tpn.NUM_FEATURES)).astype(np.float32)
    weights = torch.stack([es3, cn.net_weights(bots.panel()["fof_raise"],
                                               "cpu")])
    got = harness("mlp", [2, n_bank0, n - n_bank0,
                          *_weights_as_ints(weights),
                          *_flat(torch.from_numpy(feats).view(torch.int32))])
    bank = torch.tensor([0] * n_bank0 + [1] * (n - n_bank0),
                        dtype=torch.int32)
    want = cn._bank_logits(torch.from_numpy(feats.T.copy()), weights[None],
                           bank)
    assert got.astype(np.int32).tolist() == \
        _flat(want.T.contiguous().view(torch.int32))


def _nine_banks():
    """Nine distinct nets as banks: the seventh on in shared memory, the
    last two read from global memory."""
    panel = bots.panel()
    return cn.bank_weights(
        [tpn.load_params(ES3), tpn.load_params("data/policy_6max_200.npz")]
        + [panel[k] for k in ("jam_tight", "fof_call", "fof_raise",
                              "nit_ladder", "made_ladder", "jam_loose",
                              "minraisebot")], "cpu")


@pytest.mark.parametrize("per_bank", [
    (3, 0, 5, 1, 0, 2, 7, 4, 9), (0, 0, 0, 0, 0, 0, 0, 20, 0),
    (0, 0, 0, 0, 0, 0, 0, 0, 33), (30, 25, 20, 35, 28, 22, 31, 40, 25)])
def test_mlp_rows_nine_banks_device_code_equals_plain(harness, per_bank):
    """The dense phase over nine banks of seeded weights, banks 7 and 8
    read from the launch's weights rather than the block's shared copy,
    against ``_bank_logits`` bit for bit."""
    rng = np.random.default_rng(sum(per_bank))
    n = sum(per_bank)
    feats = rng.uniform(-1.5, 1.5, (n, tpn.NUM_FEATURES)).astype(np.float32)
    weights = torch.from_numpy(
        rng.normal(0, 0.4, (9, cn.NUM_WEIGHTS)).astype(np.float32))
    got = harness("mlp", [9, *per_bank, *_weights_as_ints(weights),
                          *_flat(torch.from_numpy(feats).view(torch.int32))])
    bank = torch.tensor([b for b, k in enumerate(per_bank) for _ in range(k)],
                        dtype=torch.int32)
    want = cn._bank_logits(torch.from_numpy(feats.T.copy()), weights[None],
                           bank)
    assert got.astype(np.int32).tolist() == \
        _flat(want.T.contiguous().view(torch.int32))


@pytest.mark.parametrize("stb,net_seats", [
    ((8, 7, 6, 5, 4, 3), 0b111111), ((7, 8, 0, 8, 7, 1), 0b110011)])
def test_net_league_nine_banks_block_phase_equals_plain(harness, stb,
                                                        net_seats):
    """B7 with the most banks a launch takes: the seats of banks 7 and 8
    play nets read from global memory."""
    P = 6
    cfg = TableConfig(num_seats=P, rules="standard")
    state = cn.initial_packed_state(15, cfg, ce.TABLES_PER_BLOCK, "cpu")
    _net_eval_harness(harness, state, _nine_banks(), "standard", P,
                      net_seats, True, stb)


@pytest.mark.parametrize("stb,net_seats", [
    ((0, 1, 1, 1, 1, 1), 0b000011), ((1, 0, 1, 0, 1, 0), 0b111111)])
def test_net_league_block_buttons_equals_plain(harness, es3, stb,
                                               net_seats):
    """B7 on blocks whose tables share a button: in the first slots a
    bank's segment is empty in some blocks of the launch and full in
    others."""
    P = 6
    cfg = TableConfig(num_seats=P, rules="standard")
    state = _block_buttons(
        cn.initial_packed_state(16, cfg, ce.TABLES_PER_BLOCK, "cpu"), cfg)
    weights = cn.bank_weights([tpn.load_params(ES3),
                               tpn.load_params("data/policy_6max_200.npz")],
                              "cpu")
    _net_eval_harness(harness, state, weights, "standard", P, net_seats,
                      True, stb)


@pytest.mark.parametrize("rules", cn.RULES)
def test_net_det_block_buttons_equals_plain(harness, rules):
    """Banked K5 on blocks whose tables share a button, bank 0 at seat 0
    alone: its segment is empty in some blocks of a step and full in
    others."""
    panel = bots.panel()
    weights = cn.bank_weights([panel["jam_tight"], panel["fof_call"]], "cpu")
    _net_det_harness(harness, weights, (0, 1, 1, 1, 1, 1), rules, 6,
                     block_buttons=True)


# The splits: K4 and K6 with one piece stubbed (probe_split.cuh,
# probe_net.cuh), every variant against its plain version.

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("variant", csp.VARIANTS)
def test_split_device_code_equals_plain(harness, variant, shared):
    """One table of K4 under each variant (mc_split_run) in Philox mode,
    from a mid-hand state (pots on the table), the cold rows per thread or
    in a block's columns, against the plain variant on ops/philox.py's
    words."""
    P, n_steps = 6, 64
    state = _mid_hand_state(P)
    got = harness("split", [P, 0, csp.VARIANTS.index(variant), 43, n_steps,
                            ce._defer_for(n_steps), 5, 10, ce.FOLD_P_BITS,
                            ce.RAISE_P_BITS, int(shared),
                            ce.TABLES_PER_BLOCK, *_flat(ce._to_rows(state))])
    want = csp.run_split(variant, 43, state, P, n_steps, 5, 10)
    _check_rows(got, want, TableConfig(num_seats=P))
    if variant in ("full", *csp.CONTROLS):
        assert torch.equal(want, ce.run_perpetual_prng(43, state, P, n_steps,
                                                       5, 10))


@pytest.mark.parametrize("variant", cns.VARIANTS)
def test_net_split_device_code_equals_plain(harness, es3, variant):
    """Whole blocks of K6 under each variant (mc_split_run_net_eval) in
    Philox mode, es3 at seats 0 and 3, against the plain variant: the
    final state and the count of net decisions."""
    P, n_steps, net_seats = 6, 32, 0b001001
    cfg = TableConfig(num_seats=P, rules="standard")
    state = cn.initial_packed_state(8, cfg, ce.TABLES_PER_BLOCK, "cpu")
    got = harness("net_split", [P, 1, cns.VARIANTS.index(variant), 78,
                                n_steps, ce._defer_for(n_steps), 5, 10, 100,
                                net_seats, 1, ce.FOLD_P_BITS,
                                ce.RAISE_P_BITS, ce.TABLES_PER_BLOCK,
                                *_weights_as_ints(es3),
                                *_flat(ce._to_rows(state))])
    decisions = torch.zeros(1, dtype=torch.int64)
    want = cns.run_net_split(variant, 78, state, es3, P, n_steps, 5, 10, 100,
                             net_seats, decisions=decisions)
    _check_rows(got[:-1], want, cfg)
    assert got[-1] == int(decisions) > 0
    if variant in ("full", *cns.CONTROLS):
        assert torch.equal(want, cn.run_net_eval(78, state, es3, P, n_steps,
                                                 5, 10, 100, "standard",
                                                 net_seats))
