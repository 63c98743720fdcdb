// The policy net inside the engine (ops/cuda_net.py): the decision
// features of one table, and the MLP of a block's net decisions as a phase
// of the whole block.
//
// A transcription of montecarlo_tpu/ops/pallas_engine.py: _features
// (:1008) and _masked_suit_masks (:990), _mlp_logits (:1105),
// _gumbel_pick (:1078), _argmax_pick (:1095), _net_action (:1123) and the
// kernel bodies of _make_net_kernel (:1171), banked and per candidate.
//
// The block phase. As the TPU runs the MLP densely for the 1024 tables of
// a block, a slot of the net kernels runs in three phases over the
// MC_NET_THREADS tables of a CUDA block, one table a thread:
//   (a) each thread steps its own table up to the decision; a thread whose
//       seat plays a net writes its 24 features to a row of the block's
//       staging area (mc_stage_rows: a warp ballot per bank, a popc rank,
//       per-warp counts), rows grouped by bank so each bank's rows are
//       contiguous;
//   (b) all threads run the MLP densely over the staged rows, one bank
//       segment at a time, that bank's weights from the block's shared copy
//       (mc_mlp_rows; a launch's banks past the seventh from global
//       memory): each thread a tile of rows x 4 outputs, so one input
//       load serves 4 outputs and one weight load serves the tile's rows;
//       the hidden rows pass through shared memory MC_NET_CHUNK rows at a
//       time, and the logits overwrite the row's first four features;
//   (c) each net thread reads its four logits, masks and picks.
// Every thread reaches every barrier: the slot loops have the same trip
// count on every thread, and a table with no head or no net seat skips the
// work of a phase, not its barrier.
//
// The same code is host C++ (MC_HD): MCLanes and MC_EACH_LANE make a phase
// one thread's part on the card and a loop over the block's lanes on the
// host, where a barrier is the end of a loop and a ballot a loop over the
// warp's lanes; tests/test_torch_csrc_host.py runs whole blocks that way.
//
// Banks. The TPU joins B nets into one block-diagonal MLP B times wider
// (_stack_weights_league) and selects the acting seat's logit group. Here
// the B nets lie side by side, each in the flat layout below, and a row
// runs only its seat's bank: the wide form's other terms are exact zeros,
// so the logits are the same function.
//
// Float order. The kernel must give the plain version's logits bit for
// bit, or a pick flips somewhere among ~10^8 decisions and the integer
// states part. So every float operation here rounds once (mc_fadd,
// mc_fmul, mc_fdiv: __fadd_rn and friends, never an FMA), each quotient is
// a correctly rounded division, and each output of a dense layer sums bias
// first and then the products of input 0, 1, ... in order — the order of
// models/policy_net.py:_dense; the tiling changes only which thread
// computes which output. logf is libdevice's (no fast math). Tensor cores
// would round the products' inputs (TF32, bf16) and sum in the hardware's
// order, so they are not used.
#pragma once

#include "engine.cuh"

#define MC_NUM_FEATURES 24
#define MC_HIDDEN 64
#define MC_NUM_ACTIONS 4
#define MC_NET_SLOT_WORDS (2 + MC_NUM_ACTIONS)
#define MC_PROBE_ROWS (MC_NUM_FEATURES + 2 * MC_NUM_ACTIONS)

// The flat weight buffer (ops/cuda_net.py:WEIGHT_SHAPES): w1 [24, 64], b1,
// w2 [64, 64], b2, w3 [64, 4], b3, row-major, [in, out]. Every part starts
// on a 16-byte boundary, as does every bank (24,080 bytes).
#define MC_W1 0
#define MC_B1 (MC_W1 + MC_NUM_FEATURES * MC_HIDDEN)
#define MC_W2 (MC_B1 + MC_HIDDEN)
#define MC_B2 (MC_W2 + MC_HIDDEN * MC_HIDDEN)
#define MC_W3 (MC_B2 + MC_HIDDEN)
#define MC_B3 (MC_W3 + MC_HIDDEN * MC_NUM_ACTIONS)
#define MC_NET_WEIGHTS (MC_B3 + MC_NUM_ACTIONS)
static_assert(MC_NET_WEIGHTS == 6020, "weights of the 24-64-64-4 MLP");
static_assert(MC_B1 % 4 == 0 && MC_W2 % 4 == 0 && MC_B2 % 4 == 0 &&
                  MC_W3 % 4 == 0 && MC_B3 % 4 == 0 &&
                  MC_NET_WEIGHTS % 4 == 0,
              "float4 loads of every part");

// Tables (threads) of a block, its warps, the banks a launch may carry and
// the banks a block holds in shared memory: 7 x 24,080 bytes of weights
// and the staging area fit the 227 KB (232,448 bytes) a block may use, so
// banks 7 and 8 of a launch are read from global memory (through the
// read-only cache). 256-table blocks (against 128) share a block's weights
// over twice the tables, so two banks still leave two blocks an SM (chosen
// on the card with ab_engine.py --also).
#define MC_NET_THREADS 256
#define MC_NET_WARPS (MC_NET_THREADS / 32)
#define MC_MAX_BANKS 9
#define MC_SMEM_BANKS 7
// Staging rows: a table's 24 features, padded to 28 floats so that eight
// threads' float4 accesses to eight rows fall in distinct banks; the hidden
// rows of a chunk, 64 floats padded to 68 likewise. The hidden rows pass
// through MC_NET_CHUNK rows at a time (chosen on the card:
// montecarlo_tpu_torch/scripts/ab_engine.py --variants).
#define MC_NET_X_STRIDE 28
#define MC_NET_H_STRIDE 68
#define MC_NET_CHUNK 32
// A dense layer's tile: 16 groups of 4 outputs x MC_NET_ROW_GROUPS groups
// of MC_NET_TILE rows cover a chunk's 64 outputs with the block's threads.
#define MC_NET_ROW_GROUPS (MC_NET_THREADS / 16)
#define MC_NET_TILE (MC_NET_CHUNK / MC_NET_ROW_GROUPS)
static_assert(MC_NET_THREADS % 32 == 0 &&
                  MC_NET_CHUNK % MC_NET_ROW_GROUPS == 0 &&
                  MC_NET_ROW_GROUPS % 8 == 0 &&
                  MC_NET_CHUNK * MC_NUM_ACTIONS <= MC_NET_THREADS,
              "a chunk is whole tiles, eight lanes of a warp hold eight "
              "row groups, and a chunk's 4 logits a row take at most the "
              "block's threads");

// The block's shared memory: the banks' weights, the staging rows, the two
// hidden chunks and the per-warp row counts of each bank; and the block's
// candidate's weights in global memory, where banks from MC_SMEM_BANKS on
// are read.
struct MCNetShared {
  float* w;   // [min(n_banks, MC_SMEM_BANKS), MC_NET_WEIGHTS]
  float* x;   // [MC_NET_THREADS, MC_NET_X_STRIDE]: features, then logits
  float* h1;  // [MC_NET_CHUNK, MC_NET_H_STRIDE]
  float* h2;  // [MC_NET_CHUNK, MC_NET_H_STRIDE]
  int* cnt;   // [MC_NET_WARPS, MC_MAX_BANKS]
  const float* gw;  // [n_banks, MC_NET_WEIGHTS], global
};

// The banks of a launch that a block holds in shared memory.
MC_HD constexpr int mc_smem_banks(int n_banks) {
  return n_banks < MC_SMEM_BANKS ? n_banks : MC_SMEM_BANKS;
}
MC_HD constexpr int mc_net_smem_floats(int n_banks) {
  return mc_smem_banks(n_banks) * MC_NET_WEIGHTS +
         MC_NET_THREADS * MC_NET_X_STRIDE +
         2 * MC_NET_CHUNK * MC_NET_H_STRIDE + MC_NET_WARPS * MC_MAX_BANKS;
}
static_assert(mc_net_smem_floats(MC_MAX_BANKS) * 4 <= 232448,
              "the shared banks and the staging area fit a block");

MC_HD MCNetShared mc_net_shared(float* base, int n_banks,
                                const float* weights) {
  MCNetShared sh;
  sh.w = base;
  sh.gw = weights;
  sh.x = sh.w + mc_smem_banks(n_banks) * MC_NET_WEIGHTS;
  sh.h1 = sh.x + MC_NET_THREADS * MC_NET_X_STRIDE;
  sh.h2 = sh.h1 + MC_NET_CHUNK * MC_NET_H_STRIDE;
  sh.cnt = reinterpret_cast<int*>(sh.h2 + MC_NET_CHUNK * MC_NET_H_STRIDE);
  return sh;
}

// Four floats from / to a 16-byte aligned address: one 128-bit shared
// memory access on the card.
MC_HD void mc_ld4(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}
// A weight load: four floats (16-byte aligned) or one, from shared memory,
// or with G from global memory through the read-only cache.
template <bool G>
MC_HD void mc_ldw4(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  if (G) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#endif
  mc_ld4(p, v);
}
template <bool G>
MC_HD float mc_ldw(const float* p) {
#ifdef __CUDA_ARCH__
  if (G) return __ldg(p);
#endif
  return *p;
}
MC_HD void mc_st4(float* p, const float* v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  for (int i = 0; i < 4; ++i) p[i] = v[i];
#endif
}

// The block's lanes: the state a thread keeps from phase to phase. On the
// card `lanes` is the thread's own lane and lane t is that one; on the host
// it is the block's MC_NET_THREADS lanes. MC_EACH_LANE(t) runs its body as
// lane t: once, as the calling thread, on the card; for every lane in turn
// on the host. mc_block_sync is __syncthreads on the card and nothing on
// the host, where each phase's loop ends before the next begins.
#ifdef __CUDA_ARCH__
#define MC_EACH_LANE(t) \
  for (int t = threadIdx.x, t##_end = t + 1; t < t##_end; ++t)
#else
#define MC_EACH_LANE(t) for (int t = 0; t < MC_NET_THREADS; ++t)
#endif

MC_HD void mc_block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

template <class Lane>
struct MCLanes {
  Lane* lanes;
  MC_HD Lane& operator[](int t) const {
#ifdef __CUDA_ARCH__
    (void)t;
    return *lanes;
#else
    return lanes[t];
#endif
  }
  // The lanes of lane t's warp whose row key is `key`, bit (lane mod 32).
  // On the card every thread of the warp calls it together.
  MC_HD uint32_t ballot(int t, int key) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xFFFFFFFFu, lanes->key == key);
#else
    uint32_t m = 0u;
    const int w0 = t / 32 * 32;
    for (int u = 0; u < 32; ++u)
      m |= (uint32_t)(lanes[w0 + u].key == key) << u;
    return m;
#endif
  }
};

// What a thread keeps between the phases of a slot: its table, its word
// source (K6's MCWords, K5's deal stash column), the slot's head, street
// total and raw action, the bank of its net decision (key, -1 for none),
// its staging row, the slot's words and its count of net decisions.
template <class Table, class Src>
struct MCNetLane {
  Table s;
  Src src;
  int head, total, raw, key, row, n_net;
  uint32_t words[MC_NET_SLOT_WORDS];
  MC_HD explicit MCNetLane(const Src& src_) : src(src_), key(-1), n_net(0) {}
};

// The bank of the seat acting at play-order position `head`: seat (button
// + head) mod P plays bank (bank_map >> 4 seat) & 15 (seat_to_bank, four
// bits a seat).
MC_HD int mc_bank_of(int seat, unsigned long long bank_map) {
  return (int)((bank_map >> (4 * seat)) & 15u);
}
template <int P, int R, class Rows>
MC_HD int mc_seat_of(const MCTable<P, R, Rows>& s, int head) {
  return mc_floormod(s.rows.get(MCCold<P, R>::BUTTON) + head, P);
}

// Candidate c's slice of a population launch: its n_tables tables of the
// packed state and its n_banks banks of weights. The offsets reach past
// 2^31 elements, so they are computed in 64 bits.
template <int P, int R>
MC_HD long long mc_candidate_state(long long c, int n_tables) {
  return c * n_tables * mc_fields<P, R>();
}
MC_HD long long mc_candidate_weights(long long c, int n_banks) {
  return c * n_banks * MC_NET_WEIGHTS;
}

// The 24 decision features of position `head` (_features), into f.
template <int P, int R, class Rows>
MC_HD void mc_features(const MCTable<P, R, Rows>& s, int head, int bb,
                       float* f) {
  constexpr int L = MCTable<P, R, Rows>::L;
  using C = MCCold<P, R>;
  const int total = mc_street_total<L>(s.lvl);
  int pot = total;
  for (int row = 0; row < 4 * L; ++row)
    pot = mc_add(pot, s.rows.get(C::POT_AMT + row));
  const int needed = mc_sub(total, mc_sel<P>(s.contrib, head));
  const int stage = s.stage;
  const int n_comm = stage == 0 ? 0 : stage == 1 ? 3 : stage == 2 ? 4 : 5;

  // made-hand key of the hole cards and the revealed board
  const int hole0 = s.rows.get(C::HOLE0 + head),
            hole1 = s.rows.get(C::HOLE1 + head);
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  mc_add_card(m, hole0);
  mc_add_card(m, hole1);
  for (int i = 0; i < n_comm; ++i) mc_add_card(m, s.rows.get(C::BOARD + i));
  const int key = mc_eval_key(m[0], m[1], m[2], m[3]);

  const float fP = (float)P;
  const float pot_f = (float)pot, needed_f = (float)needed;
  const int full = (1 << P) - 1;
  const int sr = s.street_raises;
  for (int k = 0; k < 4; ++k) f[k] = stage == k ? 1.f : 0.f;
  f[4] = mc_fdiv((float)n_comm, 5.f);
  f[5] = mc_fdiv(pot_f, 100.f * fP);
  f[6] = mc_fdiv(needed_f, 100.f);
  f[7] = mc_fdiv((float)mc_sel<P>(s.stacks, head), 100.f);
  f[8] = needed == 0 ? 1.f : 0.f;
  f[9] = mc_fdiv((float)mc_popc((uint32_t)(s.in_hand & full)), fP);
  f[10] = mc_fdiv((float)mc_popc((uint32_t)(s.to_act & full)), fP);
  f[11] = mc_fdiv((float)head, fP);
  const float odds_den = mc_fadd(needed_f, pot_f);
  f[12] = mc_fdiv(pot_f, odds_den > 1.f ? odds_den : 1.f);
  f[13] = mc_fdiv(mc_fdiv(needed_f, (float)bb), 10.f);
  f[14] = mc_fdiv((float)(key >> MC_CAT_SHIFT), 8.f);
  f[15] = mc_fdiv((float)((key >> 16) & 0xF), 14.f);
  f[16] = mc_fdiv((float)(2 + mc_floormod(hole0, 13)), 14.f);
  f[17] = mc_fdiv((float)(2 + mc_floormod(hole1, 13)), 14.f);
  f[18] = ((hole0 * 5) >> 6) == ((hole1 * 5) >> 6) ? 1.f : 0.f;
  f[19] = mc_floormod(hole0, 13) == mc_floormod(hole1, 13) ? 1.f : 0.f;
  f[20] = mc_fdiv((float)sr, 4.f);
  f[21] = sr > 0 ? 1.f : 0.f;
  f[22] = sr > 0 ? mc_fdiv((float)mc_floormod(s.last_raiser - head, P), fP)
                 : 0.f;
  f[23] = sr >= 2 ? 1.f : 0.f;
}

// Gumbel noise of one word (_gumbel_pick): u = (bits >> 8) 2^-24, exact;
// log(-log(max(u, 1e-12))) is returned for the caller to subtract.
MC_HD float mc_neg_gumbel(uint32_t bits) {
  float u = mc_fmul((float)(int)(bits >> 8), 5.9604644775390625e-08f);
  return logf(-logf(u > 1e-12f ? u : 1e-12f));
}

// Phase (b)'s tile: outputs col .. col + 3 of a 64-wide layer and rows rg,
// rg + G, ..., rg + G (MC_NET_TILE - 1) of a chunk (G = MC_NET_ROW_GROUPS;
// lane t: rg = t mod G, col = 4 (t / G)), from inputs x [rows, XS] into
// out [rows, MC_NET_H_STRIDE], ReLU'd. Each output is b[j], then
// + x[0] w[0][j], + x[1] w[1][j], ... in order. Every warp holds eight row groups or more,
// so a chunk of few rows keeps every warp (and its scheduler) busy, and
// the eight lanes of a 128-bit access share a weight address and read
// eight consecutive rows (distinct banks at the padded strides). A lane
// whose first row is at or past n_rows does nothing; a row past it is
// computed from row n_rows - 1 and not used. The weights are in shared
// memory, or with GW in global memory.
template <int N_IN, int XS, bool GW>
MC_HD void mc_dense_tile(const float* w, const float* b, const float* x,
                         float* out, int t, int n_rows) {
  constexpr int TR = MC_NET_TILE, G = MC_NET_ROW_GROUPS;
  const int rg = t % G, col = 4 * (t / G);
  if (rg >= n_rows) return;
  float acc[TR][4], bias[4];
  mc_ldw4<GW>(b + col, bias);
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[r][o] = bias[o];
#pragma unroll
  for (int i = 0; i < N_IN; i += 4) {
    float xv[TR][4];
#pragma unroll
    for (int r = 0; r < TR; ++r)
      mc_ld4(x + mc_min(rg + G * r, n_rows - 1) * XS + i, xv[r]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float wv[4];
      mc_ldw4<GW>(w + (i + k) * MC_HIDDEN + col, wv);
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int o = 0; o < 4; ++o)
          acc[r][o] = mc_fadd(acc[r][o], mc_fmul(xv[r][k], wv[o]));
    }
  }
#pragma unroll
  for (int r = 0; r < TR; ++r) {
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[r][o] = acc[r][o] > 0.f ? acc[r][o] : 0.f;
    mc_st4(out + (rg + G * r) * MC_NET_H_STRIDE + col, acc[r]);
  }
}

// The output layer, logit a of one row: b3[a] + h[0] w3[0][a] + ...
template <bool GW>
MC_HD float mc_dense_out(const float* w, const float* b, const float* h,
                         int a) {
  float acc = mc_ldw<GW>(b + a);
#pragma unroll 4
  for (int i = 0; i < MC_HIDDEN; i += 4) {
    float hv[4];
    mc_ld4(h + i, hv);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc = mc_fadd(acc, mc_fmul(hv[k],
                                 mc_ldw<GW>(w + (i + k) * MC_NUM_ACTIONS + a)));
  }
  return acc;
}

// Rows of bank b in the staging area, and the rows before them.
MC_HD int mc_bank_rows(const MCNetShared& sh, int b) {
  int n = 0;
  for (int w = 0; w < MC_NET_WARPS; ++w) n += sh.cnt[w * MC_MAX_BANKS + b];
  return n;
}

// One bank's segment of phase (b), staged rows start .. end - 1, with the
// bank's weights w (in shared memory, or with GW in global memory),
// MC_NET_CHUNK rows at a time; row r's logits replace its first four
// features. Every thread calls it.
template <bool GW>
MC_HD void mc_mlp_segment(const MCNetShared& sh, const float* w, int start,
                          int end) {
  for (int c = start; c < end; c += MC_NET_CHUNK) {
    const int n = mc_min(end - c, MC_NET_CHUNK);
    MC_EACH_LANE(t)
    mc_dense_tile<MC_NUM_FEATURES, MC_NET_X_STRIDE, GW>(
        w + MC_W1, w + MC_B1, sh.x + c * MC_NET_X_STRIDE, sh.h1, t, n);
    mc_block_sync();
    MC_EACH_LANE(t)
    mc_dense_tile<MC_HIDDEN, MC_NET_H_STRIDE, GW>(w + MC_W2, w + MC_B2,
                                                  sh.h1, sh.h2, t, n);
    mc_block_sync();
    // the output layer, lane t logit t / CHUNK of row t mod CHUNK, reads
    // h2 while the next chunk's first layer writes h1; the next write of
    // h2 is after a barrier
    MC_EACH_LANE(t) {
      const int row = t % MC_NET_CHUNK, a = t / MC_NET_CHUNK;
      if (a >= MC_NUM_ACTIONS || row >= n) continue;
      sh.x[(c + row) * MC_NET_X_STRIDE + a] = mc_dense_out<GW>(
          w + MC_W3, w + MC_B3, sh.h2 + row * MC_NET_H_STRIDE, a);
    }
  }
}

// Phase (b): the MLP (_mlp_logits: 24 -> 64 -> 64 -> 4, ReLU) over the
// staged rows, bank segment by bank segment: banks below MC_SMEM_BANKS
// from the block's shared copy, the others from global memory. Every
// thread calls it.
MC_HD void mc_mlp_rows(const MCNetShared& sh, int n_banks) {
  int start = 0;
  for (int b = 0; b < n_banks; ++b) {
    const int end = start + mc_bank_rows(sh, b);
    if (b < MC_SMEM_BANKS)
      mc_mlp_segment<false>(sh, sh.w + b * MC_NET_WEIGHTS, start, end);
    else
      mc_mlp_segment<true>(sh, sh.gw + b * MC_NET_WEIGHTS, start, end);
    start = end;
  }
  mc_block_sync();
}

// Phase (a)'s staging: each lane with a row key (its bank, >= 0) gets the
// row after the rows of lower banks, of earlier warps with its bank, and
// of its warp's lower lanes with its bank, and writes its 24 features
// there; then a barrier. Returns the count of staged rows (the same on
// every lane, read before the barrier: the counts are rewritten by the
// next slot's staging once every lane has passed it).
template <int P, int R, class Lanes>
MC_HD int mc_stage_rows(const Lanes& blk, const MCNetShared& sh, int n_banks,
                        int bb) {
  MC_EACH_LANE(t) {
    auto& L = blk[t];
    const int lane = t % 32;
    int rank = 0;
    for (int b = 0; b < n_banks; ++b) {
      const uint32_t m = blk.ballot(t, b);
      if (L.key == b) rank = mc_popc(m & ((1u << lane) - 1u));
      if (lane == 0) sh.cnt[t / 32 * MC_MAX_BANKS + b] = mc_popc(m);
    }
    L.row = rank;
  }
  mc_block_sync();
  int n_rows = 0;
  MC_EACH_LANE(t) {
    auto& L = blk[t];
    n_rows = 0;
    for (int b = 0; b < n_banks; ++b) n_rows += mc_bank_rows(sh, b);
    if (L.key < 0) continue;
    for (int b = 0; b < L.key; ++b) L.row += mc_bank_rows(sh, b);
    for (int w = 0; w < t / 32; ++w) L.row += sh.cnt[w * MC_MAX_BANKS + L.key];
    float f[MC_NUM_FEATURES];
    mc_features(L.s, L.head, bb, f);
    float* x = sh.x + L.row * MC_NET_X_STRIDE;
#pragma unroll
    for (int i = 0; i < MC_NUM_FEATURES; i += 4) mc_st4(x + i, f + i);
  }
  mc_block_sync();
  return n_rows;
}

// Phases (a) and (b) for the lanes' row keys set: stage, and run the MLP
// unless no lane staged a row (a decision the same on every lane).
template <int P, int R, class Lanes>
MC_HD void mc_net_logits(const Lanes& blk, const MCNetShared& sh,
                         int n_banks, int bb) {
  if (mc_stage_rows<P, R>(blk, sh, n_banks, bb) > 0)
    mc_mlp_rows(sh, n_banks);
}

// The masked logits of position `head` from its row's logits (folding
// with nothing owed is masked, policy_net.py:80-81); with `gbits`, the
// Gumbel scores logits + g in their place.
template <int P, int R, class Rows>
MC_HD void mc_net_scores(const MCTable<P, R, Rows>& s, int head, int total,
                         const float* logits, const uint32_t* gbits,
                         float* lg) {
  mc_ld4(logits, lg);
  const int needed = mc_sub(total, mc_sel<P>(s.contrib, head));
  lg[0] = mc_fadd(lg[0], needed == 0 ? -1e9f : 0.f);
  if (gbits)
    for (int a = 0; a < MC_NUM_ACTIONS; ++a)
      lg[a] = mc_fsub(lg[a], mc_neg_gumbel(gbits[a]));
}

// Phase (c): the net's raw action (_net_action) from its row's logits:
// argmax of the masked logits, or the Gumbel pick on `gbits`; the first
// index attaining the max; menu fold / call / 2bb / max(pot + needed, 2bb).
template <int P, int R, class Rows>
MC_HD int mc_net_pick(const MCTable<P, R, Rows>& s, int head, int total,
                      int bb, const float* logits, const uint32_t* gbits) {
  constexpr int L = MCTable<P, R, Rows>::L;
  using C = MCCold<P, R>;
  float lg[MC_NUM_ACTIONS];
  mc_net_scores(s, head, total, logits, gbits, lg);
  int idx = 0;
  for (int a = 1; a < MC_NUM_ACTIONS; ++a)
    if (lg[a] > lg[idx]) idx = a;
  if (idx == 0) return -1;
  if (idx == 1) return 0;
  const int small = 2 * bb;
  if (idx == 2) return small;
  int pot = total;
  for (int row = 0; row < 4 * L; ++row)
    pot = mc_add(pot, s.rows.get(C::POT_AMT + row));
  return mc_max(mc_add(pot, mc_sub(total, mc_sel<P>(s.contrib, head))),
                small);
}

// K5's work for a block of tables: n_steps fused steps, every seat playing
// its bank's net by argmax; hand h > 0 of a table is dealt from its stash
// column (lane src) row min(h, hmax - 1).
template <int P, int R, class Lanes>
MC_HD void mc_run_net_det(const Lanes& blk, const MCNetShared& sh,
                          long long stride, int n_steps, int hmax, int sb,
                          int bb, int n_banks, unsigned long long bank_map) {
  constexpr int L = mc_layers<R>();
  using C = MCCold<P, R>;
  for (int i = 0; i < n_steps; ++i) {
    // (a) a table with no head is a no-op this step, whatever it would play
    MC_EACH_LANE(t) {
      auto& Ln = blk[t];
      Ln.key = -1;
      if (!Ln.s.order) continue;
      Ln.head = mc_head<P>(Ln.s.order, Ln.s.cursor);
      Ln.total = mc_street_total<L>(Ln.s.lvl);
      Ln.key = mc_bank_of(mc_seat_of(Ln.s, Ln.head), bank_map);
    }
    mc_net_logits<P, R>(blk, sh, n_banks, bb);  // (b)
    // (c) pick, step, settle
    MC_EACH_LANE(t) {
      auto& Ln = blk[t];
      if (Ln.key >= 0)
        mc_step_nosettle(Ln.s,
                         mc_net_pick(Ln.s, Ln.head, Ln.total, bb,
                                     sh.x + Ln.row * MC_NET_X_STRIDE,
                                     nullptr),
                         Ln.head, Ln.total);
      if (Ln.s.wait) {
        const int hand_ptr =
            mc_min(Ln.s.rows.get(C::HAND_CT) + 1, hmax - 1);
        mc_settle_pass(Ln.s, MCDealStash{Ln.src, stride, hand_ptr}, sb, bb);
      }
    }
  }
}

// K6's work for a block of tables: per iteration, `defer` slots of six
// words (u, amt_bits, four Gumbel words; all drawn whoever acts), then 2P+5
// deal words and a settle pass. Seats whose bit is set in net_seats play
// their bank's net, the others the random policy. Each lane counts its net
// decisions in n_net.
template <int P, int R, class Lanes>
MC_HD void mc_run_net_eval(const Lanes& blk, const MCNetShared& sh,
                           int n_steps, int defer, int sb, int bb, int ss,
                           int net_seats, bool reset_stacks,
                           uint32_t fold_bits, uint32_t raise_bits,
                           int n_banks, unsigned long long bank_map) {
  constexpr int NC = 2 * P + 5;
  constexpr int L = mc_layers<R>();
  for (int it = 0; it < n_steps / defer; ++it) {
    for (int k = 0; k < defer; ++k) {
      // (a) the slot's words, the random policy's action, the net's key
      MC_EACH_LANE(t) {
        auto& Ln = blk[t];
        for (int i = 0; i < MC_NET_SLOT_WORDS; ++i)
          Ln.words[i] = Ln.src.next();
        Ln.key = -1;
        if (!Ln.s.order) continue;  // no head: the slot is a no-op
        Ln.head = mc_head<P>(Ln.s.order, Ln.s.cursor);
        Ln.total = mc_street_total<L>(Ln.s.lvl);
        Ln.raw = mc_policy(Ln.s, Ln.head, Ln.total, Ln.words[0],
                           Ln.words[1], fold_bits, raise_bits);
        const int seat = mc_seat_of(Ln.s, Ln.head);
        if ((net_seats >> seat) & 1) {
          Ln.key = mc_bank_of(seat, bank_map);
          ++Ln.n_net;
        }
      }
      mc_net_logits<P, R>(blk, sh, n_banks, bb);  // (b)
      // (c) the net lanes pick; every lane with a head steps
      MC_EACH_LANE(t) {
        auto& Ln = blk[t];
        if (!Ln.s.order) continue;
        if (Ln.key >= 0)
          Ln.raw = mc_net_pick(Ln.s, Ln.head, Ln.total, bb,
                               sh.x + Ln.row * MC_NET_X_STRIDE,
                               Ln.words + 2);
        mc_step_nosettle(Ln.s, Ln.raw, Ln.head, Ln.total);
      }
    }
    MC_EACH_LANE(t) {
      auto& Ln = blk[t];
      int deal[NC];
      mc_sample_cards<NC>(Ln.src, nullptr, 0, deal);
      mc_settle_pass(Ln.s, MCDealArray{deal}, sb, bb, ss, reset_stacks);
    }
  }
}

// The probe's work for a block of tables (one net): per table, the
// features, the masked logits and the Gumbel scores on `words` [4, T] of
// the acting position, into out [MC_PROBE_ROWS, T], T = stride. Lane t's
// table is table `t0 + t`.
template <int P, int R, class Lanes>
MC_HD void mc_run_net_probe(const Lanes& blk, const MCNetShared& sh,
                            const int* words, float* out, long long t0,
                            long long stride, int bb) {
  constexpr int L = mc_layers<R>();
  MC_EACH_LANE(t) {
    auto& Ln = blk[t];
    Ln.head = mc_head<P>(Ln.s.order, Ln.s.cursor);
    Ln.total = mc_street_total<L>(Ln.s.lvl);
    Ln.key = 0;
  }
  mc_net_logits<P, R>(blk, sh, 1, bb);
  MC_EACH_LANE(t) {
    auto& Ln = blk[t];
    float f[MC_NUM_FEATURES], lg[MC_NUM_ACTIONS];
    mc_features(Ln.s, Ln.head, bb, f);
    mc_net_scores(Ln.s, Ln.head, Ln.total,
                  sh.x + Ln.row * MC_NET_X_STRIDE, nullptr, lg);
    float* o = out + t0 + t;
    for (int i = 0; i < MC_NUM_FEATURES; ++i) o[i * stride] = f[i];
    for (int a = 0; a < MC_NUM_ACTIONS; ++a) {
      const uint32_t g = (uint32_t)words[a * stride + t0 + t];
      o[(MC_NUM_FEATURES + a) * stride] = lg[a];
      o[(MC_NUM_FEATURES + MC_NUM_ACTIONS + a) * stride] =
          mc_fsub(lg[a], mc_neg_gumbel(g));
    }
  }
}
