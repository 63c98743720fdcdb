// Equity rollouts (ops/cuda_equity.py), host- and device-compilable.
//
// K1, K2 and B3 (since their redesign for the H100) share one form: a
// rollout's words go straight into registers (mc_rollout_words: Philox
// blocks computed in order, or the injected rows; the source a template
// flag), draw t is one word modulo the compile-time constant NLIVE - t
// (the dead count is fixed by the instantiation, so nvcc emits a
// multiply-high, not a division), distinct by bubble insertion among the
// earlier draws' live indices, and a live index becomes its card's bit in
// two packed suit planes through a deck table in shared memory (K1 and
// B3: the launch's MCDeck; K2: each hero's own, built by the block). Hands
// are ranked by mc_rank7, which orders them as mc_eval_cmp does with no
// leading-bit search. Every array index is a compile-time constant: no
// stack frame.
#pragma once

#include "evaluator.cuh"
#include "philox.cuh"

// Where a rollout of K1, K2 or B3 stops: a probe of where their time goes,
// built as a variant and timed without comparing (scripts/ab_engine.py
// --variants MC_EQUITY_CUT=1,MC_EQUITY_CUT=2,MC_EQUITY_CUT=3 --time-only).
// 1: the words only; 2: with the draws (each card's live index); 3: with
// the board's (and K2's villain's) suit planes; 4: the whole rollout, the
// kernels' result. A cut returns its partial result, which the kernel adds
// to its first counter whole, so nvcc drops none of the work before it.
#define MC_EQUITY_CUT 4

// The key of the 7-card hand whose planes are lo and hi: mc_rank7 of its
// four suit masks, taken out with shifts. It orders hands as mc_eval_cmp
// does, and K1, K2 and B3 only compare keys.
MC_HD uint32_t mc_eval_planes(uint32_t lo, uint32_t hi) {
  return mc_rank7(lo & 0xFFFFu, lo >> 16, hi & 0xFFFFu, hi >> 16);
}

// Multiway equity (pallas_equity.py:268-298): up to MC_MAX_HANDS hands in
// one pot. lcm(1..13) x 16,384 rollouts overflows the TPU kernel's int32
// shares in one program, so 12 hands is the JAX package's limit too.
#define MC_MAX_HANDS 12
// The Philox sub-stream of multiway rollouts: K1 draws from sub-stream 0
// and K2 from 1..65535 (hand h + 1), so 65536 is no other kernel's.
#define MC_SUB_MULTIWAY 65536u

// lcm(1..n): a multiway pot's shares, so that every split is exact.
MC_HD constexpr int mc_lcm_to(int n) {
  int l = 1;
  for (int i = 2; i <= n; ++i) {
    int a = l, b = i;
    while (b) {
      int r = a % b;
      a = b;
      b = r;
    }
    l = l / a * i;
  }
  return l;
}

// A launch's deck: live index i (the i-th card, ascending, that is not
// dead) -> its card's plane bit. A draw's live index past the earlier
// draws becomes its card through this table: the shift past the dead cards
// and the suit planes in one load (on the card, from the block's copy in
// shared memory). It took 0.94 and 0.72 of K1's time with the other forms
// measured: the walk past the dead cards with their count a compile-time
// constant, and the x-th free bit of a 64-bit mask (PERF.md).
struct MCDeck {
  uint64_t live[52];
};

// The deck of n_dead ascending dead cards.
MC_HD void mc_make_deck(const int* dead, int n_dead, MCDeck* d) {
  int i = 0, k = 0;
  for (int c = 0; c < 52; ++c) {
    if (k < n_dead && dead[k] == c) {
      ++k;
      continue;
    }
    d->live[i++] = mc_card_bit64(c);
  }
  for (; i < 52; ++i) d->live[i] = 0u;
}

// The two planes of four suit masks (pallas_equity.py:96-120).
MC_HD void mc_masks_to_planes(const int* m, uint32_t* planes) {
  planes[0] = (uint32_t)m[0] | (uint32_t)m[1] << 16;
  planes[1] = (uint32_t)m[2] | (uint32_t)m[3] << 16;
}

// Draw t of a rollout: word w modulo D = NLIVE - t, a compile-time
// constant (pallas_equity.py:_uniform_draws' rule, exact).
template <uint32_t D>
MC_HD uint32_t mc_draw_mod(uint32_t w) {
  static_assert(D >= 1 && D <= 52, "a live-card count");
  return w % D;
}

// Draw T of a rollout and the draws after it, each card's plane bit ORed
// into mv (the first NV draws: K2's villain) or m (the rest: the board),
// one step a draw, so that T, and with it the divisor and the mask, is a
// compile-time constant. chosen: the earlier draws' live indices,
// ascending.
template <int NLIVE, int NDRAW, int NV, int T>
MC_HD void mc_draw_step(const uint32_t (&w)[NDRAW], const uint64_t* live,
                        int (&chosen)[NDRAW], uint64_t& mv, uint64_t& m,
                        uint32_t& cut) {
  if constexpr (T < NDRAW) {
    int x = (int)mc_draw_mod<NLIVE - T>(w[T]);
#pragma unroll
    for (int j = 0; j < T; ++j) x += x >= chosen[j];
    int carry = x;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int c = chosen[j];
      chosen[j] = mc_min(carry, c);
      carry = mc_max(carry, c);
    }
    chosen[T] = carry;
    cut = cut * 53u + (uint32_t)x;
    if constexpr (T < NV)
      mv |= live[x];
    else
      m |= live[x];
    mc_draw_step<NLIVE, NDRAW, NV, T + 1>(w, live, chosen, mv, m, cut);
  }
}

// The board's NDRAW drawn cards as the two packed planes lo (suits 0, 1)
// and hi (suits 2, 3), from the rollout's words (pallas_equity.py:65-120:
// the same cards as insertion then the shift past the 52 - NLIVE dead
// cards). `live` is the deck's table. `cut` gathers the draws for
// MC_EQUITY_CUT.
template <int NLIVE, int NDRAW>
MC_HD void mc_draw_planes(const uint32_t (&w)[NDRAW], const uint64_t* live,
                          uint32_t& lo, uint32_t& hi, uint32_t& cut) {
  int chosen[NDRAW];
  uint64_t m = 0u, unused = 0u;
  mc_draw_step<NLIVE, NDRAW, 0, 0>(w, live, chosen, unused, m, cut);
  lo = (uint32_t)m;
  hi = (uint32_t)(m >> 32);
}

struct MCEquityParams {
  MCDeck deck;                       // holes + known board dead
  uint32_t hero[2], villain[2];      // planes, known board included
};

// Hand vs hand on a board missing NDRAW = 9 - n_dead cards
// (pallas_equity.py:126-142), rollout r. Returns +1 hero wins, 0 tie, -1
// loss (under MC_EQUITY_CUT < 4, the cut's partial result).
template <int NDRAW, bool INJECT>
MC_HD int mc_rollout_vs_hand(const MCEquityParams& p, const uint64_t* live,
                             const int* words, long long n, long long r,
                             uint32_t seed) {
  uint32_t w[NDRAW];
  mc_rollout_words<NDRAW, INJECT>(w, words, n, r, seed, 0u);
  uint32_t cut = 0u;
#if MC_EQUITY_CUT == 1
#pragma unroll
  for (int t = 0; t < NDRAW; ++t) cut = cut * 53u + w[t];
  return (int)cut;
#endif
  uint32_t lo, hi;
  mc_draw_planes<43 + NDRAW, NDRAW>(w, live, lo, hi, cut);
#if MC_EQUITY_CUT == 2
  return (int)cut;
#elif MC_EQUITY_CUT == 3
  return (int)((lo | p.hero[0]) ^ ((hi | p.villain[1]) << 1));
#endif
  const uint32_t vh = mc_eval_planes(lo | p.hero[0], hi | p.hero[1]);
  const uint32_t vv = mc_eval_planes(lo | p.villain[0], hi | p.villain[1]);
  return (vh > vv) - (vh < vv);
}

// Entry i of a hero's deck (K2): the i-th card, ascending, that is not
// one of the hero's ascending holes d0 < d1, as its plane bit; i < 50.
// The shift past the two holes is _sample_cards' (pallas_equity.py:88-92).
MC_HD uint64_t mc_hero_live(int i, int d0, int d1) {
  int card = i;
  card += card >= d0;
  card += card >= d1;
  return mc_card_bit64(card);
}

// K2's rollout r: the hero (planes `hero`, its holes the deck's only dead
// cards) vs a random villain, 2 villain and 5 board cards drawn from the
// hero's 50 live cards (pallas_equity.py:182-205). `live`: the hero's deck
// (mc_hero_live); `words`: hand h's row of the injected words, `stride`
// H * n; sub: the hand's Philox sub-stream h + 1. Returns +1 hero wins, 0
// tie, -1 loss (under MC_EQUITY_CUT < 4, the cut's partial result).
template <bool INJECT>
MC_HD int mc_rollout_sweep(const uint32_t (&hero)[2], const uint64_t* live,
                           const int* words, long long stride, long long r,
                           uint32_t seed, uint32_t sub) {
  uint32_t w[7];
  mc_rollout_words<7, INJECT>(w, words, stride, r, seed, sub);
  uint32_t cut = 0u;
#if MC_EQUITY_CUT == 1
#pragma unroll
  for (int t = 0; t < 7; ++t) cut = cut * 53u + w[t];
  return (int)cut;
#endif
  int chosen[7];
  uint64_t vm = 0u, bm = 0u;
  mc_draw_step<50, 7, 2, 0>(w, live, chosen, vm, bm, cut);
#if MC_EQUITY_CUT == 2
  return (int)cut;
#endif
  const uint32_t lo = (uint32_t)bm, hi = (uint32_t)(bm >> 32);
  const uint32_t vlo = lo | (uint32_t)vm, vhi = hi | (uint32_t)(vm >> 32);
#if MC_EQUITY_CUT == 3
  return (int)((lo | hero[0]) ^ vlo ^ (((hi | hero[1]) ^ vhi) << 1));
#endif
  const uint32_t vh = mc_eval_planes(lo | hero[0], hi | hero[1]);
  const uint32_t vv = mc_eval_planes(vlo, vhi);
  return (vh > vv) - (vh < vv);
}

struct MCMultiwayParams {
  MCDeck deck;                       // holes + known board dead
  uint32_t hand[MC_MAX_HANDS][2];    // planes, known board included
};

// One multiway rollout r of N hands on a board missing NDRAW = 5 - K cards:
// rank every hand and add lcm(1..N) / (number of winners) to each
// winner's share, an exact integer split of the pot. The share of a split
// comes from selects over the compile-time quotients.
template <int N, int NDRAW, bool INJECT>
MC_HD void mc_rollout_multiway(const MCMultiwayParams& p,
                               const uint64_t* live, const int* words,
                               long long n, long long r, uint32_t seed,
                               uint32_t (&shares)[N]) {
  uint32_t lo = 0u, hi = 0u, cut = 0u;
  if constexpr (NDRAW > 0) {
    uint32_t w[NDRAW];
    mc_rollout_words<NDRAW, INJECT>(w, words, n, r, seed, MC_SUB_MULTIWAY);
#if MC_EQUITY_CUT == 1
#pragma unroll
    for (int t = 0; t < NDRAW; ++t) cut = cut * 53u + w[t];
    shares[0] += cut;
    return;
#endif
    mc_draw_planes<47 - 2 * N + NDRAW, NDRAW>(w, live, lo, hi, cut);
#if MC_EQUITY_CUT == 2
    shares[0] += cut;
    return;
#endif
  }
#if MC_EQUITY_CUT == 3
  shares[0] += (lo | p.hand[0][0]) ^ ((hi | p.hand[0][1]) << 1) ^ cut;
  return;
#endif
  uint32_t v[N];
  uint32_t vmax = 0u;
#pragma unroll
  for (int h = 0; h < N; ++h) {
    v[h] = mc_eval_planes(lo | p.hand[h][0], hi | p.hand[h][1]);
    vmax = vmax > v[h] ? vmax : v[h];
  }
  int cnt = 0;
#pragma unroll
  for (int h = 0; h < N; ++h) cnt += v[h] == vmax;
  constexpr uint32_t S = (uint32_t)mc_lcm_to(N);
  uint32_t share = S;
#pragma unroll
  for (int k = 2; k <= N; ++k) share = cnt == k ? S / k : share;
#pragma unroll
  for (int h = 0; h < N; ++h) shares[h] += v[h] == vmax ? share : 0u;
}

#define MC_THREADS 256
// Waves of resident blocks in an equity launch (mc_rollout_grid): a
// block's share of the rollouts small enough that the SMs finish together
// (16 waves took 0.96 of the time of one, 64 the same as 16: PERF.md).
#define MC_EQUITY_WAVES 16

// Blocks of MC_THREADS for each of `hands` rows of n rollouts (K1 and B3:
// one row; K2: a row a hero hand, the grid's y) on a card that holds
// `wave` blocks at once: MC_EQUITY_WAVES waves over all rows, at least one
// block a row, fewer for a small n, and more where a thread would
// otherwise run so many rollouts that its 32-bit counters, at most
// `per_rollout` a rollout, could overflow (grid-stride: a thread runs at
// most ceil(n / (blocks x MC_THREADS)) rollouts).
MC_HD long long mc_rollout_grid(long long n, uint32_t per_rollout,
                                long long wave, int hands = 1) {
  if (n <= 0) return 1;
  long long b = (n - 1) / MC_THREADS + 1;
  const long long cap = (MC_EQUITY_WAVES * wave - 1) / hands + 1;
  if (b > cap) b = cap;
  const long long per_thread = 0xFFFFFFFFll / per_rollout;
  const long long need = ((n - 1) / per_thread) / MC_THREADS + 1;
  return b < need ? need : b;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// Sum n <= N per-thread counters v over the block, one atomic per counter
// (counter i into out[i * stride]): warp shuffles, one partial per warp in
// shared memory, then thread i adds counter i's partials.
template <int N>
__device__ void mc_block_add(const unsigned long long* v, int n,
                             unsigned long long* out, long long stride) {
  __shared__ unsigned long long part[MC_THREADS / 32][N];
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) {  // n is the same for the whole block
      unsigned long long a = v[i];
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_down_sync(0xffffffffu, a, off);
      if (lane == 0) part[warp][i] = a;
    }
  __syncthreads();
  if (threadIdx.x < n) {
    unsigned long long t = 0;
    for (int w = 0; w < MC_THREADS / 32; ++w) t += part[w][threadIdx.x];
    atomicAdd(&out[threadIdx.x * stride], t);
  }
}

// The deck's table into the block's shared memory (one thread, every
// index a constant: a run-time index into a kernel parameter would copy
// the parameters to the stack frame).
__device__ __forceinline__ void mc_share_live(const MCDeck& deck,
                                              uint64_t* live) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 52; ++i) live[i] = deck.live[i];
  }
  __syncthreads();
}

// A hero's deck (K2) in the block's shared memory: thread i < 50 writes
// entry i (mc_hero_live of the ascending holes d0 < d1).
__device__ __forceinline__ void mc_share_hero_live(int d0, int d1,
                                                   uint64_t* live) {
  if (threadIdx.x < 50) live[threadIdx.x] = mc_hero_live(threadIdx.x, d0, d1);
  __syncthreads();
}

// The blocks an SM holds of `kernel` (cudaOccupancyMaxActiveBlocksPer
// Multiprocessor, from its registers and shared memory), at least 1.
template <class Kernel>
static int mc_blocks_per_sm(Kernel kernel) {
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MC_THREADS,
                                                0);
  return mc_max(per_sm, 1);
}

// Blocks of MC_THREADS for each of `hands` rows of n rollouts of `kernel`
// (mc_rollout_grid, a wave being the SMs times mc_blocks_per_sm); 0 when
// n would need more than 2^31 - 1 blocks a row.
template <class Kernel>
static int mc_rollout_blocks(Kernel kernel, long long n,
                             uint32_t per_rollout, int hands = 1) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long b = mc_rollout_grid(
      n, per_rollout, (long long)sms * mc_blocks_per_sm(kernel), hands);
  return b > 0x7FFFFFFFll ? 0 : (int)b;
}
#endif
