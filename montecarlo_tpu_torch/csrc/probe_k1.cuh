// K1's variants (ops/cuda_k1_variants.py): one rollout of hand vs hand
// under a sampler, a suit-mask form and a hand key, the variant V (an
// MC_K1_VARIANT_* value) a template parameter.
//
// The counterpart of scripts/bench_kernel_variants.py:30-134, which swaps
// pieces of the JAX K1 body (pallas_equity.py:_uniform_draws, _masks_of,
// eval_masks_cmp_impl) and times the whole kernel again. A variant
// composes three choices:
//   sampler  mod            draw t is word t mod D = NLIVE - t (K1's and
//                           _uniform_draws' rule);
//            ms16           word t times D, high word, as the JAX script
//                           computes it from 16-bit halves:
//                           (xh D + ((xl D) >> 16)) >> 16;
//            two_noreject   one word a pair of draws: x mod D then
//                           (x / (D + 1)) mod D, D + 1 the pair's first
//                           bound; an odd last draw x mod D;
//            fallback_word  word 0 a fallback fb, draw t from word t + 1:
//                           a word at or above floor(2^32 / D) D takes
//                           fb mod D instead (unsigned compare);
//   masks    table          the launch's deck table in shared memory (K1);
//            packed         the live index shifted past the dead cards,
//                           then suit (card 5) >> 6 and the bit in one of
//                           the two planes (pallas_equity.py:95-120, the
//                           script's masks_packed);
//   key      rank7          mc_rank7 (K1's);
//            ref            mc_eval_key, the packed reference key;
//            none           each side's suit-0 mask m0 (the script's stub);
//            one            the hero's mc_eval_cmp key (eval_masks_cmp_
//                           impl's values, which the script's _one_eval
//                           compares with a mask), the villain's m0.
// A variant reads only the words its sampler uses: mc_k1_n_words of them,
// from K1's Philox stream (seed, r mod 2^32, r >> 32, 0) in the JAX draw
// order, or injected. equity.cuh is not changed, so K1 keeps its build.
#pragma once

#include "equity.cuh"

#define MC_K1_VARIANT_CURRENT 0
#define MC_K1_VARIANT_MS16 1
#define MC_K1_VARIANT_MS16_PACKED 2
#define MC_K1_VARIANT_OLD_PACKED 3
#define MC_K1_VARIANT_MS16_NOEVAL 4
#define MC_K1_VARIANT_OLD_SAMPLER 5
#define MC_K1_VARIANT_TWO_NOREJECT 6
#define MC_K1_VARIANT_FALLBACK_WORD 7
#define MC_K1_VARIANT_REF_EVAL 8
#define MC_K1_VARIANT_OLD_SAMPLER_REF_EVAL 9
#define MC_K1_VARIANT_NO_EVAL 10
#define MC_K1_VARIANT_ONE_EVAL 11

#define MC_K1_MOD 0
#define MC_K1_MS16 1
#define MC_K1_TWO 2
#define MC_K1_FALLBACK 3

#define MC_K1_TABLE 0
#define MC_K1_PACKED 1

#define MC_K1_RANK7 0
#define MC_K1_REF 1
#define MC_K1_NONE 2
#define MC_K1_ONE 3

MC_HD constexpr int mc_k1_sampler(int v) {
  return v == MC_K1_VARIANT_MS16 || v == MC_K1_VARIANT_MS16_PACKED ||
                 v == MC_K1_VARIANT_MS16_NOEVAL
             ? MC_K1_MS16
         : v == MC_K1_VARIANT_TWO_NOREJECT  ? MC_K1_TWO
         : v == MC_K1_VARIANT_FALLBACK_WORD ? MC_K1_FALLBACK
                                            : MC_K1_MOD;
}

MC_HD constexpr int mc_k1_masks(int v) {
  return v == MC_K1_VARIANT_MS16_PACKED || v == MC_K1_VARIANT_OLD_PACKED
             ? MC_K1_PACKED
             : MC_K1_TABLE;
}

MC_HD constexpr int mc_k1_key(int v) {
  return v == MC_K1_VARIANT_REF_EVAL ||
                 v == MC_K1_VARIANT_OLD_SAMPLER_REF_EVAL
             ? MC_K1_REF
         : v == MC_K1_VARIANT_MS16_NOEVAL || v == MC_K1_VARIANT_NO_EVAL
             ? MC_K1_NONE
         : v == MC_K1_VARIANT_ONE_EVAL ? MC_K1_ONE
                                       : MC_K1_RANK7;
}

// Words a rollout of NDRAW draws reads under sampler S.
MC_HD constexpr int mc_k1_n_words(int s, int ndraw) {
  return s == MC_K1_TWO ? (ndraw + 1) / 2
         : s == MC_K1_FALLBACK ? ndraw + 1
                               : ndraw;
}

// A launch's parameters: the deck table (masks "table"), the ascending
// dead cards (masks "packed"), the two sides' planes.
struct MCK1Params {
  MCDeck deck;
  int dead[8];
  uint32_t hero[2], villain[2];
};

// Draw T (bound D = NLIVE - T) of the rollout's words w under sampler S,
// and the draws after it, each bound a compile-time constant.
template <int S, int NLIVE, int NDRAW, int K, int T>
MC_HD void mc_k1_draw(const uint32_t (&w)[K], uint32_t (&d)[NDRAW]) {
  if constexpr (T < NDRAW) {
    constexpr uint32_t D = NLIVE - T;
    if constexpr (S == MC_K1_MOD) {
      d[T] = w[T] % D;
    } else if constexpr (S == MC_K1_MS16) {
      const uint32_t x = w[T];
      d[T] = ((x >> 16) * D + (((x & 0xFFFFu) * D) >> 16)) >> 16;
    } else if constexpr (S == MC_K1_TWO) {
      const uint32_t x = w[T / 2];
      if constexpr (T % 2 == 0)
        d[T] = x % D;
      else
        d[T] = (x / (D + 1)) % D;
    } else {
      constexpr uint32_t thresh =
          (uint32_t)((0x100000000ull / D) * D);
      const uint32_t x = w[T + 1];
      d[T] = x < thresh ? x % D : w[0] % D;
    }
    mc_k1_draw<S, NLIVE, NDRAW, K, T + 1>(w, d);
  }
}

// Draw T's live index (bubble insertion among the earlier draws' indices,
// `chosen` ascending) and its card's bit into the planes lo, hi: from the
// deck table `live`, or (packed) by the shift past the 52 - NLIVE dead
// cards and the suit's arithmetic.
template <int M, int NLIVE, int NDRAW, int T>
MC_HD void mc_k1_place(const uint32_t (&d)[NDRAW], const uint64_t* live,
                       const int* dead, int (&chosen)[NDRAW], uint32_t& lo,
                       uint32_t& hi) {
  if constexpr (T < NDRAW) {
    int x = (int)d[T];
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
    if constexpr (M == MC_K1_TABLE) {
      const uint64_t b = live[x];
      lo |= (uint32_t)b;
      hi |= (uint32_t)(b >> 32);
    } else {
      int card = x;
#pragma unroll
      for (int j = 0; j < 52 - NLIVE; ++j) card += card >= dead[j];
      const int suit = (card * 5) >> 6;
      const uint32_t bit = 1u << ((card - 13 * suit + 2) | ((suit & 1) << 4));
      lo |= suit > 1 ? 0u : bit;
      hi |= suit > 1 ? bit : 0u;
    }
    mc_k1_place<M, NLIVE, NDRAW, T + 1>(d, live, dead, chosen, lo, hi);
  }
}

// One side's key under key form KEY (`first`: the hero's, which "one"
// evaluates) of the planes lo, hi.
template <int KEY>
MC_HD uint32_t mc_k1_side_key(uint32_t lo, uint32_t hi, bool first) {
  if constexpr (KEY == MC_K1_RANK7) {
    return mc_eval_planes(lo, hi);
  } else if constexpr (KEY == MC_K1_REF) {
    return (uint32_t)mc_eval_key(lo & 0xFFFFu, lo >> 16, hi & 0xFFFFu,
                                 hi >> 16);
  } else if constexpr (KEY == MC_K1_ONE) {
    return first ? (uint32_t)mc_eval_cmp(lo & 0xFFFFu, lo >> 16,
                                         hi & 0xFFFFu, hi >> 16)
                 : lo & 0xFFFFu;
  } else {
    return lo & 0xFFFFu;
  }
}

// Rollout r of variant V on a board missing NDRAW = 9 - n_dead cards:
// +1 hero wins, 0 tie, -1 loss. Words from Philox or, INJECT, word t at
// words[t * n + r].
template <int V, int NDRAW, bool INJECT>
MC_HD int mc_k1_variant_rollout(const MCK1Params& p, const uint64_t* live,
                                const int* words, long long n, long long r,
                                uint32_t seed) {
  constexpr int S = mc_k1_sampler(V), M = mc_k1_masks(V), KEY = mc_k1_key(V);
  constexpr int K = mc_k1_n_words(S, NDRAW);
  constexpr int NLIVE = 43 + NDRAW;
  uint32_t w[K];
  mc_rollout_words<K, INJECT>(w, words, n, r, seed, 0u);
  uint32_t lo = 0u, hi = 0u;
  if constexpr (S == MC_K1_MOD && M == MC_K1_TABLE) {
    uint32_t cut = 0u;  // K1's own draw code (equity.cuh)
    mc_draw_planes<NLIVE, NDRAW>(w, live, lo, hi, cut);
  } else {
    uint32_t d[NDRAW];
    mc_k1_draw<S, NLIVE, NDRAW, K, 0>(w, d);
    int chosen[NDRAW];
    mc_k1_place<M, NLIVE, NDRAW, 0>(d, live, p.dead, chosen, lo, hi);
  }
  const uint32_t vh = mc_k1_side_key<KEY>(lo | p.hero[0], hi | p.hero[1],
                                          true);
  const uint32_t vv =
      mc_k1_side_key<KEY>(lo | p.villain[0], hi | p.villain[1], false);
  return (vh > vv) - (vh < vv);
}

// The variants' grid: as K1's (mc_rollout_grid) with the block size and
// the waves given: ceil(n / threads) blocks, at most `waves` waves of
// `wave` resident blocks, and at least enough that no thread runs 2^32
// rollouts.
MC_HD long long mc_k1_grid(long long n, int threads, int waves,
                           long long wave) {
  if (n <= 0) return 1;
  long long b = (n - 1) / threads + 1;
  const long long cap = (long long)waves * wave;
  if (b > cap) b = cap;
  const long long need = ((n - 1) / 0xFFFFFFFFll) / threads + 1;
  return b < need ? need : b;
}
