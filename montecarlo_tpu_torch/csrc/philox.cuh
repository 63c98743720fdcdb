// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC'11), written out for the port's kernels.
//
// A stream is keyed by (seed, stream id); word i of a stream is output
// i % 4 of the block at counter (i / 4, stream_hi, c2, 0). Counter-based,
// so a word's value depends only on (seed, stream, index), never on the
// launch geometry. Bounded draws take one word modulo the bound, the draw
// rule of the TPU kernels (bias bound / 2^32, about 1e-8 at bound 52).
#pragma once

#include "common.cuh"

MC_HD void mc_mulhilo(uint32_t a, uint32_t b, uint32_t* hi, uint32_t* lo) {
  uint64_t p = (uint64_t)a * (uint64_t)b;
  *hi = (uint32_t)(p >> 32);
  *lo = (uint32_t)p;
}

// The Philox4x32-10 block function, in place on the counter x[4].
MC_HD void mc_philox4x32_10(uint32_t* x, uint32_t key0, uint32_t key1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0, lo0, hi1, lo1;
    mc_mulhilo(0xD2511F53u, x[0], &hi0, &lo0);
    mc_mulhilo(0xCD9E8D57u, x[2], &hi1, &lo1);
    uint32_t y0 = hi1 ^ x[1] ^ key0;
    uint32_t y2 = hi0 ^ x[3] ^ key1;
    x[0] = y0; x[1] = lo1; x[2] = y2; x[3] = lo0;
    key0 += 0x9E3779B9u;
    key1 += 0xBB67AE85u;
  }
}

struct MCPhilox {
  uint32_t k0, k1;    // key: seed, low word of the stream id
  uint32_t c1, c2;    // fixed counter words: high stream word, sub-stream
  uint32_t block;     // next counter block
  uint32_t buf[4];
  int used;           // words of buf already returned

  MC_HD MCPhilox(uint32_t seed, uint32_t stream_lo, uint32_t stream_hi,
                 uint32_t sub)
      : k0(seed), k1(stream_lo), c1(stream_hi), c2(sub), block(0), used(4) {}

  MC_HD void refill() {
    buf[0] = block; buf[1] = c1; buf[2] = c2; buf[3] = 0;
    mc_philox4x32_10(buf, k0, k1);
    ++block;
    used = 0;
  }

  MC_HD uint32_t next() {
    if (used == 4) refill();
    return buf[used++];
  }
};

// Source of u32 words for a random kernel: injected words when `words` is
// non-null (word i at words[i * stride + offset]), else Philox.
struct MCWords {
  const int* words;
  long long stride, offset, i;
  MCPhilox rng;

  MC_HD MCWords(const int* w, long long stride_, long long offset_,
                uint32_t seed, uint32_t stream_lo, uint32_t stream_hi,
                uint32_t sub)
      : words(w), stride(stride_), offset(offset_), i(0),
        rng(seed, stream_lo, stream_hi, sub) {}

  MC_HD uint32_t next() {
    if (words) return (uint32_t)words[(i++) * stride + offset];
    return rng.next();
  }
};

// The engine kernels' word sources (engine.cuh): word i of a table's stream
// by `at(i)`, or the next word by `next()` from a position set by `seek`.
// The injected form is a template parameter of the kernels, not a branch
// on every word as in MCWords.
//
// Philox, register-resident: the last block drawn is kept as four scalars
// and a word is picked from them by selects, so that no array is indexed
// at run time and the source never touches local memory. A draw from the
// cached block costs three selects; a new block, one Philox4x32-10.
struct MCPhiloxWords {
  uint32_t k0, k1, c1, c2;  // key: seed, low stream word; counter words
  uint32_t blk;             // the block held in w0..w3
  uint32_t w0, w1, w2, w3;
  uint32_t pos;             // next word of next()

  MC_HD MCPhiloxWords(uint32_t seed, uint32_t stream_lo, uint32_t stream_hi,
                      uint32_t sub)
      : k0(seed), k1(stream_lo), c1(stream_hi), c2(sub), blk(0xFFFFFFFFu),
        w0(0u), w1(0u), w2(0u), w3(0u), pos(0u) {}

  MC_HD uint32_t at(uint32_t i) {
    const uint32_t b = i >> 2;
    if (b != blk) {
      uint32_t x[4] = {b, c1, c2, 0u};
      mc_philox4x32_10(x, k0, k1);
      w0 = x[0]; w1 = x[1]; w2 = x[2]; w3 = x[3];
      blk = b;
    }
    const uint32_t j = i & 3u;
    return j == 0u ? w0 : j == 1u ? w1 : j == 2u ? w2 : w3;
  }
  MC_HD void seek(uint32_t i) { pos = i; }
  MC_HD uint32_t next() { return at(pos++); }
};

// Injected words: word i at words[i * stride] (`words` already offset to
// the table).
struct MCInjectedWords {
  const int* words;
  long long stride;
  uint32_t pos;

  MC_HD MCInjectedWords(const int* w, long long stride_)
      : words(w), stride(stride_), pos(0u) {}
  MC_HD uint32_t at(uint32_t i) const {
    return (uint32_t)words[(long long)i * stride];
  }
  MC_HD void seek(uint32_t i) { pos = i; }
  MC_HD uint32_t next() { return at(pos++); }
};

// The equity kernels' word source (K1, K2, B3): words 0..K-1 of rollout r
// straight into registers, every index a compile-time constant once
// unrolled. From Philox (key (seed, r mod 2^32), counter (b, r >> 32, sub,
// 0)), the ceil(K / 4) blocks computed in order; or, INJECT, word t from
// words[t * stride + r] (`words` already offset to the rollouts' row: K1
// and B3 pass stride n, K2 hand h's row h * n and stride H * n). The
// source is a template flag, not a branch on a word.
template <int K, bool INJECT>
MC_HD void mc_rollout_words(uint32_t (&w)[K], const int* words,
                            long long stride, long long r, uint32_t seed,
                            uint32_t sub) {
  if constexpr (INJECT) {
#pragma unroll
    for (int t = 0; t < K; ++t) w[t] = (uint32_t)words[t * stride + r];
  } else {
#pragma unroll
    for (int b = 0; b < (K + 3) / 4; ++b) {
      uint32_t x[4] = {(uint32_t)b, (uint32_t)(r >> 32), sub, 0u};
      mc_philox4x32_10(x, seed, (uint32_t)r);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * b + j < K) w[4 * b + j] = x[j];
    }
  }
}

// Draw K distinct live cards (pallas_equity.py:65-93): draw t is one word
// mod (live - t), made distinct by bubble insertion into the ascending
// list of earlier draws, then shifted past the n_dead ascending dead cards.
// Src: any word source with next() (MCWords, MCPhiloxWords,
// MCInjectedWords).
template <int K, class Src>
MC_HD void mc_sample_cards(Src& src, const int* dead, int n_dead,
                           int* cards) {
  int n_live = 52 - n_dead;
  int sorted_chosen[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    int x = (int)(src.next() % (uint32_t)(n_live - t));
#pragma unroll
    for (int j = 0; j < t; ++j) x += x >= sorted_chosen[j];
    int carry = x;
#pragma unroll
    for (int j = 0; j < t; ++j) {
      int c = sorted_chosen[j];
      sorted_chosen[j] = mc_min(carry, c);
      carry = mc_max(carry, c);
    }
    sorted_chosen[t] = carry;
    int card = x;
    for (int d = 0; d < n_dead; ++d) card += card >= dead[d];
    cards[t] = card;
  }
}
