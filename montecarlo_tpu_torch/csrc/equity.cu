// Equity rollout kernels (ops/cuda_equity.py).
//
// K1 `mc_equity_kernel` replaces montecarlo_tpu/ops/pallas_equity.py:125
// (_make_equity_kernel via equity_counts_pallas): hand vs hand rollouts on
// a board with 0, 3 or 4 known cards. K2 `mc_sweep_kernel` replaces
// pallas_equity.py:182 (_sweep_kernel via sweep_counts_pallas): per hero
// hand, rollouts against a random villain (7 cards drawn from 50). B3
// `mc_multiway_kernel` replaces pallas_equity.py:268 (_make_multiway_kernel
// via equity_multiway_pallas): N hands in one pot on a board with K known
// cards, each winner taking lcm(1..N) / (number of winners) shares.
//
// A rollout: draw the missing cards (one u32 word mod the live count per
// card, ordered draws made distinct by bubble insertion, then shifted past
// the ascending dead cards), build four suit masks, rank the 7-card hands
// with the comparison key, count win / tie (B3: add each winner's share).
// Everything stays in registers: the kernels are integer-ALU bound
// (Philox, sampling and two evaluations, B3 N, a few hundred integer ops
// per rollout) and touch memory only for the optional injected words and
// one atomic per block per counter. One thread runs rollouts in a
// grid-stride loop; 64-bit counters take any rollout count in one launch.
#include <cuda_runtime.h>

#include "equity.cuh"

#define MC_THREADS 256

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

// Rollout r reads injected word t at words[t * n + r].
template <int NDRAW>
__global__ void __launch_bounds__(MC_THREADS)
    mc_equity_kernel(uint32_t seed, MCEquityParams p, long long n,
                     const int* words, unsigned long long* out) {
  unsigned long long wins = 0, ties = 0;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    MCWords src(words, n, r, seed, (uint32_t)r, (uint32_t)(r >> 32), 0u);
    int res = mc_rollout_vs_hand<NDRAW>(src, p);
    wins += res > 0;
    ties += res == 0;
  }
  const unsigned long long counts[2] = {wins, ties};
  mc_block_add<2>(counts, 2, out, 1);
}

// Grid (chunks, hands): blockIdx.y is the hero hand h; rollout r of hand h
// reads injected word t at words[t * H * n + h * n + r].
__global__ void __launch_bounds__(MC_THREADS)
    mc_sweep_kernel(uint32_t seed, const int* dead, const int* hmask,
                    long long n, const int* words, unsigned long long* out) {
  int h = blockIdx.y, H = gridDim.y;
  int hd[2] = {dead[2 * h], dead[2 * h + 1]};
  uint32_t hm[4];
  for (int s = 0; s < 4; ++s) hm[s] = (uint32_t)hmask[4 * h + s];
  unsigned long long wins = 0, ties = 0;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    MCWords src(words, (long long)H * n, (long long)h * n + r, seed,
                (uint32_t)r, (uint32_t)(r >> 32), (uint32_t)h + 1u);
    int res = mc_rollout_vs_random(src, hd, hm);
    wins += res > 0;
    ties += res == 0;
  }
  const unsigned long long counts[2] = {wins, ties};
  mc_block_add<2>(counts, 2, out + h, H);
}

// Rollout r draws from Philox stream (seed, r mod 2^32, r >> 32,
// MC_SUB_MULTIWAY), or reads injected word t at words[t * n + r]. The
// shares stay in registers (64 bits, so any n fits one launch) until the
// block's reduction.
template <int NDRAW>
__global__ void __launch_bounds__(MC_THREADS)
    mc_multiway_kernel(uint32_t seed, MCMultiwayParams p, long long n,
                       const int* words, unsigned long long* out) {
  unsigned long long shares[MC_MAX_HANDS];
#pragma unroll
  for (int h = 0; h < MC_MAX_HANDS; ++h) shares[h] = 0;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    MCWords src(words, n, r, seed, (uint32_t)r, (uint32_t)(r >> 32),
                MC_SUB_MULTIWAY);
    mc_rollout_multiway<NDRAW>(src, p, shares);
  }
  mc_block_add<MC_MAX_HANDS>(shares, p.n_hands, out, 1);
}

static int mc_blocks(long long n, int cap) {
  long long b = (n + MC_THREADS - 1) / MC_THREADS;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

// params: n_dead ascending dead cards, then 4 hero and 4 villain masks.
// out: int64[2] (wins, ties), zeroed by the caller. Returns cudaError_t.
extern "C" int mc_equity_counts(int seed, const int* params, int n_dead,
                                long long n, const int* words,
                                unsigned long long* out, void* stream) {
  MCEquityParams p;
  p.n_dead = n_dead;
  for (int i = 0; i < 8; ++i) p.dead[i] = i < n_dead ? params[i] : 99;
  for (int s = 0; s < 4; ++s) {
    p.hero[s] = (uint32_t)params[n_dead + s];
    p.villain[s] = (uint32_t)params[n_dead + 4 + s];
  }
  int blocks = mc_blocks(n, 132 * 16);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_dead == 4)
    mc_equity_kernel<5><<<blocks, MC_THREADS, 0, s>>>(seed, p, n, words, out);
  else if (n_dead == 7)
    mc_equity_kernel<2><<<blocks, MC_THREADS, 0, s>>>(seed, p, n, words, out);
  else if (n_dead == 8)
    mc_equity_kernel<1><<<blocks, MC_THREADS, 0, s>>>(seed, p, n, words, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dead: int32[H, 2] ascending holes, hmask: int32[H, 4] (device).
// out: int64[2, H] (wins row, ties row), zeroed by the caller.
extern "C" int mc_sweep_counts(int seed, const int* dead, const int* hmask,
                               int H, long long n, const int* words,
                               unsigned long long* out, void* stream) {
  if (H < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  int cap = (132 * 16) / H;
  dim3 grid(mc_blocks(n, cap < 1 ? 1 : cap), H);
  mc_sweep_kernel<<<grid, MC_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t)seed, dead, hmask, n, words, out);
  return (int)cudaGetLastError();
}

// dead: the 2N + K ascending dead cards; hand_masks: int32[N, 4] suit masks
// with the K known board cards OR-ed in (both host memory). out: int64[N]
// shares, zeroed by the caller; a rollout's shares sum to lcm(1..N).
// Returns cudaError_t (cudaErrorInvalidValue unless 2 <= N <= 12 and
// 0 <= K <= 5).
extern "C" int mc_multiway_shares(int seed, const int* dead, int n_dead,
                                  const int* hand_masks, int n_hands,
                                  long long n, const int* words,
                                  unsigned long long* out, void* stream) {
  const int k = n_dead - 2 * n_hands;
  if (n_hands < 2 || n_hands > MC_MAX_HANDS || k < 0 || k > 5)
    return (int)cudaErrorInvalidValue;
  MCMultiwayParams p;
  p.n_dead = n_dead;
  p.n_hands = n_hands;
  for (int i = 0; i < 2 * MC_MAX_HANDS + 5; ++i)
    p.dead[i] = i < n_dead ? dead[i] : 99;
  for (int h = 0; h < MC_MAX_HANDS; ++h)
    for (int s = 0; s < 4; ++s)
      p.hand[h][s] = h < n_hands ? (uint32_t)hand_masks[4 * h + s] : 0u;
  p.scale = mc_lcm_to(n_hands);
  int blocks = mc_blocks(n, 132 * 16);
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t sd = (uint32_t)seed;
  switch (5 - k) {
#define MC_CASE(D)                                                        \
  case D:                                                                 \
    mc_multiway_kernel<D><<<blocks, MC_THREADS, 0, st>>>(sd, p, n, words, \
                                                         out);            \
    break;
    MC_CASE(0) MC_CASE(1) MC_CASE(2) MC_CASE(3) MC_CASE(4) MC_CASE(5)
#undef MC_CASE
  }
  return (int)cudaGetLastError();
}
