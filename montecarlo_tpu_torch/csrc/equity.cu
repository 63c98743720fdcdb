// Equity rollout kernels (ops/cuda_equity.py).
//
// K1 `mc_equity_kernel` replaces montecarlo_tpu/ops/pallas_equity.py:125
// (_make_equity_kernel via equity_counts_pallas): hand vs hand rollouts on
// a board with 0, 3 or 4 known cards. K2 `mc_sweep_kernel` replaces
// pallas_equity.py:182 (_sweep_kernel via sweep_counts_pallas): per hero
// hand, rollouts against a random villain (7 cards drawn from 50).
//
// A rollout: draw the missing cards (one u32 word mod the live count per
// card, ordered draws made distinct by bubble insertion, then shifted past
// the ascending dead cards), build four suit masks, rank both 7-card hands
// with the comparison key, count win / tie. Everything stays in registers:
// the kernels are integer-ALU bound (Philox, sampling and two evaluations,
// a few hundred integer ops per rollout) and touch memory only for the
// optional injected words and one atomic per block per counter. One
// thread runs rollouts in a grid-stride loop; 64-bit counters take any
// rollout count in one launch.
#include <cuda_runtime.h>

#include "equity.cuh"

#define MC_THREADS 256

// Sum two per-thread counters over the block, one atomic each.
__device__ void mc_block_add(unsigned long long a, unsigned long long b,
                             unsigned long long* out_a,
                             unsigned long long* out_b) {
  __shared__ unsigned long long sa[MC_THREADS / 32], sb[MC_THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long ta = 0, tb = 0;
    for (int i = 0; i < MC_THREADS / 32; ++i) {
      ta += sa[i];
      tb += sb[i];
    }
    atomicAdd(out_a, ta);
    atomicAdd(out_b, tb);
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
  mc_block_add(wins, ties, &out[0], &out[1]);
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
  mc_block_add(wins, ties, &out[h], &out[H + h]);
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
