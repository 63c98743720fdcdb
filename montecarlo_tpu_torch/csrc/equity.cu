// Equity rollout kernels (ops/cuda_equity.py): K1 and K2 here, B3 in
// multiway.cu.
//
// K1 `mc_equity_kernel` replaces montecarlo_tpu/ops/pallas_equity.py:125
// (_make_equity_kernel via equity_counts_pallas): hand vs hand rollouts on
// a board with 0, 3 or 4 known cards. K2 `mc_sweep_kernel` replaces
// pallas_equity.py:182 (_sweep_kernel via sweep_counts_pallas): per hero
// hand, rollouts against a random villain (7 cards drawn from 50).
//
// A rollout: draw the missing cards (one u32 word mod the live count per
// card, ordered draws made distinct by bubble insertion, then shifted past
// the ascending dead cards), build the suit masks, rank the 7-card hands
// with the comparison key, count win / tie. The kernels are integer-ALU
// bound (Philox, the draws and two evaluations, a few hundred integer ops
// per rollout) and touch memory only for the optional injected words and
// one atomic per block per counter. One thread runs rollouts in a
// grid-stride loop.
//
// Both take the form of equity.cuh: the words in registers, the draws
// modulo compile-time constants, the dead shift and the suit planes from
// the block's deck table in shared memory, and no stack frame; the first
// form (a run-time divisor, a word buffer and suit masks indexed at run
// time, both in local memory) spent most of its time on the words and the
// masks (PERF.md). Their counters are 32-bit per thread (mc_rollout_blocks
// keeps a thread's rollouts below 2^32) and their grid MC_EQUITY_WAVES
// waves of resident blocks, over all hands for K2.
#include "equity.cuh"

// Rollout r draws from Philox stream (seed, r mod 2^32, r >> 32, 0), or
// (INJECT) reads injected word t at words[t * n + r].
template <int NDRAW, bool INJECT>
__global__ void __launch_bounds__(MC_THREADS)
    mc_equity_kernel(uint32_t seed, MCEquityParams p, long long n,
                     const int* words, unsigned long long* out) {
  __shared__ uint64_t live[52];
  mc_share_live(p.deck, live);
  uint32_t wins = 0u, ties = 0u;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const int res =
        mc_rollout_vs_hand<NDRAW, INJECT>(p, live, words, n, r, seed);
#if MC_EQUITY_CUT < 4
    wins += (uint32_t)res;
#else
    wins += res > 0;
    ties += res == 0;
#endif
  }
  const unsigned long long counts[2] = {wins, ties};
  mc_block_add<2>(counts, 2, out, 1);
}

// Grid (chunks, hands): blockIdx.y is the hero hand h, whose deck the
// block builds in shared memory. Rollout r of hand h draws from Philox
// stream (seed, r mod 2^32, r >> 32, h + 1), or (INJECT) reads injected
// word t at words[t * H * n + h * n + r].
template <bool INJECT>
__global__ void __launch_bounds__(MC_THREADS)
    mc_sweep_kernel(uint32_t seed, const int* dead, const int* hmask,
                    long long n, const int* words, unsigned long long* out) {
  __shared__ uint64_t live[50];
  const int h = blockIdx.y;
  mc_share_hero_live(dead[2 * h], dead[2 * h + 1], live);
  uint32_t hero[2];
  mc_masks_to_planes(hmask + 4 * h, hero);
  const int* row = INJECT ? words + (long long)h * n : nullptr;
  const long long stride = (long long)gridDim.y * n;
  uint32_t wins = 0u, ties = 0u;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const int res = mc_rollout_sweep<INJECT>(hero, live, row, stride, r,
                                             seed, (uint32_t)h + 1u);
#if MC_EQUITY_CUT < 4
    wins += (uint32_t)res;
#else
    wins += res > 0;
    ties += res == 0;
#endif
  }
  const unsigned long long counts[2] = {wins, ties};
  mc_block_add<2>(counts, 2, out + h, gridDim.y);
}

template <int NDRAW>
static int mc_launch_equity(uint32_t seed, const MCEquityParams& p,
                            long long n, const int* words,
                            unsigned long long* out, cudaStream_t s) {
  auto kernel = words ? mc_equity_kernel<NDRAW, true>
                      : mc_equity_kernel<NDRAW, false>;
  const int blocks = mc_rollout_blocks(kernel, n, 1u);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, MC_THREADS, 0, s>>>(seed, p, n, words, out);
  return (int)cudaGetLastError();
}

// params: n_dead ascending dead cards, then 4 hero and 4 villain masks.
// out: int64[2] (wins, ties), zeroed by the caller. Returns cudaError_t.
extern "C" int mc_equity_counts(int seed, const int* params, int n_dead,
                                long long n, const int* words,
                                unsigned long long* out, void* stream) {
  MCEquityParams p;
  mc_make_deck(params, n_dead, &p.deck);
  mc_masks_to_planes(params + n_dead, p.hero);
  mc_masks_to_planes(params + n_dead + 4, p.villain);
  const uint32_t sd = (uint32_t)seed;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_dead) {
    case 4: return mc_launch_equity<5>(sd, p, n, words, out, s);
    case 7: return mc_launch_equity<2>(sd, p, n, words, out, s);
    case 8: return mc_launch_equity<1>(sd, p, n, words, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2's grid for H hands of n rollouts: out[0] its blocks a hand (the
// grid's x; mc_rollout_blocks over H rows), out[1] the blocks an SM holds
// of the instantiation (injected words or Philox). Returns cudaError_t
// (cudaErrorInvalidValue unless 1 <= H <= 65535, the grid's y, and the
// blocks a hand fit the grid's x).
extern "C" int mc_sweep_grid(int H, long long n, int inject, int* out) {
  if (H < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = inject ? mc_sweep_kernel<true> : mc_sweep_kernel<false>;
  out[0] = mc_rollout_blocks(kernel, n, 1u, H);
  out[1] = mc_blocks_per_sm(kernel);
  return out[0] == 0 ? (int)cudaErrorInvalidValue : (int)cudaSuccess;
}

// dead: int32[H, 2] each hero's distinct holes, ascending; hmask: int32[H,
// 4] their suit masks (device). out: int64[2, H] (wins row, ties row),
// zeroed by the caller. Returns cudaError_t.
extern "C" int mc_sweep_counts(int seed, const int* dead, const int* hmask,
                               int H, long long n, const int* words,
                               unsigned long long* out, void* stream) {
  int grid[2];
  const int err = mc_sweep_grid(H, n, words != nullptr, grid);
  if (err) return err;
  auto kernel = words ? mc_sweep_kernel<true> : mc_sweep_kernel<false>;
  kernel<<<dim3(grid[0], H), MC_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t)seed, dead, hmask, n, words, out);
  return (int)cudaGetLastError();
}
