// K1's variants (ops/cuda_k1_variants.py, B-6): K1 with its sampler, its
// suit masks or its hand key swapped, one variant per build.
//
// Replaces scripts/bench_kernel_variants.py:137-175 (run_variant), which
// monkeypatches pallas_equity's _uniform_draws, _masks_of,
// eval_masks_cmp_impl and TILE and times equity_vs_hand_pallas, whose
// pallas_call is pallas_equity.py:164 (K1), again: the twelve variants of
// its VARIANTS table (probe_k1.cuh says what each composes) and its tile
// axis. Here nvcc compiles this file once per variant, with
// -DMC_K1_VARIANT=MC_K1_VARIANT_<variant> (ops/_build.py:build_probe),
// into a library of its own, so that a variant's kernel is built alone and
// its ptxas report is its own. The kernel is K1's (equity.cu,
// mc_equity_kernel) for a preflop board (NDRAW = 5): one thread a rollout
// in a grid-stride loop, the words in registers, the deck table in shared
// memory, 32-bit counters a thread and one atomic per block per counter.
// The TPU's tile becomes the launch's shape: THREADS a block, a
// compile-time constant for __launch_bounds__ (256, K1's, in every build;
// 128, 512 and 1024 too in a build with -DMC_K1_TILES=1, made for the
// variant timed across tiles; injected words at 256 only), and waves of
// resident blocks, a run-time count (K1: 256 and 16). A
// rollout's words depend on its index alone, so every shape gives the same
// counts. Bound: integer operations, as K1's (Philox blocks, the draws, the
// keys), less what a variant leaves out.
#include <cuda_runtime.h>

#include "probe_k1.cuh"

#ifndef MC_K1_VARIANT
#error "build with -DMC_K1_VARIANT=MC_K1_VARIANT_<variant> (ops/_build.py)"
#endif
#ifndef MC_K1_TILES
#define MC_K1_TILES 0
#endif

// Sum the block's two counters, one atomic each: warp shuffles, one
// partial per warp in shared memory, then threads 0 and 1 add them up.
template <int THREADS>
__device__ void mc_k1_block_add(uint32_t wins, uint32_t ties,
                                unsigned long long* out) {
  __shared__ unsigned long long part[THREADS / 32][2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned long long v[2] = {wins, ties};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    unsigned long long a = v[i];
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) part[warp][i] = a;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned long long t = 0;
    for (int w = 0; w < THREADS / 32; ++w) t += part[w][threadIdx.x];
    atomicAdd(&out[threadIdx.x], t);
  }
}

// Rollout r draws from Philox stream (seed, r mod 2^32, r >> 32, 0), or
// (INJECT) reads injected word t at words[t * n + r].
template <int NDRAW, bool INJECT, int THREADS>
__global__ void __launch_bounds__(THREADS)
    mc_k1_variant_kernel(uint32_t seed, MCK1Params p, long long n,
                         const int* words, unsigned long long* out) {
  __shared__ uint64_t live[52];
  if constexpr (mc_k1_masks(MC_K1_VARIANT) == MC_K1_TABLE)
    mc_share_live(p.deck, live);
  uint32_t wins = 0u, ties = 0u;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    const int res = mc_k1_variant_rollout<MC_K1_VARIANT, NDRAW, INJECT>(
        p, live, words, n, r, seed);
    wins += res > 0;
    ties += res == 0;
  }
  mc_k1_block_add<THREADS>(wins, ties, out);
}

// The kernel of a launch shape: Philox at 256 threads a block (at 128,
// 512 and 1024 too when MC_K1_TILES), injected words at 256.
template <bool INJECT, int THREADS>
static int mc_k1_launch(uint32_t seed, const MCK1Params& p, long long n,
                        const int* words, int waves, int* grid,
                        unsigned long long* out, cudaStream_t s) {
  auto kernel = mc_k1_variant_kernel<5, INJECT, THREADS>;
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  per_sm = mc_max(per_sm, 1);
  const long long b = mc_k1_grid(n, THREADS, waves, (long long)sms * per_sm);
  if (b > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  grid[0] = (int)b;
  grid[1] = per_sm;
  if (out) kernel<<<(int)b, THREADS, 0, s>>>(seed, p, n, words, out);
  return (int)cudaGetLastError();
}

static int mc_k1_dispatch(uint32_t seed, const MCK1Params& p, long long n,
                          const int* words, int threads, int waves,
                          int* grid, unsigned long long* out,
                          cudaStream_t s) {
  if (waves < 1) return (int)cudaErrorInvalidValue;
  if (words) {
    if (threads != 256) return (int)cudaErrorInvalidValue;
    return mc_k1_launch<true, 256>(seed, p, n, words, waves, grid, out, s);
  }
  switch (threads) {
    case 256:
      return mc_k1_launch<false, 256>(seed, p, n, words, waves, grid, out, s);
#if MC_K1_TILES
    case 128:
      return mc_k1_launch<false, 128>(seed, p, n, words, waves, grid, out, s);
    case 512:
      return mc_k1_launch<false, 512>(seed, p, n, words, waves, grid, out, s);
    case 1024:
      return mc_k1_launch<false, 1024>(seed, p, n, words, waves, grid, out,
                                       s);
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// params: the 4 ascending dead cards (preflop), then 4 hero and 4 villain
// masks. out: int64[2] (wins, ties), zeroed by the caller; grid: int[2],
// the launch's blocks and the kernel's blocks an SM. Returns cudaError_t
// (cudaErrorInvalidValue for another dead count, a block size the build
// has not, or injected words at another than 256).
extern "C" int mc_probe_k1(int seed, const int* params, int n_dead,
                           long long n, const int* words, int threads,
                           int waves, int* grid, unsigned long long* out,
                           void* stream) {
  if (n_dead != 4) return (int)cudaErrorInvalidValue;
  MCK1Params p;
  mc_make_deck(params, n_dead, &p.deck);
  for (int i = 0; i < 8; ++i) p.dead[i] = i < n_dead ? params[i] : 52;
  mc_masks_to_planes(params + n_dead, p.hero);
  mc_masks_to_planes(params + n_dead + 4, p.villain);
  return mc_k1_dispatch((uint32_t)seed, p, n, words, threads, waves, grid,
                        out, (cudaStream_t)stream);
}

// The launch mc_probe_k1 makes for n rollouts at a shape, without
// launching: grid[0] its blocks, grid[1] the kernel's blocks an SM.
extern "C" int mc_probe_k1_grid(long long n, int threads, int waves,
                                int inject, int* grid) {
  MCK1Params p = {};
  return mc_k1_dispatch(0u, p, n, inject ? (const int*)&p : nullptr,
                        threads, waves, grid, nullptr, 0);
}

// The variant this library was built for (an MC_K1_VARIANT_* value).
extern "C" int mc_probe_k1_id(void) { return MC_K1_VARIANT; }
