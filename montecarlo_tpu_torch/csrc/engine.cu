// Whole-step betting-engine kernels (ops/cuda_engine.py).
//
// K3 `mc_engine_det_kernel` replaces montecarlo_tpu/ops/pallas_engine.py:
// 716 `_make_kernel(mode="det")` via run_perpetual_det: one fused
// step_table per step on injected raw actions, deals read from a per-hand
// stash. K4 `mc_engine_prng_kernel` replaces `_make_kernel(mode="prng")`
// via run_perpetual_prng: the random policy, `defer` betting slots per
// settle pass and an in-kernel deal, on Philox words or injected words.
// Both are instantiated per rule set (reference, standard, tournament) for
// the one seat count MC_SEATS of the library being built, as the TPU
// kernels are compiled per static configuration.
//
// Layout: the packed state [n_blocks, F, 8, 128] int32 of the JAX engine,
// 1024 tables per block. One thread runs one table: it reads the table's F
// rows once, runs every step of the launch on its private copy (registers
// and local memory, which the L1 caches), and writes the rows once.
// Neighbouring threads hold neighbouring tables, so each row load and
// store coalesces across the warp. The kernels are bound by integer and
// local-memory work per step (the state is read and written once per
// launch); this first form keeps the whole table in one struct and leaves
// register allocation to the compiler.
#include <cuda_runtime.h>

#include "engine.cuh"

#define MC_ENGINE_THREADS 128

// actions: [n_blocks, n_steps, 8, 128]; cards: [n_blocks, hmax, 2P+5, 8,
// 128]. Hand h > 0 of a table is dealt from stash row min(h, hmax - 1).
template <int P, int R>
__global__ void __launch_bounds__(MC_ENGINE_THREADS)
    mc_engine_det_kernel(int* state, const int* actions, const int* cards,
                         int n_tables, int n_steps, int hmax, int sb,
                         int bb) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tables) return;
  const long long blk = t / MC_TABLES_PER_BLOCK;
  const int lane = t % MC_TABLES_PER_BLOCK;
  MCTable<P, R> s;
  mc_load(s, state, t);
  mc_run_det(s, actions + blk * n_steps * MC_TABLES_PER_BLOCK + lane,
             cards + blk * hmax * (2 * P + 5) * MC_TABLES_PER_BLOCK + lane,
             MC_TABLES_PER_BLOCK, n_steps, hmax, sb, bb);
  mc_store(s, state, t);
}

// Injected words: int32 [n_steps / defer, 2 * defer + 2P + 5, n_tables];
// else Philox keyed by (seed, table).
template <int P, int R>
__global__ void __launch_bounds__(MC_ENGINE_THREADS)
    mc_engine_prng_kernel(int* state, uint32_t seed, const int* words,
                          int n_tables, int n_steps, int defer, int sb,
                          int bb, uint32_t fold_bits, uint32_t raise_bits) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tables) return;
  MCTable<P, R> s;
  mc_load(s, state, t);
  MCWords src(words, n_tables, t, seed, (uint32_t)t, 0u, 0u);
  mc_run_prng(s, src, n_steps, defer, sb, bb, fold_bits, raise_bits);
  mc_store(s, state, t);
}

// In-place on `state`. rules: 0 reference, 1 standard, 2 tournament.
// Returns cudaError_t (cudaErrorInvalidValue for a seat count other than
// the library's MC_SEATS or another rule set).
extern "C" int mc_engine_det(int* state, const int* actions,
                             const int* cards, int n_blocks, int P,
                             int rules, int n_steps, int hmax, int sb, int bb,
                             void* stream) {
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  int grid = (n_tables + MC_ENGINE_THREADS - 1) / MC_ENGINE_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N:                                                       \
    mc_engine_det_kernel<N, R><<<grid, MC_ENGINE_THREADS, 0, st>>>(       \
        state, actions, cards, n_tables, n_steps, hmax, sb, bb);          \
    break;
  MC_ENGINE_DISPATCH(MC_CASE)
#undef MC_CASE
  return (int)cudaGetLastError();
}

extern "C" int mc_engine_prng(int* state, int seed, const int* words,
                              int n_blocks, int P, int rules, int n_steps,
                              int defer, int sb, int bb, int fold_bits,
                              int raise_bits, void* stream) {
  if (defer < 1 || n_steps % defer != 0) return (int)cudaErrorInvalidValue;
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  int grid = (n_tables + MC_ENGINE_THREADS - 1) / MC_ENGINE_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N:                                                       \
    mc_engine_prng_kernel<N, R><<<grid, MC_ENGINE_THREADS, 0, st>>>(      \
        state, (uint32_t)seed, words, n_tables, n_steps, defer, sb, bb,   \
        (uint32_t)fold_bits, (uint32_t)raise_bits);                       \
    break;
  MC_ENGINE_DISPATCH(MC_CASE)
#undef MC_CASE
  return (int)cudaGetLastError();
}
