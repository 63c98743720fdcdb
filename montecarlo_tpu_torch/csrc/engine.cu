// Whole-step betting-engine kernels (ops/cuda_engine.py).
//
// K3 `mc_engine_det_kernel` replaces montecarlo_tpu/ops/pallas_engine.py:
// 716 `_make_kernel(mode="det")` via run_perpetual_det: one fused
// step_table per step on injected raw actions, deals read from a per-hand
// stash. K4 `mc_engine_prng_kernel` replaces `_make_kernel(mode="prng")`
// via run_perpetual_prng: the random policy, `defer` betting slots per
// settle pass and an in-kernel deal, on Philox words or (a second
// instantiation, INJECT) injected words. Both are instantiated per rule set
// (reference, standard, tournament) for the one seat count MC_SEATS of the
// library being built, as the TPU kernels are compiled per static
// configuration.
//
// Layout: the packed state [n_blocks, F, 8, 128] int32 of the JAX engine,
// 1024 tables per block. One thread runs one table: it reads the table's F
// rows once, runs every step of the launch (K3: on the table's own step
// cursor, with the settle passes of a warp's tables run together), and
// writes the rows once;
// neighbouring threads hold neighbouring tables, so each row load and store
// coalesces across the warp. Where the table lives meanwhile (engine.cuh,
// MCTable): the hot fields of the betting step (34 words at P = 6 under
// reference rules, 43 under the others) in registers, every seat or layer
// index a select; the cold rows (109 / 117 / 123 words: cards, meters, pot
// rows) in a column of the block's dynamic shared memory, row r of thread
// i at smem[r * MC_ENGINE_THREADS + i]. The kernels are bound by the
// integer work of the step and the settle pass, not by memory: the state
// crosses HBM once each way per launch. A table that is frozen (empty play
// order, no settle pending: a won tournament) is a fixed point, so it is
// neither loaded nor stored, and one that freezes during the launch leaves
// its loop; a warp whose tables have all left retires.
//
// Occupancy (engine.cuh, mc_engine_blocks_per_sm): the shared rows bound
// the blocks an SM holds, and __launch_bounds__ caps the registers so that
// the register file holds as many.
#include <cuda_runtime.h>

#include "engine.cuh"

// actions: [n_blocks, n_steps, 8, 128]; cards: [n_blocks, hmax, 2P+5, 8,
// 128]. Hand h > 0 of a table is dealt from stash row min(h, hmax - 1).
// Each table steps on its own cursor and the warp settles its waiting
// tables together (mc_run_det), so no lane returns early: the warp's
// ballots need all 32. A lane past the tables, or whose table is frozen
// (a fixed point, neither loaded nor stored), holds a frozen table.
template <int P, int R>
__global__ void __launch_bounds__(MC_ENGINE_THREADS,
                                  mc_engine_blocks_per_sm<P, R>())
    mc_engine_det_kernel(int* state, const int* actions, const int* cards,
                         int n_tables, int n_steps, int hmax, int sb,
                         int bb) {
  extern __shared__ int mc_cold[];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int* rows = mc_table_rows<P, R>(state, t);
  const bool live =
      t < n_tables && !mc_frozen_rows<P, R>(rows, MC_TABLES_PER_BLOCK);
  const long long blk = t / MC_TABLES_PER_BLOCK;
  const int lane = t % MC_TABLES_PER_BLOCK;
  MCTable<P, R, MCEngineRows> s;
  s.rows.col = mc_cold + threadIdx.x;
  if (live)
    mc_load(s, rows, MC_TABLES_PER_BLOCK);
  else
    s.order = s.wait = 0;
  mc_run_det(s, actions + blk * n_steps * MC_TABLES_PER_BLOCK + lane,
             cards + blk * hmax * (2 * P + 5) * MC_TABLES_PER_BLOCK + lane,
             MC_TABLES_PER_BLOCK, n_steps, hmax, sb, bb);
  if (live) mc_store(s, rows, MC_TABLES_PER_BLOCK);
}

// INJECT: words int32 [n_steps / defer, 2 * defer + 2P + 5, n_tables];
// else Philox keyed by (seed, table).
template <int P, int R, bool INJECT>
__global__ void __launch_bounds__(MC_ENGINE_THREADS,
                                  mc_engine_blocks_per_sm<P, R>())
    mc_engine_prng_kernel(int* state, uint32_t seed, const int* words,
                          int n_tables, int n_steps, int defer, int sb,
                          int bb, uint32_t fold_bits, uint32_t raise_bits) {
  extern __shared__ int mc_cold[];
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tables) return;
  int* rows = mc_table_rows<P, R>(state, t);
  if (mc_frozen_rows<P, R>(rows, MC_TABLES_PER_BLOCK)) return;
  MCTable<P, R, MCEngineRows> s;
  s.rows.col = mc_cold + threadIdx.x;
  mc_load(s, rows, MC_TABLES_PER_BLOCK);
  if constexpr (INJECT) {
    MCInjectedWords src(words + t, n_tables);
    mc_run_prng(s, src, n_steps, defer, sb, bb, fold_bits, raise_bits);
  } else {
    MCPhiloxWords src(seed, (uint32_t)t, 0u, 0u);
    mc_run_prng(s, src, n_steps, defer, sb, bb, fold_bits, raise_bits);
  }
  mc_store(s, rows, MC_TABLES_PER_BLOCK);
}

template <int P, int R>
static int mc_launch_det(int* state, const int* actions, const int* cards,
                         int n_tables, int n_steps, int hmax, int sb, int bb,
                         cudaStream_t st) {
  constexpr int smem = mc_engine_smem<P, R>();
  cudaError_t err = mc_engine_attributes(mc_engine_det_kernel<P, R>, smem);
  if (err != cudaSuccess) return (int)err;
  mc_engine_det_kernel<P, R><<<n_tables / MC_ENGINE_THREADS,
                               MC_ENGINE_THREADS, smem, st>>>(
      state, actions, cards, n_tables, n_steps, hmax, sb, bb);
  return (int)cudaGetLastError();
}

template <int P, int R, bool INJECT>
static int mc_launch_prng(int* state, uint32_t seed, const int* words,
                          int n_tables, int n_steps, int defer, int sb,
                          int bb, uint32_t fold_bits, uint32_t raise_bits,
                          cudaStream_t st) {
  constexpr int smem = mc_engine_smem<P, R>();
  cudaError_t err =
      mc_engine_attributes(mc_engine_prng_kernel<P, R, INJECT>, smem);
  if (err != cudaSuccess) return (int)err;
  mc_engine_prng_kernel<P, R, INJECT><<<n_tables / MC_ENGINE_THREADS,
                                        MC_ENGINE_THREADS, smem, st>>>(
      state, seed, words, n_tables, n_steps, defer, sb, bb, fold_bits,
      raise_bits);
  return (int)cudaGetLastError();
}

// In-place on `state`. rules: 0 reference, 1 standard, 2 tournament.
// Returns cudaError_t (cudaErrorInvalidValue for a seat count other than
// the library's MC_SEATS or another rule set).
extern "C" int mc_engine_det(int* state, const int* actions,
                             const int* cards, int n_blocks, int P,
                             int rules, int n_steps, int hmax, int sb, int bb,
                             void* stream) {
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N:                                                       \
    return mc_launch_det<N, R>(state, actions, cards, n_tables, n_steps,  \
                               hmax, sb, bb, st);
  MC_ENGINE_DISPATCH(MC_CASE)
#undef MC_CASE
}

extern "C" int mc_engine_prng(int* state, int seed, const int* words,
                              int n_blocks, int P, int rules, int n_steps,
                              int defer, int sb, int bb, int fold_bits,
                              int raise_bits, void* stream) {
  if (defer < 1 || n_steps % defer != 0) return (int)cudaErrorInvalidValue;
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N:                                                       \
    return words ? mc_launch_prng<N, R, true>(                            \
                       state, (uint32_t)seed, words, n_tables, n_steps,   \
                       defer, sb, bb, (uint32_t)fold_bits,                \
                       (uint32_t)raise_bits, st)                          \
                 : mc_launch_prng<N, R, false>(                           \
                       state, (uint32_t)seed, words, n_tables, n_steps,   \
                       defer, sb, bb, (uint32_t)fold_bits,                \
                       (uint32_t)raise_bits, st);
  MC_ENGINE_DISPATCH(MC_CASE)
#undef MC_CASE
}
