// The stage probe (ops/cuda_stages.py): one stage of the whole-step engine
// body per build.
//
// Replaces scripts/debug_kernel_compile.py:27 `compile_variant` (its
// pallas_call at :36), which compiles the JAX engine kernel's step body in
// stages to find what its compile time and its cost come from. Here nvcc
// compiles this file once per stage, with -DMC_SEATS=P and
// -DMC_STAGE=MC_STAGE_<name> (ops/_build.py:build_probe), into a library
// of its own, so each build's seconds and ptxas report (registers, stack
// frame, spills) belong to that stage alone; the report's kernel is the
// Philox instantiation, the one the measurement runs (the injected one
// serves the tests). The kernel is K4's shape: one thread per table of the
// packed state [n_blocks, F, 8, 128] (reference rules, as the script's),
// the table's F rows read once into K4's form (hot fields in registers,
// cold rows in the block's shared memory), n_steps applications of the
// stage, the rows written once. Bound: the
// stage's integer work per table-step, or at least the state's bytes once
// each way; the probe's use is to compare the stages with each other and
// with K3, not to reach a bound.
#include <cuda_runtime.h>

#include "probe_stages.cuh"

#ifndef MC_SEATS
#error "build with -DMC_SEATS=P (ops/_build.py)"
#endif
#ifndef MC_STAGE
#error "build with -DMC_STAGE=MC_STAGE_<name> (ops/_build.py)"
#endif

// INJECT: words int32 [n_steps, W, n_tables] (W the stage's words per
// step); else Philox keyed by (seed, table) on sub-stream MC_SUB_PROBE.
// K4's block and cold-row column (engine.cuh, MC_ENGINE_THREADS).
template <int P, bool INJECT>
__global__ void __launch_bounds__(MC_ENGINE_THREADS,
                                  mc_engine_blocks_per_sm<P, MC_REFERENCE>())
    mc_stage_kernel(int* state, uint32_t seed, const int* words,
                    int n_tables, int n_steps, int sb, int bb,
                    uint32_t fold_bits, uint32_t raise_bits) {
  extern __shared__ int mc_cold[];
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tables) return;
  int* rows = mc_table_rows<P, MC_REFERENCE>(state, t);
  MCTable<P, MC_REFERENCE, MCEngineRows> s;
  s.rows.col = mc_cold + threadIdx.x;
  mc_load(s, rows, MC_TABLES_PER_BLOCK);
  if constexpr (INJECT) {
    MCInjectedWords src(words + t, n_tables);
    for (int i = 0; i < n_steps; ++i)
      mc_stage_step<MC_STAGE>(s, src, sb, bb, fold_bits, raise_bits);
  } else {
    MCPhiloxWords src(seed, (uint32_t)t, 0u, MC_SUB_PROBE);
    for (int i = 0; i < n_steps; ++i)
      mc_stage_step<MC_STAGE>(s, src, sb, bb, fold_bits, raise_bits);
  }
  mc_store(s, rows, MC_TABLES_PER_BLOCK);
}

template <bool INJECT>
static int mc_launch_stage(int* state, uint32_t seed, const int* words,
                           int n_tables, int n_steps, int sb, int bb,
                           uint32_t fold_bits, uint32_t raise_bits,
                           cudaStream_t st) {
  constexpr int smem = mc_engine_smem<MC_SEATS, MC_REFERENCE>();
  cudaError_t err =
      mc_engine_attributes(mc_stage_kernel<MC_SEATS, INJECT>, smem);
  if (err != cudaSuccess) return (int)err;
  mc_stage_kernel<MC_SEATS, INJECT><<<n_tables / MC_ENGINE_THREADS,
                                      MC_ENGINE_THREADS, smem, st>>>(
      state, seed, words, n_tables, n_steps, sb, bb, fold_bits, raise_bits);
  return (int)cudaGetLastError();
}

// In place on `state`. Returns cudaError_t (cudaErrorInvalidValue for a
// seat count other than the build's).
extern "C" int mc_probe_stage(int* state, int seed, const int* words,
                              int n_blocks, int P, int n_steps, int sb,
                              int bb, int fold_bits, int raise_bits,
                              void* stream) {
  if (P != MC_SEATS) return (int)cudaErrorInvalidValue;
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
  return words ? mc_launch_stage<true>(state, (uint32_t)seed, words,
                                       n_tables, n_steps, sb, bb,
                                       (uint32_t)fold_bits,
                                       (uint32_t)raise_bits, st)
               : mc_launch_stage<false>(state, (uint32_t)seed, words,
                                        n_tables, n_steps, sb, bb,
                                        (uint32_t)fold_bits,
                                        (uint32_t)raise_bits, st);
}

// The stage this library was built for (an MC_STAGE_* value).
extern "C" int mc_probe_stage_id(void) { return MC_STAGE; }
