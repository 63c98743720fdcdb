// The stage probe (ops/cuda_stages.py): one stage of the whole-step engine
// body per build.
//
// Replaces scripts/debug_kernel_compile.py:27 `compile_variant` (its
// pallas_call at :36), which compiles the JAX engine kernel's step body in
// stages to find what its compile time and its cost come from. Here nvcc
// compiles this file once per stage, with -DMC_SEATS=P and
// -DMC_STAGE=MC_STAGE_<name> (ops/_build.py:build_stage), into a library
// of its own, so each build's seconds and ptxas report (registers, stack
// frame, spills) belong to that stage alone. The kernel is K3/K4's shape:
// one thread per table of the packed state [n_blocks, F, 8, 128] (reference
// rules, as the script's), the table's F rows read into an MCTable once,
// n_steps applications of the stage, the rows written once. Bound: the
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

#define MC_STAGE_THREADS 128

// Injected words: int32 [n_steps, W, n_tables] (W the stage's words per
// step); else Philox keyed by (seed, table) on sub-stream MC_SUB_PROBE.
template <int P>
__global__ void __launch_bounds__(MC_STAGE_THREADS)
    mc_stage_kernel(int* state, uint32_t seed, const int* words,
                    int n_tables, int n_steps, int sb, int bb,
                    uint32_t fold_bits, uint32_t raise_bits) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tables) return;
  MCTable<P, MC_REFERENCE> s;
  mc_load(s, state, t);
  MCWords src(words, n_tables, t, seed, (uint32_t)t, 0u, MC_SUB_PROBE);
  for (int i = 0; i < n_steps; ++i)
    mc_stage_step<MC_STAGE>(s, src, sb, bb, fold_bits, raise_bits);
  mc_store(s, state, t);
}

// In place on `state`. Returns cudaError_t (cudaErrorInvalidValue for a
// seat count other than the build's).
extern "C" int mc_probe_stage(int* state, int seed, const int* words,
                              int n_blocks, int P, int n_steps, int sb,
                              int bb, int fold_bits, int raise_bits,
                              void* stream) {
  if (P != MC_SEATS) return (int)cudaErrorInvalidValue;
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  int grid = (n_tables + MC_STAGE_THREADS - 1) / MC_STAGE_THREADS;
  mc_stage_kernel<MC_SEATS><<<grid, MC_STAGE_THREADS, 0,
                              (cudaStream_t)stream>>>(
      state, (uint32_t)seed, words, n_tables, n_steps, sb, bb,
      (uint32_t)fold_bits, (uint32_t)raise_bits);
  return (int)cudaGetLastError();
}

// The stage this library was built for (an MC_STAGE_* value).
extern "C" int mc_probe_stage_id(void) { return MC_STAGE; }
