// The K4 split (ops/cuda_split.py): K4 with one piece of its step stubbed,
// one variant per build.
//
// Replaces scripts/exp_step_split.py:75-117, which times the JAX engine
// kernel (pallas_engine.py:824, K4) with one module-level piece of its body
// monkeypatched at a time: stub_settle, stub_eval, stub_deal, stub_policy,
// stub_street, and the controls settle_copy and street_copy
// (probe_split.cuh says what each does). Here nvcc compiles
// this file once per variant, with -DMC_SEATS=P and
// -DMC_SPLIT=MC_SPLIT_<variant> (ops/_build.py:build_probe), into a
// library of its own, so that a variant's kernel is built alone and its
// ptxas report is its own. The kernel is K4's (engine.cu,
// mc_engine_prng_kernel, the Philox instantiation) under reference rules:
// one thread per table of the packed state [n_blocks, F, 8, 128], the hot
// fields in registers, the cold rows in the block's shared-memory column,
// words from Philox stream (seed, table, 0, 0) as K4 draws them, so that
// the full variant returns K4's state. Bound: as K4, the integer work of
// the step and the settle pass less the stubbed piece's; the split's use
// is each stub's saving against its baseline (full, or the control that
// runs the same copy), not a bound.
#include <cuda_runtime.h>

#include "probe_split.cuh"

#ifndef MC_SEATS
#error "build with -DMC_SEATS=P (ops/_build.py)"
#endif
#ifndef MC_SPLIT
#error "build with -DMC_SPLIT=MC_SPLIT_<variant> (ops/_build.py)"
#endif

template <int P>
__global__ void __launch_bounds__(MC_ENGINE_THREADS,
                                  mc_engine_blocks_per_sm<P, MC_REFERENCE>())
    mc_split_kernel(int* state, uint32_t seed, int n_tables, int n_steps,
                    int defer, int sb, int bb, uint32_t fold_bits,
                    uint32_t raise_bits) {
  extern __shared__ int mc_cold[];
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tables) return;
  int* rows = mc_table_rows<P, MC_REFERENCE>(state, t);
  if (mc_frozen_rows<P, MC_REFERENCE>(rows, MC_TABLES_PER_BLOCK)) return;
  MCTable<P, MC_REFERENCE, MCEngineRows> s;
  s.rows.col = mc_cold + threadIdx.x;
  mc_load(s, rows, MC_TABLES_PER_BLOCK);
  MCPhiloxWords src(seed, (uint32_t)t, 0u, 0u);
  mc_split_run<MC_SPLIT>(s, src, n_steps, defer, sb, bb, fold_bits,
                         raise_bits);
  mc_store(s, rows, MC_TABLES_PER_BLOCK);
}

// In place on `state`. Returns cudaError_t (cudaErrorInvalidValue for a
// seat count other than the build's or a step count not a multiple of
// defer).
extern "C" int mc_probe_split(int* state, int seed, int n_blocks, int P,
                              int n_steps, int defer, int sb, int bb,
                              int fold_bits, int raise_bits, void* stream) {
  if (P != MC_SEATS || defer < 1 || n_steps % defer != 0)
    return (int)cudaErrorInvalidValue;
  const int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  constexpr int smem = mc_engine_smem<MC_SEATS, MC_REFERENCE>();
  cudaError_t err = mc_engine_attributes(mc_split_kernel<MC_SEATS>, smem);
  if (err != cudaSuccess) return (int)err;
  mc_split_kernel<MC_SEATS><<<n_tables / MC_ENGINE_THREADS,
                              MC_ENGINE_THREADS, smem,
                              (cudaStream_t)stream>>>(
      state, (uint32_t)seed, n_tables, n_steps, defer, sb, bb,
      (uint32_t)fold_bits, (uint32_t)raise_bits);
  return (int)cudaGetLastError();
}

// The variant this library was built for (an MC_SPLIT_* value).
extern "C" int mc_probe_split_id(void) { return MC_SPLIT; }
