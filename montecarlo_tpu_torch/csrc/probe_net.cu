// The K6 split (ops/cuda_net_split.py): K6 with one piece of the net
// decision stubbed, one variant per build.
//
// Replaces scripts/exp_net_split.py:70-95, which times the JAX net-eval
// kernel (pallas_engine.py:1272, K6) with one module-level piece of its
// body monkeypatched at a time: stub_gumbel, stub_feat_eval,
// stub_features, stub_net, and the control feat_copy (probe_net.cuh says
// what each does). nvcc
// compiles this file once per variant, with -DMC_SEATS=P and
// -DMC_NET_SPLIT=MC_NET_SPLIT_<variant> (ops/_build.py:build_probe), into
// a library of its own. The kernel is K6's (net.cu, mc_net_eval_kernel)
// for one net under standard rules (the script's): 256-table blocks, the
// block phase over the net decisions' staged rows, the weights in shared
// memory, the same launch bounds (128 registers a thread), words from
// Philox stream (seed, table, 0, 0) or injected, so that the full variant
// returns K6's state. Bound: as K6, float issue on the net decisions and
// the engine's integer work elsewhere, less the stubbed piece's; the
// split's use is each stub's saving against its baseline (full, or the
// control that runs the same copies), not a bound.
#include <cuda_runtime.h>

#include "probe_net.cuh"

#ifndef MC_SEATS
#error "build with -DMC_SEATS=P (ops/_build.py)"
#endif
#ifndef MC_NET_SPLIT
#error "build with -DMC_NET_SPLIT=MC_NET_SPLIT_<variant> (ops/_build.py)"
#endif

// K6's blocks an SM (net.cu)
#define MC_NET_MIN_BLOCKS 2

// weights: [n_banks, 6020]; injected words int32 [n_steps / defer, W,
// n_tables] (W: ops/cuda_net_split.py, split_words_shape), else Philox
// keyed by (seed, table). With n_net, the launch adds its count of net
// decisions there.
template <int P, int R>
__global__ void __launch_bounds__(MC_NET_THREADS, MC_NET_MIN_BLOCKS)
    mc_split_net_kernel(int* state, uint32_t seed, const int* words,
                        const float* weights, int n_tables, int n_steps,
                        int defer, int sb, int bb, int ss, int net_seats,
                        int reset_stacks, uint32_t fold_bits,
                        uint32_t raise_bits, int n_banks,
                        unsigned long long bank_map,
                        unsigned long long* n_net) {
  extern __shared__ __align__(16) float mc_net_smem[];
  const MCNetShared sh = mc_net_shared(mc_net_smem, n_banks, weights);
  const int n = mc_smem_banks(n_banks) * MC_NET_WEIGHTS;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sh.w[i] = sh.gw[i];
  __syncthreads();
  const int t = blockIdx.x * MC_NET_THREADS + threadIdx.x;
  int* rows = mc_table_rows<P, R>(state, t);
  MCNetLane<MCTableLocal<P, R>, MCWords> lane(
      MCWords(words, n_tables, t, seed, (uint32_t)t, 0u, 0u));
  mc_load(lane.s, rows, MC_TABLES_PER_BLOCK);
  mc_split_run_net_eval<MC_NET_SPLIT, P, R>(
      MCLanes<decltype(lane)>{&lane}, sh, n_steps, defer, sb, bb, ss,
      net_seats, reset_stacks != 0, fold_bits, raise_bits, n_banks,
      bank_map);
  mc_store(lane.s, rows, MC_TABLES_PER_BLOCK);
  if (n_net) atomicAdd(n_net, (unsigned long long)lane.n_net);
}

// In place on `state`. Standard rules only. Returns cudaError_t
// (cudaErrorInvalidValue for a seat count other than the build's, other
// rules, a step count not a multiple of defer, or a bank count out of
// range).
extern "C" int mc_probe_net_split(int* state, int seed, const int* words,
                                  const float* weights, int n_blocks, int P,
                                  int rules, int n_steps, int defer, int sb,
                                  int bb, int ss, int net_seats,
                                  int reset_stacks, int fold_bits,
                                  int raise_bits, int n_banks,
                                  unsigned long long bank_map,
                                  unsigned long long* n_net, void* stream) {
  if (P != MC_SEATS || rules != MC_STANDARD || defer < 1 ||
      n_steps % defer != 0 || n_banks < 1 || n_banks > MC_MAX_BANKS)
    return (int)cudaErrorInvalidValue;
  const int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  const int smem = mc_net_smem_floats(n_banks) * (int)sizeof(float);
  auto kernel = mc_split_net_kernel<MC_SEATS, MC_STANDARD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_tables / MC_NET_THREADS, MC_NET_THREADS, smem,
           (cudaStream_t)stream>>>(
      state, (uint32_t)seed, words, weights, n_tables, n_steps, defer, sb,
      bb, ss, net_seats, reset_stacks, (uint32_t)fold_bits,
      (uint32_t)raise_bits, n_banks, bank_map, n_net);
  return (int)cudaGetLastError();
}

// The variant this library was built for (an MC_NET_SPLIT_* value).
extern "C" int mc_probe_net_split_id(void) { return MC_NET_SPLIT; }
