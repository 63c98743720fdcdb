// Policy-net evaluation kernels (ops/cuda_net.py).
//
// K5 `mc_net_det_kernel` replaces montecarlo_tpu/ops/pallas_engine.py:1171
// `_make_net_kernel(mode="det")` via run_net_det: every seat plays the net
// of its bank by argmax, deals come from an injected stash, and every step
// settles. K6 `mc_net_eval_kernel` replaces `_make_net_kernel` in prng
// mode, in the three forms of its callers: run_net_eval (one net),
// run_net_league (B7: B banks, seat -> bank) and run_net_eval_pop (B8: a
// grid of C candidates, each with its own B banks). Net seats pick by
// Gumbel argmax, the others play the random policy, `defer` slots per
// settle pass, stacks reset every hand. One kernel body serves every form:
// the single net is B = 1, C = 1.
//
// Layout: one thread runs one table of the packed state, read and written
// once per launch, as in the engine kernels (engine.cu). A block of
// MC_NET_THREADS tables copies its candidate's B banks of 6,020 floats
// (the first MC_SMEM_BANKS of them; the rest are read from global memory)
// into dynamic shared memory once, beside the staging area of the block phase
// (net.cuh): each slot, the tables that play a net write their features to
// rows grouped by bank, all its threads run the MLP densely over those rows
// from the shared weights, and each net table reads back its logits. A
// decision costs 11,776 float operations (5,888 products and 5,888 sums,
// each rounded once: no FMA, see net.cuh); in the dense phase a product is
// one multiply and one add, its weight and input loads shared over a
// 4-output x MC_NET_TILE-row tile, and no warp runs the MLP for one lane's
// decision (a per-thread MLP would, in nearly every warp and slot: es3 at
// one seat gives a decision to ~15% of the table-slots). K6 is bound by
// float issue on the net decisions and by the engine's integer work
// elsewhere. Shared memory per block: min(B, 7) x 24,080 bytes of weights
// and mc_net_smem_floats' staging (46,368 bytes: 256 rows of features, two
// hidden chunks of 32 rows, the row counts); the blocks an SM follow from
// it and from the registers (mc_net_occupancy reports them).
//
// K6's table, as K5's: the hot fields in registers, the cold rows in a
// per-thread array (chosen on the card with scripts/ab_engine.py: the
// whole table pinned to local memory took 2-6% longer, and K4's form, the
// cold rows in a shared column, 1.4-1.7x: its 59,904 bytes a 128-table
// block beside the weights left 1-2 blocks an SM).
//
// Population grid (B8): the candidate is blockIdx.y. Table t of every
// candidate reads Philox stream (seed, t), so all candidates play the same
// deals and random-seat draws (common random numbers), as the TPU keys its
// stream on the block index alone.
#include <cuda_runtime.h>

#include "net.cuh"

// K5's and K6's blocks an SM (a cap of 128 registers a thread): B7's 2^16
// tables, 256 blocks, then run in one wave of 132 x 2 (with 128-table
// blocks, a cap of 168 took 3-5% longer than one of 128; uncapped, K5 and
// K6 took 165-202 registers, one block an SM, and 1.11-1.18x as long).
#define MC_NET_MIN_BLOCKS 2
// The largest grid y dimension: candidates of one launch.
#define MC_MAX_CANDIDATES 65535

// Dynamic shared bytes of a net kernel's block: the banks and the staging
// area.
static int mc_net_smem_bytes(int n_banks) {
  return mc_net_smem_floats(n_banks) * (int)sizeof(float);
}

// The block's shared banks from the launch's weights.
__device__ void mc_load_weights(const MCNetShared& sh, int n_banks) {
  const int n = mc_smem_banks(n_banks) * MC_NET_WEIGHTS;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sh.w[i] = sh.gw[i];
  __syncthreads();
}

// Shared memory above 48 KB is dynamic only after this opt-in.
template <typename Kernel>
static cudaError_t mc_opt_in_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// cards: [n_blocks, hmax, 2P+5, 8, 128]; weights: [n_banks, 6020].
// n_tables is a whole number of CUDA blocks (the 1024-table tile), so every
// thread of a block holds a table and reaches every barrier.
template <int P, int R>
__global__ void __launch_bounds__(MC_NET_THREADS, MC_NET_MIN_BLOCKS)
    mc_net_det_kernel(int* state, const int* cards, const float* weights,
                      int n_tables, int n_steps, int hmax, int sb, int bb,
                      int n_banks, unsigned long long bank_map) {
  extern __shared__ __align__(16) float mc_net_smem[];
  const MCNetShared sh = mc_net_shared(mc_net_smem, n_banks, weights);
  mc_load_weights(sh, n_banks);
  const int t = blockIdx.x * MC_NET_THREADS + threadIdx.x;
  const long long blk = t / MC_TABLES_PER_BLOCK;
  int* rows = mc_table_rows<P, R>(state, t);
  MCNetLane<MCTableLocal<P, R>, const int*> lane(
      cards + blk * hmax * (2 * P + 5) * MC_TABLES_PER_BLOCK +
      t % MC_TABLES_PER_BLOCK);
  mc_load(lane.s, rows, MC_TABLES_PER_BLOCK);
  mc_run_net_det<P, R>(MCLanes<decltype(lane)>{&lane}, sh,
                       MC_TABLES_PER_BLOCK, n_steps, hmax, sb, bb, n_banks,
                       bank_map);
  mc_store(lane.s, rows, MC_TABLES_PER_BLOCK);
}

// state: [n_cand, n_blocks, F, 8, 128]; weights: [n_cand, n_banks, 6020].
// Injected words: int32 [n_steps / defer, 6 defer + 2P + 5, n_tables], the
// same for every candidate; else Philox keyed by (seed, table). With
// n_net, the launch adds its count of net decisions there.
template <int P, int R>
__global__ void __launch_bounds__(MC_NET_THREADS, MC_NET_MIN_BLOCKS)
    mc_net_eval_kernel(int* state, uint32_t seed, const int* words,
                       const float* weights, int n_tables, int n_steps,
                       int defer, int sb, int bb, int ss, int net_seats,
                       int reset_stacks, uint32_t fold_bits,
                       uint32_t raise_bits, int n_banks,
                       unsigned long long bank_map,
                       unsigned long long* n_net) {
  extern __shared__ __align__(16) float mc_net_smem[];
  const long long c = blockIdx.y;
  const MCNetShared sh = mc_net_shared(
      mc_net_smem, n_banks, weights + mc_candidate_weights(c, n_banks));
  mc_load_weights(sh, n_banks);
  const int t = blockIdx.x * MC_NET_THREADS + threadIdx.x;
  int* rows =
      mc_table_rows<P, R>(state + mc_candidate_state<P, R>(c, n_tables), t);
  MCNetLane<MCTableLocal<P, R>, MCWords> lane(
      MCWords(words, n_tables, t, seed, (uint32_t)t, 0u, 0u));
  mc_load(lane.s, rows, MC_TABLES_PER_BLOCK);
  mc_run_net_eval<P, R>(MCLanes<decltype(lane)>{&lane}, sh, n_steps, defer,
                        sb, bb, ss, net_seats, reset_stacks != 0, fold_bits,
                        raise_bits, n_banks, bank_map);
  mc_store(lane.s, rows, MC_TABLES_PER_BLOCK);
  if (n_net) atomicAdd(n_net, (unsigned long long)lane.n_net);
}

// A probe, on no main path: per table, the features, the masked logits
// and the Gumbel scores on `words` [4, n_tables] of the acting position,
// into out [MC_PROBE_ROWS, n_tables], the logits through the block phase.
template <int P, int R>
__global__ void __launch_bounds__(MC_NET_THREADS)
    mc_net_probe_kernel(const int* state, const int* words,
                        const float* weights, float* out, int n_tables,
                        int bb) {
  extern __shared__ __align__(16) float mc_net_smem[];
  const MCNetShared sh = mc_net_shared(mc_net_smem, 1, weights);
  mc_load_weights(sh, 1);
  const int t = blockIdx.x * MC_NET_THREADS + threadIdx.x;
  MCNetLane<MCTableLocal<P, R>, int> lane(0);
  mc_load(lane.s, mc_table_rows<P, R>(state, t), MC_TABLES_PER_BLOCK);
  mc_run_net_probe<P, R>(MCLanes<decltype(lane)>{&lane}, sh, words, out,
                         (long long)blockIdx.x * MC_NET_THREADS, n_tables,
                         bb);
}

// In-place on `state`. rules: 0 reference, 1 standard. Returns
// cudaError_t (cudaErrorInvalidValue for a seat count other than the
// library's MC_SEATS, another rule set, or a bank or candidate count out of
// range).
extern "C" int mc_net_det(int* state, const int* cards, const float* weights,
                          int n_blocks, int P, int rules, int n_steps,
                          int hmax, int sb, int bb, int n_banks,
                          unsigned long long bank_map, void* stream) {
  if (n_banks < 1 || n_banks > MC_MAX_BANKS) return (int)cudaErrorInvalidValue;
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N: {                                                     \
    const int smem = mc_net_smem_bytes(n_banks);             \
    err = mc_opt_in_smem(mc_net_det_kernel<N, R>, smem);                  \
    if (err != cudaSuccess) return (int)err;                              \
    mc_net_det_kernel<N, R><<<n_tables / MC_NET_THREADS, MC_NET_THREADS,  \
                              smem, st>>>(state, cards, weights,          \
                                          n_tables, n_steps, hmax, sb,    \
                                          bb, n_banks, bank_map);         \
    break;                                                                \
  }
  MC_DISPATCH(MC_CASE)
#undef MC_CASE
  return (int)cudaGetLastError();
}

extern "C" int mc_net_eval(int* state, int seed, const int* words,
                           const float* weights, int n_cand, int n_blocks,
                           int P, int rules, int n_steps, int defer, int sb,
                           int bb, int ss, int net_seats, int reset_stacks,
                           int fold_bits, int raise_bits, int n_banks,
                           unsigned long long bank_map,
                           unsigned long long* n_net, void* stream) {
  if (defer < 1 || n_steps % defer != 0 || n_banks < 1 ||
      n_banks > MC_MAX_BANKS || n_cand < 1 || n_cand > MC_MAX_CANDIDATES)
    return (int)cudaErrorInvalidValue;
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  dim3 grid(n_tables / MC_NET_THREADS, n_cand);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N: {                                                     \
    const int smem = mc_net_smem_bytes(n_banks);              \
    err = mc_opt_in_smem(mc_net_eval_kernel<N, R>, smem);                 \
    if (err != cudaSuccess) return (int)err;                              \
    mc_net_eval_kernel<N, R><<<grid, MC_NET_THREADS, smem, st>>>(         \
        state, (uint32_t)seed, words, weights, n_tables, n_steps, defer,  \
        sb, bb, ss, net_seats, reset_stacks, (uint32_t)fold_bits,         \
        (uint32_t)raise_bits, n_banks, bank_map, n_net);                  \
    break;                                                                \
  }
  MC_DISPATCH(MC_CASE)
#undef MC_CASE
  return (int)cudaGetLastError();
}

extern "C" int mc_net_probe(const int* state, const int* words,
                            const float* weights, float* out, int n_blocks,
                            int P, int rules, int bb, void* stream) {
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N: {                                                     \
    const int smem = mc_net_smem_bytes(1);                   \
    err = mc_opt_in_smem(mc_net_probe_kernel<N, R>, smem);                \
    if (err != cudaSuccess) return (int)err;                              \
    mc_net_probe_kernel<N, R><<<n_tables / MC_NET_THREADS,                \
                                MC_NET_THREADS, smem, st>>>(              \
        state, words, weights, out, n_tables, bb);                        \
    break;                                                                \
  }
  MC_DISPATCH(MC_CASE)
#undef MC_CASE
  return (int)cudaGetLastError();
}

template <typename Kernel>
static int mc_occupancy(Kernel kernel, int smem, int* out) {
  cudaError_t err = mc_opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, kernel, MC_NET_THREADS, smem);
}

// The launch of a net kernel (0 K5, 1 K6, 2 the probe: one net) with
// n_banks banks:
// out[0] its dynamic shared bytes per block, out[1] the blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int mc_net_occupancy(int kernel, int P, int rules, int n_banks,
                                int* out) {
  if (n_banks < 1 || n_banks > MC_MAX_BANKS || kernel < 0 || kernel > 2)
    return (int)cudaErrorInvalidValue;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N: {                                                     \
    const int smem = mc_net_smem_bytes(kernel == 2 ? 1 : n_banks);        \
    return kernel == 0   ? mc_occupancy(mc_net_det_kernel<N, R>, smem, out) \
           : kernel == 1 ? mc_occupancy(mc_net_eval_kernel<N, R>, smem, out) \
                         : mc_occupancy(mc_net_probe_kernel<N, R>, smem,  \
                                        out);                             \
  }
  MC_DISPATCH(MC_CASE)
#undef MC_CASE
}
