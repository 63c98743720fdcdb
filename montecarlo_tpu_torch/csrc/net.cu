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
// Layout as the engine kernels (engine.cu): one thread runs one table of the
// packed state, read and written once per launch, its hot fields in
// registers. A block copies its candidate's B banks of 6,020 floats (B x
// 24,080 bytes) into dynamic shared memory once, so the table's cold rows
// stay a per-thread array (MCTableLocal, local memory) rather than a shared
// column; a thread reads the bank of its acting seat, a broadcast while the
// warp's acting seats share a bank. Features, hidden activations and
// logits live in registers and local memory. A decision
// costs 11,776 float operations (5,888 products, 5,888 sums, each rounded
// once: no FMA, see net.cuh), so K6 is bound by float issue on the net
// seats' decisions and by the engine's integer work elsewhere. The MLP on
// tensor cores (128 tables x 24 features as an mma tile) is later work.
//
// Population grid (B8): the candidate is blockIdx.y. Table t of every
// candidate reads Philox stream (seed, t), so all candidates play the same
// deals and random-seat draws (common random numbers), as the TPU keys its
// stream on the block index alone.
#include <cuda_runtime.h>

#include "net.cuh"

#define MC_NET_THREADS 128
// K6's blocks an SM (a cap of 128 registers a thread): B7's 2^16 tables,
// 512 blocks, then run in one wave of 132 x 4 (at ptxas's own choice for
// standard rules, 167 to 207 registers, they take two).
#define MC_NET_EVAL_MIN_BLOCKS 4
// The largest grid y dimension: candidates of one launch.
#define MC_MAX_CANDIDATES 65535

__device__ void mc_load_weights(float* w, const float* weights, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) w[i] = weights[i];
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
template <int P, int R>
__global__ void __launch_bounds__(MC_NET_THREADS)
    mc_net_det_kernel(int* state, const int* cards, const float* weights,
                      int n_tables, int n_steps, int hmax, int sb, int bb,
                      int n_banks, unsigned long long bank_map) {
  extern __shared__ float w[];
  mc_load_weights(w, weights, n_banks * MC_NET_WEIGHTS);
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tables) return;
  const long long blk = t / MC_TABLES_PER_BLOCK;
  const int lane = t % MC_TABLES_PER_BLOCK;
  int* rows = mc_table_rows<P, R>(state, t);
  MCTableLocal<P, R> s;
  mc_load(s, rows, MC_TABLES_PER_BLOCK);
  mc_run_net_det(s,
                 cards + blk * hmax * (2 * P + 5) * MC_TABLES_PER_BLOCK + lane,
                 MC_TABLES_PER_BLOCK, n_steps, hmax, sb, bb, w, bank_map);
  mc_store(s, rows, MC_TABLES_PER_BLOCK);
}

// state: [n_cand, n_blocks, F, 8, 128]; weights: [n_cand, n_banks, 6020].
// Injected words: int32 [n_steps / defer, 6 defer + 2P + 5, n_tables], the
// same for every candidate; else Philox keyed by (seed, table). With
// n_net, the launch adds its count of net decisions there.
template <int P, int R>
__global__ void __launch_bounds__(MC_NET_THREADS, MC_NET_EVAL_MIN_BLOCKS)
    mc_net_eval_kernel(int* state, uint32_t seed, const int* words,
                       const float* weights, int n_tables, int n_steps,
                       int defer, int sb, int bb, int ss, int net_seats,
                       int reset_stacks, uint32_t fold_bits,
                       uint32_t raise_bits, int n_banks,
                       unsigned long long bank_map,
                       unsigned long long* n_net) {
  extern __shared__ float w[];
  const long long c = blockIdx.y;
  mc_load_weights(w, weights + mc_candidate_weights(c, n_banks),
                  n_banks * MC_NET_WEIGHTS);
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tables) return;
  int* rows =
      mc_table_rows<P, R>(state + mc_candidate_state<P, R>(c, n_tables), t);
  MCTableLocal<P, R> s;
  mc_load(s, rows, MC_TABLES_PER_BLOCK);
  // the whole table in local memory, as in the engine's first form: with
  // its hot fields in registers K6 took twice its time at every register
  // cap tried (96 to 205), and 1.5x with the MLP a call of its own
  // (scripts/ab_engine.py)
  mc_pin_to_memory(s);
  MCWords src(words, n_tables, t, seed, (uint32_t)t, 0u, 0u);
  int n = mc_run_net_eval(s, src, n_steps, defer, sb, bb, ss, net_seats,
                          reset_stacks != 0, fold_bits, raise_bits, w,
                          bank_map);
  mc_store(s, rows, MC_TABLES_PER_BLOCK);
  if (n_net) atomicAdd(n_net, (unsigned long long)n);
}

// A probe, on no main path: per table, the features, the masked logits
// and the Gumbel scores on `words` [4, n_tables] of the acting position,
// into out [MC_PROBE_ROWS, n_tables].
template <int P, int R>
__global__ void __launch_bounds__(MC_NET_THREADS)
    mc_net_probe_kernel(const int* state, const int* words,
                        const float* weights, float* out, int n_tables,
                        int bb) {
  __shared__ float w[MC_NET_WEIGHTS];
  mc_load_weights(w, weights, MC_NET_WEIGHTS);
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tables) return;
  MCTableLocal<P, R> s;
  mc_load(s, mc_table_rows<P, R>(state, t),
          MC_TABLES_PER_BLOCK);
  float f[MC_NUM_FEATURES], lg[MC_NUM_ACTIONS];
  mc_net_scores(s, mc_head<P>(s.order, s.cursor), bb, w, nullptr, f, lg);
  float* o = out + t;
  for (int i = 0; i < MC_NUM_FEATURES; ++i) o[(long long)i * n_tables] = f[i];
  for (int a = 0; a < MC_NUM_ACTIONS; ++a) {
    uint32_t g = (uint32_t)words[(long long)a * n_tables + t];
    o[(long long)(MC_NUM_FEATURES + a) * n_tables] = lg[a];
    o[(long long)(MC_NUM_FEATURES + MC_NUM_ACTIONS + a) * n_tables] =
        mc_fsub(lg[a], mc_neg_gumbel(g));
  }
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
  int grid = (n_tables + MC_NET_THREADS - 1) / MC_NET_THREADS;
  int smem = n_banks * MC_NET_WEIGHTS * (int)sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N:                                                       \
    err = mc_opt_in_smem(mc_net_det_kernel<N, R>, smem);                  \
    if (err != cudaSuccess) return (int)err;                              \
    mc_net_det_kernel<N, R><<<grid, MC_NET_THREADS, smem, st>>>(          \
        state, cards, weights, n_tables, n_steps, hmax, sb, bb, n_banks,  \
        bank_map);                                                        \
    break;
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
  dim3 grid((n_tables + MC_NET_THREADS - 1) / MC_NET_THREADS, n_cand);
  int smem = n_banks * MC_NET_WEIGHTS * (int)sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N:                                                       \
    err = mc_opt_in_smem(mc_net_eval_kernel<N, R>, smem);                 \
    if (err != cudaSuccess) return (int)err;                              \
    mc_net_eval_kernel<N, R><<<grid, MC_NET_THREADS, smem, st>>>(         \
        state, (uint32_t)seed, words, weights, n_tables, n_steps, defer,  \
        sb, bb, ss, net_seats, reset_stacks, (uint32_t)fold_bits,         \
        (uint32_t)raise_bits, n_banks, bank_map, n_net);                  \
    break;
  MC_DISPATCH(MC_CASE)
#undef MC_CASE
  return (int)cudaGetLastError();
}

extern "C" int mc_net_probe(const int* state, const int* words,
                            const float* weights, float* out, int n_blocks,
                            int P, int rules, int bb, void* stream) {
  int n_tables = n_blocks * MC_TABLES_PER_BLOCK;
  int grid = (n_tables + MC_NET_THREADS - 1) / MC_NET_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
#define MC_CASE(N, R)                                                     \
  case R * 100 + N:                                                       \
    mc_net_probe_kernel<N, R><<<grid, MC_NET_THREADS, 0, st>>>(           \
        state, words, weights, out, n_tables, bb);                        \
    break;
  MC_DISPATCH(MC_CASE)
#undef MC_CASE
  return (int)cudaGetLastError();
}
