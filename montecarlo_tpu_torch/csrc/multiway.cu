// The multiway equity kernel B3 (ops/cuda_equity.py:multiway_shares).
//
// `mc_multiway_kernel` replaces montecarlo_tpu/ops/pallas_equity.py:268
// (_make_multiway_kernel via equity_multiway_pallas): N hands in one pot
// on a board with K known cards, each winner taking lcm(1..N) / (number of
// winners) shares. It is instantiated on (N, NDRAW = 5 - K) and on the
// word source, so the live count of every draw, the unroll over the hands
// and the split's quotients are compile-time constants, and a thread's
// N shares are 32-bit registers (mc_rollout_blocks keeps a thread's
// rollouts x lcm(1..N) below 2^32) until the block's 64-bit reduction.
// The rollout is K1's (equity.cuh): words in registers, draws modulo
// constants, the deck table in shared memory, no stack frame.
#include "equity.cuh"

// Rollout r draws from Philox stream (seed, r mod 2^32, r >> 32,
// MC_SUB_MULTIWAY), or (INJECT) reads injected word t at words[t * n + r].
template <int N, int NDRAW, bool INJECT>
__global__ void __launch_bounds__(MC_THREADS)
    mc_multiway_kernel(uint32_t seed, MCMultiwayParams p, long long n,
                       const int* words, unsigned long long* out) {
  __shared__ uint64_t live[52];
  mc_share_live(p.deck, live);
  uint32_t shares[N];
#pragma unroll
  for (int h = 0; h < N; ++h) shares[h] = 0u;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if constexpr (NDRAW == 0) {
    // the whole board is known, so every rollout is the same: one
    // rollout's shares times this thread's rollouts
    mc_rollout_multiway<N, 0, false>(p, live, words, n, 0, seed, shares);
    const uint32_t k = first < n ? (uint32_t)((n - 1 - first) / stride + 1)
                                 : 0u;
#pragma unroll
    for (int h = 0; h < N; ++h) shares[h] *= k;
  } else {
    for (long long r = first; r < n; r += stride)
      mc_rollout_multiway<N, NDRAW, INJECT>(p, live, words, n, r, seed,
                                            shares);
  }
  unsigned long long wide[N];
#pragma unroll
  for (int h = 0; h < N; ++h) wide[h] = shares[h];
  mc_block_add<N>(wide, N, out, 1);
}

template <int N, int NDRAW, bool INJECT>
static int mc_launch_multiway(uint32_t seed, const MCMultiwayParams& p,
                              long long n, const int* words,
                              unsigned long long* out, cudaStream_t s) {
  auto kernel = mc_multiway_kernel<N, NDRAW, INJECT>;
  const int blocks = mc_rollout_blocks(kernel, n, (unsigned)mc_lcm_to(N));
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, MC_THREADS, 0, s>>>(seed, p, n, words, out);
  return (int)cudaGetLastError();
}

// The instantiation for NDRAW and the word source (with NDRAW = 0 there
// are no words).
template <int N>
static int mc_launch_multiway_n(int ndraw, uint32_t seed,
                                const MCMultiwayParams& p, long long n,
                                const int* words, unsigned long long* out,
                                cudaStream_t s) {
  switch (ndraw) {
#define MC_CASE(D)                                                          \
  case D:                                                                   \
    return words ? mc_launch_multiway<N, D, true>(seed, p, n, words, out, s) \
                 : mc_launch_multiway<N, D, false>(seed, p, n, words, out, s);
    MC_CASE(1) MC_CASE(2) MC_CASE(3) MC_CASE(4) MC_CASE(5)
#undef MC_CASE
    case 0: return mc_launch_multiway<N, 0, false>(seed, p, n, words, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dead: the 2N + K ascending dead cards; hand_masks: int32[N, 4] suit masks
// with the K known board cards OR-ed in (both host memory). out: int64[N]
// shares, zeroed by the caller; a rollout's shares sum to lcm(1..N).
// Returns cudaError_t (cudaErrorInvalidValue unless 2 <= N <= 12 and
// 0 <= K <= 5).
extern "C" int mc_multiway_shares(int seed, const int* dead, int n_dead,
                                  const int* hand_masks, int n_hands,
                                  long long n, const int* words,
                                  unsigned long long* out, void* stream) {
  const int k = n_dead - 2 * n_hands;
  if (n_hands < 2 || n_hands > MC_MAX_HANDS || k < 0 || k > 5)
    return (int)cudaErrorInvalidValue;
  MCMultiwayParams p;
  mc_make_deck(dead, n_dead, &p.deck);
  for (int h = 0; h < MC_MAX_HANDS; ++h) {
    p.hand[h][0] = p.hand[h][1] = 0u;
    if (h < n_hands) mc_masks_to_planes(hand_masks + 4 * h, p.hand[h]);
  }
  const uint32_t sd = (uint32_t)seed;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_hands) {
#define MC_CASE(N) \
  case N: return mc_launch_multiway_n<N>(5 - k, sd, p, n, words, out, st);
    MC_CASE(2) MC_CASE(3) MC_CASE(4) MC_CASE(5) MC_CASE(6) MC_CASE(7)
    MC_CASE(8) MC_CASE(9) MC_CASE(10) MC_CASE(11) MC_CASE(12)
#undef MC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
