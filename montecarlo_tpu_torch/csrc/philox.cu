// Bare Philox4x32-10 blocks (ops/philox.py:philox_blocks): a probe that
// holds the kernels' generator (philox.cuh) against published known-answer
// vectors. Not on the main path.
#include <cuda_runtime.h>

#include "philox.cuh"

// ctr_key: [n, 6] u32 (counter x0..x3, key k0, k1); out: [n, 4] u32.
__global__ void mc_philox_blocks_kernel(const uint32_t* ctr_key,
                                        uint32_t* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[4];
  for (int j = 0; j < 4; ++j) x[j] = ctr_key[6 * i + j];
  mc_philox4x32_10(x, ctr_key[6 * i + 4], ctr_key[6 * i + 5]);
  for (int j = 0; j < 4; ++j) out[4 * i + j] = x[j];
}

extern "C" int mc_philox_blocks(const int* ctr_key, int* out, int n,
                                void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  mc_philox_blocks_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ctr_key, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
