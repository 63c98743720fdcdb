// The carry probe (ops/cuda_carry.py), built as a library of its own.
//
// Replaces scripts/exp_carry_model.py:46 `carry_array`, :63 `carry_dict`
// and :82 `ref_resident` (their pallas_call at :56, :75 and :95): a kernel
// whose body only adds 1 to each of a table's R int32 words for n_steps
// steps, over [n_blocks, R, 8, 128]. One thread carries one table. The
// three forms place the words in registers, in local memory and in global
// memory (probe_carry.cuh), to price a word that the engine kernels (K3-K6,
// 128-168 registers, 688-1,920-byte stack frames) carry from one step to
// the next.
//
// Bound: R * n_steps int32 adds per table against 8R bytes (each word read
// and written once); at R = 141, 2^20 tables and 512 steps that is 4.52 ms
// of operations at 16.75 T/s against 0.35 ms of bytes at 3.35 TB/s. The
// array form should run at the operation bound; the other two show what
// local and global memory add to it.
#include <cuda_runtime.h>

#include "probe_carry.cuh"

#define MC_CARRY_THREADS 128

#define MC_CARRY_KERNEL(NAME, BODY)                                        \
  template <int R>                                                        \
  __global__ void __launch_bounds__(MC_CARRY_THREADS)                     \
      NAME(const int* in, int* out, int n_tables, int n_steps) {          \
    int t = blockIdx.x * blockDim.x + threadIdx.x;                        \
    if (t < n_tables) BODY<R>(in, out, t, n_steps);                       \
  }
MC_CARRY_KERNEL(mc_carry_array_kernel, mc_carry_array)
MC_CARRY_KERNEL(mc_carry_dict_kernel, mc_carry_dict)
MC_CARRY_KERNEL(mc_carry_ref_kernel, mc_carry_ref)
#undef MC_CARRY_KERNEL

// form: 0 array, 1 dict, 2 ref. Reads `in`, writes `out` (both [n_blocks,
// R, 8, 128] int32). Returns cudaError_t (cudaErrorInvalidValue for a
// form or R the library was not built with).
extern "C" int mc_probe_carry(int form, int R, const int* in, int* out,
                              int n_blocks, int n_steps, void* stream) {
  int n_tables = n_blocks * MC_CARRY_TABLES;
  int grid = (n_tables + MC_CARRY_THREADS - 1) / MC_CARRY_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
#define MC_CASE(FORM, KERNEL, N)                                           \
  case FORM * 1000 + N:                                                   \
    KERNEL<N><<<grid, MC_CARRY_THREADS, 0, st>>>(in, out, n_tables,       \
                                                  n_steps);               \
    break;
#define MC_ARRAY(N) MC_CASE(0, mc_carry_array_kernel, N)
#define MC_DICT(N) MC_CASE(1, mc_carry_dict_kernel, N)
#define MC_REF(N) MC_CASE(2, mc_carry_ref_kernel, N)
  switch (form * 1000 + R) {
    MC_CARRY_ARRAY_R(MC_ARRAY)
    MC_CARRY_ROWS_R(MC_DICT)
    MC_CARRY_ROWS_R(MC_REF)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MC_ARRAY
#undef MC_DICT
#undef MC_REF
#undef MC_CASE
  return (int)cudaGetLastError();
}
