// Shared definitions for the port's kernels.
//
// The device functions are also valid host C++ (MC_HD expands to inline
// outside nvcc), so their arithmetic can be compiled and checked by a host
// compiler against the plain PyTorch versions.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define MC_HD __host__ __device__ __forceinline__
#else
#define MC_HD inline
#endif

MC_HD int mc_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Position of the highest set bit; -1 for x == 0.
MC_HD int mc_msb(uint32_t x) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(x);
#else
  return x ? 31 - __builtin_clz(x) : -1;
#endif
}

// Position of the lowest set bit; x != 0.
MC_HD int mc_ffs(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

MC_HD int mc_min(int a, int b) { return a < b ? a : b; }
MC_HD int mc_max(int a, int b) { return a > b ? a : b; }

// int32 arithmetic that wraps like jnp/torch int32 (signed overflow is
// undefined in C++, so go through uint32).
MC_HD int mc_add(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
MC_HD int mc_sub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }
MC_HD int mc_mul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }

// An empty volatile asm that reads x from a register and, as far as the
// compiler knows, writes it back changed: nothing computed from x before
// it is reused after it. The probe kernels (probe_carry.cuh,
// probe_stages.cuh) put it in their step loops, so that a loop of adds
// stays a loop of adds and a step's reads of unchanged state are not
// hoisted out of the loop. It emits no instruction.
MC_HD void mc_keep(int& x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(x));
#else
  (void)x;
#endif
}

// The same for a pointer: the addresses computed from it, and so the loads
// through it, are not reused across it.
template <class T>
MC_HD void mc_keep_ptr(T*& p) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+l"(p));
#else
  (void)p;
#endif
}

// Floor division and floor modulo (Python / jnp / torch semantics; C's
// `/` and `%` truncate toward zero). b > 0.
MC_HD int mc_floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
MC_HD int mc_floormod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

// float32 operations rounded once each, never contracted into a fused
// multiply-add, so a sum of products has one fixed rounding sequence that
// PyTorch's separate elementwise operations reproduce. The host form
// relies on the compiler not contracting (-ffp-contract=off).
MC_HD float mc_fadd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
MC_HD float mc_fsub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
MC_HD float mc_fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
MC_HD float mc_fdiv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
