// The carry probe's per-table bodies (ops/cuda_carry.py): one table's R
// int32 words carried through n_steps steps, each step adding 1 to every
// word, in three placements.
//
// The layout is scripts/exp_carry_model.py's [n_blocks, R, 8, 128]: word j
// of table t (one lane of the (8, 128) tile) at
// (t / 1024) * R * 1024 + j * 1024 + t % 1024, so a warp's loads and
// stores of one word coalesce. Each add passes through mc_keep, so the
// compiler can neither fold a table's n_steps adds into one add of
// n_steps nor hoist a word out of the step loop.
#pragma once

#include "common.cuh"

#define MC_CARRY_TABLES 1024

MC_HD long long mc_carry_base(int R, long long t) {
  return (t / MC_CARRY_TABLES) * R * MC_CARRY_TABLES + t % MC_CARRY_TABLES;
}

// carry_array (exp_carry_model.py:46): the words in a private array that
// only compile-time indices reach (the row loop unrolled, the step loop
// not), so ptxas can keep all R in registers.
template <int R>
MC_HD void mc_carry_array(const int* in, int* out, long long t,
                          int n_steps) {
  const long long base = mc_carry_base(R, t);
  int x[R];
#pragma unroll
  for (int j = 0; j < R; ++j) x[j] = in[base + j * MC_CARRY_TABLES];
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      mc_keep(x[j]);
      x[j] = mc_add(x[j], 1);
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) out[base + j * MC_CARRY_TABLES] = x[j];
}

template <int R>
struct MCCarryRows {
  int r[R];
};

// carry_dict (exp_carry_model.py:63), the engine's form: a struct of R rows
// loaded and stored row by row as mc_load / mc_store do (engine.cuh), and
// walked with a run-time row index, as the engine's seat and layer loops
// index MCTable (s.stacks[head], s.pot_amt[row]). A private array indexed
// at run time lives in the thread's local memory: each word-step is a
// local load, an add and a local store.
template <int R>
MC_HD void mc_carry_dict(const int* in, int* out, long long t, int n_steps) {
  const long long base = mc_carry_base(R, t);
  MCCarryRows<R> s;
  int* v = reinterpret_cast<int*>(&s);
  for (int f = 0; f < R; ++f) v[f] = in[base + f * MC_CARRY_TABLES];
  for (int i = 0; i < n_steps; ++i) {
#pragma unroll 1
    for (int j = 0; j < R; ++j) {
      int w = s.r[j];
      mc_keep(w);
      s.r[j] = mc_add(w, 1);
    }
  }
  for (int f = 0; f < R; ++f) out[base + f * MC_CARRY_TABLES] = v[f];
}

// ref_resident (exp_carry_model.py:82): no carry. The words live in `out`
// in global memory; each step loads, adds to and stores every word
// through a volatile pointer, so no load or store leaves the loop.
template <int R>
MC_HD void mc_carry_ref(const int* in, int* out, long long t, int n_steps) {
  const long long base = mc_carry_base(R, t);
  volatile int* o = out + base;
  for (int j = 0; j < R; ++j)
    o[j * MC_CARRY_TABLES] = in[base + j * MC_CARRY_TABLES];
  for (int i = 0; i < n_steps; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      o[j * MC_CARRY_TABLES] = mc_add(o[j * MC_CARRY_TABLES], 1);
  }
}

// The word counts R of each form: carry_array at the script's 16, 36, 70
// and 141, the engine's F at P = 6 today (143 reference, 160 standard, 166
// tournament; engine.cuh), and 192 .. 256 to find where the registers run
// out; the struct and global forms at 141 and at the engine's three F.
#define MC_CARRY_ARRAY_R(X) \
  X(16) X(36) X(70) X(141) X(143) X(160) X(166) X(192) X(224) X(248) X(256)
#define MC_CARRY_ROWS_R(X) X(141) X(143) X(160) X(166)
