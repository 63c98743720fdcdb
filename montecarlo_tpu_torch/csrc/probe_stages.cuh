// The stage probe's per-table bodies (ops/cuda_stages.py): the stages of
// scripts/debug_kernel_compile.py (v_carry :65, v_policy :71, v_street :78,
// v_deal :94, v_settle :103, v_full :127), each built from the engine's own
// device functions (engine.cuh), for one table.
//
// The table is K4's (engine.cuh, MCTable): hot fields in registers, cold
// rows in the storage class Rows (the kernel's shared-memory column, the
// host harness's per-thread array). Words are drawn as the JAX bodies draw
// them: _policy_prng's u, then amt_bits; then _sample_cards' 2P + 5. A
// stage that reads state it does not change first passes those fields
// through mc_keep (a cold row in shared memory: its column address through
// mc_keep_ptr), so that every step reads them again, as an engine step does
// when the step before may have changed them (otherwise the compiler
// computes the head scan or the hand values once, before the step loop).
#pragma once

#include "engine.cuh"

// The Philox sub-stream of the stage probe: table t of a launch draws from
// (seed, t, 0, 65537), which no other kernel uses (K4 and K6 draw from
// sub-stream 0, first_deal from 1, K2 from 1..169, deal_stash from 2, B3
// from 65536).
#define MC_SUB_PROBE 65537u

#define MC_STAGE_CARRY 0
#define MC_STAGE_POLICY 1
#define MC_STAGE_STREET 2
#define MC_STAGE_DEAL 3
#define MC_STAGE_SETTLE 4
#define MC_STAGE_FULL 5

template <int N>
MC_HD void mc_keep_rows(int* rows) {
  for (int i = 0; i < N; ++i) mc_keep(rows[i]);
}

// Every cold row read afresh: the shared column's address is made opaque
// (its rows cannot be hoisted out of the step loop), a per-thread array's
// rows each pass through mc_keep.
template <int T>
MC_HD void mc_keep_cold(MCRowsShared<T>& rows) {
  mc_keep_ptr(rows.col);
}
template <int N>
MC_HD void mc_keep_cold(MCRowsLocal<N>& rows) {
  mc_keep_rows<N>(rows.v);
}

// _policy_prng on the next two words, with the head scan and the amount
// owed read afresh.
template <int P, int R, class Rows, class Src>
MC_HD int mc_stage_policy_raw(MCTable<P, R, Rows>& s, Src& src,
                              uint32_t fold_bits, uint32_t raise_bits) {
  constexpr int L = MCTable<P, R, Rows>::L;
  mc_keep(s.order);
  mc_keep(s.cursor);
  mc_keep_rows<L>(s.lvl);
  mc_keep_rows<P>(s.contrib);
  const uint32_t u = src.next();
  const uint32_t amt_bits = src.next();
  return mc_policy(s, mc_head<P>(s.order, s.cursor),
                   mc_street_total<L>(s.lvl), u, amt_bits, fold_bits,
                   raise_bits);
}

// One step of stage STAGE (an MC_STAGE_* value). Only that stage's code is
// instantiated, so a build of one stage compiles that stage alone.
template <int STAGE, int P, int R, class Rows, class Src>
MC_HD void mc_stage_step(MCTable<P, R, Rows>& s, Src& src, int sb, int bb,
                         uint32_t fold_bits, uint32_t raise_bits) {
  constexpr int L = MCTable<P, R, Rows>::L;
  constexpr int NC = 2 * P + 5;
  using C = MCCold<P, R>;
  if constexpr (STAGE == MC_STAGE_CARRY) {
    int hand_ct = s.rows.get(C::HAND_CT);
    mc_keep(hand_ct);
    s.rows.set(C::HAND_CT, mc_add(hand_ct, 1));
  } else if constexpr (STAGE == MC_STAGE_POLICY) {
    const int raw = mc_stage_policy_raw(s, src, fold_bits, raise_bits);
    s.street_raises = mc_add(s.street_raises, raw > 0);
  } else if constexpr (STAGE == MC_STAGE_STREET) {
    // the jnp.where of debug_kernel_compile.py:87-90: update on a raise,
    // merge on a fold, no change on a call
    const int raw = mc_stage_policy_raw(s, src, fold_bits, raise_bits);
    const int total = mc_street_total<L>(s.lvl);
    if (raw > 0)
      s.overflow |= (int)mc_street_update<L>(s.lvl, s.ln,
                                             mc_add(mc_max(raw, 0), total));
    else if (raw < 0)
      mc_street_merge<P, L>(s.lvl, s.ln, s.contrib);
  } else if constexpr (STAGE == MC_STAGE_DEAL) {
    int cards[NC];
    mc_sample_cards<NC>(src, nullptr, 0, cards);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      s.rows.set(C::HOLE0 + p, cards[p]);
      s.rows.set(C::HOLE1 + p, cards[P + p]);
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) s.rows.set(C::BOARD + i, cards[2 * P + i]);
  } else if constexpr (STAGE == MC_STAGE_SETTLE) {
    // the payout of every pot row added to the stacks, pots kept (no
    // clearing): the settle pass's payout half
    mc_keep_cold(s.rows);
    mc_keep(s.in_hand);
    mc_settle_pass<P, R, true>(s, MCDealArray{nullptr}, sb, bb);
  } else {
    static_assert(STAGE == MC_STAGE_FULL, "stage");
    // _engine_step at DEFER = 1: two policy words and 2P + 5 card words
    // every step, whatever the table's state
    const uint32_t u = src.next();
    const uint32_t amt_bits = src.next();
    int cards[NC];
    mc_sample_cards<NC>(src, nullptr, 0, cards);
    if (s.order) {
      const int head = mc_head<P>(s.order, s.cursor);
      const int total = mc_street_total<L>(s.lvl);
      mc_step_nosettle(
          s, mc_policy(s, head, total, u, amt_bits, fold_bits, raise_bits),
          head, total);
    }
    mc_settle_pass(s, MCDealArray{cards}, sb, bb);
  }
}
