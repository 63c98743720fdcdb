// The K6 split's block body (ops/cuda_net_split.py): K6's work for a block
// of tables (net.cuh, mc_run_net_eval) with one piece of the net decision
// stubbed, the variant V (an MC_NET_SPLIT_* value) a template parameter.
//
// scripts/exp_net_split.py:70-95 monkeypatches one module-level piece of
// the JAX net kernel's body at a time and times the whole kernel again.
// The variants, as the script's:
//   full            K6 itself;
//   stub_gumbel     the pick is the argmax of the masked logits
//                   (_gumbel_pick -> first index of the max): no Gumbel
//                   words are drawn and no logarithm is taken;
//   stub_feat_eval  the features' hand key is the first suit-mask word of
//                   the hole cards and the revealed board (eval_masks_impl
//                   -> m0);
//   stub_features   every feature 0 (_features -> zeros; the script's 20
//                   predate the four raise features): the MLP still runs,
//                   on zero rows;
//   stub_net        a net seat always checks or calls (_net_action -> 0):
//                   no block phase, no Gumbel words.
// and one control that stubs nothing and returns K6's state:
//   feat_copy       the staging and features copies that stub_features and
//                   stub_feat_eval run, with K6's features and key in them:
//                   the baseline of their savings.
// A stub removes its words from the stream, as the JAX stubs draw none: a
// slot reads 2 + 4 words (u, amt_bits, four Gumbel words), 2 under
// stub_gumbel and stub_net, then an iteration's 2P + 5 deal words, in
// order from the table's stream.
//
// Each variant is composed from net.cuh's and engine.cuh's device
// functions (mc_policy, mc_net_logits, mc_mlp_rows, mc_net_pick,
// mc_step_nosettle, mc_settle_pass, ...). The two pieces that hold a
// stubbed part inside them are written out here for the variants that
// change it: the staging of the features (stub_features) and the features
// with the first mask word as the key (stub_feat_eval); feat_copy runs the
// same copies with nothing stubbed, so that their own code shape is timed
// apart from the stubs. net.cuh is not changed, so K5, K6, B7 and B8 keep
// their builds.
#pragma once

#include "net.cuh"

#define MC_NET_SPLIT_FULL 0
#define MC_NET_SPLIT_STUB_GUMBEL 1
#define MC_NET_SPLIT_STUB_FEAT_EVAL 2
#define MC_NET_SPLIT_STUB_FEATURES 3
#define MC_NET_SPLIT_STUB_NET 4
#define MC_NET_SPLIT_FEAT_COPY 5

// Words a slot draws under variant V.
template <int V>
MC_HD constexpr int mc_net_split_slot_words() {
  return V == MC_NET_SPLIT_STUB_GUMBEL || V == MC_NET_SPLIT_STUB_NET
             ? 2
             : MC_NET_SLOT_WORDS;
}

// mc_features with the made-hand key the first suit-mask word
// (stub_feat_eval) or K6's (feat_copy).
template <int V, int P, int R, class Rows>
MC_HD void mc_split_features_copy(const MCTable<P, R, Rows>& s, int head,
                                  int bb, float* f) {
  constexpr int L = MCTable<P, R, Rows>::L;
  using C = MCCold<P, R>;
  const int total = mc_street_total<L>(s.lvl);
  int pot = total;
  for (int row = 0; row < 4 * L; ++row)
    pot = mc_add(pot, s.rows.get(C::POT_AMT + row));
  const int needed = mc_sub(total, mc_sel<P>(s.contrib, head));
  const int stage = s.stage;
  const int n_comm = stage == 0 ? 0 : stage == 1 ? 3 : stage == 2 ? 4 : 5;

  const int hole0 = s.rows.get(C::HOLE0 + head),
            hole1 = s.rows.get(C::HOLE1 + head);
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  mc_add_card(m, hole0);
  mc_add_card(m, hole1);
  for (int i = 0; i < n_comm; ++i) mc_add_card(m, s.rows.get(C::BOARD + i));
  const int key = V == MC_NET_SPLIT_STUB_FEAT_EVAL
                      ? (int)m[0]
                      : mc_eval_key(m[0], m[1], m[2], m[3]);

  const float fP = (float)P;
  const float pot_f = (float)pot, needed_f = (float)needed;
  const int full = (1 << P) - 1;
  const int sr = s.street_raises;
  for (int k = 0; k < 4; ++k) f[k] = stage == k ? 1.f : 0.f;
  f[4] = mc_fdiv((float)n_comm, 5.f);
  f[5] = mc_fdiv(pot_f, 100.f * fP);
  f[6] = mc_fdiv(needed_f, 100.f);
  f[7] = mc_fdiv((float)mc_sel<P>(s.stacks, head), 100.f);
  f[8] = needed == 0 ? 1.f : 0.f;
  f[9] = mc_fdiv((float)mc_popc((uint32_t)(s.in_hand & full)), fP);
  f[10] = mc_fdiv((float)mc_popc((uint32_t)(s.to_act & full)), fP);
  f[11] = mc_fdiv((float)head, fP);
  const float odds_den = mc_fadd(needed_f, pot_f);
  f[12] = mc_fdiv(pot_f, odds_den > 1.f ? odds_den : 1.f);
  f[13] = mc_fdiv(mc_fdiv(needed_f, (float)bb), 10.f);
  f[14] = mc_fdiv((float)(key >> MC_CAT_SHIFT), 8.f);
  f[15] = mc_fdiv((float)((key >> 16) & 0xF), 14.f);
  f[16] = mc_fdiv((float)(2 + mc_floormod(hole0, 13)), 14.f);
  f[17] = mc_fdiv((float)(2 + mc_floormod(hole1, 13)), 14.f);
  f[18] = ((hole0 * 5) >> 6) == ((hole1 * 5) >> 6) ? 1.f : 0.f;
  f[19] = mc_floormod(hole0, 13) == mc_floormod(hole1, 13) ? 1.f : 0.f;
  f[20] = mc_fdiv((float)sr, 4.f);
  f[21] = sr > 0 ? 1.f : 0.f;
  f[22] = sr > 0 ? mc_fdiv((float)mc_floormod(s.last_raiser - head, P), fP)
                 : 0.f;
  f[23] = sr >= 2 ? 1.f : 0.f;
}

// mc_stage_rows with each staged row's features those of variant V: zero
// (stub_features), the first-word key's (stub_feat_eval) or K6's
// (feat_copy).
template <int V, int P, int R, class Lanes>
MC_HD int mc_split_stage_rows(const Lanes& blk, const MCNetShared& sh,
                              int n_banks, int bb) {
  MC_EACH_LANE(t) {
    auto& L = blk[t];
    const int lane = t % 32;
    int rank = 0;
    for (int b = 0; b < n_banks; ++b) {
      const uint32_t m = blk.ballot(t, b);
      if (L.key == b) rank = mc_popc(m & ((1u << lane) - 1u));
      if (lane == 0) sh.cnt[t / 32 * MC_MAX_BANKS + b] = mc_popc(m);
    }
    L.row = rank;
  }
  mc_block_sync();
  int n_rows = 0;
  MC_EACH_LANE(t) {
    auto& L = blk[t];
    n_rows = 0;
    for (int b = 0; b < n_banks; ++b) n_rows += mc_bank_rows(sh, b);
    if (L.key < 0) continue;
    for (int b = 0; b < L.key; ++b) L.row += mc_bank_rows(sh, b);
    for (int w = 0; w < t / 32; ++w) L.row += sh.cnt[w * MC_MAX_BANKS + L.key];
    float f[MC_NUM_FEATURES];
    if constexpr (V == MC_NET_SPLIT_STUB_FEATURES) {
#pragma unroll
      for (int i = 0; i < MC_NUM_FEATURES; ++i) f[i] = 0.f;
    } else {
      mc_split_features_copy<V>(L.s, L.head, bb, f);
    }
    float* x = sh.x + L.row * MC_NET_X_STRIDE;
#pragma unroll
    for (int i = 0; i < MC_NUM_FEATURES; i += 4) mc_st4(x + i, f + i);
  }
  mc_block_sync();
  return n_rows;
}

// Phases (a) and (b) of a slot under variant V (mc_net_logits).
template <int V, int P, int R, class Lanes>
MC_HD void mc_split_net_logits(const Lanes& blk, const MCNetShared& sh,
                               int n_banks, int bb) {
  if constexpr (V == MC_NET_SPLIT_STUB_FEATURES ||
                V == MC_NET_SPLIT_STUB_FEAT_EVAL ||
                V == MC_NET_SPLIT_FEAT_COPY) {
    if (mc_split_stage_rows<V, P, R>(blk, sh, n_banks, bb) > 0)
      mc_mlp_rows(sh, n_banks);
  } else {
    mc_net_logits<P, R>(blk, sh, n_banks, bb);
  }
}

// K6's work for a block of tables (mc_run_net_eval) under variant V.
template <int V, int P, int R, class Lanes>
MC_HD void mc_split_run_net_eval(const Lanes& blk, const MCNetShared& sh,
                                 int n_steps, int defer, int sb, int bb,
                                 int ss, int net_seats, bool reset_stacks,
                                 uint32_t fold_bits, uint32_t raise_bits,
                                 int n_banks, unsigned long long bank_map) {
  constexpr int NC = 2 * P + 5;
  constexpr int L = mc_layers<R>();
  constexpr int SW = mc_net_split_slot_words<V>();
  for (int it = 0; it < n_steps / defer; ++it) {
    for (int k = 0; k < defer; ++k) {
      // (a) the slot's words, the random policy's action, the net's key
      MC_EACH_LANE(t) {
        auto& Ln = blk[t];
        for (int i = 0; i < SW; ++i) Ln.words[i] = Ln.src.next();
        Ln.key = -1;
        if (!Ln.s.order) continue;
        Ln.head = mc_head<P>(Ln.s.order, Ln.s.cursor);
        Ln.total = mc_street_total<L>(Ln.s.lvl);
        Ln.raw = mc_policy(Ln.s, Ln.head, Ln.total, Ln.words[0],
                           Ln.words[1], fold_bits, raise_bits);
        const int seat = mc_seat_of(Ln.s, Ln.head);
        if ((net_seats >> seat) & 1) {
          Ln.key = mc_bank_of(seat, bank_map);
          ++Ln.n_net;
        }
      }
      // (b)
      if constexpr (V != MC_NET_SPLIT_STUB_NET)
        mc_split_net_logits<V, P, R>(blk, sh, n_banks, bb);
      // (c) the net lanes pick; every lane with a head steps
      MC_EACH_LANE(t) {
        auto& Ln = blk[t];
        if (!Ln.s.order) continue;
        if (Ln.key >= 0) {
          const float* logits = sh.x + Ln.row * MC_NET_X_STRIDE;
          if constexpr (V == MC_NET_SPLIT_STUB_NET)
            Ln.raw = 0;
          else if constexpr (V == MC_NET_SPLIT_STUB_GUMBEL)
            Ln.raw = mc_net_pick(Ln.s, Ln.head, Ln.total, bb, logits,
                                 nullptr);
          else
            Ln.raw = mc_net_pick(Ln.s, Ln.head, Ln.total, bb, logits,
                                 Ln.words + 2);
        }
        mc_step_nosettle(Ln.s, Ln.raw, Ln.head, Ln.total);
      }
    }
    MC_EACH_LANE(t) {
      auto& Ln = blk[t];
      int deal[NC];
      mc_sample_cards<NC>(Ln.src, nullptr, 0, deal);
      mc_settle_pass(Ln.s, MCDealArray{deal}, sb, bb, ss, reset_stacks);
    }
  }
}
