// The policy net inside the engine, as scalar code for one thread
// (ops/cuda_net.py).
//
// A transcription of montecarlo_tpu/ops/pallas_engine.py: _features
// (:1008) and _masked_suit_masks (:990), _mlp_logits (:1105),
// _gumbel_pick (:1078), _argmax_pick (:1095), _net_action (:1123) and the
// kernel bodies of _make_net_kernel (:1171), banked and per candidate.
//
// Banks. The TPU joins B nets into one block-diagonal MLP B times wider
// (_stack_weights_league) and selects the acting seat's logit group. Here
// the B nets lie side by side, each in the flat layout below, and a
// decision runs only the acting seat's bank: the wide form's other terms
// are exact zeros, so the logits are the same function.
//
// Float order. The kernel must give the plain version's logits bit for
// bit, or a pick flips somewhere among ~10^8 decisions and the integer
// states part. So every float operation here rounds once (mc_fadd,
// mc_fmul, mc_fdiv: __fadd_rn and friends, never an FMA), each quotient is
// a correctly rounded division, and each dense layer sums bias first and
// then the products of input 0, 1, ... in order — the order of
// models/policy_net.py:_dense. logf is libdevice's (no fast math).
#pragma once

#include "engine.cuh"

#define MC_NUM_FEATURES 24
#define MC_HIDDEN 64
#define MC_NUM_ACTIONS 4
#define MC_NET_SLOT_WORDS (2 + MC_NUM_ACTIONS)
#define MC_PROBE_ROWS (MC_NUM_FEATURES + 2 * MC_NUM_ACTIONS)

// The flat weight buffer (ops/cuda_net.py:WEIGHT_SHAPES): w1 [24, 64], b1,
// w2 [64, 64], b2, w3 [64, 4], b3, row-major, [in, out].
#define MC_W1 0
#define MC_B1 (MC_W1 + MC_NUM_FEATURES * MC_HIDDEN)
#define MC_W2 (MC_B1 + MC_HIDDEN)
#define MC_B2 (MC_W2 + MC_HIDDEN * MC_HIDDEN)
#define MC_W3 (MC_B2 + MC_HIDDEN)
#define MC_B3 (MC_W3 + MC_HIDDEN * MC_NUM_ACTIONS)
#define MC_NET_WEIGHTS (MC_B3 + MC_NUM_ACTIONS)
static_assert(MC_NET_WEIGHTS == 6020, "weights of the 24-64-64-4 MLP");
// Banks a block holds in shared memory: 9 x 24,080 bytes fit the 227 KB
// (232,448 bytes) a block may use.
#define MC_MAX_BANKS 9

// The weights of the bank that plays the seat acting at play-order
// position `head`: seat (button + head) mod P plays bank
// (bank_map >> 4 seat) & 15 (seat_to_bank, four bits a seat).
template <int P, int R, class Rows>
MC_HD const float* mc_bank(const MCTable<P, R, Rows>& s, int head,
                           const float* w, unsigned long long bank_map) {
  const int seat =
      mc_floormod(s.rows.get(MCCold<P, R>::BUTTON) + head, P);
  return w + (int)((bank_map >> (4 * seat)) & 15u) * MC_NET_WEIGHTS;
}

// Candidate c's slice of a population launch: its n_tables tables of the
// packed state and its n_banks banks of weights. The offsets reach past
// 2^31 elements, so they are computed in 64 bits.
template <int P, int R>
MC_HD long long mc_candidate_state(long long c, int n_tables) {
  return c * n_tables * mc_fields<P, R>();
}
MC_HD long long mc_candidate_weights(long long c, int n_banks) {
  return c * n_banks * MC_NET_WEIGHTS;
}

// The 24 decision features of position `head` (_features), into f.
template <int P, int R, class Rows>
MC_HD void mc_features(const MCTable<P, R, Rows>& s, int head, int bb,
                       float* f) {
  constexpr int L = MCTable<P, R, Rows>::L;
  using C = MCCold<P, R>;
  const int total = mc_street_total<L>(s.lvl);
  int pot = total;
  for (int row = 0; row < 4 * L; ++row)
    pot = mc_add(pot, s.rows.get(C::POT_AMT + row));
  const int needed = mc_sub(total, mc_sel<P>(s.contrib, head));
  const int stage = s.stage;
  const int n_comm = stage == 0 ? 0 : stage == 1 ? 3 : stage == 2 ? 4 : 5;

  // made-hand key of the hole cards and the revealed board
  const int hole0 = s.rows.get(C::HOLE0 + head),
            hole1 = s.rows.get(C::HOLE1 + head);
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  mc_add_card(m, hole0);
  mc_add_card(m, hole1);
  for (int i = 0; i < n_comm; ++i) mc_add_card(m, s.rows.get(C::BOARD + i));
  const int key = mc_eval_key(m[0], m[1], m[2], m[3]);

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

// out[j] = b[j] + x[0] w[0][j] + x[1] w[1][j] + ..., in that order.
template <int N_IN, int N_OUT, bool RELU>
MC_HD void mc_dense(const float* w, const float* b, const float* x,
                    float* out) {
#ifdef __CUDA_ARCH__
#pragma unroll 1
#endif
  for (int j = 0; j < N_OUT; ++j) {
    float acc = b[j];
    for (int i = 0; i < N_IN; ++i)
      acc = mc_fadd(acc, mc_fmul(x[i], w[i * N_OUT + j]));
    out[j] = RELU ? (acc > 0.f ? acc : 0.f) : acc;
  }
}

// The MLP (_mlp_logits): 24 -> 64 -> 64 -> 4, ReLU. A call of its own on
// the card: inlined, its float chains and the engine's state share one
// register allocation, and K6 ran 1.20x slower (B8 1.21x, with two banks
// 1.30x; an A/B on an H100, scripts/ab_engine.py).
MC_HD_CALL void mc_mlp_logits(const float* w, const float* x, float* logits) {
  float h1[MC_HIDDEN], h2[MC_HIDDEN];
  mc_dense<MC_NUM_FEATURES, MC_HIDDEN, true>(w + MC_W1, w + MC_B1, x, h1);
  mc_dense<MC_HIDDEN, MC_HIDDEN, true>(w + MC_W2, w + MC_B2, h1, h2);
  mc_dense<MC_HIDDEN, MC_NUM_ACTIONS, false>(w + MC_W3, w + MC_B3, h2,
                                             logits);
}

// Gumbel noise of one word (_gumbel_pick): u = (bits >> 8) 2^-24, exact;
// log(-log(max(u, 1e-12))) is returned for the caller to subtract.
MC_HD float mc_neg_gumbel(uint32_t bits) {
  float u = mc_fmul((float)(int)(bits >> 8), 5.9604644775390625e-08f);
  return logf(-logf(u > 1e-12f ? u : 1e-12f));
}

// Features and masked logits of the acting position; with `gbits`, the
// Gumbel scores logits + g in place of the logits.
template <int P, int R, class Rows>
MC_HD void mc_net_scores(const MCTable<P, R, Rows>& s, int head, int bb,
                         const float* w, const uint32_t* gbits, float* f,
                         float* lg) {
  mc_features(s, head, bb, f);
  mc_mlp_logits(w, f, lg);
  // folding with nothing owed is masked (policy_net.py:80-81)
  const int needed = mc_sub(mc_street_total<MCTable<P, R, Rows>::L>(s.lvl),
                            mc_sel<P>(s.contrib, head));
  lg[0] = mc_fadd(lg[0], needed == 0 ? -1e9f : 0.f);
  if (gbits)
    for (int a = 0; a < MC_NUM_ACTIONS; ++a)
      lg[a] = mc_fsub(lg[a], mc_neg_gumbel(gbits[a]));
}

// The net's raw action (_net_action): argmax of the masked logits, or the
// Gumbel pick on `gbits`; the first index attaining the max; menu fold /
// call / 2bb / max(pot + needed, 2bb).
template <int P, int R, class Rows>
MC_HD int mc_net_action(const MCTable<P, R, Rows>& s, int head, int bb,
                        const float* w, const uint32_t* gbits) {
  constexpr int L = MCTable<P, R, Rows>::L;
  using C = MCCold<P, R>;
  float f[MC_NUM_FEATURES], lg[MC_NUM_ACTIONS];
  mc_net_scores(s, head, bb, w, gbits, f, lg);
  int idx = 0;
  for (int a = 1; a < MC_NUM_ACTIONS; ++a)
    if (lg[a] > lg[idx]) idx = a;
  if (idx == 0) return -1;
  if (idx == 1) return 0;
  const int small = 2 * bb;
  if (idx == 2) return small;
  const int total = mc_street_total<L>(s.lvl);
  int pot = total;
  for (int row = 0; row < 4 * L; ++row)
    pot = mc_add(pot, s.rows.get(C::POT_AMT + row));
  return mc_max(mc_add(pot, mc_sub(total, mc_sel<P>(s.contrib, head))),
                small);
}

// K5's work for one table: n_steps fused steps, every seat playing its
// bank's net by argmax; hand h > 0 is dealt from stash row min(h, hmax - 1).
template <int P, int R, class Rows>
MC_HD void mc_run_net_det(MCTable<P, R, Rows>& s, const int* stash,
                          long long stride, int n_steps, int hmax, int sb,
                          int bb, const float* w,
                          unsigned long long bank_map) {
  constexpr int L = MCTable<P, R, Rows>::L;
  using C = MCCold<P, R>;
  for (int i = 0; i < n_steps; ++i) {
    // a table with no head is a no-op this step, whatever it would play
    if (s.order) {
      const int head = mc_head<P>(s.order, s.cursor);
      const int raw = mc_net_action(s, head, bb,
                                    mc_bank(s, head, w, bank_map), nullptr);
      mc_step_nosettle(s, raw, head, mc_street_total<L>(s.lvl));
    }
    if (s.wait) {
      const int hand_ptr = mc_min(s.rows.get(C::HAND_CT) + 1, hmax - 1);
      mc_settle_pass(s, MCDealStash{stash, stride, hand_ptr}, sb, bb);
    }
  }
}

// K6's work for one table: per iteration, `defer` slots of six words (u,
// amt_bits, four Gumbel words; all drawn whoever acts), then 2P+5 deal
// words and a settle pass. Seats whose bit is set in net_seats play their
// bank's net, the others the random policy. Returns the count of net
// decisions.
template <int P, int R, class Rows>
MC_HD int mc_run_net_eval(MCTable<P, R, Rows>& s, MCWords& src, int n_steps,
                          int defer, int sb, int bb, int ss, int net_seats,
                          bool reset_stacks, uint32_t fold_bits,
                          uint32_t raise_bits, const float* w,
                          unsigned long long bank_map) {
  constexpr int NC = 2 * P + 5;
  constexpr int L = MCTable<P, R, Rows>::L;
  using C = MCCold<P, R>;
  int n_net = 0;
  for (int it = 0; it < n_steps / defer; ++it) {
    for (int k = 0; k < defer; ++k) {
      uint32_t words[MC_NET_SLOT_WORDS];
      for (int i = 0; i < MC_NET_SLOT_WORDS; ++i) words[i] = src.next();
      if (!s.order) continue;  // no head: the slot is a no-op
      const int head = mc_head<P>(s.order, s.cursor);
      const int total = mc_street_total<L>(s.lvl);
      int raw = mc_policy(s, head, total, words[0], words[1], fold_bits,
                          raise_bits);
      if ((net_seats >> mc_floormod(s.rows.get(C::BUTTON) + head, P)) & 1) {
        raw = mc_net_action(s, head, bb, mc_bank(s, head, w, bank_map),
                            words + 2);
        ++n_net;
      }
      mc_step_nosettle(s, raw, head, total);
    }
    int deal[NC];
    mc_sample_cards<NC>(src, nullptr, 0, deal);
    mc_settle_pass(s, MCDealArray{deal}, sb, bb, ss, reset_stacks);
  }
  return n_net;
}
