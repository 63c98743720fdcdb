// One equity rollout (ops/cuda_equity.py), host- and device-compilable.
#pragma once

#include "evaluator.cuh"
#include "philox.cuh"

struct MCEquityParams {
  int dead[8];   // ascending dead cards (holes + known board)
  int n_dead;
  uint32_t hero[4], villain[4];  // suit masks, known board included
};

// Hand vs hand on a board missing NDRAW = 9 - n_dead cards
// (pallas_equity.py:126-142). Returns +1 hero wins, 0 tie, -1 loss.
template <int NDRAW>
MC_HD int mc_rollout_vs_hand(MCWords& src, const MCEquityParams& p) {
  int cards[NDRAW];
  mc_sample_cards<NDRAW>(src, p.dead, p.n_dead, cards);
  uint32_t m[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int t = 0; t < NDRAW; ++t) mc_add_card(m, cards[t]);
  int vh = mc_eval_cmp(m[0] | p.hero[0], m[1] | p.hero[1], m[2] | p.hero[2],
                       m[3] | p.hero[3]);
  int vv = mc_eval_cmp(m[0] | p.villain[0], m[1] | p.villain[1],
                       m[2] | p.villain[2], m[3] | p.villain[3]);
  return (vh > vv) - (vh < vv);
}

// Hero (ascending holes hd, masks hm) vs a random villain: 2 villain and 5
// board cards from the 50 live cards (pallas_equity.py:182-205).
MC_HD int mc_rollout_vs_random(MCWords& src, const int* hd,
                               const uint32_t* hm) {
  int cards[7];
  mc_sample_cards<7>(src, hd, 2, cards);
  uint32_t vm[4] = {0u, 0u, 0u, 0u}, bm[4] = {0u, 0u, 0u, 0u};
  mc_add_card(vm, cards[0]);
  mc_add_card(vm, cards[1]);
#pragma unroll
  for (int t = 2; t < 7; ++t) mc_add_card(bm, cards[t]);
  int vh = mc_eval_cmp(bm[0] | hm[0], bm[1] | hm[1], bm[2] | hm[2],
                       bm[3] | hm[3]);
  int vv = mc_eval_cmp(bm[0] | vm[0], bm[1] | vm[1], bm[2] | vm[2],
                       bm[3] | vm[3]);
  return (vh > vv) - (vh < vv);
}

// Multiway equity (pallas_equity.py:268-298): up to MC_MAX_HANDS hands in
// one pot. lcm(1..13) x 16,384 rollouts overflows the TPU kernel's int32
// shares in one program, so 12 hands is the JAX package's limit too.
#define MC_MAX_HANDS 12
// The Philox sub-stream of multiway rollouts: K1 draws from sub-stream 0
// and K2 from 1..65535 (hand h + 1), so 65536 is no other kernel's.
#define MC_SUB_MULTIWAY 65536u

// lcm(1..n): a multiway pot's shares, so that every split is exact.
MC_HD int mc_lcm_to(int n) {
  int l = 1;
  for (int i = 2; i <= n; ++i) {
    int a = l, b = i;
    while (b) {
      int r = a % b;
      a = b;
      b = r;
    }
    l = l / a * i;
  }
  return l;
}

struct MCMultiwayParams {
  int dead[2 * MC_MAX_HANDS + 5];  // ascending dead cards (holes + board)
  int n_dead, n_hands, scale;      // scale = lcm(1..n_hands)
  uint32_t hand[MC_MAX_HANDS][4];  // suit masks, known board included
};

// One rollout: draw the NDRAW = 5 - K missing board cards, rank every
// hand, and add scale / (number of winners) to each winner's share, an
// exact integer split of the pot.
template <int NDRAW>
MC_HD void mc_rollout_multiway(MCWords& src, const MCMultiwayParams& p,
                               unsigned long long* shares) {
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  if constexpr (NDRAW > 0) {
    int cards[NDRAW];
    mc_sample_cards<NDRAW>(src, p.dead, p.n_dead, cards);
#pragma unroll
    for (int t = 0; t < NDRAW; ++t) mc_add_card(m, cards[t]);
  }
  int v[MC_MAX_HANDS], vmax = 0, cnt = 0;
#pragma unroll
  for (int h = 0; h < MC_MAX_HANDS; ++h)
    if (h < p.n_hands) {
      v[h] = mc_eval_cmp(m[0] | p.hand[h][0], m[1] | p.hand[h][1],
                         m[2] | p.hand[h][2], m[3] | p.hand[h][3]);
      vmax = h ? mc_max(vmax, v[h]) : v[h];
    }
#pragma unroll
  for (int h = 0; h < MC_MAX_HANDS; ++h)
    if (h < p.n_hands) cnt += v[h] == vmax;
  const unsigned long long share = (unsigned long long)(p.scale / cnt);
#pragma unroll
  for (int h = 0; h < MC_MAX_HANDS; ++h)
    if (h < p.n_hands && v[h] == vmax) shares[h] += share;
}
