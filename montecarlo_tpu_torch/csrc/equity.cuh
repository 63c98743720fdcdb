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
