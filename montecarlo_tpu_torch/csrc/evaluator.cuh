// Device forms of the hand keys (ops/evaluator.py).
//
// Four 15-bit suit masks (bit r = rank r, 2..14) -> mc_eval_cmp, the
// comparison key (eval_masks_cmp_impl, itself
// montecarlo_tpu/ops/evaluator.py:186-265), whose order and ties equal the
// packed reference key's; or mc_eval_key, the packed key itself
// (eval_masks_impl: category << 20 | five rank nibbles), which the policy
// features read. Scalar selects on registers: ~100 integer ops, no memory
// traffic.
#pragma once

#include "common.cuh"

// Ranks of the hand-value categories (handval.py).
#define MC_CAT_SHIFT 20
#define MC_CAT_PAIR 1
#define MC_CAT_TWO_PAIR 2
#define MC_CAT_TRIPS 3
#define MC_CAT_STRAIGHT 4
#define MC_CAT_FLUSH 5
#define MC_CAT_FULL_HOUSE 6
#define MC_CAT_QUADS 7
#define MC_CAT_STRAIGHT_FLUSH 8

MC_HD uint32_t mc_bit(int pos) { return pos >= 0 ? (1u << pos) : 0u; }

// Top rank of the best 5-long run of set bits, else -1 (no wheel).
MC_HD int mc_run5_top(uint32_t m) {
  uint32_t r = m & (m >> 1) & (m >> 2) & (m >> 3) & (m >> 4);
  return r ? mc_msb(r) + 4 : -1;
}

// Clear lowest set bits until at most n remain (bounded like the jnp form).
MC_HD uint32_t mc_keep_top(uint32_t m, int n, int max_clears) {
  for (int i = 0; i < max_clears; ++i)
    if (mc_popc(m) > n) m &= m - 1;
  return m;
}

MC_HD int mc_eval_cmp(uint32_t m0, uint32_t m1, uint32_t m2, uint32_t m3) {
  uint32_t present = m0 | m1 | m2 | m3;
  uint32_t c2p = (m0 & m1) | (m0 & m2) | (m0 & m3) | (m1 & m2) | (m1 & m3) |
                 (m2 & m3);
  uint32_t c3p = (m0 & m1 & m2) | (m0 & m1 & m3) | (m0 & m2 & m3) |
                 (m1 & m2 & m3);
  uint32_t c4 = m0 & m1 & m2 & m3;
  uint32_t trips = c3p & ~c4;
  uint32_t pairs = c2p & ~c3p;

  int straight_top = mc_run5_top(present);
  uint32_t fmask = (mc_popc(m0) >= 5 ? m0 : 0u) | (mc_popc(m1) >= 5 ? m1 : 0u) |
                   (mc_popc(m2) >= 5 ? m2 : 0u) | (mc_popc(m3) >= 5 ? m3 : 0u);
  int sf_top = mc_run5_top(fmask);

  int q = mc_max(mc_msb(c4), 0);
  int qk = mc_max(mc_msb(present & ~mc_bit(q)), 0);
  int t_fh = mc_max(mc_msb(trips), 0);
  int p_fh = mc_max(mc_msb((trips | pairs) & ~mc_bit(t_fh)), 0);

  if (sf_top >= 0) return (MC_CAT_STRAIGHT_FLUSH << 19) | sf_top;
  if (c4) return (MC_CAT_QUADS << 19) | (q << 4) | qk;
  if (trips && (pairs || mc_popc(trips) >= 2))
    return (MC_CAT_FULL_HOUSE << 19) | (t_fh << 4) | p_fh;
  if (fmask) return (MC_CAT_FLUSH << 19) | (int)mc_keep_top(fmask, 5, 2);
  if (straight_top >= 0) return (MC_CAT_STRAIGHT << 19) | straight_top;
  if (trips)
    return (MC_CAT_TRIPS << 19) | (t_fh << 15) |
           (int)mc_keep_top(present & ~mc_bit(t_fh), 2, 2);
  if (mc_popc(pairs) >= 2) {
    uint32_t top2 = mc_keep_top(pairs, 2, 1);
    return (MC_CAT_TWO_PAIR << 19) | (int)(top2 << 4) |
           mc_max(mc_msb(present & ~top2), 0);
  }
  if (pairs) {
    int p1 = mc_msb(pairs);
    return (MC_CAT_PAIR << 19) | (p1 << 15) |
           (int)mc_keep_top(present & ~mc_bit(p1), 3, 2);
  }
  return (int)mc_keep_top(present, 5, 2);
}

// The k highest set-bit positions of m, descending, 0-padded (_top_ranks).
MC_HD void mc_top_ranks(uint32_t m, int k, int* out) {
  for (int i = 0; i < k; ++i) {
    int p = mc_msb(m);
    out[i] = mc_max(p, 0);
    m &= ~mc_bit(p);
  }
}

// The packed key (eval_masks_impl): category << 20 | r0 << 16 | r1 << 12
// | r2 << 8 | r3 << 4 | r4, for 0 to 7 cards.
MC_HD int mc_eval_key(uint32_t m0, uint32_t m1, uint32_t m2, uint32_t m3) {
  uint32_t present = m0 | m1 | m2 | m3;
  uint32_t c2p = (m0 & m1) | (m0 & m2) | (m0 & m3) | (m1 & m2) | (m1 & m3) |
                 (m2 & m3);
  uint32_t c3p = (m0 & m1 & m2) | (m0 & m1 & m3) | (m0 & m2 & m3) |
                 (m1 & m2 & m3);
  uint32_t c4 = m0 & m1 & m2 & m3;
  uint32_t trips = c3p & ~c4;
  uint32_t pairs = c2p & ~c3p;
  int straight_top = mc_run5_top(present);
  uint32_t fmask = (mc_popc(m0) >= 5 ? m0 : 0u) | (mc_popc(m1) >= 5 ? m1 : 0u) |
                   (mc_popc(m2) >= 5 ? m2 : 0u) | (mc_popc(m3) >= 5 ? m3 : 0u);
  int sf_top = mc_run5_top(fmask);
  int t_fh = mc_max(mc_msb(trips), 0);

  int cat, r[5];
  if (sf_top >= 0) {
    cat = MC_CAT_STRAIGHT_FLUSH;
    for (int i = 0; i < 5; ++i) r[i] = sf_top - i;
  } else if (c4) {
    cat = MC_CAT_QUADS;
    int q = mc_max(mc_msb(c4), 0);
    r[0] = r[1] = r[2] = r[3] = q;
    r[4] = mc_max(mc_msb(present & ~mc_bit(q)), 0);
  } else if (trips && (pairs || mc_popc(trips) >= 2)) {
    cat = MC_CAT_FULL_HOUSE;
    r[0] = r[1] = r[2] = t_fh;
    r[3] = r[4] = mc_max(mc_msb((trips | pairs) & ~mc_bit(t_fh)), 0);
  } else if (fmask) {
    cat = MC_CAT_FLUSH;
    mc_top_ranks(fmask, 5, r);
  } else if (straight_top >= 0) {
    cat = MC_CAT_STRAIGHT;
    for (int i = 0; i < 5; ++i) r[i] = straight_top - i;
  } else if (trips) {
    cat = MC_CAT_TRIPS;
    r[0] = r[1] = r[2] = t_fh;
    mc_top_ranks(present & ~mc_bit(t_fh), 2, r + 3);
  } else if (mc_popc(pairs) >= 2) {
    cat = MC_CAT_TWO_PAIR;
    int hl[2];
    mc_top_ranks(pairs, 2, hl);
    r[0] = r[1] = hl[0];
    r[2] = r[3] = hl[1];
    r[4] = mc_max(mc_msb(present & ~mc_bit(hl[0]) & ~mc_bit(hl[1])), 0);
  } else if (pairs) {
    cat = MC_CAT_PAIR;
    int p1 = mc_max(mc_msb(pairs), 0);
    r[0] = r[1] = p1;
    mc_top_ranks(present & ~mc_bit(p1), 3, r + 2);
  } else {
    cat = 0;  // high card
    mc_top_ranks(present, 5, r);
  }
  int key = cat << MC_CAT_SHIFT;
  for (int i = 0; i < 5; ++i) key |= r[i] << (16 - 4 * i);
  return key;
}

// Four suit masks of a list of card ids: suit = id / 13, bit = 2 + id % 13.
MC_HD void mc_add_card(uint32_t m[4], int card) {
  int suit = (card * 5) >> 6;  // == card / 13 for 0 <= card < 64
  m[suit] |= 1u << (card - 13 * suit + 2);
}
