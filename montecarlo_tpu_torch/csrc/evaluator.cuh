// Device forms of the hand keys (ops/evaluator.py).
//
// Four 15-bit suit masks (bit r = rank r, 2..14) -> mc_eval_cmp, the
// comparison key (eval_masks_cmp_impl, itself
// montecarlo_tpu/ops/evaluator.py:186-265), whose order and ties equal the
// packed reference key's; or mc_eval_key, the packed key itself
// (eval_masks_impl: category << 20 | five rank nibbles), which the policy
// features read; or mc_rank7, a key of other values in mc_eval_cmp's
// order for exactly 7 cards, which K1 and B3 compare. Scalar selects on
// registers: ~100 integer ops, no memory traffic.
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

// The highest set bit of m as a mask, for m with at most three set bits.
MC_HD uint32_t mc_top1_of3(uint32_t m) {
  const uint32_t m1 = m & (m - 1u), m2 = m1 & (m1 - 1u);
  return m2 ? m2 : (m1 ? m1 : m);
}

// A key in the order of mc_eval_cmp, for exactly 7 cards (the equity
// kernels, which only compare keys): category << 28 | primary << 13 |
// secondary, each part a rank mask (bit r = rank r) or the top bit of a
// run, unsigned. The same categories and payloads as mc_eval_cmp, with no
// leading-bit search and three population counts: the top rank of a mask
// of at most three ranks by clearing low bits (mc_top1_of3), a straight's
// top as the top bit of its run of run-starts (with 7 cards a hand has one
// run), the fourth suit's count as 7 less the other three, and the top n
// ranks of a mask whose count the category fixes by clearing the lowest
// bits (high card: 7 ranks; pair: 5 besides the pair; trips: 4 besides
// the trips). Two hands compare as their mc_eval_cmp keys do.
MC_HD uint32_t mc_rank7(uint32_t m0, uint32_t m1, uint32_t m2, uint32_t m3) {
  const uint32_t m012 = m0 | m1 | m2, present = m012 | m3;
  const uint32_t all012 = m0 & m1 & m2;
  const uint32_t maj012 = (m0 & m1) | (m0 & m2) | (m1 & m2);
  const uint32_t c4 = all012 & m3;
  const uint32_t c3p = all012 | (maj012 & m3);
  const uint32_t trips = c3p & ~c4;
  const uint32_t pairs = (maj012 | (m012 & m3)) & ~c3p;
  const int n0 = mc_popc(m0), n1 = mc_popc(m1), n2 = mc_popc(m2);
  const int n3 = 7 - n0 - n1 - n2;
  const uint32_t fmask = n0 >= 5   ? m0
                         : n1 >= 5 ? m1
                         : n2 >= 5 ? m2
                         : n3 >= 5 ? m3
                                   : 0u;
  const int nf = mc_max(mc_max(n0, n1), mc_max(n2, n3));
  uint32_t fl = fmask;  // the flush's top 5 of 5 to 7
  fl = nf > 5 ? fl & (fl - 1u) : fl;
  fl = nf > 6 ? fl & (fl - 1u) : fl;
  const uint32_t run = present & (present >> 1) & (present >> 2) &
                       (present >> 3) & (present >> 4);
  const uint32_t frun = fmask & (fmask >> 1) & (fmask >> 2) & (fmask >> 3) &
                        (fmask >> 4);
  const uint32_t t2 = trips & (trips - 1u);  // the higher of two trips
  const uint32_t t = t2 ? t2 : trips;
  const uint32_t rest = (trips | pairs) & ~t;  // at most two ranks
  const uint32_t rest2 = rest & (rest - 1u);
  const uint32_t p2 = pairs & (pairs - 1u), p3 = p2 & (p2 - 1u);
  const uint32_t top2 = p3 ? p2 : pairs;  // two pair: the top two of 2 or 3
  uint32_t tk = present & ~trips;  // trips: the top 2 of 4
  tk &= tk - 1u;
  tk &= tk - 1u;
  uint32_t pk = present & ~pairs;  // pair: the top 3 of 5
  pk &= pk - 1u;
  pk &= pk - 1u;
  uint32_t hk = present;  // high card: the top 5 of 7
  hk &= hk - 1u;
  hk &= hk - 1u;

  uint32_t key = hk;
  key = pairs ? (uint32_t)MC_CAT_PAIR << 28 | pairs << 13 | pk : key;
  key = p2 ? (uint32_t)MC_CAT_TWO_PAIR << 28 | top2 << 13 |
                 mc_top1_of3(present & ~top2)
           : key;
  key = trips ? (uint32_t)MC_CAT_TRIPS << 28 | trips << 13 | tk : key;
  key = run ? (uint32_t)MC_CAT_STRAIGHT << 28 | (run & ~(run >> 1)) : key;
  key = fmask ? (uint32_t)MC_CAT_FLUSH << 28 | fl : key;
  key = trips && (pairs || t2)
            ? (uint32_t)MC_CAT_FULL_HOUSE << 28 | t << 13 |
                  (rest2 ? rest2 : rest)
            : key;
  key = c4 ? (uint32_t)MC_CAT_QUADS << 28 | c4 << 13 |
                 mc_top1_of3(present & ~c4)
           : key;
  return frun ? (uint32_t)MC_CAT_STRAIGHT_FLUSH << 28 | (frun & ~(frun >> 1))
              : key;
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

// The equity kernels' form of the suit masks (K1, B3): two packed planes
// (pallas_equity.py:96-120), suits 0 and 1 in bits 2..14 and 18..30 of
// plane lo, suits 2 and 3 likewise in plane hi; held as one 64-bit word,
// lo in the low half, card c's bit is 16 * suit + 2 + c % 13. The order of
// the bits is the order of the card ids.
MC_HD uint64_t mc_card_bit64(int card) {
  const int suit = (card * 5) >> 6;
  return (uint64_t)1u << (card + 3 * suit + 2);
}
