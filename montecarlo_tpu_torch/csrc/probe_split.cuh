// The K4 split's per-table body (ops/cuda_split.py): K4's work for one
// table (engine.cuh, mc_run_prng) with one piece of its step stubbed, the
// variant V (an MC_SPLIT_* value) a template parameter.
//
// The subtractive counterpart of the stage probe (probe_stages.cuh, which
// builds the step up stage by stage): scripts/exp_step_split.py:75-117
// monkeypatches one module-level piece of the JAX kernel body at a time
// and times the whole kernel again. The variants, as the script's:
//   full         K4 itself;
//   stub_settle  no showdown payout (_settle_payout = 0): no hand values,
//                no pot rows read;
//   stub_eval    each seat's hand value is the first suit-mask word of its
//                seven cards (eval_masks_cmp_impl -> m0), the payout
//                otherwise as K4's;
//   stub_deal    the next hand's cards all 0 (_sample_cards -> zeros): no
//                deal words are drawn;
//   stub_policy  every action a check or call (_policy_prng -> 0): no
//                policy words are drawn;
//   stub_street  the street update and merge are the identity
//                (_street_update / _street_merge), no overflow latched;
// and two controls that stub nothing and return K4's state:
//   settle_copy  the settle-pass copy that stub_settle and stub_eval run,
//                with K4's payout in it: the baseline of their savings;
//   street_copy  the step copy that stub_street runs, with the street
//                update, merge and overflow latch in it: its baseline.
// A stub removes its words from the stream, as the JAX stubs draw none:
// an iteration of `defer` slots reads PW defer + DW words, PW = 2 policy
// words a slot (0 under stub_policy) and DW = 2P + 5 deal words (0 under
// stub_deal), from word it (PW defer + DW) of the table's stream.
//
// Each variant is composed from engine.cuh's device functions (mc_policy,
// mc_step_nosettle, mc_settle_pass, mc_street_total, ...); the two pieces
// that hold a stubbed part inside them are written out here, under
// reference rules, for the variants that change them: the betting step
// without the street algebra (stub_street) and the settle pass with no
// payout (stub_settle) or the first mask word as the value (stub_eval);
// the controls run the same copies with nothing stubbed, so that a copy's
// own code shape is timed apart from its stub. Reference rules only (the
// script's TableConfig(num_seats=6)).
// engine.cuh is not changed, so K4 keeps its build.
#pragma once

#include "engine.cuh"

#define MC_SPLIT_FULL 0
#define MC_SPLIT_STUB_SETTLE 1
#define MC_SPLIT_STUB_EVAL 2
#define MC_SPLIT_STUB_DEAL 3
#define MC_SPLIT_STUB_POLICY 4
#define MC_SPLIT_STUB_STREET 5
#define MC_SPLIT_SETTLE_COPY 6
#define MC_SPLIT_STREET_COPY 7

// Words a betting slot and a deal draw under variant V.
template <int V>
MC_HD constexpr int mc_split_slot_words() {
  return V == MC_SPLIT_STUB_POLICY ? 0 : 2;
}
template <int V, int P>
MC_HD constexpr int mc_split_deal_words() {
  return V == MC_SPLIT_STUB_DEAL ? 0 : 2 * P + 5;
}

// stub_deal's next hand: every card 0.
struct MCDealZero {
  template <int NC>
  MC_HD void deal(int* out) const {
#pragma unroll
    for (int c = 0; c < NC; ++c) out[c] = 0;
  }
};

// mc_step_nosettle under reference rules with the street update and merge
// the identity (stub_street: the levels stay as they are, no overflow is
// latched) or as K4's (street_copy); payments, membership, the flush and
// the transitions as K4's.
template <int V, int P, class Rows>
MC_HD void mc_split_step_copy(MCTable<P, MC_REFERENCE, Rows>& s, int raw,
                              int head, int total) {
  constexpr int R = MC_REFERENCE;
  constexpr int L = MCTable<P, R, Rows>::L;
  using C = MCCold<P, R>;
  if (s.order == 0) return;
  const int cursor_after = mc_wrap<P>(head + 1);
  const int head_bit = 1 << head;
  const int stage0 = s.stage;

  const int contrib_head = mc_sel<P>(s.contrib, head);
  const int delta = mc_sub(total, contrib_head);
  const int stack_head = mc_sel<P>(s.stacks, head);
  const int cap = mc_sub(stack_head, delta);
  const int clamped = mc_max(0, mc_min(raw, cap));
  const int action = raw > 0 ? clamped : raw;
  const bool is_fold = action < 0, is_raise = action > 0,
             is_call = action == 0;
  const int r = mc_max(action, 0);
  const bool threads = (is_call && total > 0) || is_raise;
  const int amount = is_raise ? mc_add(r, total) : total;
  const int paid = threads ? (is_raise ? mc_add(delta, r) : delta) : 0;

  bool ovf = false;
  if constexpr (V == MC_SPLIT_STREET_COPY) {
    if (threads)
      ovf = mc_street_update<L>(s.lvl, s.ln, amount);
    else if (is_fold || (is_call && total == 0))
      mc_street_merge<P, L>(s.lvl, s.ln, s.contrib);
  }
  if (threads) mc_put<P>(s.contrib, head, mc_max(contrib_head, amount));
  mc_put<P>(s.stacks, head, mc_sub(stack_head, paid));

  const bool went_all_in = threads && paid == stack_head;
  if (is_fold || went_all_in) s.in_hand &= ~head_bit;
  if (is_fold) s.order &= ~head_bit;
  const int actable = s.in_hand;
  s.to_act = is_raise ? (actable & ~head_bit) : (s.to_act & ~head_bit);
  if (is_fold)
    s.folded |= head_bit;
  else
    s.cursor = cursor_after;
  const int n_in = mc_popc((uint32_t)s.in_hand & ((1u << P) - 1u));

  if (s.to_act == 0 || n_in <= 1) {
    if (stage0 >= 0 && stage0 <= 3) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (s.lvl[j] <= 0) continue;
        int set = 0;
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (s.contrib[p] >= s.lvl[j] && !((s.folded >> p) & 1))
            set |= 1 << p;
        const int row = stage0 * L + j;
        s.rows.set(C::POT_AMT + row, mc_sub(s.lvl[j], j ? s.lvl[j - 1] : 0));
        s.rows.set(C::POT_SET + row, set);
        s.rows.set(C::EXTRA + row, s.ln[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) s.lvl[j] = s.ln[j] = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) s.contrib[p] = 0;
  }

  const bool stage_done = s.to_act == 0;
  if (stage_done && !(n_in <= 1 || s.stage == 3)) {
    s.stage += 1;
    s.to_act = s.order = actable;
    s.cursor = 0;
  }
  const bool ended = n_in <= 1 || (s.to_act == 0 && s.stage == 3);
  if (ended) {
    s.to_act = s.order = 0;
    s.wait = 1;
  }
  const bool reset = s.stage != stage0 || ended;
  s.street_raises = reset ? 0 : s.street_raises + is_raise;
  if (is_raise) s.last_raiser = head;
  if (reset) s.last_raiser = P;
  s.overflow |= (int)ovf;
}

// mc_settle_pass under reference rules (no stack reset) with the payout of
// variant V: none at all (stub_settle: no hand values, no pot rows
// read), each seat's value the first suit-mask word of its seven cards
// (stub_eval: mc_eval_cmp replaced, the payout otherwise K4's), or K4's
// (settle_copy). The rest,
// meters, rotation, blinds and the deal, as K4's.
template <int V, int P, class Rows, class Deal>
MC_HD void mc_split_settle_pass(MCTable<P, MC_REFERENCE, Rows>& s,
                                const Deal& cards, int sb, int bb) {
  constexpr int R = MC_REFERENCE;
  constexpr int L = MCTable<P, R, Rows>::L;
  constexpr int NC = 2 * P + 5;
  using C = MCCold<P, R>;
  constexpr int full = (1 << P) - 1;
  if (!s.wait) return;
  int pay[P];
#pragma unroll
  for (int p = 0; p < P; ++p) pay[p] = 0;
  if constexpr (V != MC_SPLIT_STUB_SETTLE) {
    uint32_t bm[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 5; ++i) mc_add_card(bm, s.rows.get(C::BOARD + i));
    int values[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t m[4] = {bm[0], bm[1], bm[2], bm[3]};
      mc_add_card(m, s.rows.get(C::HOLE0 + p));
      mc_add_card(m, s.rows.get(C::HOLE1 + p));
      if constexpr (V == MC_SPLIT_STUB_EVAL)
        values[p] = (int)m[0];
      else
        values[p] = mc_eval_cmp(m[0], m[1], m[2], m[3]);
    }
    for (int row = 0; row < 4 * L; ++row) {
      const int elig = s.rows.get(C::POT_SET + row) & s.in_hand;
      if (elig == 0) continue;
      int vmax = 0, cnt = 0;
#pragma unroll
      for (int p = 0; p < P; ++p)
        if ((elig >> p) & 1) vmax = mc_max(vmax, values[p]);
#pragma unroll
      for (int p = 0; p < P; ++p)
        cnt += ((elig >> p) & 1) && values[p] == vmax;
      if (cnt == 0) continue;
      const int share = mc_floordiv(
          mc_mul(s.rows.get(C::POT_AMT + row), s.rows.get(C::EXTRA + row)),
          cnt);
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (((elig >> p) & 1) && values[p] == vmax)
          pay[p] = mc_add(pay[p], share);
    }
  }
  int delta[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    s.stacks[p] = mc_add(s.stacks[p], pay[p]);
    delta[p] = mc_sub(s.stacks[p], s.rows.get(C::HAND_START + p));
    s.rows.set(C::DELTA_SUM + p,
               mc_add(s.rows.get(C::DELTA_SUM + p), delta[p]));
  }
  const int button = s.rows.get(C::BUTTON);
  if (button >= 0 && button < P) {
#pragma unroll
    for (int i = 0; i < P; ++i)
      s.rows.set(C::SEAT_DELTA + i,
                 mc_add(s.rows.get(C::SEAT_DELTA + i),
                        mc_sel<P>(delta, mc_wrap<P>(i - button + P))));
  }
  s.rows.set(C::HAND_CT, s.rows.get(C::HAND_CT) + 1);
  for (int row = 0; row < 4 * L; ++row) {
    s.rows.set(C::POT_AMT + row, 0);
    s.rows.set(C::POT_SET + row, 0);
    s.rows.set(C::EXTRA + row, 0);
  }
  s.wait = 0;
  // next hand: rotate the players list by one, post blinds, deal
  int rot[P];
#pragma unroll
  for (int p = 0; p < P; ++p) rot[p] = mc_sel<P>(s.stacks, mc_wrap<P>(p + 1));
#pragma unroll
  for (int j = 0; j < L; ++j) s.lvl[j] = s.ln[j] = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int blind = p == 0 ? sb : (p == 1 ? bb : 0);
    s.stacks[p] = mc_sub(rot[p], blind);
    s.contrib[p] = blind;
  }
  s.lvl[0] = mc_min(sb, bb);
  s.ln[0] = 2;
  if (sb != bb) {
    s.lvl[1] = mc_max(sb, bb);
    s.ln[1] = 1;
  }
  int next[NC];
  cards.template deal<NC>(next);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    s.rows.set(C::HAND_START + p, rot[p]);
    s.rows.set(C::HOLE0 + p, next[p]);
    s.rows.set(C::HOLE1 + p, next[P + p]);
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) s.rows.set(C::BOARD + i, next[2 * P + i]);
  s.in_hand = full;
  s.to_act = s.order = full;
  s.cursor = mc_wrap<P>(2);
  s.folded = 0;
  s.stage = 0;
  s.rows.set(C::BUTTON, mc_floormod(button + 1, P));
}

// The settle pass of variant V, the deal words from `pos` of src.
template <int V, int P, class Rows, class Src>
MC_HD void mc_split_settle(MCTable<P, MC_REFERENCE, Rows>& s, Src& src,
                           uint32_t pos, int sb, int bb) {
  if constexpr (V == MC_SPLIT_STUB_DEAL)
    mc_settle_pass(s, MCDealZero{}, sb, bb);
  else if constexpr (V == MC_SPLIT_STUB_SETTLE || V == MC_SPLIT_STUB_EVAL ||
                     V == MC_SPLIT_SETTLE_COPY)
    mc_split_settle_pass<V>(s, MCDealDraw<Src>{src, pos}, sb, bb);
  else
    mc_settle_pass(s, MCDealDraw<Src>{src, pos}, sb, bb);
}

// K4's work for one table (mc_run_prng) under variant V, reference rules:
// per iteration, `defer` betting slots, then a settle pass. A frozen table
// leaves the loop, as in K4.
template <int V, int P, class Rows, class Src>
MC_HD void mc_split_run(MCTable<P, MC_REFERENCE, Rows>& s, Src& src,
                        int n_steps, int defer, int sb, int bb,
                        uint32_t fold_bits, uint32_t raise_bits) {
  constexpr int L = MCTable<P, MC_REFERENCE, Rows>::L;
  constexpr uint32_t PW = mc_split_slot_words<V>();
  const uint32_t W = PW * defer + mc_split_deal_words<V, P>();
  for (int it = 0; it < n_steps / defer; ++it) {
    if (mc_frozen(s)) break;
    const uint32_t base = (uint32_t)it * W;
    for (int k = 0; k < defer; ++k) {
      if (!s.order) continue;
      const int head = mc_head<P>(s.order, s.cursor);
      const int total = mc_street_total<L>(s.lvl);
      int raw = 0;
      if constexpr (V != MC_SPLIT_STUB_POLICY)
        raw = mc_policy(s, head, total, src.at(base + PW * k),
                        src.at(base + PW * k + 1), fold_bits, raise_bits);
      if constexpr (V == MC_SPLIT_STUB_STREET || V == MC_SPLIT_STREET_COPY)
        mc_split_step_copy<V>(s, raw, head, total);
      else
        mc_step_nosettle(s, raw, head, total);
    }
    mc_split_settle<V>(s, src, base + PW * defer, sb, bb);
  }
}
