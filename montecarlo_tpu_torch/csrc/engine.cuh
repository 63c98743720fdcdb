// One table of the whole-step betting engine, as scalar code for one
// thread (ops/cuda_engine.py).
//
// A transcription of the vectorized device functions of
// montecarlo_tpu/ops/pallas_engine.py (_head_info :192, _street_update
// :206, _street_merge :230, _settle_payout :291, _step_nosettle :326,
// _settle_pass :499, _policy_prng :700) for one table: where the JAX form
// selects over a leading seat or layer axis, this form loops over it. Every
// `%` and `//` of the JAX form is a floor operation (mc_floormod,
// mc_floordiv); int32 products wrap as they do in jnp.
//
// The rule set is a template parameter R, as it is static in the JAX
// engine: MC_REFERENCE (the reference's accounting quirks), MC_STANDARD
// (stack-capped payments, showdown-live all-ins, contributor pots with odd
// chips to the first winner, capped blinds, chained street transitions) or
// MC_TOURNAMENT (standard betting and payout; busted seats leave the deal,
// the button and blinds skip them, each seat's first bust is recorded, and
// a table with one player holding chips freezes).
#pragma once

#include "evaluator.cuh"
#include "philox.cuh"

#define MC_REFERENCE 0
#define MC_STANDARD 1
#define MC_TOURNAMENT 2
#define MC_MAX_RAISE 20
#define MC_MAX_RAISES_PER_STREET 2
#define MC_TABLES_PER_BLOCK 1024

// Street layer capacity per rule set (pallas_engine.py:104-105).
template <int R>
MC_HD constexpr int mc_layers() {
  return R == MC_REFERENCE ? 6 : 10;
}

// The rows only some rule sets keep, after pot_set: the reference's
// n-inflation counter per pot row; the all-in seat mask of the standard
// and tournament rules; the tournament's per-seat first-bust hand index.
template <int P, int L, int R>
struct MCRuleRows;
template <int P, int L>
struct MCRuleRows<P, L, MC_REFERENCE> {
  int pot_n[4 * L];
};
template <int P, int L>
struct MCRuleRows<P, L, MC_STANDARD> {
  int all_in;
};
template <int P, int L>
struct MCRuleRows<P, L, MC_TOURNAMENT> {
  int all_in;
  int bust_at[P];
};

// The packed per-table state: field order and sizes of
// pallas_engine._field_layout(P, rules), one int per row.
template <int P, int R>
struct MCTable {
  static constexpr int L = mc_layers<R>();
  int stage, cursor, street_raises, last_raiser, folded, in_hand, to_act,
      order, wait, hand_ct, overflow, button;
  int stacks[P], contrib[P], hole0[P], hole1[P], hand_start[P], delta_sum[P],
      seat_delta[P];
  int board[5], lvl[L], ln[L];
  int pot_amt[4 * L], pot_set[4 * L];
  MCRuleRows<P, L, R> rr;
};

template <int P, int R>
MC_HD constexpr int mc_fields() {
  return 12 + 7 * P + 5 + 10 * mc_layers<R>() +
         (R == MC_REFERENCE ? 4 * mc_layers<R>() : 1) +
         (R == MC_TOURNAMENT ? P : 0);
}
static_assert(sizeof(MCTable<6, MC_REFERENCE>) ==
                  4 * mc_fields<6, MC_REFERENCE>(), "layout");
static_assert(sizeof(MCTable<6, MC_STANDARD>) ==
                  4 * mc_fields<6, MC_STANDARD>(), "layout");
static_assert(sizeof(MCTable<6, MC_TOURNAMENT>) ==
                  4 * mc_fields<6, MC_TOURNAMENT>(), "layout");
static_assert(mc_fields<6, MC_REFERENCE>() == 143, "F, P=6, reference");
static_assert(mc_fields<6, MC_STANDARD>() == 160, "F, P=6, standard");
static_assert(mc_fields<6, MC_TOURNAMENT>() == 166, "F, P=6, tournament");

// Table t's rows of the packed state [n_blocks, F, 8, 128] into / out of
// its struct (row f of table t at block * F * 1024 + f * 1024 + lane).
template <int P, int R>
MC_HD void mc_load(MCTable<P, R>& s, const int* state, long long t) {
  constexpr int F = mc_fields<P, R>();
  const int* src = state + (t / MC_TABLES_PER_BLOCK) * F *
                               MC_TABLES_PER_BLOCK +
                   t % MC_TABLES_PER_BLOCK;
  int* dst = reinterpret_cast<int*>(&s);
  for (int f = 0; f < F; ++f) dst[f] = src[f * MC_TABLES_PER_BLOCK];
}

template <int P, int R>
MC_HD void mc_store(const MCTable<P, R>& s, int* state, long long t) {
  constexpr int F = mc_fields<P, R>();
  int* dst = state + (t / MC_TABLES_PER_BLOCK) * F * MC_TABLES_PER_BLOCK +
             t % MC_TABLES_PER_BLOCK;
  const int* src = reinterpret_cast<const int*>(&s);
  for (int f = 0; f < F; ++f) dst[f * MC_TABLES_PER_BLOCK] = src[f];
}

// First unmasked play-order position scanning from cursor (_head_info).
template <int P, int R>
MC_HD int mc_head(const MCTable<P, R>& s) {
  int best = P;
  for (int p = 0; p < P; ++p)
    if ((s.order >> p) & 1) best = mc_min(best, mc_floormod(p - s.cursor, P));
  return mc_floormod(s.cursor + best, P);
}

template <int L>
MC_HD int mc_street_total(const int* lvl) {
  int t = lvl[0];
  for (int j = 1; j < L; ++j) t = mc_max(t, lvl[j]);
  return t;
}

// Levels-form update-bets (_street_update) with do == true: +1 the n of
// covered levels, sorted-insert a new boundary. Returns the overflow
// latch: an insert into full levels drops the top row, as the JAX form's
// shift does.
template <int L>
MC_HD bool mc_street_update(int* lvl, int* ln, int a) {
  int cnt = 0, pos = 0, n_inc[L];
  bool exists = false;
  for (int j = 0; j < L; ++j) {
    bool v = lvl[j] > 0;
    cnt += v;
    n_inc[j] = ln[j] + (v && lvl[j] <= a);
    exists |= v && lvl[j] == a;
    pos += v && lvl[j] < a;
  }
  if (exists) {
    for (int j = 0; j < L; ++j) ln[j] = n_inc[j];
    return false;
  }
  int new_n = pos == cnt ? 1 : (pos < L ? ln[pos] : 0) + 1;
  int nl[L], nn[L];
  for (int j = 0; j < L; ++j) {
    if (j < pos) {
      nl[j] = lvl[j];
      nn[j] = n_inc[j];
    } else if (j == pos) {
      nl[j] = a;
      nn[j] = new_n;
    } else {
      nl[j] = lvl[j - 1];
      nn[j] = n_inc[j - 1];
    }
  }
  for (int j = 0; j < L; ++j) {
    lvl[j] = nl[j];
    ln[j] = nn[j];
  }
  return cnt >= L;
}

// Levels-form merge-bets (_street_merge) with do == true: drop boundaries
// no contribution matches and compact both columns.
template <int P, int L>
MC_HD void mc_street_merge(int* lvl, int* ln, const int* contrib) {
  int ol[L], on[L], k = 0;
  for (int j = 0; j < L; ++j) ol[j] = on[j] = 0;
  for (int j = 0; j < L; ++j) {
    bool matched = false;
    for (int p = 0; p < P; ++p) matched |= contrib[p] == lvl[j];
    if (matched && lvl[j] > 0) {
      ol[k] = lvl[j];
      on[k] = ln[j];
      ++k;
    }
  }
  for (int j = 0; j < L; ++j) {
    lvl[j] = ol[j];
    ln[j] = on[j];
  }
}

// The betting half of step_table (_step_nosettle). A table whose hand ends
// latches `wait` and empties its play order.
template <int P, int R>
MC_HD void mc_step_nosettle(MCTable<P, R>& s, int raw) {
  constexpr int L = MCTable<P, R>::L;
  constexpr bool REF = R == MC_REFERENCE;
  if (s.order == 0) return;  // no head: the whole step is a no-op
  const int head = mc_head(s);
  const int cursor_after = (head + 1) % P;
  const int head_bit = 1 << head;
  const int stage0 = s.stage;

  const int total = mc_street_total<L>(s.lvl);
  const int delta = mc_sub(total, s.contrib[head]);
  const int stack_head = s.stacks[head];
  const int cap = mc_sub(stack_head, delta);
  const int clamped = mc_max(0, mc_min(raw, cap));
  const int action = raw > 0 ? clamped : raw;
  const bool is_fold = action < 0, is_raise = action > 0,
             is_call = action == 0;
  const int r = mc_max(action, 0);
  const bool is_check = is_call && total == 0;
  const bool threads = (is_call && total > 0) || is_raise;
  int amount, paid;
  if constexpr (REF) {
    // a call pays the full delta (stacks may go negative)
    amount = is_raise ? mc_add(r, total) : total;
    paid = threads ? (is_raise ? mc_add(delta, r) : delta) : 0;
  } else {
    // payments cap at the stack; an all-in for less joins what it covers
    const int pay_call = mc_min(delta, stack_head);
    const int pay_raise = mc_min(mc_add(delta, r), stack_head);
    amount = is_raise ? mc_sub(mc_add(r, total),
                               mc_sub(mc_add(delta, r), pay_raise))
                      : mc_sub(total, mc_sub(delta, pay_call));
    paid = threads ? (is_raise ? pay_raise : pay_call) : 0;
  }

  bool ovf = false;
  if (threads)
    ovf = mc_street_update<L>(s.lvl, s.ln, amount);
  else if (is_fold || is_check)
    mc_street_merge<P, L>(s.lvl, s.ln, s.contrib);
  if (threads) s.contrib[head] = mc_max(s.contrib[head], amount);
  s.stacks[head] = mc_sub(s.stacks[head], paid);

  const bool went_all_in = threads && paid == stack_head;
  int actable;
  if constexpr (REF) {
    // exact-equality all-ins leave :players (board.clj:53-89)
    if (is_fold || went_all_in) s.in_hand &= ~head_bit;
    if (is_fold) s.order &= ~head_bit;
    actable = s.in_hand;
  } else {
    // all-in seats stop acting but stay showdown-live
    if (is_fold) s.in_hand &= ~head_bit;
    if (went_all_in) s.rr.all_in |= head_bit;
    if (is_fold || went_all_in) s.order &= ~head_bit;
    actable = s.in_hand & ~s.rr.all_in;
  }
  s.to_act = is_raise ? (actable & ~head_bit) : (s.to_act & ~head_bit);
  if (is_fold)
    s.folded |= head_bit;
  else
    s.cursor = cursor_after;
  const int n_in = mc_popc((uint32_t)s.in_hand & ((1u << P) - 1u));

  // flush the street into the pot slot of the current stage: layer sets
  // are the non-folded members (reference) or the original contributors
  if (s.to_act == 0 || n_in <= 1) {
    for (int j = 0; j < L; ++j) {
      if (s.lvl[j] <= 0 || stage0 < 0 || stage0 > 3) continue;
      int set = 0;
      for (int p = 0; p < P; ++p)
        if (s.contrib[p] >= s.lvl[j] && (!REF || !((s.folded >> p) & 1)))
          set |= 1 << p;
      int row = stage0 * L + j;
      s.pot_amt[row] = mc_sub(s.lvl[j], j ? s.lvl[j - 1] : 0);
      s.pot_set[row] = set;
      if constexpr (REF) s.rr.pot_n[row] = s.ln[j];
    }
    for (int j = 0; j < L; ++j) s.lvl[j] = s.ln[j] = 0;
    for (int p = 0; p < P; ++p) s.contrib[p] = 0;
  }

  // street transitions: at most one under reference rules; standard
  // rules chain the board out when nobody can act
  for (int k = 0; k < (REF ? 1 : 4); ++k) {
    const bool stage_done = s.to_act == 0;
    const bool gend = n_in <= 1 || (stage_done && s.stage == 3);
    if (stage_done && !gend) {
      s.stage += 1;
      s.to_act = s.order = actable;
      s.cursor = 0;
    }
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

// Settlement and next hand for a waiting table (_settle_pass): showdown
// payout per pot row, delta meters, players-list rotation (by one; in a
// tournament, to the next position holding chips), blinds, and the deal
// `cards` [2P + 5]. With `reset_stacks` every hand starts from `ss` chips
// a seat. A tournament table left with one player holding chips does not
// redeal: it keeps its settled stacks and hand, and freezes.
//
// PAYOUT_ONLY (the stage probe's `settle`, probe_stages.cuh): the payout
// half alone (_settle_payout), for any table, waiting or not: every pot
// row's payout added to the stacks, nothing else changed, `cards` unread.
// It is a template flag rather than a function of its own so that the
// kernels' instantiation (false) is compiled from the same code as before
// the probe existed.
template <int P, int R, bool PAYOUT_ONLY = false>
MC_HD void mc_settle_pass(MCTable<P, R>& s, const int* cards, int sb, int bb,
                          int ss = 0, bool reset_stacks = false) {
  constexpr int L = MCTable<P, R>::L;
  constexpr bool REF = R == MC_REFERENCE;
  constexpr bool TOUR = R == MC_TOURNAMENT;
  constexpr int full = (1 << P) - 1;
  if constexpr (!PAYOUT_ONLY)
    if (!s.wait) return;
  uint32_t bm[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 5; ++i) mc_add_card(bm, s.board[i]);
  int values[P], pay[P];
  for (int p = 0; p < P; ++p) {
    uint32_t m[4] = {bm[0], bm[1], bm[2], bm[3]};
    mc_add_card(m, s.hole0[p]);
    mc_add_card(m, s.hole1[p]);
    values[p] = mc_eval_cmp(m[0], m[1], m[2], m[3]);
    pay[p] = 0;
  }
  for (int row = 0; row < 4 * L; ++row) {
    int elig = s.pot_set[row] & s.in_hand, vmax = 0, cnt = 0, first = P;
    for (int p = 0; p < P; ++p)
      if ((elig >> p) & 1) vmax = mc_max(vmax, values[p]);
    for (int p = 0; p < P; ++p)
      if (((elig >> p) & 1) && values[p] == vmax) {
        ++cnt;
        first = mc_min(first, p);
      }
    if (cnt == 0) continue;
    int total_pot;
    if constexpr (REF)  // amt * inflated n, remainders vanish
      total_pot = mc_mul(s.pot_amt[row], s.rr.pot_n[row]);
    else  // exactly the chips contributed
      total_pot = mc_mul(s.pot_amt[row],
                         mc_popc((uint32_t)s.pot_set[row] & (uint32_t)full));
    const int share = mc_floordiv(total_pot, cnt);
    for (int p = 0; p < P; ++p)
      if (((elig >> p) & 1) && values[p] == vmax) pay[p] = mc_add(pay[p], share);
    // odd chips to the first-position winner
    if constexpr (!REF)
      pay[first] = mc_add(pay[first], mc_floormod(total_pot, cnt));
  }
  if constexpr (PAYOUT_ONLY) {
    for (int p = 0; p < P; ++p) s.stacks[p] = mc_add(s.stacks[p], pay[p]);
    return;
  }
  int delta[P];
  for (int p = 0; p < P; ++p) {
    s.stacks[p] = mc_add(s.stacks[p], pay[p]);
    delta[p] = mc_sub(s.stacks[p], s.hand_start[p]);
    s.delta_sum[p] = mc_add(s.delta_sum[p], delta[p]);
  }
  // seat view of the positional deltas (and, in a tournament, of the
  // settled stacks): roll by the button; 0 for a button out of range
  const bool button_ok = s.button >= 0 && s.button < P;
  if (button_ok)
    for (int i = 0; i < P; ++i)
      s.seat_delta[i] =
          mc_add(s.seat_delta[i], delta[mc_floormod(i - s.button, P)]);
  int shift = 1;  // the players list rotates to the next alive position
  bool redeal = true;
  if constexpr (TOUR) {
    // each seat's first bust: the 0-based index of the hand just settled
    for (int i = 0; i < P; ++i) {
      const int seat_stack =
          button_ok ? s.stacks[mc_floormod(i - s.button, P)] : 0;
      if (seat_stack <= 0 && s.rr.bust_at[i] < 0)
        s.rr.bust_at[i] = s.hand_ct;
    }
    int n_alive = 0;
    shift = P;
    for (int p = 0; p < P; ++p)
      if (s.stacks[p] > 0) {
        ++n_alive;
        if (p >= 1) shift = mc_min(shift, p);
      }
    shift = mc_min(mc_max(shift, 1), P - 1);
    redeal = n_alive > 1;
  }
  s.hand_ct += 1;
  for (int row = 0; row < 4 * L; ++row) {
    s.pot_amt[row] = s.pot_set[row] = 0;
    if constexpr (REF) s.rr.pot_n[row] = 0;
  }
  s.wait = 0;
  if (!redeal) {
    // a tournament won: the table freezes as settled, its play order
    // empty, so every later step and settle pass is a no-op
    s.to_act = s.order = 0;
    return;
  }

  // next hand: rotate the players list, post blinds, deal
  int rot[P];
  for (int p = 0; p < P; ++p)
    rot[p] = reset_stacks ? ss : s.stacks[(p + shift) % P];
  for (int j = 0; j < L; ++j) s.lvl[j] = s.ln[j] = 0;
  int in_hand = full, to_act = full, bb_pos = 1;
  if constexpr (REF) {
    for (int p = 0; p < P; ++p) {
      int blind = p == 0 ? sb : (p == 1 ? bb : 0);
      s.stacks[p] = mc_sub(rot[p], blind);
      s.contrib[p] = blind;
    }
    s.lvl[0] = mc_min(sb, bb);
    s.ln[0] = 2;
    if (sb != bb) {
      s.lvl[1] = mc_max(sb, bb);
      s.ln[1] = 1;
    }
  } else {
    if constexpr (TOUR) {
      // dead seats leave the deal; the big blind is the first alive
      // position >= 1, and action starts after it
      in_hand = 0;
      bb_pos = P;
      for (int p = 0; p < P; ++p)
        if (rot[p] > 0) {
          in_hand |= 1 << p;
          if (p >= 1) bb_pos = mc_min(bb_pos, p);
        }
      bb_pos = mc_min(bb_pos, P - 1);
    }
    // blinds capped at the stack, placed through the street algebra;
    // all-in blinds (and, under standard rules, busted seats) sit out,
    // showdown-live
    const int pay0 = mc_min(mc_max(rot[0], 0), sb);
    const int pay1 = mc_min(mc_max(rot[bb_pos], 0), bb);
    int all_in = 0;
    for (int p = 0; p < P; ++p) {
      int blind = p == 0 ? pay0 : (p == bb_pos ? pay1 : 0);
      s.stacks[p] = mc_sub(rot[p], blind);
      s.contrib[p] = blind;
      if (s.stacks[p] <= 0) all_in |= 1 << p;
    }
    if (pay0 > 0) mc_street_update<L>(s.lvl, s.ln, pay0);
    if (pay1 > 0) mc_street_update<L>(s.lvl, s.ln, pay1);
    all_in &= in_hand;
    s.rr.all_in = all_in;
    to_act = in_hand & ~all_in;
  }
  for (int p = 0; p < P; ++p) {
    s.hand_start[p] = rot[p];
    s.hole0[p] = cards[p];
    s.hole1[p] = cards[P + p];
  }
  for (int i = 0; i < 5; ++i) s.board[i] = cards[2 * P + i];
  s.in_hand = in_hand;
  s.to_act = s.order = to_act;
  s.cursor = (bb_pos + 1) % P;
  s.folded = 0;
  s.stage = 0;
  s.button = mc_floormod(s.button + shift, P);
}

// random_policy on two u32 words (_policy_prng): fold 15% (a free check
// when nothing is owed), raise 30% by 1..20 while the street has fewer
// than 2 raises, else call.
template <int P, int R>
MC_HD int mc_policy(const MCTable<P, R>& s, uint32_t u, uint32_t amt_bits,
                    uint32_t fold_bits, uint32_t raise_bits) {
  int amt = (int)(amt_bits % (uint32_t)MC_MAX_RAISE) + 1;
  int head = mc_head(s);
  bool owes =
      mc_sub(mc_street_total<MCTable<P, R>::L>(s.lvl), s.contrib[head]) > 0;
  bool can_raise = s.street_raises < MC_MAX_RAISES_PER_STREET;
  bool is_fold = u < fold_bits;
  bool is_raise = u < raise_bits && !is_fold && can_raise;
  return is_fold ? (owes ? -1 : 0) : (is_raise ? amt : 0);
}

// Hand h's deal from a stash: card c at stash[(h * (2P+5) + c) * stride].
template <int P>
MC_HD void mc_stash_deal(const int* stash, long long stride, int hand_ptr,
                         int* deal) {
  constexpr int NC = 2 * P + 5;
  for (int c = 0; c < NC; ++c)
    deal[c] = stash[((long long)hand_ptr * NC + c) * stride];
}

// K3's work for one table: n_steps fused steps. act[i * stride] is step
// i's raw action; hand h > 0 is dealt from stash row min(h, hmax - 1).
template <int P, int R>
MC_HD void mc_run_det(MCTable<P, R>& s, const int* act, const int* stash,
                      long long stride, int n_steps, int hmax, int sb,
                      int bb) {
  for (int i = 0; i < n_steps; ++i) {
    int hand_ptr = mc_min(s.hand_ct + 1, hmax - 1);
    mc_step_nosettle(s, act[i * stride]);
    if (s.wait) {
      int deal[2 * P + 5];
      mc_stash_deal<P>(stash, stride, hand_ptr, deal);
      mc_settle_pass(s, deal, sb, bb);
    }
  }
}

// K4's work for one table: per iteration, `defer` betting slots of two
// words each (u, then amt_bits), then 2P+5 deal words and a settle pass.
template <int P, int R>
MC_HD void mc_run_prng(MCTable<P, R>& s, MCWords& src, int n_steps,
                       int defer, int sb, int bb, uint32_t fold_bits,
                       uint32_t raise_bits) {
  constexpr int NC = 2 * P + 5;
  for (int it = 0; it < n_steps / defer; ++it) {
    for (int k = 0; k < defer; ++k) {
      uint32_t u = src.next();
      uint32_t amt_bits = src.next();
      mc_step_nosettle(s, mc_policy(s, u, amt_bits, fold_bits, raise_bits));
    }
    int deal[NC];
    mc_sample_cards<NC>(src, nullptr, 0, deal);
    mc_settle_pass(s, deal, sb, bb);
  }
}

// Launch a kernel template<P, R> for the run-time (P, rules) of a C entry:
// `CASE(N, R)` is expanded for the one seat count MC_SEATS that the build
// defines (ops/_build.py builds a library per seat count), under the rule
// sets the entry takes; any other (P, rules) is refused. The engine kernels
// (K3, K4) take all three rule sets, the net kernels (K5, K6) reference
// and standard, as the JAX net entry points do.
#define MC_DISPATCH_SWITCH(CASES)         \
  switch (rules * 100 + P) {              \
    CASES                                 \
    default:                              \
      return (int)cudaErrorInvalidValue;  \
  }
#define MC_DISPATCH(CASE)                 \
  MC_DISPATCH_SWITCH(CASE(MC_SEATS, MC_REFERENCE)  \
                     CASE(MC_SEATS, MC_STANDARD))
#define MC_ENGINE_DISPATCH(CASE)                   \
  MC_DISPATCH_SWITCH(CASE(MC_SEATS, MC_REFERENCE)  \
                     CASE(MC_SEATS, MC_STANDARD)   \
                     CASE(MC_SEATS, MC_TOURNAMENT))
