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
//
// Where a table lives (MCTable). The fields every betting step reads and
// writes (stage .. overflow, all_in, stacks[P], contrib[P], lvl[L], ln[L]:
// 34 words at P = 6 under reference rules, 43 under the others) are plain
// members, and every access by a run-time seat or layer index is a compare
// and select over the compile-time slots (mc_sel, mc_put), so that no hot
// array has its address taken and the compiler keeps them in registers. A
// single run-time index into one of them would move the whole table to
// local memory (the stage probe's finding: 0 B -> 648 B of stack). The rows
// that only the street flush and the settle pass touch (MCCold: hand_ct,
// button, the cards, the hand's meters, the pot rows, pot_n or bust_at)
// live in a storage class, a template parameter of every step function:
// MCRowsShared, a column of the block's shared memory (K3, K4, the stage
// probe), or MCRowsLocal, a per-thread array (K5/K6, whose shared memory
// holds the weight banks, and the host harness).
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

// Rows of the packed per-table state, pallas_engine._field_layout(P, rules).
template <int P, int R>
MC_HD constexpr int mc_fields() {
  return 12 + 7 * P + 5 + 10 * mc_layers<R>() +
         (R == MC_REFERENCE ? 4 * mc_layers<R>() : 1) +
         (R == MC_TOURNAMENT ? P : 0);
}
static_assert(mc_fields<6, MC_REFERENCE>() == 143, "F, P=6, reference");
static_assert(mc_fields<6, MC_STANDARD>() == 160, "F, P=6, standard");
static_assert(mc_fields<6, MC_TOURNAMENT>() == 166, "F, P=6, tournament");

// Offsets of the packed rows (_field_layout's order). TAIL is pot_n
// (reference, 4L rows) or all_in (the others); bust_at follows all_in.
template <int P, int R>
struct MCLayout {
  static constexpr int L = mc_layers<R>();
  static constexpr int STAGE = 0, CURSOR = 1, STREET_RAISES = 2,
                       LAST_RAISER = 3, FOLDED = 4, IN_HAND = 5, TO_ACT = 6,
                       ORDER = 7, WAIT = 8, HAND_CT = 9, OVERFLOW = 10,
                       BUTTON = 11, STACKS = 12, CONTRIB = 12 + P,
                       LVL = 17 + 7 * P, LN = LVL + L,
                       TAIL = LN + 9 * L;
};

// The cold rows, numbered apart from the hot fields: the packed rows that
// no betting step reads except through the street flush (the pot rows at
// the current stage).
template <int P, int R>
struct MCCold {
  static constexpr int L = mc_layers<R>();
  static constexpr int HAND_CT = 0, BUTTON = 1, HOLE0 = 2, HOLE1 = 2 + P,
                       HAND_START = 2 + 2 * P, DELTA_SUM = 2 + 3 * P,
                       SEAT_DELTA = 2 + 4 * P, BOARD = 2 + 5 * P,
                       POT_AMT = 7 + 5 * P, POT_SET = POT_AMT + 4 * L,
                       EXTRA = POT_SET + 4 * L;  // pot_n or bust_at
  static constexpr int N =
      EXTRA + (R == MC_REFERENCE ? 4 * L : R == MC_TOURNAMENT ? P : 0);
  // The packed row of cold row r.
  static MC_HD constexpr int field(int r) {
    return r == HAND_CT   ? MCLayout<P, R>::HAND_CT
           : r == BUTTON  ? MCLayout<P, R>::BUTTON
           : r < POT_AMT  ? 10 + 2 * P + r       // hole0 .. board
           : r < EXTRA || R == MC_REFERENCE ? 10 + 2 * P + 2 * L + r
                                            : 11 + 2 * P + 2 * L + r;
  }
};
static_assert(MCCold<6, MC_REFERENCE>::N == 109, "cold rows, reference");
static_assert(MCCold<6, MC_STANDARD>::N == 117, "cold rows, standard");
static_assert(MCCold<6, MC_TOURNAMENT>::N == 123, "cold rows, tournament");
static_assert(MCCold<6, MC_TOURNAMENT>::field(MCCold<6, 2>::N - 1) ==
                  mc_fields<6, MC_TOURNAMENT>() - 1, "bust_at last");

// Cold rows in a per-thread array (a run-time row index puts it in local
// memory: K5/K6 and the host harness).
template <int N>
struct MCRowsLocal {
  int v[N];
  MC_HD int get(int r) const { return v[r]; }
  MC_HD void set(int r, int x) { v[r] = x; }
};

// Cold rows in the block's shared memory, column-major: row r of thread i
// at smem[r * T + i] (`col` = smem + i), so consecutive threads hit
// consecutive banks and a run-time row is a plain address.
template <int T>
struct MCRowsShared {
  int* col;
  MC_HD int get(int r) const { return col[r * T]; }
  MC_HD void set(int r, int x) { col[r * T] = x; }
};

template <int P, int R, class Rows>
struct MCTable {
  static constexpr int L = mc_layers<R>();
  int stage, cursor, street_raises, last_raiser, folded, in_hand, to_act,
      order, wait, overflow;
  int all_in;  // standard and tournament rules; 0 under reference rules
  int stacks[P], contrib[P], lvl[L], ln[L];
  Rows rows;
};

// The per-thread form.
template <int P, int R>
using MCTableLocal = MCTable<P, R, MCRowsLocal<MCCold<P, R>::N>>;

// a[i] for a run-time i, by compare and select over the compile-time slots
// (0 for i out of [0, N)); mc_put writes a[i] likewise. Neither takes the
// array's address, so it stays in registers.
template <int N>
MC_HD int mc_sel(const int* a, int i) {
  int v = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) v = k == i ? a[k] : v;
  return v;
}

template <int N>
MC_HD void mc_put(int* a, int i, int x) {
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = k == i ? x : a[k];
}

// x - N for x in [N, 2N): the floor modulo of a sum of two values in
// [0, N).
template <int N>
MC_HD int mc_wrap(int x) {
  return x >= N ? x - N : x;
}

// Table t's rows of the packed state [n_blocks, F, 8, 128]: row f at
// [f * MC_TABLES_PER_BLOCK].
template <int P, int R, class T>
MC_HD T* mc_table_rows(T* state, long long t) {
  return state + (t / MC_TABLES_PER_BLOCK) * mc_fields<P, R>() *
                     MC_TABLES_PER_BLOCK +
         t % MC_TABLES_PER_BLOCK;
}

// A table from / to its packed rows, row f at src[f * stride].
template <int P, int R, class Rows>
MC_HD void mc_load(MCTable<P, R, Rows>& s, const int* src,
                   long long stride) {
  using Lay = MCLayout<P, R>;
  using C = MCCold<P, R>;
  constexpr int L = Lay::L;
  s.stage = src[Lay::STAGE * stride];
  s.cursor = src[Lay::CURSOR * stride];
  s.street_raises = src[Lay::STREET_RAISES * stride];
  s.last_raiser = src[Lay::LAST_RAISER * stride];
  s.folded = src[Lay::FOLDED * stride];
  s.in_hand = src[Lay::IN_HAND * stride];
  s.to_act = src[Lay::TO_ACT * stride];
  s.order = src[Lay::ORDER * stride];
  s.wait = src[Lay::WAIT * stride];
  s.overflow = src[Lay::OVERFLOW * stride];
  s.all_in = R == MC_REFERENCE ? 0 : src[Lay::TAIL * stride];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    s.stacks[p] = src[(Lay::STACKS + p) * stride];
    s.contrib[p] = src[(Lay::CONTRIB + p) * stride];
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    s.lvl[j] = src[(Lay::LVL + j) * stride];
    s.ln[j] = src[(Lay::LN + j) * stride];
  }
  for (int r = 0; r < C::N; ++r) s.rows.set(r, src[C::field(r) * stride]);
}

template <int P, int R, class Rows>
MC_HD void mc_store(const MCTable<P, R, Rows>& s, int* dst,
                    long long stride) {
  using Lay = MCLayout<P, R>;
  using C = MCCold<P, R>;
  constexpr int L = Lay::L;
  dst[Lay::STAGE * stride] = s.stage;
  dst[Lay::CURSOR * stride] = s.cursor;
  dst[Lay::STREET_RAISES * stride] = s.street_raises;
  dst[Lay::LAST_RAISER * stride] = s.last_raiser;
  dst[Lay::FOLDED * stride] = s.folded;
  dst[Lay::IN_HAND * stride] = s.in_hand;
  dst[Lay::TO_ACT * stride] = s.to_act;
  dst[Lay::ORDER * stride] = s.order;
  dst[Lay::WAIT * stride] = s.wait;
  dst[Lay::OVERFLOW * stride] = s.overflow;
  if (R != MC_REFERENCE) dst[Lay::TAIL * stride] = s.all_in;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    dst[(Lay::STACKS + p) * stride] = s.stacks[p];
    dst[(Lay::CONTRIB + p) * stride] = s.contrib[p];
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    dst[(Lay::LVL + j) * stride] = s.lvl[j];
    dst[(Lay::LN + j) * stride] = s.ln[j];
  }
  for (int r = 0; r < C::N; ++r) dst[C::field(r) * stride] = s.rows.get(r);
}

// A table with an empty play order and no settle pending is a fixed point
// of mc_step_nosettle and mc_settle_pass under every rule set (a frozen
// tournament; a deal where nobody can act).
template <int P, int R, class Rows>
MC_HD bool mc_frozen(const MCTable<P, R, Rows>& s) {
  return s.order == 0 && s.wait == 0;
}

// The same test on a table's packed rows (row f at rows[f * stride]).
template <int P, int R>
MC_HD bool mc_frozen_rows(const int* rows, long long stride) {
  return rows[MCLayout<P, R>::ORDER * stride] == 0 &&
         rows[MCLayout<P, R>::WAIT * stride] == 0;
}

// First unmasked play-order position scanning from cursor (_head_info):
// the order mask rotated right by the cursor, then its lowest set bit.
// Equal to the scan min over set bits p of (p - cursor) mod P for every
// cursor (floor modulo); the cursor itself when order is empty.
template <int P>
MC_HD int mc_head(int order, int cursor) {
  constexpr uint32_t full = (1u << P) - 1u;
  const int c = mc_floormod(cursor, P);
  const uint32_t o = (uint32_t)order & full;
  const uint32_t rot = ((o >> c) | (o << (P - c))) & full;
  return rot ? mc_wrap<P>(c + mc_ffs(rot)) : c;
}

template <int L>
MC_HD int mc_street_total(const int* lvl) {
  int t = lvl[0];
#pragma unroll
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
#pragma unroll
  for (int j = 0; j < L; ++j) {
    bool v = lvl[j] > 0;
    cnt += v;
    n_inc[j] = ln[j] + (v && lvl[j] <= a);
    exists |= v && lvl[j] == a;
    pos += v && lvl[j] < a;
  }
  if (exists) {
#pragma unroll
    for (int j = 0; j < L; ++j) ln[j] = n_inc[j];
    return false;
  }
  const int new_n = pos == cnt ? 1 : mc_sel<L>(ln, pos) + 1;
  int nl[L], nn[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    nl[j] = j < pos ? lvl[j] : j == pos ? a : (j ? lvl[j - 1] : 0);
    nn[j] = j < pos ? n_inc[j] : j == pos ? new_n : (j ? n_inc[j - 1] : 0);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    lvl[j] = nl[j];
    ln[j] = nn[j];
  }
  return cnt >= L;
}

// Levels-form merge-bets (_street_merge) with do == true: drop boundaries
// no contribution matches and compact both columns. Level j that is kept
// goes to slot k (the count kept before it), k <= j: a triangle of selects,
// whose row j a warp skips when no lane has a level there.
template <int P, int L>
MC_HD void mc_street_merge(int* lvl, int* ln, const int* contrib) {
  int ol[L], on[L], k = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) ol[j] = on[j] = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (lvl[j] <= 0) continue;  // not kept
    bool matched = false;
#pragma unroll
    for (int p = 0; p < P; ++p) matched |= contrib[p] == lvl[j];
    const bool keep = matched;
#pragma unroll
    for (int i = 0; i <= j; ++i) {
      const bool here = keep && k == i;
      ol[i] = here ? lvl[j] : ol[i];
      on[i] = here ? ln[j] : on[i];
    }
    k += keep;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    lvl[j] = ol[j];
    ln[j] = on[j];
  }
}

// The betting half of step_table (_step_nosettle), with the slot's head
// (mc_head) and street total (mc_street_total) computed once by the
// caller. A table whose hand ends latches `wait` and empties its play
// order.
template <int P, int R, class Rows>
MC_HD void mc_step_nosettle(MCTable<P, R, Rows>& s, int raw, int head,
                            int total) {
  constexpr int L = MCTable<P, R, Rows>::L;
  using C = MCCold<P, R>;
  constexpr bool REF = R == MC_REFERENCE;
  if (s.order == 0) return;  // no head: the whole step is a no-op
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
  if (threads) mc_put<P>(s.contrib, head, mc_max(contrib_head, amount));
  mc_put<P>(s.stacks, head, mc_sub(stack_head, paid));

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
    if (went_all_in) s.all_in |= head_bit;
    if (is_fold || went_all_in) s.order &= ~head_bit;
    actable = s.in_hand & ~s.all_in;
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
    if (stage0 >= 0 && stage0 <= 3) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        if (s.lvl[j] <= 0) continue;
        int set = 0;
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (s.contrib[p] >= s.lvl[j] && (!REF || !((s.folded >> p) & 1)))
            set |= 1 << p;
        const int row = stage0 * L + j;
        s.rows.set(C::POT_AMT + row, mc_sub(s.lvl[j], j ? s.lvl[j - 1] : 0));
        s.rows.set(C::POT_SET + row, set);
        if constexpr (REF) s.rows.set(C::EXTRA + row, s.ln[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < L; ++j) s.lvl[j] = s.ln[j] = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) s.contrib[p] = 0;
  }

  // street transitions: at most one under reference rules; standard
  // rules chain the board out when nobody can act
#pragma unroll
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

// The next hand's cards for the settle pass, [2P + 5]: from an array, or
// drawn from a word source at a fixed position (after the payout, so the
// cards are not live across it).
struct MCDealArray {
  const int* cards;
  template <int NC>
  MC_HD void deal(int* out) const {
#pragma unroll
    for (int c = 0; c < NC; ++c) out[c] = cards[c];
  }
};

template <class Src>
struct MCDealDraw {
  Src& src;
  uint32_t pos;
  template <int NC>
  MC_HD void deal(int* out) const {
    src.seek(pos);
    mc_sample_cards<NC>(src, nullptr, 0, out);
  }
};

// Settlement and next hand for a waiting table (_settle_pass): showdown
// payout per pot row, delta meters, players-list rotation (by one; in a
// tournament, to the next position holding chips), blinds, and the deal
// `cards` [2P + 5] (an MCDealArray or MCDealDraw). With `reset_stacks`
// every hand starts from `ss` chips a seat. A tournament table left with
// one player holding chips does not redeal: it keeps its settled stacks
// and hand, and freezes.
//
// PAYOUT_ONLY (the stage probe's `settle`, probe_stages.cuh): the payout
// half alone (_settle_payout), for any table, waiting or not: every pot
// row's payout added to the stacks, nothing else changed, `cards` unused.
template <int P, int R, bool PAYOUT_ONLY = false, class Rows, class Deal>
MC_HD void mc_settle_pass(MCTable<P, R, Rows>& s, const Deal& cards, int sb,
                          int bb, int ss = 0, bool reset_stacks = false) {
  constexpr int L = MCTable<P, R, Rows>::L;
  constexpr int NC = 2 * P + 5;
  using C = MCCold<P, R>;
  constexpr bool REF = R == MC_REFERENCE;
  constexpr bool TOUR = R == MC_TOURNAMENT;
  constexpr int full = (1 << P) - 1;
  if constexpr (!PAYOUT_ONLY)
    if (!s.wait) return;
  uint32_t bm[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 5; ++i) mc_add_card(bm, s.rows.get(C::BOARD + i));
  int values[P], pay[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    uint32_t m[4] = {bm[0], bm[1], bm[2], bm[3]};
    mc_add_card(m, s.rows.get(C::HOLE0 + p));
    mc_add_card(m, s.rows.get(C::HOLE1 + p));
    values[p] = mc_eval_cmp(m[0], m[1], m[2], m[3]);
    pay[p] = 0;
  }
  for (int row = 0; row < 4 * L; ++row) {
    const int pot_set = s.rows.get(C::POT_SET + row);
    const int elig = pot_set & s.in_hand;
    if (elig == 0) continue;  // most rows: nobody eligible, nothing paid
    int vmax = 0, cnt = 0, first = P;
#pragma unroll
    for (int p = 0; p < P; ++p)
      if ((elig >> p) & 1) vmax = mc_max(vmax, values[p]);
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (((elig >> p) & 1) && values[p] == vmax) {
        ++cnt;
        first = mc_min(first, p);
      }
    if (cnt == 0) continue;
    const int amt = s.rows.get(C::POT_AMT + row);
    int total_pot;
    if constexpr (REF)  // amt * inflated n, remainders vanish
      total_pot = mc_mul(amt, s.rows.get(C::EXTRA + row));
    else  // exactly the chips contributed
      total_pot = mc_mul(amt, mc_popc((uint32_t)pot_set & (uint32_t)full));
    const int share = mc_floordiv(total_pot, cnt);
    // odd chips to the first-position winner
    const int rem = REF ? 0 : mc_floormod(total_pot, cnt);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (((elig >> p) & 1) && values[p] == vmax)
        pay[p] = mc_add(pay[p], share);
      if (!REF && p == first) pay[p] = mc_add(pay[p], rem);
    }
  }
  if constexpr (PAYOUT_ONLY) {
#pragma unroll
    for (int p = 0; p < P; ++p) s.stacks[p] = mc_add(s.stacks[p], pay[p]);
    return;
  }
  int delta[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    s.stacks[p] = mc_add(s.stacks[p], pay[p]);
    delta[p] = mc_sub(s.stacks[p], s.rows.get(C::HAND_START + p));
    s.rows.set(C::DELTA_SUM + p,
               mc_add(s.rows.get(C::DELTA_SUM + p), delta[p]));
  }
  // seat view of the positional deltas (and, in a tournament, of the
  // settled stacks): roll by the button; 0 for a button out of range
  const int button = s.rows.get(C::BUTTON);
  const int hand_ct = s.rows.get(C::HAND_CT);
  const bool button_ok = button >= 0 && button < P;
  if (button_ok) {
#pragma unroll
    for (int i = 0; i < P; ++i)
      s.rows.set(C::SEAT_DELTA + i,
                 mc_add(s.rows.get(C::SEAT_DELTA + i),
                        mc_sel<P>(delta, mc_wrap<P>(i - button + P))));
  }
  int shift = 1;  // the players list rotates to the next alive position
  bool redeal = true;
  if constexpr (TOUR) {
    // each seat's first bust: the 0-based index of the hand just settled
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int seat_stack =
          button_ok ? mc_sel<P>(s.stacks, mc_wrap<P>(i - button + P)) : 0;
      if (seat_stack <= 0 && s.rows.get(C::EXTRA + i) < 0)
        s.rows.set(C::EXTRA + i, hand_ct);
    }
    int n_alive = 0;
    shift = P;
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (s.stacks[p] > 0) {
        ++n_alive;
        if (p >= 1) shift = mc_min(shift, p);
      }
    shift = mc_min(mc_max(shift, 1), P - 1);
    redeal = n_alive > 1;
  }
  s.rows.set(C::HAND_CT, hand_ct + 1);
  for (int row = 0; row < 4 * L; ++row) {
    s.rows.set(C::POT_AMT + row, 0);
    s.rows.set(C::POT_SET + row, 0);
    if constexpr (REF) s.rows.set(C::EXTRA + row, 0);
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
#pragma unroll
  for (int p = 0; p < P; ++p)
    rot[p] = reset_stacks ? ss : mc_sel<P>(s.stacks, mc_wrap<P>(p + shift));
#pragma unroll
  for (int j = 0; j < L; ++j) s.lvl[j] = s.ln[j] = 0;
  int in_hand = full, to_act = full, bb_pos = 1;
  if constexpr (REF) {
#pragma unroll
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
#pragma unroll
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
    const int pay1 = mc_min(mc_max(mc_sel<P>(rot, bb_pos), 0), bb);
    int all_in = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int blind = p == 0 ? pay0 : (p == bb_pos ? pay1 : 0);
      s.stacks[p] = mc_sub(rot[p], blind);
      s.contrib[p] = blind;
      if (s.stacks[p] <= 0) all_in |= 1 << p;
    }
    if (pay0 > 0) mc_street_update<L>(s.lvl, s.ln, pay0);
    if (pay1 > 0) mc_street_update<L>(s.lvl, s.ln, pay1);
    all_in &= in_hand;
    s.all_in = all_in;
    to_act = in_hand & ~all_in;
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
  s.in_hand = in_hand;
  s.to_act = s.order = to_act;
  s.cursor = mc_wrap<P>(bb_pos + 1);
  s.folded = 0;
  s.stage = 0;
  s.rows.set(C::BUTTON, mc_floormod(button + shift, P));
}

// random_policy on two u32 words (_policy_prng) at the slot's head and
// street total: fold 15% (a free check when nothing is owed), raise 30% by
// 1..20 while the street has fewer than 2 raises, else call.
template <int P, int R, class Rows>
MC_HD int mc_policy(const MCTable<P, R, Rows>& s, int head, int total,
                    uint32_t u, uint32_t amt_bits, uint32_t fold_bits,
                    uint32_t raise_bits) {
  int amt = (int)(amt_bits % (uint32_t)MC_MAX_RAISE) + 1;
  bool owes = mc_sub(total, mc_sel<P>(s.contrib, head)) > 0;
  bool can_raise = s.street_raises < MC_MAX_RAISES_PER_STREET;
  bool is_fold = u < fold_bits;
  bool is_raise = u < raise_bits && !is_fold && can_raise;
  return is_fold ? (owes ? -1 : 0) : (is_raise ? amt : 0);
}

// Hand h's deal from a stash: card c at stash[(h * (2P+5) + c) * stride].
struct MCDealStash {
  const int* stash;
  long long stride;
  int hand_ptr;
  template <int NC>
  MC_HD void deal(int* out) const {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      out[c] = stash[((long long)hand_ptr * NC + c) * stride];
  }
};

// K3's warp schedule (mc_run_det): the warp settles its waiting tables
// together once at least this many of its 32 wait, or once none of them
// can step (chosen on the card: scripts/ab_engine.py --variants).
#define MC_DET_SETTLE_MIN 16

// The warp's lanes for which x holds, as a bit mask. Every lane of the
// warp must call it together. On the host, where the harness runs one
// table at a time, a warp is one lane.
MC_HD uint32_t mc_warp_ballot(bool x) {
#ifdef __CUDA_ARCH__
  return __ballot_sync(0xffffffffu, x);
#else
  return x ? 1u : 0u;
#endif
}

// K3's work for one table: n_steps fused steps, each a betting step and,
// where the hand ended, a settle pass. act[i * stride] is step i's raw
// action; hand h > 0 is dealt from stash row min(h, hmax - 1).
//
// A table's result depends on its own actions and hand count alone, so
// its settle pass may wait while the warp's other tables step: each table
// steps on its own cursor i until a hand ends, then waits, and the warp
// runs one settle pass for all its waiting tables at once (the pass is
// the heavy part: P hand keys, 4L pot rows, the deal). A frozen table
// neither steps nor waits. Every lane of the warp stays in the loop until
// none steps or waits; a lane without a table holds a frozen one. With a
// warp of one lane (the host) this is the loop of step i, then the settle
// pass, that the plain version runs.
template <int P, int R, class Rows>
MC_HD void mc_run_det(MCTable<P, R, Rows>& s, const int* act,
                      const int* stash, long long stride, int n_steps,
                      int hmax, int sb, int bb) {
  using C = MCCold<P, R>;
  constexpr int L = MCTable<P, R, Rows>::L;
  int i = 0;         // the table's next step
  bool due = false;  // step i - 1 ended a hand: settle before step i
  while (true) {
    if (!due && i < n_steps && !mc_frozen(s)) {
      if (s.order) {
        const int head = mc_head<P>(s.order, s.cursor);
        mc_step_nosettle(s, act[i * stride], head,
                         mc_street_total<L>(s.lvl));
      }
      ++i;
      due = s.wait;
    }
    const uint32_t waiting = mc_warp_ballot(due);
    const uint32_t stepping =
        mc_warp_ballot(!due && i < n_steps && !mc_frozen(s));
    if (!waiting && !stepping) return;
    if (due && (!stepping || mc_popc(waiting) >= MC_DET_SETTLE_MIN)) {
      const int hand_ptr = mc_min(s.rows.get(C::HAND_CT) + 1, hmax - 1);
      mc_settle_pass(s, MCDealStash{stash, stride, hand_ptr}, sb, bb);
      due = false;
    }
  }
}

// K4's work for one table: per iteration, `defer` betting slots of two
// words each (u, then amt_bits), then 2P+5 deal words and a settle pass.
// Iteration it's words start at word it * (2 defer + 2P + 5) of the
// table's stream, whoever reads them: a slot with no head draws nothing,
// and the deal is drawn only for a table that settles. A frozen table
// (mc_frozen) leaves the loop: every later slot and pass is a no-op.
template <int P, int R, class Rows, class Src>
MC_HD void mc_run_prng(MCTable<P, R, Rows>& s, Src& src, int n_steps,
                       int defer, int sb, int bb, uint32_t fold_bits,
                       uint32_t raise_bits) {
  constexpr int L = MCTable<P, R, Rows>::L;
  const uint32_t W = 2 * defer + 2 * P + 5;
  for (int it = 0; it < n_steps / defer; ++it) {
    if (mc_frozen(s)) break;
    const uint32_t base = (uint32_t)it * W;
    for (int k = 0; k < defer; ++k) {
      if (!s.order) continue;
      const uint32_t u = src.at(base + 2 * k);
      const uint32_t amt_bits = src.at(base + 2 * k + 1);
      const int head = mc_head<P>(s.order, s.cursor);
      const int total = mc_street_total<L>(s.lvl);
      mc_step_nosettle(
          s, mc_policy(s, head, total, u, amt_bits, fold_bits, raise_bits),
          head, total);
    }
    mc_settle_pass(s, MCDealDraw<Src>{src, base + 2 * defer}, sb, bb);
  }
}

// The first hand's scalar rules (ops/cuda_engine._first_hand, which
// pack_state follows): under standard and tournament rules the blinds are
// capped at the stack and a seat whose blind takes its whole stack is
// all-in; the street opens at levels lo = min(sb, bb) (2 contributors)
// and, when the blinds differ, hi = max(sb, bb) (1).
struct MCFirstHand {
  int sb, bb, all_in, lo, hi;
};

template <int P, int R>
MC_HD MCFirstHand mc_first_hand(int sb, int bb, int ss) {
  MCFirstHand h;
  if (R != MC_REFERENCE) {
    sb = mc_min(sb, mc_max(ss, 0));
    bb = mc_min(bb, mc_max(ss, 0));
  }
  h.sb = sb;
  h.bb = bb;
  h.all_in = 0;
  if (R != MC_REFERENCE) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (mc_sub(ss, p == 0 ? sb : (p == 1 ? bb : 0)) <= 0)
        h.all_in |= 1 << p;
  }
  h.lo = mc_min(sb, bb);
  h.hi = mc_max(sb, bb);
  return h;
}

// Table `table`'s F packed rows of a request's first state, row f at
// rows[f * stride], each written once: pack_state(cfg, first_deal(...))
// of that table. The first deal is 2P+5 cards drawn with no dead cards
// from Philox stream (seed, table, 0, 1), which no kernel draws from:
// holes round-robin (hole0 of seat k the k-th card, hole1 the (P+k)-th),
// then the board. Blinds posted (mc_first_hand), the cursor after the big
// blind, every other row 0 but bust_at (-1: nobody has busted).
template <int P, int R>
MC_HD void mc_first_state_rows(int* rows, long long stride, uint32_t seed,
                               uint32_t table, int sb, int bb, int ss) {
  using Lay = MCLayout<P, R>;
  using C = MCCold<P, R>;
  constexpr int NC = 2 * P + 5, full = (1 << P) - 1;
  constexpr int HOLE0 = C::field(C::HOLE0), BOARD = C::field(C::BOARD),
                HAND_START = C::field(C::HAND_START);
  const MCFirstHand h = mc_first_hand<P, R>(sb, bb, ss);
  int cards[NC];
  MCPhiloxWords src(seed, table, 0u, 1u);
  mc_sample_cards<NC>(src, nullptr, 0, cards);
  // f is a constant once unrolled, so every test below folds
#pragma unroll
  for (int f = 0; f < mc_fields<P, R>(); ++f) {
    int v = 0;
    if (f == Lay::CURSOR)
      v = 2 % P;
    else if (f == Lay::LAST_RAISER)
      v = P;
    else if (f == Lay::IN_HAND)
      v = full;
    else if (f == Lay::TO_ACT || f == Lay::ORDER)
      v = full & ~h.all_in;
    else if (f >= Lay::STACKS && f < Lay::STACKS + P)
      v = mc_sub(ss, f == Lay::STACKS ? h.sb
                     : f == Lay::STACKS + 1 ? h.bb : 0);
    else if (f == Lay::CONTRIB)
      v = h.sb;
    else if (f == Lay::CONTRIB + 1)
      v = h.bb;
    else if (f >= HOLE0 && f < HOLE0 + 2 * P)  // hole0, then hole1
      v = cards[f - HOLE0];
    else if (f >= HAND_START && f < HAND_START + P)
      v = ss;
    else if (f >= BOARD && f < BOARD + 5)
      v = cards[2 * P + f - BOARD];
    else if (f == Lay::LVL)
      v = h.lo;
    else if (f == Lay::LVL + 1)
      v = h.lo != h.hi ? h.hi : 0;
    else if (f == Lay::LN)
      v = 2;
    else if (f == Lay::LN + 1)
      v = h.lo != h.hi ? 1 : 0;
    else if (R != MC_REFERENCE && f == Lay::TAIL)
      v = h.all_in;
    else if (R == MC_TOURNAMENT && f > Lay::TAIL)
      v = -1;
    rows[f * stride] = v;
  }
}

#ifdef __CUDACC__
// Launch configuration of the kernels that keep their cold rows in shared
// memory (K3, K4, the stage probe): MC_ENGINE_THREADS tables a block (chosen
// on the card: montecarlo_tpu_torch/scripts/ab_engine.py --variants), the
// block's rows, and the blocks an SM holds by its shared memory (228 KB,
// less 1 KB the runtime keeps per block).
#define MC_ENGINE_THREADS 64
#define MC_SM_SHARED_BYTES (228 * 1024)
#define MC_BLOCK_RESERVED_SHARED_BYTES 1024

template <int P, int R>
constexpr int mc_engine_smem() {
  return MCCold<P, R>::N * MC_ENGINE_THREADS * (int)sizeof(int);
}

template <int P, int R>
constexpr int mc_engine_blocks_per_sm() {
  return MC_SM_SHARED_BYTES /
         (mc_engine_smem<P, R>() + MC_BLOCK_RESERVED_SHARED_BYTES);
}

using MCEngineRows = MCRowsShared<MC_ENGINE_THREADS>;
static_assert(MC_TABLES_PER_BLOCK % MC_ENGINE_THREADS == 0,
              "a CUDA block lies within a state block");

// Shared memory above 48 KB is dynamic only after this opt-in. The L1 /
// shared split is left to the driver, which sizes it to the blocks that
// fit (asking for the whole shared memory measured the same).
template <typename Kernel>
static cudaError_t mc_engine_attributes(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}
#endif  // __CUDACC__

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
