"""Exact heads-up TURN+RIVER two-street subgame solver (CFR+). The port of
``montecarlo_tpu/models/turn_solver.py``.

Game definition
---------------
Both players hold a combo from the C(48, 2) pairs off the turn board
(uniform prior over card-removal-consistent (hero, villain, river)
triples). The turn street uses the river solver's 5-node tree (one bet
size ``B``, one raise TO ``B + R``):

    P1: check | bet
      check -> P2: check          -> line "cc"  (river, pot)
                 bet -> P1: fold                  (P1 nets 0)
                        call      -> line "xbc" (river, pot + 2B)
      bet   -> P2: fold                           (P1 nets +pot)
                 call             -> line "bc"  (river, pot + 2B)
                 raise -> P1: fold                (P1 nets -B)
                          call    -> line "brc" (river, pot + 2(B+R))

Each continue line L reaches a river subgame with pot ``pot_L`` and its
own tree (bet ``B_L = river_bet_frac * pot_L`` or ``river_bets[L]``,
raise TO ``B_L + R_L`` with ``R_L = pot_L + 2 B_L``). The chance node is
uniform over the rivers valid for the (hero, villain) pair. Utilities are
P1's net chips from the TURN start; the game stays constant-sum at
``pot``.

Solver: CFR+ with alternating updates and linear averaging, river
infosets indexed [line, river, combo]. The JAX module sweeps the rivers in
a loop with the four lines inside it; here every river and line moves at
once. River r's chance weight of a pair is the panel
``M[r] = mask0 * free_r free_r^T / cnt`` ([Rn, C, C], built once a call
with ``MW = M * W_r``), and every river value is a sum over the opponent
of M or MW times a per-opponent vector (a utility is an affine form of
W), so one pass is two batched products over all (river, line, vector)
columns. The update order is the JAX body's: the P1 river pass on the
pre-update reaches, the P2 pass on the reaches of the updated turn P1
strategies and the updated P1 river regrets, then every river average
from the regrets after both updates, weighted by the reaches before them.

The products are float32 with TF32 off (``require_full_f32``): TF32's
10-bit mantissa moves EVs by about 1e-3 relative.

Validation reductions (``tests/test_turn_solver.py``, on the port in
``tests/test_torch_turn_solver.py``): ``river_betting=False`` is the
one-street game on the chance-averaged equity matrix; ``turn_betting=
False`` with a single river is the river subgame on board + [r].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.models.river_solver import (
    _Iterations,
    _advance,
    _average,
    _clash_free,
    _free_map,
    _hand_keys,
    _menu_size,
    _node_probs,
    _normalize,
    _owed2_map,
    _pot_share,
    _regret_step,
    _scripted_deck,
)

F32 = torch.float32

LINES = ("cc", "xbc", "bc", "brc")


class TurnRiverGame(NamedTuple):
    keys: torch.Tensor     # [Rn, C] int64 7-card eval keys per river card
    has_r: torch.Tensor    # [Rn, C] f32: combo contains that river card
    mask0: torch.Tensor    # [C, C] valid pair indicator (f32; cnt>0 folded in)
    cnt: torch.Tensor      # [C, C] f32 number of valid rivers per pair
    rivers: torch.Tensor   # [Rn] i32 river card ids
    pot: float
    bet: float             # turn bet B
    raise_: float          # turn raise increment R (raise TO B + R)
    river_bet_frac: float = 1.0
    turn_betting: bool = True
    river_betting: bool = True
    # Raise gates: the no-raise tree is the deepest game that fits the
    # engine's 100-chip stacks with the nets' own pot-raise menu sizes.
    turn_raise: bool = True
    river_raise: bool = True
    # Optional per-line river bet override [4] (chips): the net's actual
    # menu sizes, measured by turn_river_node_states.
    river_bets: Optional[Tuple[float, float, float, float]] = None

    @property
    def pots_l(self) -> np.ndarray:
        pot, B, R = self.pot, self.bet, self.raise_
        return np.array([pot, pot + 2 * B, pot + 2 * B, pot + 2 * (B + R)],
                        np.float64)

    @property
    def c1_l(self) -> np.ndarray:
        """P1 turn contribution per line."""
        B, R = self.bet, self.raise_
        return np.array([0.0, B, B, B + R], np.float64)


class TurnRiverStrategy(NamedTuple):
    """Average strategies. Turn nodes [C, A]; river nodes [4, Rn, C, A]
    (line-major). Rows sum to 1 where live."""
    t0: torch.Tensor  # [C, 2] P1 turn root: check / bet
    t1: torch.Tensor  # [C, 2] P2 after check: check / bet
    t2: torch.Tensor  # [C, 2] P1 after check-bet: fold / call
    t3: torch.Tensor  # [C, 3] P2 after bet: fold / call / raise
    t4: torch.Tensor  # [C, 2] P1 after bet-raise: fold / call
    s0: torch.Tensor  # [4, Rn, C, 2] P1 river root
    s1: torch.Tensor  # [4, Rn, C, 2] P2 river after check
    s2: torch.Tensor  # [4, Rn, C, 2] P1 river after check-bet
    s3: torch.Tensor  # [4, Rn, C, 3] P2 river after bet
    s4: torch.Tensor  # [4, Rn, C, 2] P1 river after bet-raise


def turn_combos(board4: Sequence[int]) -> np.ndarray:
    dead = set(int(c) for c in board4)
    live = [c for c in range(52) if c not in dead]
    return np.array([(a, b) for i, a in enumerate(live)
                     for b in live[i + 1:]], np.int32)


def make_turn_river_game(board4: Sequence[int],
                         rivers: Optional[Sequence[int]] = None,
                         combos: Optional[np.ndarray] = None,
                         pot: float = 4.0, bet: float = 4.0,
                         raise_: float = 12.0,
                         river_bet_frac: float = 1.0,
                         turn_betting: bool = True,
                         river_betting: bool = True,
                         turn_raise: bool = True,
                         river_raise: bool = True,
                         river_bets: Optional[Sequence[float]] = None,
                         device=None) -> Tuple[TurnRiverGame, np.ndarray]:
    """Build the two-street game from the port's evaluator on ``device``
    (the card when None). ``rivers`` defaults to every card off the turn
    board (the exact game); a subset defines a smaller exact game.
    Returns (game, combos)."""
    dev = resolve(device)
    board4 = np.asarray(board4, np.int32)
    if board4.shape != (4,):
        raise ValueError(f"a turn board has 4 cards, got {board4.shape}")
    dead = set(int(c) for c in board4)
    if rivers is None:
        rivers = [c for c in range(52) if c not in dead]
    rivers = np.asarray(rivers, np.int32)
    if set(rivers.tolist()) & dead:
        raise ValueError("a river card is on the turn board")
    if combos is None:
        combos = turn_combos(board4)
    combos = np.asarray(combos, np.int32)

    boards = np.concatenate([np.broadcast_to(board4, (len(rivers), 4)),
                             rivers[:, None]], 1)
    keys = _hand_keys(combos, boards, dev)                    # [Rn, C]
    has_r = ((combos[None, :, 0] == rivers[:, None])
             | (combos[None, :, 1] == rivers[:, None])).astype(np.float32)
    # valid rivers per pair; pairs with none are dead (single-river games)
    free = 1.0 - has_r
    cnt = free.T @ free
    mask0 = _clash_free(combos, combos) * (cnt > 0)
    return (TurnRiverGame(
        keys, torch.as_tensor(has_r, device=dev),
        torch.as_tensor(mask0, device=dev), torch.as_tensor(cnt, device=dev),
        torch.as_tensor(rivers, device=dev), float(pot), float(bet),
        float(raise_), float(river_bet_frac), bool(turn_betting),
        bool(river_betting), bool(turn_raise), bool(river_raise),
        None if river_bets is None
        else tuple(float(b) for b in river_bets)), combos)


def require_full_f32() -> None:
    """Refuse to run the solver's products with TF32 on: its 10-bit
    mantissa moves EVs by about 1e-3 relative, past the gates the
    records are held to."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: "
                           "the solvers need float32 products")


def _river_sizes(game: TurnRiverGame):
    """Per-line (pot_L, B_L, R_L), each f32 [4, 1, 1] (broadcasting over
    rivers and combos)."""
    dev = game.mask0.device
    pots = torch.tensor(game.pots_l, dtype=F32, device=dev)
    if game.river_bets is not None:
        bl = torch.tensor(game.river_bets, dtype=F32, device=dev)
    else:
        bl = game.river_bet_frac * pots
    rl = pots + 2.0 * bl  # pot-raise facing the bet
    return tuple(x[:, None, None] for x in (pots, bl, rl))


def _gates(game: TurnRiverGame):
    """(turn P1-root gate [2], turn P2 gates [2]/[3], river gates)."""
    tb = 1.0 if game.turn_betting else 0.0
    rb = 1.0 if game.river_betting else 0.0
    tr = tb if game.turn_raise else 0.0
    rr = rb if game.river_raise else 0.0
    dev = game.mask0.device

    def g(*x):
        return torch.tensor(x, dtype=F32, device=dev)

    return dict(t0=g(1.0, tb), t1=g(1.0, tb), t3=g(1.0, 1.0, tr),
                s0=g(1.0, rb), s1=g(1.0, rb), s3=g(1.0, 1.0, rr))


def _w_matrix(keys_r):
    """P1 pot share [..., C, C] for river keys [..., C]."""
    return _pot_share(keys_r, keys_r)


def _panels(game: TurnRiverGame):
    """(M, MW) [Rn, C, C]: the chance weight mask0 * free_r free_r^T / cnt
    of each (river, pair), and M times that river's pot share."""
    require_full_f32()
    free = 1.0 - game.has_r
    safe_cnt = torch.where(game.cnt > 0, game.cnt, 1.0)
    M = game.mask0 * free[:, :, None] * free[:, None, :] / safe_cnt
    return M, M * _w_matrix(game.keys)


def _products(M, MW, x, over_rows: bool):
    """Sums over the opponent of both panels times the vectors ``x``
    [4, Rn, C, k] (line, river, opponent combo, vector): over villains
    (columns) for P1 values, over heroes (rows, ``over_rows``) for P2's.
    Returns (M-sums, MW-sums), each [4, Rn, C, k]."""
    L, Rn, C, k = x.shape
    cols = x.permute(1, 2, 0, 3).reshape(Rn, C, L * k)
    if over_rows:
        M, MW = M.mT, MW.mT
    out = [torch.bmm(P, cols).reshape(Rn, C, L, k).permute(2, 0, 1, 3)
           for P in (M, MW)]
    return out[0], out[1]


def _river_p1_values(M, MW, sizes, rho2, s1, s2, s3, s4, best=False):
    """River-street P1 action values at every (line, river): the river
    solver's _p1_values with line-vectorized sizes, weighted by chance
    and the P2 turn reach ``rho2`` [4, C]. s* [4, Rn, C, A]. Returns
    (v0, v2, v4) [4, Rn, C, A]; with ``best`` v0 takes P1's best play at
    n2 and n4 instead of s2 and s4."""
    pot, B, R = sizes
    x = torch.stack([s3[..., 2], s1[..., 1], s3[..., 0], s3[..., 1],
                     s1[..., 0]], -1) * rho2[:, None, :, None]
    A, Aw = _products(M, MW, x, over_rows=False)
    v4 = torch.stack([A[..., 0] * (-B),
                      (pot + 2 * (B + R)) * Aw[..., 0] - (B + R) * A[..., 0]],
                     -1)
    v2 = torch.stack([torch.zeros_like(A[..., 1]),
                      (pot + 2 * B) * Aw[..., 1] - B * A[..., 1]], -1)
    check = pot * Aw[..., 4]
    # bc and xbc have identical payoffs (one bet called either way)
    bet = A[..., 2] * pot + ((pot + 2 * B) * Aw[..., 3] - B * A[..., 3])
    if best:
        v0 = torch.stack([check + v2.amax(-1), bet + v4.amax(-1)], -1)
    else:
        v0 = torch.stack([check + (s2 * v2).sum(-1),
                          bet + (s4 * v4).sum(-1)], -1)
    return v0, v2, v4


def _river_p2_values(M, MW, sizes, rho1, s0, s2, s4):
    """River-street P2 action values (v1, v3) at every (line, river),
    weighted by chance and the P1 turn reach ``rho1`` [4, C] (P2 utility
    = pot - U1)."""
    pot, B, R = sizes
    a, b = s0[..., 0], s0[..., 1]
    y = torch.stack([a, a * s2[..., 0], a * s2[..., 1], b, b * s4[..., 0],
                     b * s4[..., 1]], -1) * rho1[:, None, :, None]
    A, Aw = _products(M, MW, y, over_rows=True)
    v1 = torch.stack([
        pot * A[..., 0] - pot * Aw[..., 0],
        A[..., 1] * pot + ((pot + B) * A[..., 2]
                           - (pot + 2 * B) * Aw[..., 2])], -1)
    v3 = torch.stack([
        torch.zeros_like(A[..., 3]),
        (pot + B) * A[..., 3] - (pot + 2 * B) * Aw[..., 3],
        A[..., 4] * (pot + B) + ((pot + B + R) * A[..., 5]
                                 - (pot + 2 * (B + R)) * Aw[..., 5])], -1)
    return v1, v3


def _gate_p2_best(game, v1, v3):
    """A disabled action is unavailable to the best response: its value
    sits below every allowed one (never ``-inf``)."""
    if not game.river_betting:
        v1 = torch.stack([v1[..., 0], v1[..., 0] - 1.0], -1)
    if not (game.river_betting and game.river_raise):
        v3 = torch.cat([v3[..., :2], v3.amin(-1, keepdim=True) - 1.0], -1)
    return v1, v3


def _turn_p1_values(game, t1, t2, t3, t4, V1):
    """P1 turn action values (v0, v2, v4) from per-line river entry
    values V1 [4, C] vs P2 turn strategies."""
    mask0 = game.mask0
    pot, B, R = game.pot, game.bet, game.raise_
    s2sum = {L: (mask0 * rho[None, :]).sum(1)
             for L, rho in ((1, t1[:, 1]), (2, t3[:, 1]), (3, t3[:, 2]))}
    v4 = torch.stack([-B * s2sum[3], V1[3] - (B + R) * s2sum[3]], 1)
    v2 = torch.stack([torch.zeros_like(V1[1]), V1[1] - B * s2sum[1]], 1)
    v_check = V1[0] + (t2 * v2).sum(1)
    v_bet = (pot * (mask0 * t3[None, :, 0]).sum(1)
             + V1[2] - B * s2sum[2]
             + (t4 * v4).sum(1))
    return torch.stack([v_check, v_bet], 1), v2, v4


def _turn_p2_terms(game, t0, t2, t4, V2):
    """P2 turn values (v1_check, v1_bet, v3_fold, v3_call, v3_raise), each
    [C], from per-line river entry values V2 [4, C] vs P1 turn
    strategies."""
    mask0 = game.mask0
    pot, B, R = game.pot, game.bet, game.raise_

    def opp(x):
        return (mask0 * x[:, None]).sum(0)

    v1_bet = (pot * opp(t0[:, 0] * t2[:, 0]) + V2[1]
              - B * opp(t0[:, 0] * t2[:, 1]))
    v3_call = V2[2] - B * opp(t0[:, 1])
    v3_raise = ((pot + B) * opp(t0[:, 1] * t4[:, 0]) + V2[3]
                - (B + R) * opp(t0[:, 1] * t4[:, 1]))
    return V2[0], v1_bet, torch.zeros_like(V2[2]), v3_call, v3_raise


def _turn_p2_values(game, t0, t2, t4, V2):
    """P2 turn action values (v1, v3)."""
    v1c, v1b, v3f, v3c, v3r = _turn_p2_terms(game, t0, t2, t4, V2)
    return torch.stack([v1c, v1b], 1), torch.stack([v3f, v3c, v3r], 1)


def _turn_reaches(t0, t1, t2, t3, t4):
    """Per-line (P1 reach [4, C], P2 reach [4, C]) along the turn tree."""
    rho1 = torch.stack([t0[:, 0], t0[:, 0] * t2[:, 1],
                        t0[:, 1], t0[:, 1] * t4[:, 1]])
    rho2 = torch.stack([t1[:, 0], t1[:, 1], t3[:, 1], t3[:, 2]])
    return rho1, rho2


def _avg_turn_reaches(strat: TurnRiverStrategy):
    return _turn_reaches(strat.t0, strat.t1, strat.t2, strat.t3, strat.t4)


@torch.no_grad()
def solve_turn_river(game: TurnRiverGame, iterations: int = 1000,
                     progress_every: int = 0, log=None,
                     mesh=None) -> TurnRiverStrategy:
    """CFR+ (alternating updates, linear averaging) over both streets, on
    the game's device. ``progress_every`` > 0 logs the certified gap of
    the running average via ``log`` (default: print) at the JAX module's
    points: every that-many iterations counted in chunks of
    min(50, progress_every), and at the end.

    ``mesh``: an optional ``parallel/mesh.Mesh``. The rivers split over
    its ranks (rank r holds rivers r Rn/W .. (r + 1) Rn/W - 1: their
    panels, regrets and averages), each rank sweeps its own, and the
    per-line street-boundary entry values V1 and V2 are summed over the
    ranks (``all_reduce``); the turn updates, O(C) next to the O(Rn C^2)
    river work, are replicated. The river count must divide by the world
    size. As in JAX's mesh mode a ragged tail is rounded up to a full
    chunk of iterations, and the river averages are gathered once at the
    end (and at each progress point), so every rank returns the whole
    strategy. The iterations run eagerly (no CUDA graph: a collective is
    not captured). Equal to the single solve up to the order of the
    float32 sums over rivers; at one rank, bit for bit."""
    C = game.mask0.shape[0]
    Rn = game.keys.shape[0]
    dev = game.mask0.device
    g = _gates(game)
    sizes = _river_sizes(game)
    if mesh is not None:
        from montecarlo_tpu_torch.parallel.mesh import all_gather, all_reduce

        if Rn % mesh.size:
            raise ValueError(f"river count {Rn} must divide by the world "
                             f"size {mesh.size}")
        Rn //= mesh.size
        rivers = slice(mesh.rank * Rn, (mesh.rank + 1) * Rn)
        M, MW = _panels(game._replace(keys=game.keys[rivers],
                                      has_r=game.has_r[rivers]))
    else:
        M, MW = _panels(game)

    def street_sum(V):
        """The entry values summed over every rank's rivers."""
        return V if mesh is None else all_reduce(mesh, V)

    def zeros(*shape):
        return torch.zeros(shape, dtype=F32, device=dev)

    tr = [zeros(C, 2), zeros(C, 2), zeros(C, 2), zeros(C, 3), zeros(C, 2)]
    ta = [torch.zeros_like(x) for x in tr]
    rr = [zeros(4, Rn, C, x.shape[1]) for x in tr]
    ra = [torch.zeros_like(x) for x in rr]
    gates = (g["t0"], g["t1"], None, g["t3"], None)
    rgates = (g["s0"], g["s1"], None, g["s3"], None)

    w = torch.zeros((), dtype=F32, device=dev)

    def normed(regrets, allow):
        return [_normalize(r, a) for r, a in zip(regrets, allow)]

    def update(regrets, pairs):
        """CFR+ regret updates, in place (the iterations replay a graph)."""
        for i, s, v in pairs:
            regrets[i].copy_(_regret_step(regrets[i], s, v))

    def step():
        t0, t1, t2, t3, t4 = normed(tr, gates)

        # ---- P1 update: river infosets then turn infosets ----
        rho1, rho2 = _turn_reaches(t0, t1, t2, t3, t4)
        s0, s1, s2, s3, s4 = normed(rr, rgates)
        v0, v2, v4 = _river_p1_values(M, MW, sizes, rho2, s1, s2, s3, s4)
        update(rr, ((0, s0, v0), (2, s2, v2), (4, s4, v4)))
        V1 = street_sum((s0 * v0).sum(-1).sum(1))
        u0, u2, u4 = _turn_p1_values(game, t1, t2, t3, t4, V1)
        update(tr, ((0, t0, u0), (2, t2, u2), (4, t4, u4)))
        ta[0] += w * t0
        ta[2] += w * t0[:, 0][:, None] * t2
        ta[4] += w * t0[:, 1][:, None] * t4

        # ---- P2 update vs P1's just-updated strategies ----
        t0n, _, t2n, _, t4n = normed(tr, gates)
        rho1n, _ = _turn_reaches(t0n, t1, t2n, t3, t4n)
        s0n, _, s2n, _, s4n = normed(rr, rgates)
        v1, v3 = _river_p2_values(M, MW, sizes, rho1n, s0n, s2n, s4n)
        update(rr, ((1, s1, v1), (3, s3, v3)))
        V2 = street_sum(((s1 * v1).sum(-1) + (s3 * v3).sum(-1)).sum(1))
        u1, u3 = _turn_p2_values(game, t0n, t2n, t4n, V2)
        update(tr, ((1, t1, u1), (3, t3, u3)))
        ta[1] += w * t1
        ta[3] += w * t3

        # ---- river averages: the regrets after both updates, weighted
        # by the owner's reach before them ----
        s0, s1, s2, s3, s4 = normed(rr, rgates)
        w1 = (w * rho1)[:, None, :, None]
        w2 = (w * rho2)[:, None, :, None]
        ra[0] += w1 * s0
        ra[2] += (w1 * s0[..., :1]) * s2
        ra[4] += (w1 * s0[..., 1:]) * s4
        ra[1] += w2 * s1
        ra[3] += w2 * s3

    def to_strategy():
        whole = ra if mesh is None else [all_gather(mesh, a, 1) for a in ra]
        return TurnRiverStrategy(
            *[_average(a, x) for a, x in zip(ta, gates)],
            *[_average(a, x) for a, x in zip(whole, rgates)])

    chunk = max(1, min(50, progress_every or 50))
    log = log or (lambda d: print(d, flush=True))
    loop = _Iterations(step, w)
    t = 0
    while t < iterations:
        n = min(chunk, iterations - t)
        if mesh is None:
            loop.run(t, t + n)
        else:  # a full chunk, eagerly
            n = chunk
            for i in range(t, t + n):
                w.fill_(i + 1)
                step()
        t += n
        if progress_every and (t % progress_every == 0 or t >= iterations):
            log({"iteration": t,
                 "gap": round(exploitability_gap(game, to_strategy()), 5)})
    return to_strategy()


# ---------------------------------------------------------------------------
# Evaluation: strategy EV, best responses, exploitability gap
# ---------------------------------------------------------------------------

def _entry_values_p1(game, strat, best: bool, panels=None):
    """Per-line P1 river entry values [4, C] vs P2's average river
    strategy; ``best`` replaces P1's river play with argmax (BR)."""
    M, MW = panels or _panels(game)
    _, rho2 = _avg_turn_reaches(strat)
    v0, _, _ = _river_p1_values(M, MW, _river_sizes(game), rho2, strat.s1,
                                strat.s2, strat.s3, strat.s4, best=best)
    if not best:
        return (strat.s0 * v0).sum(-1).sum(1)
    if not game.river_betting:
        v0 = torch.stack([v0[..., 0], v0[..., 0] - 1.0], -1)
    return v0.amax(-1).sum(1)


def _entry_values_p2(game, strat, best: bool, panels=None):
    """Per-line P2 river entry values [4, C] vs P1's average river
    strategy (P1's turn reach folded in)."""
    M, MW = panels or _panels(game)
    rho1, _ = _avg_turn_reaches(strat)
    v1, v3 = _river_p2_values(M, MW, _river_sizes(game), rho1, strat.s0,
                              strat.s2, strat.s4)
    if not best:
        return ((strat.s1 * v1).sum(-1) + (strat.s3 * v3).sum(-1)).sum(1)
    v1, v3 = _gate_p2_best(game, v1, v3)
    return (v1.amax(-1) + v3.amax(-1)).sum(1)


@torch.no_grad()
def strategy_values(game: TurnRiverGame, strat: TurnRiverStrategy
                    ) -> Tuple[float, float]:
    """(P1 EV, P2 EV) under the average profile; sums to pot."""
    V1 = _entry_values_p1(game, strat, best=False)
    v0, _, _ = _turn_p1_values(game, strat.t1, strat.t2, strat.t3,
                               strat.t4, V1)
    ev1 = float((strat.t0 * v0).sum(1).sum() / game.mask0.sum())
    return ev1, float(game.pot) - ev1


def _turn_best_p1(game, strat, B1):
    """P1's best turn values (v_check, v_bet, v2, v4) from its best river
    entry values B1 [4, C], gated."""
    pot, B, R = game.pot, game.bet, game.raise_
    mask0 = game.mask0
    t1, t3 = strat.t1, strat.t3
    s2sum = {L: (mask0 * rho[None, :]).sum(1)
             for L, rho in ((1, t1[:, 1]), (2, t3[:, 1]), (3, t3[:, 2]))}
    v4 = torch.stack([-B * s2sum[3], B1[3] - (B + R) * s2sum[3]], 1)
    v2 = torch.stack([torch.zeros_like(B1[1]), B1[1] - B * s2sum[1]], 1)
    v_check = B1[0] + v2.amax(1)
    v_bet = (pot * (mask0 * t3[None, :, 0]).sum(1)
             + B1[2] - B * s2sum[2] + v4.amax(1))
    if not game.turn_betting:
        v_bet = v_check - 1.0
    return v_check, v_bet, v2, v4


def _turn_best_p2(game, strat, B2):
    """P2's best turn values (v1 [C, 2], v3 [C, 3]) from its best river
    entry values B2 [4, C], gated."""
    v1c, v1b, v3f, v3c, v3r = _turn_p2_terms(game, strat.t0, strat.t2,
                                             strat.t4, B2)
    if not game.turn_betting:
        v1b = v1c - 1.0
    if not (game.turn_betting and game.turn_raise):
        v3r = torch.minimum(v3f, torch.minimum(v3c, v3r)) - 1.0
    return torch.stack([v1c, v1b], 1), torch.stack([v3f, v3c, v3r], 1)


@torch.no_grad()
def best_response_values(game: TurnRiverGame, strat: TurnRiverStrategy
                         ) -> Tuple[float, float]:
    """(BR1, BR2) vs the average profile; gap = br1 + br2 - pot >= 0."""
    pairs = game.mask0.sum()
    panels = _panels(game)
    v_check, v_bet, _, _ = _turn_best_p1(
        game, strat, _entry_values_p1(game, strat, True, panels))
    br1 = float(torch.maximum(v_check, v_bet).sum() / pairs)
    v1, v3 = _turn_best_p2(game, strat,
                           _entry_values_p2(game, strat, True, panels))
    br2 = float((v1.amax(1) + v3.amax(1)).sum() / pairs)
    return br1, br2


def exploitability_gap(game: TurnRiverGame,
                       strat: TurnRiverStrategy) -> float:
    br1, br2 = best_response_values(game, strat)
    return br1 + br2 - float(game.pot)


def _onehot(v):
    """One-hot of the FIRST maximum along the last axis (``jnp.argmax``'s
    choice among ties), float32."""
    cols = torch.arange(v.shape[-1], device=v.device)
    idx = torch.where(v == v.amax(-1, keepdim=True), cols,
                      v.shape[-1]).amin(-1)
    return (cols == idx[..., None]).to(F32)


@torch.no_grad()
def best_response_strategy(game: TurnRiverGame, strat: TurnRiverStrategy
                           ) -> TurnRiverStrategy:
    """Per-infoset one-hot best responses against the profile ``strat``.

    P1 nodes (t0/t2/t4, s0/s2/s4) best-respond to strat's P2 nodes and P2
    nodes (t1/t3, s1/s3) to strat's P1 nodes — the bottom-up max of
    ``best_response_values`` with the argmax recorded per node. Mixing the
    returned P1 nodes with strat's P2 nodes reproduces br1 (and
    symmetrically br2). Ties resolve to the first action, so unreached
    infosets (all-zero values) take action 0."""
    M, MW = _panels(game)
    sizes = _river_sizes(game)
    rho1, rho2 = _avg_turn_reaches(strat)

    # ---- P1: river argmaxes bottom-up, then turn argmaxes ----
    v0, v2, v4 = _river_p1_values(M, MW, sizes, rho2, strat.s1, strat.s2,
                                  strat.s3, strat.s4, best=True)
    if not game.river_betting:
        v0 = torch.stack([v0[..., 0], v0[..., 0] - 1.0], -1)
    s0b, s2b, s4b = _onehot(v0), _onehot(v2), _onehot(v4)
    v_check, v_bet, u2, u4 = _turn_best_p1(game, strat,
                                           v0.amax(-1).sum(1))
    t0b = _onehot(torch.stack([v_check, v_bet], 1))
    t2b, t4b = _onehot(u2), _onehot(u4)

    # ---- P2: river argmaxes, then turn argmaxes ----
    v1, v3 = _river_p2_values(M, MW, sizes, rho1, strat.s0, strat.s2,
                              strat.s4)
    v1, v3 = _gate_p2_best(game, v1, v3)
    s1b, s3b = _onehot(v1), _onehot(v3)
    u1, u3 = _turn_best_p2(game, strat,
                           (v1.amax(-1) + v3.amax(-1)).sum(1))
    return TurnRiverStrategy(t0=t0b, t1=_onehot(u1), t2=t2b,
                             t3=_onehot(u3), t4=t4b, s0=s0b, s1=s1b,
                             s2=s2b, s3=s3b, s4=s4b)


def mix_strategies(p1_nodes: TurnRiverStrategy,
                   p2_nodes: TurnRiverStrategy) -> TurnRiverStrategy:
    """Profile with P1's nodes from one strategy, P2's from another."""
    return TurnRiverStrategy(
        t0=p1_nodes.t0, t1=p2_nodes.t1, t2=p1_nodes.t2, t3=p2_nodes.t3,
        t4=p1_nodes.t4, s0=p1_nodes.s0, s1=p2_nodes.s1, s2=p1_nodes.s2,
        s3=p2_nodes.s3, s4=p1_nodes.s4)


# ---------------------------------------------------------------------------
# Trained-net Nash gap: extract a policy artifact's two-street strategy
# and measure its exploitability in the solved subgame
# ---------------------------------------------------------------------------

def turn_river_node_states(board4: Sequence[int],
                           rivers: Sequence[int], pot_bb: int = 2,
                           with_prelude: bool = False, device=None):
    """Engine states at every decision node of the NO-RAISE two-street
    tree, on ``device`` (the card when None).

    A heads-up hand is scripted to the TURN on an injected deck (blinds,
    SB call, BB check, flop checks -> pot = 2bb = 20 chips), then the
    in-tree prefixes are applied. Bets are the NET'S OWN pot-raise menu
    sizes, measured from ``action_from_index(3, state)`` at each node
    (turn 20; river 20 on the check-check line, 30 on the bet-called
    lines).

    Returns (turn_states, river_states, sizes[, prelude]):
      turn_states:  node -> one-table TableState (n0..n3)
      river_states: line -> node -> TableState with a table per river
      sizes: dict(pot, bet, river_bets) matching
             make_turn_river_game(pot=pot, bet=bet,
             river_bets=river_bets, turn_raise=False, river_raise=False)
      prelude (``with_prelude``): the scripted preflop/flop nodes pf0, pf1,
             fl0, fl1 (distillation's early-street self-anchor states).
    Every state equals the JAX module's in every field but ``key``."""
    from montecarlo_tpu_torch.engine.state import (
        TableConfig,
        init_state,
        redeal,
    )

    if pot_bb != 2:
        raise ValueError("the scripted prelude produces a 2bb turn pot")
    cfg = TableConfig(num_seats=2, rules="standard", bets_impl="levels")
    dev = resolve(device)
    rivers = np.asarray(rivers, np.int32)
    pot = 2 * cfg.big_blind
    decks = np.stack([_scripted_deck(board4, [r]) for r in rivers])

    def dealt(n):
        return redeal(init_state(0, cfg, n, dev), decks[:n])

    def to_turn(n):
        # SB call, BB check (preflop), check-check (flop) -> turn
        return _advance(dealt(n), [0, 0, 0, 0])

    turn0 = to_turn(1)
    B = _menu_size(turn0)  # the net's turn bet
    if B != pot:
        raise RuntimeError(f"the net's turn bet {B} is not the pot {pot}")
    turn_states = {
        "n0": turn0,                       # P1 to act
        "n1": _advance(turn0, [0]),        # P2 after check
        "n2": _advance(turn0, [0, B]),     # P1 facing bet
        "n3": _advance(turn0, [B]),        # P2 facing bet
    }

    line_actions = {"cc": [0, 0], "xbc": [0, B, 0], "bc": [B, 0]}
    all_turns = to_turn(len(rivers))
    river_states, river_bets = {}, {}
    for L, acts in line_actions.items():
        # the quirky pot formula depends only on the betting line
        bl = _menu_size(_advance(turn0, acts))
        river_bets[L] = float(bl)
        r0 = _advance(all_turns, acts)
        river_states[L] = dict(n0=r0, n1=_advance(r0, [0]),
                               n2=_advance(r0, [0, bl]),
                               n3=_advance(r0, [bl]))
    sizes = dict(
        pot=float(pot), bet=float(B),
        river_bets=(river_bets["cc"], river_bets["xbc"],
                    river_bets["bc"], river_bets["bc"]))
    if with_prelude:
        s0 = dealt(1)
        prelude = {"pf0": s0, "pf1": _advance(s0, [0]),
                   "fl0": _advance(s0, [0, 0]),
                   "fl1": _advance(s0, [0, 0, 0])}
        return turn_states, river_states, sizes, prelude
    return turn_states, river_states, sizes


def _owed_call_map(p):
    """Menu probabilities -> {fold, call (+ raise mass), raise 0}."""
    return torch.stack([p[..., 0], p[..., 1] + p[..., 2] + p[..., 3],
                        torch.zeros_like(p[..., 0])], -1)


def net_turn_river_strategy(params, turn_states, river_states, combos,
                            matmul: str = "f32") -> TurnRiverStrategy:
    """Extract an artifact's two-street strategy (no-raise tree), on the
    states' device.

    Menu mapping as in ``river_solver.net_river_strategy``: with nothing
    owed {check = call-menu, bet = either raise size}; facing a bet
    {fold, call = call + raise mass}. The masked softmax is the artifact's
    own play distribution. Each river node is one batch of rivers x
    combos tables. ``matmul`` as in ``river_solver.net_river_strategy``."""
    C = len(combos)

    def probs(state, head_pos):
        """[tables, C, 4] at a node."""
        return _node_probs(params, state, head_pos, combos, matmul).reshape(
            state.n_tables, C, -1)

    t0 = _free_map(probs(turn_states["n0"], 0)[0])
    t1 = _free_map(probs(turn_states["n1"], 1)[0])
    t2 = _owed2_map(probs(turn_states["n2"], 0)[0])
    t3 = _owed_call_map(probs(turn_states["n3"], 1)[0])
    half = torch.full_like(t0, 0.5)

    s0, s1, s2, s3 = [], [], [], []
    for L in ("cc", "xbc", "bc"):
        ns = river_states[L]
        s0.append(_free_map(probs(ns["n0"], 0)))
        s1.append(_free_map(probs(ns["n1"], 1)))
        s2.append(_owed2_map(probs(ns["n2"], 0)))
        s3.append(_owed_call_map(probs(ns["n3"], 1)))
    # line brc is unreachable in the no-raise tree: uniform placeholder
    rhalf = torch.full_like(s0[0], 0.5)
    s0.append(rhalf)
    s1.append(rhalf)
    s2.append(rhalf)
    s3.append(torch.cat([rhalf, torch.zeros_like(rhalf[..., :1])], -1))
    return TurnRiverStrategy(
        t0=t0, t1=t1, t2=t2, t3=t3, t4=half,
        s0=torch.stack(s0), s1=torch.stack(s1), s2=torch.stack(s2),
        s3=torch.stack(s3), s4=torch.stack([rhalf] * 4))


@torch.no_grad()
def chance_averaged_equity(game: TurnRiverGame) -> torch.Tensor:
    """E_r[W_r | valid] as a [C, C] matrix — the one-street reduction's
    payoff base (river_betting=False collapses this game to a one-street
    game on this matrix)."""
    safe_cnt = torch.where(game.cnt > 0, game.cnt, 1.0)
    tot = torch.zeros_like(game.mask0)
    for r in range(game.keys.shape[0]):
        free_r = 1.0 - game.has_r[r]
        tot = tot + _w_matrix(game.keys[r]) * free_r[:, None] * free_r[None, :]
    return tot / safe_cnt
