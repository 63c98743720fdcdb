"""Exact heads-up river subgame solver (CFR+): the multi-street
equilibrium anchor. The port of ``montecarlo_tpu/models/river_solver.py``.

Game definition
---------------
Heads-up on a FIXED 5-card board. Each player holds one combo from a
range (uniform prior over card-removal-consistent pairs). ``pot`` chips
are already in the middle; one bet size ``bet`` and one raise size
``raise_`` (raise TO ``bet + raise_``):

    P1: check | bet
      check -> P2: check (showdown, pot) | bet
                 check-bet -> P1: fold | call (showdown, pot+2B)
      bet   -> P2: fold | call (showdown, pot+2B) | raise
                 bet-raise -> P1: fold | call (showdown, pot+2(B+R))

Payoffs are P1's net chips from river start (w = P1 pot share: win 1,
tie 0.5, loss 0); the game is constant-sum (P1 + P2 = pot):

    cc: w*pot            xbf: 0            xbc: w*(pot+2B) - B
    bf: pot              bc:  w*(pot+2B) - B
    brf: -B              brc: w*(pot+2(B+R)) - (B+R)

Solver: CFR+ (Tammelin 2014) with alternating updates, regret-matching+,
and linearly-weighted average strategies, every traversal elementwise
over the [H, V] pair matrices in float32 (the JAX module's XLA; no
matmul, so no TF32 question). Convergence is certified by the
exploitability gap ``br1 + br2 - pot`` (zero at Nash). Showdowns ride
the port's packed hand key (``ops/evaluator.py``). Every function runs
on the device of its game's tensors; the game and state constructors
take ``device`` (the card when None, ``"cpu"`` for the CPU).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve

F32 = torch.float32
I32 = torch.int32


class RiverGame(NamedTuple):
    W: torch.Tensor      # [H, V] P1 pot share (1 / 0.5 / 0)
    mask: torch.Tensor   # [H, V] card-removal-valid pair indicator (f32)
    pot: float
    bet: float
    raise_: float
    # Tree gates: disabling P2's bet-after-check and raise collapses the
    # tree to the classic half-street game with a closed-form solution.
    p2_can_bet: bool = True
    p2_can_raise: bool = True


class RiverStrategy(NamedTuple):
    """Average strategies; rows sum to 1 where the combo is live."""
    s0: torch.Tensor  # [H, 2] P1 root: check / bet
    s1: torch.Tensor  # [V, 2] P2 after check: check / bet
    s2: torch.Tensor  # [H, 2] P1 after check-bet: fold / call
    s3: torch.Tensor  # [V, 3] P2 after bet: fold / call / raise
    s4: torch.Tensor  # [H, 2] P1 after bet-raise: fold / call


def all_combos(board: Sequence[int]) -> np.ndarray:
    """All C(47, 2) hole combos from the cards not on the board."""
    dead = set(int(c) for c in board)
    live = [c for c in range(52) if c not in dead]
    return np.array([(a, b) for i, a in enumerate(live)
                     for b in live[i + 1:]], np.int32)


def _hand_keys(combos, boards, dev) -> torch.Tensor:
    """The packed 7-card keys (int64 [..., N]) of each combo [N, 2] with
    each 5-card board of ``boards`` [..., 5], one batch through the port's
    evaluator."""
    from montecarlo_tpu_torch.ops.evaluator import (
        eval_masks_impl,
        suit_masks_from_cards,
    )

    combos = torch.as_tensor(np.asarray(combos, np.int32), device=dev)
    boards = torch.as_tensor(np.asarray(boards, np.int32), device=dev)
    lead = boards.shape[:-1]
    cards = torch.cat([combos.expand(*lead, -1, -1),
                       boards[..., None, :].expand(*lead, len(combos), -1)],
                      -1)
    return eval_masks_impl(*suit_masks_from_cards(cards)).long()


def _pot_share(kh: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """[..., H, V] P1 pot share from hero keys [..., H] and villain keys
    [..., V]: 1 a win, 0.5 a tie, 0 a loss."""
    a, b = kh[..., :, None], kv[..., None, :]
    return (a > b).to(F32) + 0.5 * (a == b).to(F32)


def _clash_free(hc: np.ndarray, vc: np.ndarray) -> np.ndarray:
    """[H, V] float32: 1 where the two combos share no card."""
    clash = ((hc[:, None, 0] == vc[None, :, 0])
             | (hc[:, None, 0] == vc[None, :, 1])
             | (hc[:, None, 1] == vc[None, :, 0])
             | (hc[:, None, 1] == vc[None, :, 1]))
    return (~clash).astype(np.float32)


def make_river_game(board: Sequence[int],
                    hero_combos: Optional[np.ndarray] = None,
                    villain_combos: Optional[np.ndarray] = None,
                    pot: float = 4.0, bet: float = 2.0,
                    raise_: float = 6.0, device=None
                    ) -> Tuple[RiverGame, np.ndarray, np.ndarray]:
    """Build the payoff/validity matrices from the port's evaluator on
    ``device`` (the card when None). Combos default to every 2-card hand
    off the board. Returns (game, hero_combos, villain_combos)."""
    dev = resolve(device)
    board = np.asarray(board, np.int32)
    if board.shape != (5,):
        raise ValueError(f"a river board has 5 cards, got {board.shape}")
    if hero_combos is None:
        hero_combos = all_combos(board)
    if villain_combos is None:
        villain_combos = all_combos(board)
    hero_combos = np.asarray(hero_combos, np.int32)
    villain_combos = np.asarray(villain_combos, np.int32)
    W = _pot_share(_hand_keys(hero_combos, board, dev),
                   _hand_keys(villain_combos, board, dev))
    mask = torch.as_tensor(_clash_free(hero_combos, villain_combos),
                           device=dev)
    return (RiverGame(W, mask, float(pot), float(bet), float(raise_)),
            hero_combos, villain_combos)


def _payoffs(game: RiverGame):
    """Terminal P1 utilities as [H, V] matrices / scalars."""
    W, pot, B, R = game.W, game.pot, game.bet, game.raise_
    return dict(
        cc=pot * W,
        xbc=(pot + 2 * B) * W - B,
        bc=(pot + 2 * B) * W - B,
        brc=(pot + 2 * (B + R)) * W - (B + R),
        bf=pot,      # P2 folds to the bet
        xbf=0.0,     # P1 folds after check-bet
        brf=-B,      # P1 folds after bet-raise
    )


def _normalize(r, allow=None):
    """Regret-matching: positive part normalized; uniform over allowed
    actions if all regrets <= 0. ``allow``: optional [n_actions] 0/1
    gate (tree-config action removal)."""
    p = r.clamp(min=0.0)
    if allow is not None:
        a = allow.to(r.dtype)
        p = p * a[None]
        fallback = (a / a.sum())[None].expand_as(p)
    else:
        fallback = torch.full_like(r, 1.0 / r.shape[-1])
    tot = p.sum(-1, keepdim=True)
    return torch.where(tot > 0, p / torch.where(tot > 0, tot, 1.0), fallback)


def _gates(game: RiverGame):
    dev = game.W.device
    g1 = torch.tensor([1.0, 1.0 if game.p2_can_bet else 0.0], dtype=F32,
                      device=dev)
    g3 = torch.tensor([1.0, 1.0, 1.0 if game.p2_can_raise else 0.0],
                      dtype=F32, device=dev)
    return g1, g3


def _p1_values(game, U, s1, s2, s3, s4):
    """P1 action values [H] at each node vs P2 strategy (counterfactual:
    weighted by mask * P2 reach; P1's own strategy excluded)."""
    m = game.mask
    pot, B = game.pot, game.bet
    r4 = m * s3[None, :, 2]
    v4 = torch.stack([r4.sum(1) * (-B), (r4 * U["brc"]).sum(1)], 1)
    r2 = m * s1[None, :, 1]
    v2 = torch.stack([torch.zeros_like(m[:, 0]), (r2 * U["xbc"]).sum(1)], 1)
    v4_cur = (s4 * v4).sum(1)
    v2_cur = (s2 * v2).sum(1)
    v_check = (m * s1[None, :, 0] * U["cc"]).sum(1) + v2_cur
    v_bet = ((m * s3[None, :, 0]).sum(1) * pot
             + (m * s3[None, :, 1] * U["bc"]).sum(1)
             + v4_cur)
    return torch.stack([v_check, v_bet], 1), v2, v4


def _p2_values(game, U, s0, s2, s4):
    """P2 action values [V] at each node (P2 utility = pot - U1)."""
    m = game.mask
    pot, B = game.pot, game.bet
    r1 = m * s0[:, 0][:, None]
    v1_check = (r1 * (pot - U["cc"])).sum(0)
    v1_bet = ((r1 * s2[:, 0][:, None]).sum(0) * pot
              + (r1 * s2[:, 1][:, None] * (pot - U["xbc"])).sum(0))
    v1 = torch.stack([v1_check, v1_bet], 1)
    r3 = m * s0[:, 1][:, None]
    v3 = torch.stack([
        torch.zeros_like(m[0]),
        (r3 * (pot - U["bc"])).sum(0),
        ((r3 * s4[:, 0][:, None]).sum(0) * (pot + B)
         + (r3 * s4[:, 1][:, None] * (pot - U["brc"])).sum(0)),
    ], 1)
    return v1, v3


def _regret_step(r, s, v):
    """CFR+: r + v - <s, v>, floored at 0."""
    return (r + v - (s * v).sum(-1, keepdim=True)).clamp(min=0.0)


def _average(a, allow=None):
    """An accumulated average strategy normalized; uniform over the
    allowed actions where nothing accumulated."""
    tot = a.sum(-1, keepdim=True)
    if allow is not None:
        fb = (allow / allow.sum()).expand_as(a)
    else:
        fb = torch.full_like(a, 1.0 / a.shape[-1])
    return torch.where(tot > 0, a / torch.where(tot > 0, tot, 1.0), fb)


class _Iterations:
    """Runs a CFR+ iteration ``step`` (which updates its state in place and
    reads the iteration weight t + 1 from the 0-dim tensor ``w``) for a
    range of t. On the card the first run is eager, on a side stream (the
    warm-up), and every later one replays it captured as a CUDA graph: one
    launch an iteration for the few hundred small kernels a step is made
    of, the same kernels and so the same results."""

    def __init__(self, step, w: torch.Tensor):
        self.step, self.w, self.graph = step, w, None

    def run(self, start: int, stop: int) -> None:
        for t in range(start, stop):
            self.w.fill_(t + 1)
            if self.w.device.type != "cuda":
                self.step()
            elif self.graph is not None:
                self.graph.replay()
            else:
                side = torch.cuda.Stream(self.w.device)
                side.wait_stream(torch.cuda.current_stream(self.w.device))
                with torch.cuda.stream(side):
                    self.step()
                torch.cuda.current_stream(self.w.device).wait_stream(side)
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph):
                    self.step()


@torch.no_grad()
def solve_cfr_plus(game: RiverGame, iterations: int = 2000
                   ) -> RiverStrategy:
    """CFR+ with alternating updates and linear strategy averaging."""
    H, V = game.W.shape
    U = _payoffs(game)
    dev = game.W.device
    shapes = ((H, 2), (V, 2), (H, 2), (V, 3), (H, 2))   # nodes 0..4
    r = [torch.zeros(n, dtype=F32, device=dev) for n in shapes]
    a = [torch.zeros(n, dtype=F32, device=dev) for n in shapes]
    g1, g3 = _gates(game)
    w = torch.zeros((), dtype=F32, device=dev)

    def step():
        s0, s2, s4 = _normalize(r[0]), _normalize(r[2]), _normalize(r[4])
        s1, s3 = _normalize(r[1], g1), _normalize(r[3], g3)

        # P1 regret update (P2 plays current s1/s3)
        v0, v2, v4 = _p1_values(game, U, s1, s2, s3, s4)
        for i, s, v in ((0, s0, v0), (2, s2, v2), (4, s4, v4)):
            r[i].copy_(_regret_step(r[i], s, v))
        a[0] += w * s0
        a[2] += w * s0[:, 0][:, None] * s2
        a[4] += w * s0[:, 1][:, None] * s4

        # P2 regret update against P1's just-updated strategies
        v1, v3 = _p2_values(game, U, _normalize(r[0]), _normalize(r[2]),
                            _normalize(r[4]))
        r[1].copy_(_regret_step(r[1], s1, v1))
        r[3].copy_(_regret_step(r[3], s3, v3))
        a[1] += w * s1
        a[3] += w * s3

    _Iterations(step, w).run(0, iterations)
    return RiverStrategy(_average(a[0]), _average(a[1], g1), _average(a[2]),
                         _average(a[3], g3), _average(a[4]))


@torch.no_grad()
def strategy_values(game: RiverGame, strat: RiverStrategy
                    ) -> Tuple[float, float]:
    """(P1 EV, P2 EV) under the strategy profile, averaged over the
    uniform valid-pair prior. P1 + P2 == pot always (constant-sum)."""
    U = _payoffs(game)
    s0, s1, s2, s3, s4 = strat
    v0, _, _ = _p1_values(game, U, s1, s2, s3, s4)
    ev1 = float((s0 * v0).sum(1).sum() / game.mask.sum())
    return ev1, float(game.pot) - ev1


@torch.no_grad()
def best_response_values(game: RiverGame, strat: RiverStrategy
                         ) -> Tuple[float, float]:
    """(BR1, BR2): each side's best-response EV vs the other's average
    strategy. Exploitability gap = br1 + br2 - pot >= 0, zero at Nash."""
    U = _payoffs(game)
    s0, s1, s2, s3, s4 = strat
    m = game.mask
    pot, B = game.pot, game.bet
    pairs = m.sum()

    # BR for P1: maximize bottom-up
    r4 = m * s3[None, :, 2]
    b4 = torch.maximum(r4.sum(1) * (-B), (r4 * U["brc"]).sum(1))
    r2 = m * s1[None, :, 1]
    b2 = torch.maximum(torch.zeros_like(m[:, 0]), (r2 * U["xbc"]).sum(1))
    v_check = (m * s1[None, :, 0] * U["cc"]).sum(1) + b2
    v_bet = ((m * s3[None, :, 0]).sum(1) * pot
             + (m * s3[None, :, 1] * U["bc"]).sum(1) + b4)
    br1 = float(torch.maximum(v_check, v_bet).sum() / pairs)

    # BR for P2: at n1/n3 the best response maximizes over P2 actions,
    # with P1's later nodes played from the AVERAGE strategy.
    v1, v3 = _p2_values(game, U, s0, s2, s4)
    v1_check, v1_bet = v1[:, 0], v1[:, 1]
    # A disabled action is unavailable to the best response too.
    if not game.p2_can_bet:
        v1_bet = v1_check - 1.0
    if not game.p2_can_raise:
        v3 = torch.cat([v3[:, :2], v3.amin(1, keepdim=True) - 1.0], 1)
    # P2 reaches exactly one of n1/n3 per hand (they follow different P1
    # root actions), so the BR total is the sum of the two nodes' best
    # values; the reach weights are already inside them.
    br2 = float((torch.maximum(v1_check, v1_bet) + v3.amax(1)).sum()
                / pairs)
    return br1, br2


def exploitability_gap(game: RiverGame, strat: RiverStrategy) -> float:
    """br1 + br2 - pot (chips; zero exactly at Nash)."""
    br1, br2 = best_response_values(game, strat)
    return br1 + br2 - float(game.pot)


# ---------------------------------------------------------------------------
# Trained-net Nash gap: extract a policy artifact's river strategy and
# measure its exploitability in the solved subgame
# ---------------------------------------------------------------------------

def _scripted_deck(board: Sequence[int], extra: Sequence[int] = ()
                  ) -> np.ndarray:
    """A heads-up deck (int32 [52]) that deals ``board`` (then ``extra``,
    the river of a turn board) as the community cards, dummy holes the
    first four other cards, and the rest in order."""
    board = [int(c) for c in board] + [int(c) for c in extra]
    dummies = [c for c in range(52) if c not in set(board)][:4]
    # deck layout (engine/state.py deal): holes at 0..3, community at
    # positions 5, 6, 7 (flop), 9 (turn), 11 (river)
    pos = [0, 1, 2, 3, 5, 6, 7, 9, 11][:4 + len(board)]
    dealt = np.array(dummies + board, np.int32)
    deck = np.zeros(52, np.int32)
    deck[pos] = dealt
    deck[[p for p in range(52) if p not in pos]] = np.setdiff1d(
        np.arange(52), dealt)
    return deck


def _advance(state, actions, rules: str = "standard"):
    """``state`` stepped by each engine action in turn (clamped, every
    table the same action)."""
    from montecarlo_tpu_torch.engine.step import clamp_action, step_table

    for a in actions:
        state = step_table(state, clamp_action(state, int(a)), rules=rules)
    return state


def _menu_size(state) -> int:
    """The net's own pot-raise size (menu index 3) at table 0's head."""
    from montecarlo_tpu_torch.models.policy_net import action_from_index

    return int(action_from_index(3, state)[0])


def river_node_states(board: Sequence[int], pot_bb: int = 2, device=None):
    """Engine states at the five decision nodes of the river tree.

    A heads-up hand is scripted to the river on an injected deck (blinds,
    then checks through preflop/flop/turn -> pot = 2bb = 20 chips), then
    the in-tree prefixes are applied. Bet/raise sizes are the NET'S OWN
    pot-raise menu at those nodes, measured from
    ``action_from_index(3, state)``: B = 20 at the root, raise-by R = 50
    facing the bet (raise TO 70) — the menu's "pot" formula rides the
    reference's n-inflated layer quirk, so it is not the real pot.

    Returns (states, sizes): ``states`` maps node -> a one-table
    TableState on ``device`` (the card when None) with the acting player
    at the head (P1 nodes: position 0; P2 nodes: position 1); hole cards
    are dummies, swapped per combo by ``net_river_strategy``. The states
    equal the JAX module's in every field but ``key``."""
    from montecarlo_tpu_torch.engine.state import (
        TableConfig,
        init_state,
        redeal,
    )

    if pot_bb != 2:
        raise ValueError("the scripted prelude produces a 2bb river pot")
    cfg = TableConfig(num_seats=2, rules="standard", bets_impl="levels")
    dev = resolve(device)
    board = np.asarray(board, np.int32)
    pot = 2 * cfg.big_blind

    st = redeal(init_state(0, cfg, 1, dev), _scripted_deck(board)[None])
    st = _advance(st, [0] * 6)  # SB call, BB check, check x4
    B = _menu_size(st)
    if B != pot:
        raise RuntimeError(f"the net's river bet {B} is not the pot {pot}")
    n3 = _advance(st, [B])
    R = _menu_size(n3)  # raise-by facing B
    states = {
        "n0": st,                     # P1 to act (head position 0)
        "n1": _advance(st, [0]),       # P2 after check
        "n2": _advance(st, [0, B]),    # P1 facing bet
        "n3": n3,                     # P2 facing bet
        "n4": _advance(n3, [R]),       # P1 facing raise
    }
    return states, dict(pot=float(pot), bet=float(B), raise_=float(R))


def _swap_head(state, head_pos: int, combos):
    """A state of T x C tables: each of ``state``'s T tables repeated for
    every combo (table-major), with position ``head_pos``'s hole cards the
    combo."""
    from montecarlo_tpu_torch.engine.step import _take

    dev = state.hole.device
    combos = torch.as_tensor(np.asarray(combos), device=dev).to(I32)
    T, C = state.n_tables, combos.shape[0]
    big = _take(state, torch.arange(T, device=dev).repeat_interleave(C))
    hole = big.hole.clone()
    hole[:, head_pos] = combos.repeat(T, 1)
    return big._replace(hole=hole)


def _node_probs(params, state, head_pos: int, combos, matmul: str = "f32"
                ) -> torch.Tensor:
    """[T x C, 4] the net's masked softmax at every (table, combo) of
    ``_swap_head``: the fold logit gets -1e9 where nothing is owed, as the
    artifact plays; ``matmul`` as in ``policy_net.policy_logits``."""
    from montecarlo_tpu_torch.engine.step import head_info
    from montecarlo_tpu_torch.engine.street import bets_needed
    from montecarlo_tpu_torch.models.features import state_features
    from montecarlo_tpu_torch.models.policy_net import (
        MLPParams,
        fold_masked,
        policy_logits,
    )

    s = _swap_head(state, head_pos, combos)
    dev = s.hole.device
    params = MLPParams(*(torch.as_tensor(x).to(dev, F32) for x in params))
    with torch.no_grad():
        logits = policy_logits(params, state_features(s), matmul)
        pos, _, _ = head_info(s)
        logits = fold_masked(logits, bets_needed(s.bets, pos) == 0)
        return torch.softmax(logits, dim=-1)


def _free_map(p):
    """Menu probabilities -> the tree's {check, bet} (check = call menu,
    bet = either raise size)."""
    return torch.stack([p[..., 1], p[..., 2] + p[..., 3]], -1)


def _owed2_map(p):
    """Menu probabilities -> {fold, call (+ raise mass)}."""
    return torch.stack([p[..., 0], p[..., 1] + p[..., 2] + p[..., 3]], -1)


def net_river_strategy(params, states, hero_combos, villain_combos,
                       matmul: str = "f32") -> RiverStrategy:
    """Extract an artifact's strategy at each node for each combo, on the
    states' device.

    The net's 4-action menu maps onto the tree: with nothing owed
    {check = call-menu, bet = either raise size}; facing a bet at n3
    {fold, call, raise = either raise size}; at n2/n4 the tree has no
    raise, so raise mass continues the hand as a call. Probabilities come
    from the same masked softmax the artifact plays with, its logits
    computed as ``policy_net.policy_logits(..., matmul)`` computes them
    (``"tpu_bf16"``: as the TPU computed the JAX package's records)."""
    p0 = _node_probs(params, states["n0"], 0, hero_combos, matmul)
    p1 = _node_probs(params, states["n1"], 1, villain_combos, matmul)
    p2 = _node_probs(params, states["n2"], 0, hero_combos, matmul)
    p3 = _node_probs(params, states["n3"], 1, villain_combos, matmul)
    p4 = _node_probs(params, states["n4"], 0, hero_combos, matmul)
    s3 = torch.stack([p3[:, 0], p3[:, 1], p3[:, 2] + p3[:, 3]], 1)
    return RiverStrategy(s0=_free_map(p0), s1=_free_map(p1),
                         s2=_owed2_map(p2), s3=s3, s4=_owed2_map(p4))
