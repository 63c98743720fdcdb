"""Interactive-table backends for the server host: the port of
``montecarlo_tpu/server/backends.py``.

Two engines drive an interactive room, with conformance-tested semantics:

- ``NativeBackend``: the C++ single-table runtime (``native/mcpoker.cpp``
  through the port's ``native`` loader): per-action latency in
  microseconds, the host equivalent of the reference's per-table actor.
  Reference rules only; decks from numpy PCG64, as in the JAX package.
- ``TorchBackend``: the port's table engine (``engine/``) holding one
  table, stepped once per wire action; the only backend for the
  "standard" and "tournament" rule sets and for house bots. It runs on
  the card unless the caller passes ``device="cpu"`` (the JAX backend
  pins itself to the CPU; here the caller chooses). Its decks are the
  engine's Philox decks, the same on either device.

Both expose the same surface to ``Room``: seat order is *hand order for the
current hand* handled by the backend (button rotation included), and the
public board JSON matches ``read-board`` (``helpers.clj:33-43``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.public import card_json, public_board
from montecarlo_tpu_torch.engine.state import TableConfig, init_state
from montecarlo_tpu_torch.engine.step import (
    clamp_action,
    head_info,
    step_table,
)

I32 = torch.int32


def _layers_json(layers, ids_by_pos: Sequence[str]) -> List[Dict]:
    """[(amt, members, orig, n)] in hand-order index space -> JSON."""
    return [{
        "bet": amt,
        "players": [ids_by_pos[j] for j in range(len(ids_by_pos)) if j in mem],
        "original-players": [ids_by_pos[j] for j in range(len(ids_by_pos))
                             if j in orig],
        "n": n,
    } for amt, mem, orig, n in layers]


class NativeBackend:
    """C++ table runtime + host-side dealing and button rotation."""

    def __init__(self, n: int, small: int, big: int, seed: int,
                 stacks: Sequence[int]):
        from montecarlo_tpu_torch import native

        self._native = native
        self.n = n
        self.small, self.big = small, big
        self.rng = np.random.Generator(np.random.PCG64(seed))
        self.button = 0
        self.hand_idx = 0
        self._seat_stacks = list(stacks)  # by seat
        self._deal()

    # hand-order position j <-> seat (button + j) % n
    def _seat(self, pos: int) -> int:
        return (self.button + pos) % self.n

    def _pos(self, seat: int) -> int:
        return (seat - self.button) % self.n

    def _deal(self):
        self.deck = self.rng.permutation(52).astype(np.int32)
        order_stacks = [self._seat_stacks[self._seat(j)] for j in range(self.n)]
        self.table = self._native.NativeTable(
            self.n, self.small, self.big, self.deck, stacks=order_stacks)
        self._pull_stacks()

    def _pull_stacks(self):
        snap = self.table.snapshot()
        for j, v in enumerate(snap["stacks"]):
            self._seat_stacks[self._seat(j)] = v

    # -- Room surface ---------------------------------------------------------
    def info(self) -> Dict:
        snap = self.table.snapshot()
        return {"time": snap["time"], "stage": snap["stage"],
                "hand_idx": self.hand_idx}

    def stacks(self) -> List[int]:
        return list(self._seat_stacks)

    def set_stacks(self, stacks: Sequence[int]):
        """Push new global stacks into the live table (database.clj:8-12:
        stacks are global per-player refs, so a cross-room change is visible
        to this room's in-progress hand immediately, as in
        TorchBackend.set_stacks)."""
        self._seat_stacks = list(stacks)
        order_stacks = [self._seat_stacks[self._seat(j)]
                        for j in range(self.n)]
        self.table.set_stacks(order_stacks)

    def in_hand_seats(self) -> List[int]:
        snap = self.table.snapshot()
        return sorted(self._seat(j) for j in snap["in_hand"])

    def hole(self, seat: int):
        j = self._pos(seat)
        return int(self.deck[j]), int(self.deck[self.n + j])

    def head_seat(self) -> Optional[int]:
        snap = self.table.snapshot()
        return None if snap["head"] is None else self._seat(snap["head"])

    def act(self, amt: int) -> bool:
        """Apply one action; returns True if the hand ended (new hand dealt)."""
        self.table.act(int(amt))
        snap = self.table.snapshot()
        if snap["over"]:
            self.table.settle()
            self._pull_stacks()
            self.button = (self.button + 1) % self.n
            self.hand_idx += 1
            self._deal()
            return True
        self._pull_stacks()
        return False

    def board_json(self, ids: Sequence[str]) -> Dict:
        snap = self.table.snapshot()
        ids_by_pos = [ids[self._seat(j)] for j in range(self.n)]
        n_players = len(snap["in_hand"])
        order, cursor = snap["order"], snap["cursor"]
        play_order = []
        k = cursor
        while len(play_order) < n_players and order:
            play_order.append(ids_by_pos[order[k % len(order)]])
            k += 1
        return {
            "community-cards": [
                card_json(int(c)) for c in
                [self.deck[2 * self.n + 1], self.deck[2 * self.n + 2],
                 self.deck[2 * self.n + 3], self.deck[2 * self.n + 5],
                 self.deck[2 * self.n + 7]][: snap["n_revealed"]]],
            "bets": _layers_json(snap["bets"], ids_by_pos),
            "pots": _layers_json(snap["pots"], ids_by_pos),
            "remaining-players": [ids_by_pos[j] for j in range(self.n)
                                  if j in snap["remaining"]],
            "play-order": play_order,
            "time": snap["time"],
            "players": [{"id": ids_by_pos[j],
                         "stack": snap["stacks"][j]}
                        for j in range(self.n) if j in snap["in_hand"]],
        }


class TorchBackend:
    """The port's table engine, one table, stepped from the host.

    An action is ``clamp_action`` + ``step_table`` (clamp -> apply ->
    street transition(s) -> settle and redeal on game end,
    ``board.clj:122-129`` + ``gameplay.clj:122-150``) on the one-table
    state, then host reads of the fields the room asks for."""

    def __init__(self, n: int, small: int, big: int, seed: int,
                 stacks: Sequence[int], rules: str = "reference",
                 device=None):
        self.n = n
        self.rules = rules
        self.device = resolve(device)
        cfg = TableConfig(num_seats=n, small_blind=small, big_blind=big,
                          rules=rules, bets_impl="levels")
        state = init_state(seed, cfg, 1, self.device)
        posted = state.stacks - cfg.starting_stack
        self.state = state._replace(stacks=torch.tensor(
            [list(stacks)], dtype=I32, device=self.device) + posted)

    # Device state is positional; seats are stable. seat = (button+pos)%n.
    def _button(self) -> int:
        return int(self.state.button[0])

    def _pos(self, seat: int) -> int:
        return (seat - self._button()) % self.n

    def _seat(self, pos: int) -> int:
        return (self._button() + pos) % self.n

    def info(self) -> Dict:
        st = self.state
        time, stage, hand_idx = torch.stack(
            [st.time[0], st.stage[0], st.hand_idx[0]]).tolist()
        return {"time": time, "stage": stage, "hand_idx": hand_idx}

    def stacks(self) -> List[int]:
        pos_stacks = self.state.stacks[0].tolist()
        return [pos_stacks[self._pos(s)] for s in range(self.n)]

    def set_stacks(self, stacks: Sequence[int]):
        positional = [stacks[self._seat(j)] for j in range(self.n)]
        self.state = self.state._replace(stacks=torch.tensor(
            [positional], dtype=I32, device=self.device))

    def in_hand_seats(self) -> List[int]:
        pos = self.state.in_hand[0].nonzero()[:, 0].tolist()
        return sorted(self._seat(j) for j in pos)

    def hole(self, seat: int):
        c0, c1 = self.state.hole[0, self._pos(seat)].tolist()
        return c0, c1

    def head_seat(self) -> Optional[int]:
        pos, _, exists = head_info(self.state)
        pos, exists = torch.stack([pos[0], exists[0].to(pos.dtype)]).tolist()
        return self._seat(pos) if exists else None

    def act(self, amt: int) -> bool:
        """Apply one action; True iff the hand ended AND a fresh hand was
        dealt (a tournament table that froze returns False: no new deal)."""
        if self.rules == "tournament" and bool(self.state.hand_over[0]):
            return False  # frozen table: one player holds all the chips
        prev_idx = int(self.state.hand_idx[0])
        self.state = step_table(self.state,
                                clamp_action(self.state, int(amt)),
                                rules=self.rules)
        return int(self.state.hand_idx[0]) > prev_idx

    def board_json(self, ids: Sequence[str]) -> Dict:
        return public_board(self.state, ids, table=0)

    # -- house bots (server extension; the reference's purpose is "test
    # AIs", README.md:9: bot seats close that loop over the wire) --------
    def make_bot(self, params):
        """``(key, state) -> engine action`` from an MLP policy
        (``models/policy_net.net_policy``: a categorical pick over the
        masked fold/call/2bb/pot menu)."""
        from montecarlo_tpu_torch.models.policy_net import net_policy

        pol = net_policy(params)
        return lambda key, state: pol(key, state, None)

    def bot_action(self, fn, key) -> int:
        """One bot decision for the head seat; ``key`` is a one-table
        ``rollout/policy.PolicyKey`` on this backend's device."""
        return int(fn(key, self.state)[0])


def make_backend(kind: str, n: int, small: int, big: int, seed: int,
                 stacks: Sequence[int], rules: str = "reference",
                 device=None):
    """The backend of a room: ``kind`` "native", "torch" or "auto" (native
    where a C++ compiler exists). Standard and tournament rooms always
    run ``TorchBackend``; ``device`` is that backend's (the card when
    None)."""
    if rules != "reference":
        # The C++ table implements the reference semantics only; standard
        # and tournament rooms run on the table engine.
        return TorchBackend(n, small, big, seed, stacks, rules=rules,
                            device=device)
    if kind == "auto":
        from montecarlo_tpu_torch import native

        kind = "native" if native.available() else "torch"
    if kind == "native":
        return NativeBackend(n, small, big, seed, stacks)
    if kind == "torch":
        return TorchBackend(n, small, big, seed, stacks, device=device)
    raise ValueError(f"unknown backend {kind!r}")
