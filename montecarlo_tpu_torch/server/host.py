"""Room/registry host logic bridging clients onto the table engine: the
port of ``montecarlo_tpu/server/host.py``, with the same protocol.

The reference's concurrency machinery (per-player/per-board go-loops, STM
databases, sliding-buffer action channels — ``database.clj``, ``board.clj``,
``player.clj``) collapses into plain synchronous host code around the pure
engine step: each room owns one ``TableState``; client ``play`` commands
land in a one-slot pending mailbox (the reference's ``sliding-buffer 1``
listen channel, newest overwrites — ``database.clj:42``); after every state
change the room drains whichever seat is now head of the play-order.

Protocol quirks preserved:

- Seat order is *reverse join order*: the reference conj's joiners onto a
  list (``server.clj:57``), so the last joiner posts the small blind.
- Board updates go only to players still in the hand (``update-players``
  maps over ``:players``, ``board.clj:109-112``) — folded and all-in seats
  stop hearing about the hand.
- Hand end sends no result message: clients see fresh hole cards and the
  next hand's board (``gameplay.clj:149-150``).
- Exact status codes/messages, including the "postive" typo
  (``server.clj:39``).

Against the JAX host: a ``Registry`` takes a ``device`` that every
``TorchBackend`` room and every house-bot net runs on (the card when
None; the JAX host pins rooms to the CPU), bot rooms force the "torch"
backend, and the house bots draw from a Philox stream
(``rollout/policy.SUB_BOT``) where JAX folds the decision count into a
threefry key.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional

import torch

from montecarlo_tpu_torch.device import resolve
from montecarlo_tpu_torch.engine.public import card_json
from montecarlo_tpu_torch.ops.philox import MASK
from montecarlo_tpu_torch.rollout.policy import SUB_BOT, PolicyKey
from montecarlo_tpu_torch.server.backends import make_backend

Send = Callable[[object], None]  # per-player outbound JSON-able sink

OK = {"status": 0, "msg": "OK"}


def error(status: int, msg: str) -> Dict:
    return {"status": status, "msg": msg}


def _pos_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool) and x > 0


# House-bot policies (server extension): named pretrained artifacts a
# ``new_room`` request can seat with ``"bots": k`` — the reference's
# stated purpose is a server "to test AIs" (README.md:9); bot seats let a
# single client play trained opponents over the wire. "uniform" is the
# zero net: uniform over the masked fold/call/2bb/pot menu.
BOT_POLICIES = {
    "6max": "policy_6max_es2.npz",
    "6max-reinforce": "policy_6max_200.npz",
    "hu": "policy_hu_300.npz",
    "uniform": None,
}


def _resolve_bot_policy(name: str, device=None):
    """Bot-policy name -> MLPParams on ``device`` (the card when None;
    artifacts live in <repo>/data)."""
    import os

    from montecarlo_tpu_torch.models.policy_net import (
        MLPParams, load_params,
    )

    dev = resolve(device)
    fname = BOT_POLICIES[name]  # KeyError -> caller answers -5
    if fname is None:
        from montecarlo_tpu_torch.models.features import NUM_FEATURES

        def z(*s):
            return torch.zeros(s, dtype=torch.float32, device=dev)

        return MLPParams(z(NUM_FEATURES, 64), z(64), z(64, 64), z(64),
                         z(64, 4), z(4))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    params = load_params(os.path.join(root, "data", fname))
    return MLPParams(*(x.to(dev) for x in params))


class Room:
    """One table: players, engine backend, pending-action mailboxes."""

    def __init__(self, name: str, n: int, blinds: Dict[str, int], seed: int = 0,
                 backend: str = "auto",
                 action_timeout: Optional[float] = None,
                 default_action: int = -1,
                 rules: str = "reference",
                 bot_params=None, device=None):
        self.name = name
        self.n = n
        self.blinds = dict(blinds)
        self.seed = seed
        self.backend_kind = backend
        self.rules = rules
        self.device = device
        self.joined: List[str] = []   # join order
        self.seats: List[str] = []    # seat order (reverse join order)
        self.engine = None
        self.pending: Dict[str, Optional[int]] = {}
        # House bots (extension): pids whose actions the room computes
        # from ``bot_params`` instead of waiting on a client.
        self.bots: set = set()
        self.bot_params = bot_params
        self._bot_fn = None
        self._bot_n = 0
        # Failure-detection policy (absent in the reference: a dropped
        # client blocks its table forever, player.clj:40). When set, a head
        # seat idle for action_timeout seconds acts default_action (fold).
        self.action_timeout = action_timeout
        self.default_action = default_action
        self._last_progress = time.monotonic()

    @property
    def started(self) -> bool:
        return self.engine is not None

    def seat_of(self, pid: str) -> Optional[int]:
        return self.seats.index(pid) if pid in self.seats else None

    # -- lifecycle ----------------------------------------------------------
    def add_player(self, pid: str, registry: "Registry"):
        self.joined.append(pid)
        if len(self.joined) == self.n and not self.started:
            self.start(registry)

    def start(self, registry: "Registry"):
        # Reference list-conj semantics: last joiner heads the players list.
        self.seats = list(reversed(self.joined[: self.n]))
        # Bot rooms run the table engine (the C++ table has no policy
        # surface; the torch backend exposes the TableState the net reads).
        kind = "torch" if self.bots else self.backend_kind
        self.engine = make_backend(
            kind, self.n,
            self.blinds.get("small", 5), self.blinds.get("big", 10),
            self.seed, [registry.stacks[p] for p in self.seats],
            rules=self.rules, device=self.device)
        self.pending = {p: None for p in self.seats}
        if self.bots:
            self._bot_fn = self.engine.make_bot(self.bot_params)
            # One table's Philox stream on the engine's device; the
            # counter is the room's bot decision count (_bot_amt).
            self._bot_key = PolicyKey(
                (7919 * self.seed + 13) & MASK,
                torch.zeros(1, dtype=torch.int64,
                            device=self.engine.device), 0, SUB_BOT)
        self._sync_registry(registry)
        self._deal_messages(registry)
        self._broadcast(registry)
        self.drain(registry)  # bots may act first preflop

    # -- messaging ----------------------------------------------------------
    def _deal_messages(self, registry: "Registry"):
        """Hole cards, one player at a time (deal-hand, gameplay.clj:63-75)."""
        for k in range(2):
            for seat, pid in enumerate(self.seats):
                card = self.engine.hole(seat)[k]
                registry.send(pid, {"card": card_json(card), "room": self.name})

    def _broadcast(self, registry: "Registry"):
        """Board to every in-hand player (update-players, board.clj:109)."""
        board = self.engine.board_json(self.seats)
        for seat in self.engine.in_hand_seats():
            registry.send(self.seats[seat], board)

    def _sync_registry(self, registry: "Registry"):
        for seat, pid in enumerate(self.seats):
            registry.stacks[pid] = self.engine.stacks()[seat]

    # -- actions ------------------------------------------------------------
    def submit_action(self, pid: str, amt, registry: "Registry"):
        """The ``play`` command: drop into the one-slot mailbox (newest
        overwrites — sliding-buffer 1) and drain if it's this seat's turn."""
        if not self.started or pid not in self.pending:
            return  # reference: put to a nil channel, silently lost
        if not isinstance(amt, int) or isinstance(amt, bool):
            return
        self.pending[pid] = amt
        self.drain(registry)

    def head_pid(self) -> Optional[str]:
        seat = self.engine.head_seat()
        return None if seat is None else self.seats[seat]

    def drain(self, registry: "Registry"):
        """Apply pending actions while the head seat has one queued
        (player-action gating, player.clj:34-45); house-bot head seats
        act immediately from the room's policy net. Bot runs are bounded
        per drain (an all-bot-survivor tournament would otherwise spin
        forever); ``tick`` resumes a bounded-out run."""
        bot_budget = 256
        while True:
            pid = self.head_pid()
            if pid is None:
                return
            if pid in self.bots:
                if bot_budget == 0:
                    return
                bot_budget -= 1
                self._board_action(self._bot_amt(), registry)
                continue
            if self.pending.get(pid) is None:
                return
            amt = self.pending[pid]
            self.pending[pid] = None
            self._board_action(int(amt), registry)

    def _bot_amt(self) -> int:
        key = self._bot_key._replace(counter=self._bot_n)
        self._bot_n += 1
        return self.engine.bot_action(self._bot_fn, key)

    def _board_action(self, amt: int, registry: "Registry"):
        """board-action (board.clj:122-129) with host-visible events."""
        # Stacks are global refs shared across rooms (database.clj:8-12):
        # refresh from the registry so cross-room play sees live balances
        # (the native backend applies this at hand boundaries).
        self.engine.set_stacks([registry.stacks[p] for p in self.seats])
        new_hand = self.engine.act(amt)
        self._sync_registry(registry)
        self._last_progress = time.monotonic()
        if new_hand:
            self._deal_messages(registry)  # fresh hole cards, next hand
        self._broadcast(registry)

    def tick(self, registry: "Registry", now: Optional[float] = None):
        """Timeout sweep: force the default action for a stalled head
        seat; also resume a bot run that hit its per-drain bound."""
        if not self.started:
            return
        if self.bots and self.head_pid() in self.bots:
            self.drain(registry)
        if self.action_timeout is None:
            return
        now = time.monotonic() if now is None else now
        if (self.head_pid() is not None
                and self.head_pid() not in self.bots
                and now - self._last_progress >= self.action_timeout):
            self._board_action(self.default_action, registry)
            self.drain(registry)


class Registry:
    """The global player/room databases (``database.clj:5-6``)."""

    def __init__(self, backend: str = "auto", default_action: int = -1,
                 device=None):
        self.backend = backend  # "native" | "torch" | "auto"
        self.default_action = default_action
        self.device = device  # of torch rooms and bot nets (None: the card)
        self.rooms: Dict[str, Room] = {}
        self.stacks: Dict[str, int] = {}          # global 100-chip stacks
        self.player_rooms: Dict[str, set] = {}
        self.sinks: Dict[str, Send] = {}
        self._gensym = itertools.count(1000)

    # -- connections ---------------------------------------------------------
    def add_player(self, sink: Send) -> str:
        pid = f"G__{next(self._gensym)}"
        self.stacks[pid] = 100                    # database.clj:31
        self.player_rooms[pid] = set()
        self.sinks[pid] = sink
        return pid

    def add_bot(self) -> str:
        """Register a house bot: a player with no sink (sends drop)."""
        pid = f"B__{next(self._gensym)}"
        self.stacks[pid] = 100
        self.player_rooms[pid] = set()
        return pid

    def remove_player(self, pid: str):
        # The reference has no disconnect handling ("i don't know how to
        # quit you") — we at least drop the sink so sends become no-ops.
        self.sinks.pop(pid, None)

    def send(self, pid: str, msg):
        sink = self.sinks.get(pid)
        if sink is not None:
            sink(msg)

    # -- commands (server.clj:60-105) -----------------------------------------
    def new_room(self, pid: str, req: Dict):
        name = req.get("name")
        n = req.get("n")
        blinds = req.get("blinds") or {"small": 5, "big": 10}
        if not isinstance(blinds, dict):
            # Non-map blinds blow up the reference on (vals ...); answer the
            # blinds error instead of dying.
            return self.send(pid, error(-12, "Blinds must be positive integers"))
        if not isinstance(name, (str, type(None))):
            name = None  # unhashable/odd names -> "empty room name."
        if name in self.rooms:
            return self.send(pid, error(-5, "room already exists."))
        if name is None:
            return self.send(pid, error(-5, "empty room name."))
        if not _pos_int(n):
            return self.send(
                pid, error(-5, "n (number of players) must be a postive integer."))
        if not all(_pos_int(v) for v in blinds.values()):
            return self.send(pid, error(-12, "Blinds must be positive integers"))
        # "timeout" is a protocol extension (seconds until the head seat is
        # auto-acted); the reference ignores unknown keys, so may we.
        timeout = req.get("timeout")
        if not isinstance(timeout, (int, float)) or isinstance(timeout, bool) \
                or timeout <= 0:
            timeout = None
        # "rules" is a protocol extension: "reference" (default, bit-exact
        # Clojure semantics), "standard" (real poker accounting), or
        # "tournament" (standard + true elimination; the table freezes when
        # one player holds all the chips).
        rules = req.get("rules", "reference")
        if rules not in ("reference", "standard", "tournament"):
            return self.send(pid, error(
                -5, 'rules must be "reference", "standard" or "tournament"'))
        # "bots" is a protocol extension: seat k house bots playing the
        # named pretrained policy ("bot_policy"; default hu/6max by table
        # size). At least one seat stays human — the server tests AIs, it
        # doesn't spin bot-only tables.
        bots = req.get("bots", 0)
        if not isinstance(bots, int) or isinstance(bots, bool) \
                or not 0 <= bots < n:
            return self.send(pid, error(
                -5, "bots must be an integer in [0, n)"))
        bot_params = None
        if bots:
            policy = req.get("bot_policy", "hu" if n == 2 else "6max")
            try:
                bot_params = _resolve_bot_policy(policy, self.device)
            except (KeyError, FileNotFoundError):
                return self.send(pid, error(
                    -5, f"unknown bot_policy; have "
                        f"{sorted(BOT_POLICIES)}"))
        room = Room(name, n, blinds, seed=len(self.rooms),
                    backend=self.backend,
                    action_timeout=timeout,
                    default_action=self.default_action,
                    rules=rules, bot_params=bot_params,
                    device=self.device)
        self.rooms[name] = room
        self.send(pid, OK)
        for _ in range(bots):
            bpid = self.add_bot()
            self.player_rooms[bpid].add(name)
            room.bots.add(bpid)
            room.add_player(bpid, self)

    def join_room(self, pid: str, req: Dict):
        name = req.get("name")
        room = self.rooms.get(name)
        if room is None:
            return self.send(
                pid, error(-2, f'Room "{name}" does not exist yet.'))
        if name in self.player_rooms[pid]:
            return self.send(pid, error(-2, f'Already in room "{name}".'))
        self.player_rooms[pid].add(name)
        self.send(pid, OK)
        room.add_player(pid, self)

    def play(self, pid: str, req: Dict):
        room = self.rooms.get(req.get("name"))
        if room is not None and req.get("name") in self.player_rooms[pid]:
            room.submit_action(pid, req.get("amt"), self)

    def hand_query(self, pid: str, req: Dict):
        name = req.get("name")
        room = self.rooms.get(name)
        if name not in self.player_rooms.get(pid, set()) or room is None:
            return self.send(pid, error(-1, f"Player is not in room {name}"))
        if not room.started:
            return self.send(pid, {"hand": []})
        seat = room.seat_of(pid)
        if seat is None:
            return self.send(pid, {"hand": []})  # joined after the table filled
        c1, c2 = room.engine.hole(seat)
        # Newest card first: hands are conj'd lists (player.clj:53-55).
        self.send(pid, {"hand": [card_json(c2), card_json(c1)]})

    def tick(self, now=None):
        """Periodic failure-detection sweep over all rooms (the asyncio
        transport calls this; tests inject ``now``)."""
        for room in list(self.rooms.values()):
            room.tick(self, now=now)

    def whoami(self, pid: str):
        # The reference sends the bare gensym (server.clj:103-105), which
        # serializes as a JSON string — not the README's {"id": ...} shape.
        self.send(pid, pid)

    def dispatch(self, pid: str, req: Dict):
        try:
            self._dispatch(pid, req)
        except Exception:
            # A malformed-but-parseable request must never kill the
            # connection loop (the reference throws into aleph here).
            self.send(pid, error(-1, 'bad "type" argument'))

    def _dispatch(self, pid: str, req: Dict):
        cmd = req.get("type")
        if cmd == "new_room":
            self.new_room(pid, req)
        elif cmd == "join_room":
            self.join_room(pid, req)
        elif cmd == "play":
            self.play(pid, req)
        elif cmd == "hand":
            self.hand_query(pid, req)
        elif cmd == "whoami":
            self.whoami(pid)
        else:
            self.send(pid, error(-1, 'bad "type" argument'))
