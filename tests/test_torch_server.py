"""The port's server (``montecarlo_tpu_torch/server``) against the JAX host.

- Protocol: every case of ``tests/test_server.py`` on the port's
  ``Registry(device="cpu")`` (native and torch rooms where the case plays
  hands): status codes and strings, joins, queries, seat order, the
  mailbox, hand roll, TCP round trip, timeouts and the sweeper, many
  rooms, malformed requests, rules and bots validation, standard chips,
  the tournament freeze, and the house bots.
- Card-independent wire: fold-only and check-only scripts (no showdown)
  give transcripts equal to the JAX host's ``Registry(backend="jax")``
  after ``test_cross_room_global_stacks_identical_wire``'s scrub (private
  cards and community cards dropped), under reference, standard and
  tournament rules, and with the port's ``NativeBackend``.
- Card-dependent wire: the JAX room and the port's room in lockstep, the
  JAX deck injected into the port's state (``engine.state.redeal``, by a
  wrapper here) after every deal: whole transcripts, hole cards and
  boards included, equal for a script of calls, raises and folds under all
  three rule sets; the same for ``TorchBackend`` against the port's
  ``NativeBackend`` on its PCG64 decks.
- Bots: the bot's logits on the room's states carried to JAX (the JAX
  host's rooms hold the layers street form, which ``state_from_numpy``
  refuses, so the port's room states go across) within 2e-6 of the largest
  logit, and the same fold mask.
Integers exactly; logits within 2e-6 of the largest logit.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import step as jstep
from montecarlo_tpu.engine import street as jstreet
from montecarlo_tpu.models import features as jfeat
from montecarlo_tpu.models import policy_net as jpn
from montecarlo_tpu.server import backends as jbackends
from montecarlo_tpu.server.host import Registry as JaxRegistry
from montecarlo_tpu_torch import native
from montecarlo_tpu_torch.engine import state as tstate
from montecarlo_tpu_torch.engine.state import _tree_map
from montecarlo_tpu_torch.models import features as tfe
from montecarlo_tpu_torch.models import policy_net as tpn
from montecarlo_tpu_torch.rollout.policy import SUB_BOT
from montecarlo_tpu_torch.server import backends
from montecarlo_tpu_torch.server.backends import TorchBackend
from montecarlo_tpu_torch.server.host import BOT_POLICIES, Registry
from montecarlo_tpu_torch.server.tcp import start_server
from test_torch_features import to_jax

# One intra-op thread: the suite runs several test processes at once.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RULES = ["reference", "standard", "tournament"]
BACKENDS = ["native", "torch"]


@pytest.fixture(scope="module", autouse=True)
def compiler():
    if native.compiler() is None:
        pytest.skip("the native backend needs a host C++ compiler")


class Client:
    def __init__(self, registry):
        self.msgs = []
        self.pid = registry.add_player(self.msgs.append)


def port_registry(backend="auto"):
    return Registry(backend=backend, device="cpu")


def make3(backend="auto"):
    reg = port_registry(backend)
    return reg, [Client(reg) for _ in range(3)]


def boards(cl):
    return [m for m in cl.msgs if isinstance(m, dict) and "bets" in m]


def cards(cl):
    return [m for m in cl.msgs if isinstance(m, dict) and "card" in m]


# -- protocol: tests/test_server.py on the port ----------------------------

def test_new_room_validations():
    reg, (a, b, c) = make3()
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 0})
    assert a.msgs[-1] == {"status": -5,
                          "msg": "n (number of players) must be a postive integer."}
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 2,
                         "blinds": {"small": 0, "big": 10}})
    assert a.msgs[-1] == {"status": -12, "msg": "Blinds must be positive integers"}
    reg.dispatch(a.pid, {"type": "new_room", "n": 2})
    assert a.msgs[-1] == {"status": -5, "msg": "empty room name."}
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 2})
    assert a.msgs[-1] == {"status": 0, "msg": "OK"}
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 3})
    assert a.msgs[-1] == {"status": -5, "msg": "room already exists."}
    reg.dispatch(a.pid, {"type": "nonsense"})
    assert a.msgs[-1] == {"status": -1, "msg": 'bad "type" argument'}


def test_join_room_errors():
    reg, (a, b, c) = make3()
    reg.dispatch(a.pid, {"type": "join_room", "name": "nope"})
    assert a.msgs[-1] == {"status": -2, "msg": 'Room "nope" does not exist yet.'}
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 3})
    reg.dispatch(a.pid, {"type": "join_room", "name": "r"})
    assert a.msgs[-1] == {"status": 0, "msg": "OK"}
    reg.dispatch(a.pid, {"type": "join_room", "name": "r"})
    assert a.msgs[-1] == {"status": -2, "msg": 'Already in room "r".'}


def test_whoami_and_hand_queries():
    reg, (a, b, c) = make3()
    reg.dispatch(a.pid, {"type": "whoami"})
    assert a.msgs[-1] == a.pid
    reg.dispatch(a.pid, {"type": "hand", "name": "r"})
    assert a.msgs[-1] == {"status": -1, "msg": "Player is not in room r"}


@pytest.mark.parametrize("backend", BACKENDS)
def test_game_start_flow_and_seat_order(backend):
    reg, (a, b, c) = make3(backend)
    reg.dispatch(a.pid, {"type": "new_room", "name": "hogwarts", "n": 3})
    for cl in (a, b, c):
        reg.dispatch(cl.pid, {"type": "join_room", "name": "hogwarts"})
    room = reg.rooms["hogwarts"]
    assert room.seats == [c.pid, b.pid, a.pid]
    assert reg.stacks[c.pid] == 95 and reg.stacks[b.pid] == 90
    assert reg.stacks[a.pid] == 100
    for cl in (a, b, c):
        assert len(cards(cl)) == 2
        assert all(m["room"] == "hogwarts" for m in cards(cl))
        assert len(boards(cl)) == 1
        board = boards(cl)[0]
        assert board["time"] == 0
        assert board["play-order"][0] == a.pid
        assert board["bets"][0]["bet"] == 5
    reg.dispatch(a.pid, {"type": "hand", "name": "hogwarts"})
    hand = a.msgs[-1]["hand"]
    assert len(hand) == 2 and all("suit" in c_ and "rank" in c_ for c_ in hand)


@pytest.mark.parametrize("backend", BACKENDS)
def test_play_mailbox_and_turn_order(backend):
    reg, (a, b, c) = make3(backend)
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 3})
    for cl in (a, b, c):
        reg.dispatch(cl.pid, {"type": "join_room", "name": "r"})
    room = reg.rooms["r"]
    t0 = room.engine.info()["time"]
    reg.dispatch(b.pid, {"type": "play", "name": "r", "amt": 0})
    assert room.engine.info()["time"] == t0
    reg.dispatch(a.pid, {"type": "play", "name": "r", "amt": 0})
    assert room.engine.info()["time"] == t0 + 1
    reg.dispatch(c.pid, {"type": "play", "name": "r", "amt": 0})
    assert room.engine.info()["time"] == t0 + 3
    assert room.engine.info()["stage"] == 1
    n_boards_b = len(boards(b))
    reg.dispatch(c.pid, {"type": "play", "name": "r", "amt": -1})
    reg.dispatch(a.pid, {"type": "play", "name": "r", "amt": 0})
    assert len(boards(b)) > n_boards_b
    assert boards(c)[-1]["time"] <= room.engine.info()["time"] - 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_hand_end_rolls_into_next_hand(backend):
    reg, (a, b, _) = make3(backend)
    reg.dispatch(a.pid, {"type": "new_room", "name": "hu", "n": 2})
    reg.dispatch(a.pid, {"type": "join_room", "name": "hu"})
    reg.dispatch(b.pid, {"type": "join_room", "name": "hu"})
    room = reg.rooms["hu"]
    assert room.seats == [b.pid, a.pid]
    before = len(cards(a))
    reg.dispatch(b.pid, {"type": "play", "name": "hu", "amt": -1})
    assert len(cards(a)) == before + 2
    assert room.engine.info()["hand_idx"] == 1
    assert reg.stacks[b.pid] + reg.stacks[a.pid] == 200 - 15
    assert reg.stacks[a.pid] == 105 - 5 and reg.stacks[b.pid] == 95 - 10


async def _send(w, obj):
    w.write((json.dumps(obj) + "\r\n").encode())
    await w.drain()


async def _recv(r):
    line = await asyncio.wait_for(r.readline(), timeout=10)
    return json.loads(line.decode().rstrip("\r\n"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_tcp_round_trip(backend):
    async def scenario():
        server, reg = await start_server(port_registry(backend),
                                         host="127.0.0.1", port=0)
        port = server.sockets[0].getsockname()[1]
        r1, w1 = await asyncio.open_connection("127.0.0.1", port)
        r2, w2 = await asyncio.open_connection("127.0.0.1", port)
        await _send(w1, {"type": "whoami"})
        assert (await _recv(r1)).startswith("G__")
        w1.write(b"this is not json\r\n")
        await w1.drain()
        assert (await _recv(r1)) == {"status": -17,
                                     "msg": "You sent me bad json!"}
        await _send(w1, {"type": "new_room", "name": "hu", "n": 2})
        assert (await _recv(r1)) == {"status": 0, "msg": "OK"}
        await _send(w1, {"type": "join_room", "name": "hu"})
        assert (await _recv(r1)) == {"status": 0, "msg": "OK"}
        await _send(w2, {"type": "join_room", "name": "hu"})
        assert (await _recv(r2)) == {"status": 0, "msg": "OK"}
        for r in (r1, r2):
            msgs = [await _recv(r) for _ in range(3)]
            assert sum(1 for m in msgs if "card" in m) == 2
            assert sum(1 for m in msgs if "bets" in m) == 1
        await _send(w2, {"type": "play", "name": "hu", "amt": -1})
        msgs = [await _recv(r1) for _ in range(3)]
        assert sum(1 for m in msgs if "card" in m) == 2
        assert type(reg.rooms["hu"].engine).__name__ == {
            "native": "NativeBackend", "torch": "TorchBackend"}[backend]
        for w in (w1, w2):
            w.close()
        server.close()
        await server.wait_closed()

    asyncio.run(scenario())


def test_torch_backend_room_smoke():
    reg = port_registry("torch")
    a, b = Client(reg), Client(reg)
    reg.dispatch(a.pid, {"type": "new_room", "name": "hu", "n": 2})
    reg.dispatch(a.pid, {"type": "join_room", "name": "hu"})
    reg.dispatch(b.pid, {"type": "join_room", "name": "hu"})
    room = reg.rooms["hu"]
    assert type(room.engine).__name__ == "TorchBackend"
    assert room.engine.device == torch.device("cpu")
    reg.dispatch(b.pid, {"type": "play", "name": "hu", "amt": -1})
    assert room.engine.info()["hand_idx"] == 1
    assert reg.stacks[a.pid] + reg.stacks[b.pid] == 200 - 15


@pytest.mark.parametrize("backend", BACKENDS)
def test_action_timeout_failure_policy(backend):
    reg = port_registry(backend)
    a, b = Client(reg), Client(reg)
    reg.dispatch(a.pid, {"type": "new_room", "name": "t", "n": 2,
                         "timeout": 30})
    reg.dispatch(a.pid, {"type": "join_room", "name": "t"})
    reg.dispatch(b.pid, {"type": "join_room", "name": "t"})
    room = reg.rooms["t"]
    assert room.action_timeout == 30
    reg.tick(now=room._last_progress + 10)
    assert room.engine.info()["time"] == 0
    reg.tick(now=room._last_progress + 31)
    assert room.engine.info()["hand_idx"] == 1
    reg.dispatch(a.pid, {"type": "new_room", "name": "t2", "n": 2,
                         "timeout": "soon"})
    assert reg.rooms["t2"].action_timeout is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_many_rooms_and_interleaved_clients(backend):
    import random as _random

    rng = _random.Random(77)
    reg = port_registry(backend)
    clients = [Client(reg) for _ in range(9)]
    for r, owner in zip("abc", clients[:3]):
        reg.dispatch(owner.pid, {"type": "new_room", "name": r, "n": 3})
    for i, cl in enumerate(clients):
        reg.dispatch(cl.pid, {"type": "join_room", "name": "abc"[i % 3]})
    for r in "abc":
        assert reg.rooms[r].started
    for _ in range(300 if backend == "native" else 100):
        cl = rng.choice(clients)
        room = rng.choice("abc")
        amt = rng.choice([-1, 0, 0, 0, 3, 10, 500])
        reg.dispatch(cl.pid, {"type": "play", "name": room, "amt": amt})
    for r in "abc":
        room = reg.rooms[r]
        assert room.engine.info()["hand_idx"] >= 0
        seat0 = room.seats[0]
        reg.dispatch(seat0, {"type": "hand", "name": r})
        sink = [m for m in clients if m.pid == seat0][0].msgs
        assert "hand" in sink[-1] and len(sink[-1]["hand"]) == 2
    assert all(isinstance(v, int) for v in reg.stacks.values())


def test_tcp_timeout_sweeper_auto_folds():
    async def scenario():
        server, reg = await start_server(port_registry("torch"),
                                         host="127.0.0.1", port=0)
        port = server.sockets[0].getsockname()[1]
        r1, w1 = await asyncio.open_connection("127.0.0.1", port)
        r2, w2 = await asyncio.open_connection("127.0.0.1", port)
        await _send(w1, {"type": "new_room", "name": "t", "n": 2,
                         "timeout": 1})
        await _send(w1, {"type": "join_room", "name": "t"})
        await _send(w2, {"type": "join_room", "name": "t"})
        for _ in range(20):
            await asyncio.sleep(0.2)
            if reg.rooms["t"].started and \
                    reg.rooms["t"].engine.info()["hand_idx"] >= 1:
                break
        assert reg.rooms["t"].engine.info()["hand_idx"] >= 1
        for w in (w1, w2):
            w.close()
        server.close()
        await server.wait_closed()

    asyncio.run(scenario())


def test_malformed_requests_do_not_crash():
    reg = port_registry()
    a = Client(reg)
    reg.dispatch(a.pid, {"type": "new_room", "name": "x", "n": 2,
                         "blinds": 5})
    assert a.msgs[-1] == {"status": -12, "msg": "Blinds must be positive integers"}
    reg.dispatch(a.pid, {"type": "new_room", "name": ["weird"], "n": 2})
    assert a.msgs[-1] == {"status": -5, "msg": "empty room name."}
    reg.dispatch(a.pid, {"type": "join_room", "name": {"a": 1}})
    assert a.msgs[-1]["status"] in (-1, -2)
    reg.dispatch(a.pid, {"type": "play", "name": None, "amt": "ten"})
    reg.dispatch(a.pid, {"type": "hand", "name": 7})
    assert a.msgs[-1]["status"] == -1
    reg.dispatch(a.pid, {"type": "whoami"})
    assert a.msgs[-1] == a.pid


def test_new_room_rules_validation():
    reg, (a, b, c) = make3()
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 2,
                         "rules": "calvinball"})
    assert a.msgs[-1] == {
        "status": -5,
        "msg": 'rules must be "reference", "standard" or "tournament"'}
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 2,
                         "rules": "standard"})
    assert a.msgs[-1] == {"status": 0, "msg": "OK"}


@pytest.mark.parametrize("backend", ["native", "torch", "auto"])
def test_standard_rules_room_conserves_chips(backend):
    reg = port_registry(backend)
    a, b = Client(reg), Client(reg)
    reg.dispatch(a.pid, {"type": "new_room", "name": "s", "n": 2,
                         "rules": "standard"})
    reg.dispatch(a.pid, {"type": "join_room", "name": "s"})
    reg.dispatch(b.pid, {"type": "join_room", "name": "s"})
    room = reg.rooms["s"]
    assert type(room.engine).__name__ == "TorchBackend"
    assert room.engine.rules == "standard"
    for _ in range(4):
        head = room.head_pid()
        assert head is not None
        reg.dispatch(head, {"type": "play", "name": "s", "amt": -1})
    assert room.engine.info()["hand_idx"] == 4
    assert reg.stacks[a.pid] + reg.stacks[b.pid] == 200 - 15


def test_tournament_room_freezes_when_won():
    reg = port_registry()
    a, b = Client(reg), Client(reg)
    reg.dispatch(a.pid, {"type": "new_room", "name": "t", "n": 2,
                         "rules": "tournament",
                         "blinds": {"small": 25, "big": 50}})
    reg.dispatch(a.pid, {"type": "join_room", "name": "t"})
    reg.dispatch(b.pid, {"type": "join_room", "name": "t"})
    room = reg.rooms["t"]
    for _ in range(200):
        head = room.head_pid()
        if head is None:
            break
        reg.dispatch(head, {"type": "play", "name": "t", "amt": 500})
    stacks = sorted(reg.stacks[p] for p in (a.pid, b.pid))
    assert stacks == [0, 200], stacks
    assert room.head_pid() is None
    t0 = room.engine.info()["time"]
    reg.dispatch(a.pid, {"type": "play", "name": "t", "amt": 0})
    reg.dispatch(b.pid, {"type": "play", "name": "t", "amt": 0})
    assert room.engine.info()["time"] == t0
    assert bool(room.engine.state.hand_over[0])
    # pushing the global stacks into the frozen table does not re-open it
    room.engine.set_stacks([reg.stacks[p] for p in room.seats])
    assert room.head_pid() is None
    assert not room.engine.act(0)
    assert room.engine.info()["time"] == t0


def test_bots_validation():
    reg, (a, b, c) = make3()
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 2,
                         "bots": 2})
    assert a.msgs[-1] == {"status": -5,
                          "msg": "bots must be an integer in [0, n)"}
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 2,
                         "bots": 1, "bot_policy": "nope"})
    assert a.msgs[-1]["status"] == -5
    assert "unknown bot_policy" in a.msgs[-1]["msg"]
    assert a.msgs[-1]["msg"] == (
        f"unknown bot_policy; have {sorted(BOT_POLICIES)}")
    assert "r" not in reg.rooms


def test_heads_up_vs_uniform_bot():
    reg = port_registry()
    a = Client(reg)
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 2,
                         "bots": 1, "bot_policy": "uniform"})
    assert a.msgs[-1] == {"status": 0, "msg": "OK"}
    reg.dispatch(a.pid, {"type": "join_room", "name": "r"})
    room = reg.rooms["r"]
    assert room.started and len(room.bots) == 1
    assert room._bot_key.sub == SUB_BOT
    for _ in range(30):
        assert room.head_pid() == a.pid
        reg.dispatch(a.pid, {"type": "play", "name": "r", "amt": 0})
    assert room.engine.info()["hand_idx"] >= 2
    assert len(cards(a)) == 2 * (room.engine.info()["hand_idx"] + 1)


def _record_bot_states(room):
    """Wrap the room's ``bot_action`` to keep the state of every bot
    decision."""
    seen = []
    act = room.engine.bot_action

    def recording(fn, key):
        seen.append(room.engine.state)
        return act(fn, key)

    room.engine.bot_action = recording
    return seen


def test_six_max_vs_trained_bots():
    """Five house bots on the default 6-max artifact against one client:
    play always returns to the human, and every bot decision's logits
    equal JAX's on the same state (carried across), within 2e-6 of the
    largest logit, with the same fold mask."""
    reg = port_registry()
    a = Client(reg)
    reg.dispatch(a.pid, {"type": "new_room", "name": "r", "n": 6,
                         "bots": 5})
    assert a.msgs[-1] == {"status": 0, "msg": "OK"}
    room = reg.rooms["r"]
    reg.dispatch(a.pid, {"type": "join_room", "name": "r"})
    assert room.started
    assert isinstance(room.engine, TorchBackend)  # bot rooms force torch
    seen = _record_bot_states(room)
    for _ in range(12):
        assert room.head_pid() == a.pid
        reg.dispatch(a.pid, {"type": "play", "name": "r", "amt": 0})
    # the bots acted in between; whole hands completed
    assert len(seen) > 12
    assert room.engine.info()["hand_idx"] >= 1

    params = tpn.load_params(ROOT / "data" / BOT_POLICIES["6max"])
    jparams = jpn.load_params(str(ROOT / "data" / BOT_POLICIES["6max"]))
    batch = _tree_map(lambda *xs: torch.cat(xs), *seen)
    feats = tfe.state_features(batch)
    ours = tpn.policy_logits(params, feats).numpy()
    ours_masked = tpn.masked_logits(torch.from_numpy(ours), batch).numpy()
    jst = to_jax(batch)
    jfeats = jax.vmap(jfeat.state_features)(jst)
    np.testing.assert_array_equal(feats.numpy(), np.asarray(jfeats))
    theirs = np.asarray(jpn.policy_logits(jparams, jfeats))
    atol = 2e-6 * max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=atol)
    # the fold mask: JAX masks the fold where nothing is owed
    free = ours_masked[:, 0] < -1e8
    jfree = np.asarray(jax.vmap(lambda s: jstreet.bets_needed(
        s.bets, jstep.head_info(s)[0]) == 0)(jst))
    np.testing.assert_array_equal(free, jfree)


# -- card-independent wire: the port against the JAX host -----------------

def _scrub(m, drop_cards=True):
    if not isinstance(m, dict):
        return json.dumps(m)
    if "card" in m and drop_cards:
        return None
    if "community-cards" in m and drop_cards:
        m = {k: v for k, v in m.items() if k != "community-cards"}
    return json.dumps(m, sort_keys=True)


def _wire(reg, clients, drop_cards=True):
    wire = [_scrub(m, drop_cards) for cl in clients for m in cl.msgs]
    return [w for w in wire if w is not None], dict(reg.stacks)


def _drive(reg, rules, amounts, n=3, rooms=("a", "b")):
    """Seat ``n`` players in each room, then let each room's head act the
    amounts in turn (rooms alternating); return the transcript."""
    clients = [Client(reg) for _ in range(n)]
    for name in rooms:
        reg.dispatch(clients[0].pid, {"type": "new_room", "name": name,
                                      "n": n, "rules": rules})
        for cl in clients:
            reg.dispatch(cl.pid, {"type": "join_room", "name": name})
    for amt in amounts:
        for name in rooms:
            head = reg.rooms[name].head_pid()
            if head is not None:
                reg.dispatch(head, {"type": "play", "name": name,
                                    "amt": amt})
    return clients


FOLD_ONLY = [-1] * 6
# calls and checks through the turn of each hand: no showdown is reached
CHECK_ONLY = [0] * 8


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("script", ["fold", "check"])
def test_card_independent_wire_equals_jax(rules, script):
    amounts = FOLD_ONLY if script == "fold" else CHECK_ONLY
    jreg = JaxRegistry(backend="jax")
    treg = port_registry("torch")
    want = _wire(jreg, _drive(jreg, rules, amounts))
    got = _wire(treg, _drive(treg, rules, amounts))
    assert got == want
    assert any("play-order" in w for w in got[0])


@pytest.mark.parametrize("script", ["fold", "check"])
def test_card_independent_wire_native_equals_jax(script):
    amounts = FOLD_ONLY if script == "fold" else CHECK_ONLY
    jreg = JaxRegistry(backend="jax")
    nreg = port_registry("native")
    want = _wire(jreg, _drive(jreg, "reference", amounts))
    got = _wire(nreg, _drive(nreg, "reference", amounts))
    assert type(nreg.rooms["a"].engine).__name__ == "NativeBackend"
    assert got == want


def test_cross_room_global_stacks_identical_wire():
    """``test_server.py``'s cross-room script: the port's torch and native
    rooms against the JAX host, transcripts and global stacks equal."""
    def run(reg):
        p, q = Client(reg), Client(reg)
        for cl, msg in [
                (p, {"type": "new_room", "name": "a", "n": 2}),
                (p, {"type": "join_room", "name": "a"}),
                (q, {"type": "join_room", "name": "a"}),
                (p, {"type": "new_room", "name": "b", "n": 2}),
                (p, {"type": "join_room", "name": "b"}),
                (q, {"type": "join_room", "name": "b"}),
                (q, {"type": "play", "name": "a", "amt": -1}),
                (p, {"type": "play", "name": "a", "amt": -1}),
                (q, {"type": "play", "name": "b", "amt": 0}),
                (p, {"type": "play", "name": "b", "amt": 0})]:
            reg.dispatch(cl.pid, msg)
        room_b = reg.rooms["b"]
        live = sorted(pl["stack"] for pl in
                      room_b.engine.board_json(room_b.seats)["players"])
        return _wire(reg, (p, q)), live

    want = run(JaxRegistry(backend="jax"))
    assert run(port_registry("torch")) == want
    assert run(port_registry("native")) == want


# -- card-dependent wire: decks injected --------------------------------------

SCRIPT = [0, 20, 0, 0, -1, 0, 30, 0, 0, 0, 0, 500, 0, -1, 0, 10, 0, 0, 0,
          0, 0, -1, 40, 0, 0, 0]


def _jax_decks(monkeypatch):
    """Record the JAX host's deck of every (room seed, hand)."""
    decks = {}

    class Recording(jbackends.JaxBackend):
        def __init__(self, n, small, big, seed, stacks, rules="reference"):
            super().__init__(n, small, big, seed, stacks, rules=rules)
            self._room_seed = seed
            self._record()

        def _record(self):
            decks[(self._room_seed, int(self.state.hand_idx))] = \
                np.asarray(self.state.deck)

        def act(self, amt):
            new = super().act(amt)
            self._record()
            return new

    monkeypatch.setattr(jbackends, "JaxBackend", Recording)
    return decks


def _injecting(decks_of):
    """A ``TorchBackend`` whose every deal gets ``decks_of(seed, hand)``
    injected with ``redeal``."""
    class Injected(TorchBackend):
        def __init__(self, n, small, big, seed, stacks, rules="reference",
                     device=None):
            super().__init__(n, small, big, seed, stacks, rules=rules,
                             device=device)
            self._room_seed = seed
            self._inject()

        def _inject(self):
            deck = decks_of(self._room_seed, int(self.state.hand_idx[0]))
            self.state = tstate.redeal(self.state, torch.tensor(
                np.asarray(deck))[None])

        def act(self, amt):
            new = super().act(amt)
            if new:
                self._inject()
            return new

    return Injected


@pytest.mark.parametrize("rules", RULES)
def test_card_dependent_wire_equals_jax_with_injected_decks(rules,
                                                            monkeypatch):
    """The whole transcript, hole cards and boards included: a script of
    calls, raises and folds on the JAX host, then on the port with each
    JAX deck injected at its deal."""
    decks = _jax_decks(monkeypatch)
    jreg = JaxRegistry(backend="jax")
    want = _wire(jreg, _drive(jreg, rules, SCRIPT), drop_cards=False)
    monkeypatch.setattr(backends, "TorchBackend",
                        _injecting(lambda s, h: decks[(s, h)]))
    treg = port_registry("torch")
    got = _wire(treg, _drive(treg, rules, SCRIPT), drop_cards=False)
    assert got == want
    hands = max(h for _, h in decks)
    assert hands >= 2  # the script crossed hand boundaries
    assert sum('"card"' in w for w in got[0]) > 2 * 3 * 2


def test_card_dependent_wire_torch_equals_native(monkeypatch):
    """``TorchBackend`` against the port's ``NativeBackend`` on its PCG64
    decks (reference rules): whole transcripts equal."""
    nreg = port_registry("native")
    want = _wire(nreg, _drive(nreg, "reference", SCRIPT), drop_cards=False)

    def pcg64_deck(seed, hand):
        rng = np.random.Generator(np.random.PCG64(seed))
        for _ in range(hand):
            rng.permutation(52)
        return rng.permutation(52).astype(np.int32)

    monkeypatch.setattr(backends, "TorchBackend", _injecting(pcg64_deck))
    treg = port_registry("torch")
    got = _wire(treg, _drive(treg, "reference", SCRIPT), drop_cards=False)
    assert got == want


# -- the process entry -------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_entry_answers_whoami():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "montecarlo_tpu_torch", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "--backend", "torch"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port),
                                                timeout=5)
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline, "no server"
                time.sleep(0.2)
        with sock:
            sock.sendall(b'{"type": "whoami"}\r\n')
            line = sock.makefile("rb").readline()
        assert json.loads(line.decode()) == "G__1000"
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)


def test_ported_modules_hold_the_jax_public_names():
    """The server, native and utils modules define every public name of
    their JAX counterparts (``JaxBackend`` is ``TorchBackend`` here), and
    the shared constants are equal."""
    import importlib

    for name in ("server.host", "server.tcp", "server.backends", "native",
                 "utils.checkpoint", "utils.profiling", "__main__"):
        theirs = importlib.import_module("montecarlo_tpu." + name)
        ours = importlib.import_module("montecarlo_tpu_torch." + name)
        names = {k for k, v in vars(theirs).items() if not k.startswith("_")
                 and getattr(v, "__module__", None) == theirs.__name__}
        names -= {"JaxBackend"}
        assert names <= set(vars(ours)), (name, names - set(vars(ours)))
    from montecarlo_tpu.server import host as jhost
    from montecarlo_tpu.server import tcp as jtcp
    from montecarlo_tpu_torch.server import host as thost
    from montecarlo_tpu_torch.server import tcp as ttcp

    assert thost.OK == jhost.OK and thost.BOT_POLICIES == jhost.BOT_POLICIES
    assert ttcp.PORT == jtcp.PORT
    assert thost.error(-5, "x") == jhost.error(-5, "x")
