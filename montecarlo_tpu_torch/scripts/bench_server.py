"""Interactive-server load test: N rooms x M actions over real TCP.

The port of ``scripts/bench_server.py`` on the port's server: per-action
latency from the head player's ``play`` line hitting the socket to that
player receiving the resulting board broadcast (``board-action`` ->
``update-players``, the reference hot path ``server.clj:107-130`` /
``board.clj:122-129``), and aggregate actions/s with all rooms playing
concurrently against one in-process ``start_server(port=0)``; then the
engine+host cost of an action without sockets (``bench_direct``). The
keys are those of ``data/server_load_jax.json``.

Run from the repository root (torch rooms on the card unless ``--device
cpu``):
    python -m montecarlo_tpu_torch.scripts.bench_server --save OUT.json
        [--rooms 16] [--players 3] [--actions 200] [--direct-actions 2000]
        [--backend native|torch] [--device cuda|cpu]

Every action is a call (amt 0) so hands run forever (reference rules:
perpetual redeal, busted players never eliminated, gameplay.clj:149).
The torch backend steps each room's one-table engine per action; the
asyncio host runs rooms one action at a time, so actions/s is about one
over the engine's action latency.
"""

import argparse
import asyncio
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


async def run_room(port: int, room: str, n_players: int, n_actions: int,
                   latencies: list):
    """One room: connect players, create+join, then drive n_actions calls
    from whichever player heads the play order, timing send->broadcast."""
    clients = []
    for _ in range(n_players):
        r, w = await asyncio.open_connection("127.0.0.1", port)
        clients.append({"r": r, "w": w, "pid": None, "boards": []})

    async def send(c, obj):
        c["w"].write((json.dumps(obj) + "\r\n").encode())
        await c["w"].drain()

    async def recv(c, timeout=120.0):
        line = await asyncio.wait_for(c["r"].readline(), timeout)
        return json.loads(line.decode().rstrip())

    for c in clients:
        await send(c, {"type": "whoami"})
        c["pid"] = await recv(c)
    await send(clients[0], {"type": "new_room", "name": room,
                            "n": n_players})
    ack = await recv(clients[0])
    assert ack.get("status") == 0, ack
    for c in clients:
        await send(c, {"type": "join_room", "name": room})

    by_pid = {c["pid"]: c for c in clients}

    # Boards are broadcast ONLY to in-hand seats (host.py _broadcast),
    # and an exact-equality all-in drops a player from in_hand for the
    # rest of the hand (reference quirk, step.py) — so no fixed client
    # is guaranteed a copy of any given board. One reader task per
    # client feeds a shared queue; the drive loop waits for the FIRST
    # copy of a strictly NEWER board (the public "time" logical clock
    # advances with every play), which also keeps every socket buffer
    # drained without blocking on clients the broadcast skipped.
    q: asyncio.Queue = asyncio.Queue()

    async def reader(c):
        while True:
            msg = await c["r"].readline()
            if not msg:
                return
            msg = json.loads(msg.decode().rstrip())
            if isinstance(msg, dict) and "play-order" in msg:
                q.put_nowait((time.perf_counter(), msg))

    readers = [asyncio.ensure_future(reader(c)) for c in clients]

    async def next_board(prev):
        # Later copies of broadcast N can interleave with the first copy
        # of N+1 across sockets, and the logical clock resets per hand —
        # so a "new" board is one whose CONTENT differs from the last
        # seen (stacks/pot/play-order change with every action; copies
        # of one broadcast are byte-identical).
        while True:
            t1, b = await asyncio.wait_for(q.get(), 120.0)
            if b != prev:
                return t1, b

    # game start: hole cards + the first board reach every player
    _, board = await next_board(None)
    head = by_pid[board["play-order"][0]]

    for _ in range(n_actions):
        t0 = time.perf_counter()
        await send(head, {"type": "play", "name": room, "amt": 0})
        t1, board = await next_board(board)
        latencies.append(t1 - t0)
        head = by_pid[board["play-order"][0]]

    for task in readers:
        task.cancel()
    for c in clients:
        c["w"].close()


async def bench(backend: str, rooms: int, players: int, actions: int,
                device=None):
    from montecarlo_tpu_torch.server.host import Registry
    from montecarlo_tpu_torch.server.tcp import start_server

    registry = Registry(backend=backend, device=device)
    server, _ = await start_server(registry=registry, host="127.0.0.1",
                                   port=0)
    port = server.sockets[0].getsockname()[1]

    latencies: list = []
    t0 = time.perf_counter()
    await asyncio.gather(*[
        run_room(port, f"load{i}", players, actions, latencies)
        for i in range(rooms)])
    wall = time.perf_counter() - t0
    server.close()
    await server.wait_closed()

    lat = sorted(latencies)

    def pct(p):
        return lat[min(len(lat) - 1, int(p / 100 * len(lat)))]

    return {
        "backend": backend, "rooms": rooms, "players": players,
        "actions_per_room": actions, "total_actions": len(lat),
        "wall_seconds": round(wall, 3),
        "actions_per_sec": round(len(lat) / wall, 1),
        "latency_p50_us": round(pct(50) * 1e6, 1),
        "latency_p90_us": round(pct(90) * 1e6, 1),
        "latency_p99_us": round(pct(99) * 1e6, 1),
        "latency_mean_us": round(sum(lat) / len(lat) * 1e6, 1),
    }


def bench_direct(backend: str, actions: int = 2000, device=None):
    """Host-engine action latency without sockets: one room, actions
    dispatched synchronously through Registry.dispatch — the engine+host
    cost per action (the TCP numbers above add event-loop scheduling,
    shared here by every simulated client)."""
    from montecarlo_tpu_torch.server.host import Registry

    registry = Registry(backend=backend, device=device)
    inboxes = {}
    pids = []
    seq = iter(range(1 << 62))  # global arrival order across inboxes
    for k in range(3):
        box = []
        pid = registry.add_player(
            lambda msg, box=box: box.append((next(seq), msg)))
        inboxes[pid] = box
        pids.append(pid)
    registry.dispatch(pids[0], {"type": "new_room", "name": "d", "n": 3})
    for pid in pids:
        registry.dispatch(pid, {"type": "join_room", "name": "d"})

    def head_pid():
        # the GLOBALLY newest board: broadcasts skip non-in-hand seats
        # (all-in quirk), so any fixed player's inbox can be stale
        newest, newest_seq = None, -1
        for pid in pids:
            for s, msg in reversed(inboxes[pid]):
                if isinstance(msg, dict) and "play-order" in msg:
                    if s > newest_seq:
                        newest, newest_seq = msg, s
                    break
        if newest is None:
            raise AssertionError("no board broadcast seen")
        return newest["play-order"][0]

    lat = []
    for _ in range(actions):
        pid = head_pid()
        t0 = time.perf_counter()
        registry.dispatch(pid, {"type": "play", "name": "d", "amt": 0})
        lat.append(time.perf_counter() - t0)
    lat.sort()
    return {
        "engine_action_p50_us": round(lat[len(lat) // 2] * 1e6, 1),
        "engine_action_p99_us": round(lat[int(0.99 * len(lat))] * 1e6, 1),
        "engine_actions_per_sec": round(len(lat) / sum(lat), 1),
    }


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rooms", type=int, default=16)
    ap.add_argument("--players", type=int, default=3)
    ap.add_argument("--actions", type=int, default=200)
    ap.add_argument("--direct-actions", type=int, default=2000)
    ap.add_argument("--backend", default="native",
                    choices=["native", "torch"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--save", required=True,
                    help="output JSON (not in data/: its files are the "
                         "reference)")
    return ap


def main(argv=None):
    """Print and save the run's keys under its backend's name; return
    them."""
    args = parser().parse_args(argv)
    save = os.path.abspath(args.save)
    if os.path.commonpath([save, os.path.join(ROOT, "data")]) == \
            os.path.join(ROOT, "data"):
        raise SystemExit("--save: data/ holds the reference's records")
    from montecarlo_tpu_torch.device import resolve

    device = resolve(None if args.device == "cuda" else "cpu")
    # A few untimed direct actions first: the first torch calls on a
    # device pay its lazy set-up, which would land in the socket
    # latencies.
    t0 = time.perf_counter()
    bench_direct(args.backend, actions=4, device=device)
    print(json.dumps({"warmup_seconds":
                      round(time.perf_counter() - t0, 1)}), flush=True)

    out = asyncio.run(bench(args.backend, args.rooms, args.players,
                            args.actions, device))
    out.update(bench_direct(args.backend, args.direct_actions, device))
    out["device"] = str(device) if args.backend == "torch" else "host"
    print(json.dumps(out), flush=True)
    prev = {}
    if os.path.exists(save):
        with open(save) as f:
            prev = json.load(f)
    prev[args.backend] = out
    with open(save, "w") as f:
        json.dump(prev, f, indent=1)
    print(f"saved {args.save}")
    return out


if __name__ == "__main__":
    main()
