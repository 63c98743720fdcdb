"""Asyncio TCP server: port 10000, ``\\r\\n``-framed UTF-8 JSON lines.

A copy of ``montecarlo_tpu/server/tcp.py`` on the port's host.

The transport twin of ``start-server`` (``server.clj:132-135``, aleph +
gloss framing): one connection = one gensym player; requests dispatch on
``type``; malformed JSON answers ``{"status": -17, "msg": "You sent me bad
json!"}`` (``server.clj:123-124``). Outbound messages are JSON +
``\\r\\n`` (the gloss string frame applies both ways).
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from montecarlo_tpu_torch.server.host import Registry, error

PORT = 10000  # server.clj:135


async def _handle(registry: Registry, reader: asyncio.StreamReader,
                  writer: asyncio.StreamWriter):
    loop = asyncio.get_running_loop()
    queue: asyncio.Queue = asyncio.Queue()

    def sink(msg):
        # Host logic is synchronous; hop through a queue so sends are safe
        # from any context and writes stay ordered per connection.
        try:
            loop.call_soon_threadsafe(queue.put_nowait, msg)
        except RuntimeError:
            pass

    pid = registry.add_player(sink)

    async def pump():
        while True:
            msg = await queue.get()
            if msg is None:
                return
            writer.write((json.dumps(msg) + "\r\n").encode("utf-8"))
            await writer.drain()

    pump_task = asyncio.create_task(pump())
    buf = b""
    try:
        while True:
            data = await reader.read(4096)
            if not data:
                break
            buf += data
            while b"\r\n" in buf:
                line, buf = buf.split(b"\r\n", 1)
                if not line:
                    continue
                try:
                    req = json.loads(line.decode("utf-8"))
                    if not isinstance(req, dict):
                        raise ValueError("not an object")
                    registry.dispatch(pid, req)
                except (json.JSONDecodeError, UnicodeDecodeError, ValueError):
                    registry.send(pid, error(-17, "You sent me bad json!"))
    finally:
        registry.remove_player(pid)
        queue.put_nowait(None)
        await pump_task
        writer.close()


async def start_server(registry: Optional[Registry] = None,
                       host: str = "0.0.0.0", port: int = PORT):
    """Start and return (asyncio server, registry). A new registry's
    torch rooms run on the card: pass a ``Registry(device="cpu")`` for
    the CPU."""
    registry = registry or Registry()

    async def handler(reader, writer):
        await _handle(registry, reader, writer)

    async def timeout_sweeper():
        # Failure-detection sweep (rooms created with a "timeout" opt-in).
        while True:
            await asyncio.sleep(0.5)
            registry.tick()

    server = await asyncio.start_server(handler, host, port)
    server._mc_sweeper = asyncio.create_task(timeout_sweeper())
    return server, registry


def serve(host: str = "0.0.0.0", port: int = PORT):
    """Blocking entry point (the reference's ``lein run``)."""

    async def main():
        server, _ = await start_server(host=host, port=port)
        async with server:
            await server.serve_forever()

    asyncio.run(main())


if __name__ == "__main__":
    serve()
