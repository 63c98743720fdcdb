"""Process entry point (the reference's ``core.clj:5-7`` / ``lein run``):
start the port's TCP poker server on :10000.

    python -m montecarlo_tpu_torch [--host HOST] [--port PORT]
        [--backend native|torch|auto] [--device cuda|cpu]

Torch rooms (every standard, tournament and house-bot room, and reference
rooms under ``--backend torch``) run on the card unless ``--device cpu``.
"""

import argparse

from montecarlo_tpu_torch.server.host import Registry
from montecarlo_tpu_torch.server.tcp import PORT


def main(argv=None):
    ap = argparse.ArgumentParser(prog="montecarlo_tpu_torch")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=PORT)
    ap.add_argument("--backend", default="auto",
                    choices=["native", "torch", "auto"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import asyncio

    from montecarlo_tpu_torch.device import resolve
    from montecarlo_tpu_torch.server.tcp import start_server

    device = resolve(None if args.device == "cuda" else "cpu")

    async def run():
        server, _ = await start_server(
            Registry(backend=args.backend, device=device),
            host=args.host, port=args.port)
        async with server:
            await server.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
