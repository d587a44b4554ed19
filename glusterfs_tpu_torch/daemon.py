"""Process entry point for a brick — the glusterfsd analog.

Reference: glusterfsd/src/glusterfsd.c:2650 — one binary runs every
data-plane role, selected by the volfile it loads.  This package's
daemon serves a brick graph (``protocol/server`` over TCP), from the
command line or programmatically.  A brick never touches the card: the
codec lives in the client's EC layer.

Usage:
    python -m glusterfs_tpu_torch.daemon --volfile brick.vol --listen 24010
    python -m glusterfs_tpu_torch.daemon --volfile brick.vol --listen 0 \\
        --portfile /tmp/port   # writes the chosen port (tests use this)

The JAX package's daemon also serves an HTTP metrics endpoint
(``--metrics-port``) and arms event emission (``--eventsd``); those wait
for their modules here, and :func:`main` refuses either flag.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys

from .core.graph import Graph
from .protocol.server import BrickServer
from .core import gflog

log = gflog.get_logger("core.daemon")


async def serve_brick(volfile_text: str, host: str = "127.0.0.1",
                      port: int = 0, top_name: str | None = None,
                      portfile: str | None = None) -> BrickServer:
    """Activate a brick graph and serve it (returns the running server)."""
    graph = Graph.construct(volfile_text, top_name=top_name)
    await graph.activate()
    server = BrickServer(graph.top, host, port, graph=graph)
    await server.start()
    if portfile:
        tmp = portfile + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        os.replace(tmp, portfile)
    return server


def _dump_state(server: BrickServer, volfile: str) -> None:
    """SIGUSR1 statedump (reference glusterfsd.c:2230 wiring +
    statedump.c:831): full graph dump to a timestamped file next to
    the volfile — the de-facto live-debugging interface."""
    import json
    import time

    src = server.graph if server.graph is not None else server.top
    path = (os.path.splitext(volfile)[0]
            + f".dump.{int(time.time())}.{os.getpid()}")
    try:
        with open(path + ".tmp", "w") as f:
            json.dump(src.statedump(), f, indent=1, default=repr)
        os.replace(path + ".tmp", path)
        log.info(2, "statedump written to %s", path)
    except Exception as e:
        log.error(3, "statedump failed: %r", e)


async def _amain(args) -> None:
    from .core import flight
    from .core.metrics import register_build_info

    flight.set_role("brick")
    register_build_info("brick")
    with open(args.volfile) as f:
        text = f.read()
    server = await serve_brick(text, args.host, args.listen,
                               args.top or None, args.portfile or None)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    loop.add_signal_handler(signal.SIGUSR1, _dump_state, server,
                            args.volfile)
    await stop.wait()
    await server.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gftpu-torch-daemon")
    p.add_argument("--volfile", required=True)
    p.add_argument("--top", default="",
                   help="top layer name (default: unreferenced layer)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--listen", type=int, default=0,
                   help="TCP port (0 = ephemeral)")
    p.add_argument("--portfile", default="",
                   help="write the bound port here (for ephemeral ports)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="not available in this package (refused)")
    p.add_argument("--eventsd", default="",
                   help="not available in this package (refused)")
    args = p.parse_args(argv)
    if args.metrics_port:
        p.error("--metrics-port: the HTTP metrics endpoint is not in "
                "this package")
    if args.eventsd:
        p.error("--eventsd: event emission is not in this package")
    asyncio.run(_amain(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
