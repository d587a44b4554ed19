"""Cluster event emission — the gf_event analog.

Reference: libglusterfs/src/events.c:27-31 (gf_event): any daemon fires
a fire-and-forget UDP datagram at the local glustereventsd, which fans
events out to registered webhooks (events/src/glustereventsd.py).

Here: JSON datagrams to the endpoint named by ``GFTPU_EVENTSD``
(host:port) or :func:`configure`; unset means events are disabled and
emission is a no-op.  Never raises, never blocks — losing an event must
not fail a fop.
"""

from __future__ import annotations

import json
import os
import socket
import time

_endpoint: tuple[str, int] | None = None
_sock: socket.socket | None = None

# emission accounting (absorbed by the unified registry the same way
# wire.blob_stats is): how many lifecycle events this process fired,
# dropped on a send error, or suppressed because no eventsd is
# configured — the event plane's own health must be observable too
emit_stats = {"sent": 0, "send_failed": 0, "unconfigured": 0}

from . import metrics as _metrics  # noqa: E402

_metrics.REGISTRY.register(
    "gftpu_events_emitted_total", "counter",
    "gf_event emissions by outcome (sent / send_failed / unconfigured)",
    lambda: _metrics.labeled(emit_stats))


def configure(endpoint: str | None) -> None:
    """'host:port' enables emission in this process; None disables."""
    global _endpoint, _sock
    if not endpoint:
        _endpoint = None
        return
    host, _, port = endpoint.rpartition(":")
    try:
        _endpoint = (host or "127.0.0.1", int(port))
    except ValueError:  # malformed endpoint disables, never raises
        _endpoint = None
        return
    if _sock is None:
        _sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        _sock.setblocking(False)


def _resolve() -> tuple[str, int] | None:
    if _endpoint is not None:
        return _endpoint
    env = os.environ.get("GFTPU_EVENTSD")
    if env:
        configure(env)
        return _endpoint
    return None


def gf_event(event: str, **fields) -> bool:
    """Emit one event; returns whether a datagram was sent."""
    payload = {"event": event, "ts": time.time(), "pid": os.getpid()}
    payload.update(fields)
    target = _resolve()
    if target is None:
        emit_stats["unconfigured"] += 1
        return False
    try:
        _sock.sendto(json.dumps(payload).encode(), target)
        emit_stats["sent"] += 1
        return True
    except OSError:
        emit_stats["send_failed"] += 1
        return False
