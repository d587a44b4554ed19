"""Structured logging with stable message IDs.

The reference logs through ``gf_msg(component, level, errno, msgid, fmt)``
with per-component message-ID catalogs (reference
libglusterfs/src/logging.c, glfs-message-id.h); message IDs are stable
across releases so operators can grep/alert on them.  Here: a thin wrapper
over :mod:`logging` that prefixes records with ``[MSGID: N]`` and keeps a
per-process in-memory ring of recent messages for statedump (the
event-history analog, reference circ-buff.c).
"""

from __future__ import annotations

import collections
import logging
import threading

_RING_SIZE = 1024
_ring: collections.deque[str] = collections.deque(maxlen=_RING_SIZE)
_ring_lock = threading.Lock()

# Message-ID bases per component (glfs-message-id.h segments a global space)
COMP_BASE = {
    "core": 100000,
    "ec": 110000,
    "afr": 120000,
    "dht": 130000,
    "posix": 140000,
    "protocol": 150000,
    "mgmt": 160000,
    "heal": 170000,
    "perf": 180000,
    "features": 190000,
}


def get_logger(component: str) -> "GfLogger":
    return GfLogger(component)


class GfLogger:
    def __init__(self, component: str):
        self._log = logging.getLogger(f"glusterfs_tpu_torch.{component}")
        self._base = COMP_BASE.get(component.split(".")[0], 0)

    def _emit(self, level: int, msgid: int, msg: str, *args,
              err: int | None = None):
        mid = self._base + msgid
        text = msg % args if args else msg
        if err is not None:
            text = f"{text} [errno={err}]"
        line = f"[MSGID: {mid}] {text}"
        self._log.log(level, line)
        with _ring_lock:
            _ring.append(f"{logging.getLevelName(level)} {self._log.name} {line}")

    def debug(self, msgid: int, msg: str, *args, **kw):
        self._emit(logging.DEBUG, msgid, msg, *args, **kw)

    def info(self, msgid: int, msg: str, *args, **kw):
        self._emit(logging.INFO, msgid, msg, *args, **kw)

    def warning(self, msgid: int, msg: str, *args, **kw):
        self._emit(logging.WARNING, msgid, msg, *args, **kw)

    def error(self, msgid: int, msg: str, *args, **kw):
        self._emit(logging.ERROR, msgid, msg, *args, **kw)

    def critical(self, msgid: int, msg: str, *args, **kw):
        self._emit(logging.CRITICAL, msgid, msg, *args, **kw)


def recent_messages(limit: int = 100) -> list[str]:
    """Most recent log lines (for statedump / tests)."""
    with _ring_lock:
        items = list(_ring)
    return items[-limit:]
