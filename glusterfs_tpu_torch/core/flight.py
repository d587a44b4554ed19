"""Per-process flight recorder — the always-on black box, trimmed.

The reference keeps a per-xlator ``circ-buff.c`` event history that
only a manual statedump can read.  This module is the process's flight
recorder: a bounded ring of NOTABLE records (shm lane disarms, failfast
transport bails) that costs nothing while healthy, plus
:func:`snapshot`, which packs the record ring, the span ring
(:mod:`core.tracing`) and the metrics registry into one JSON-able
bundle (a brick's ``__incident__`` answer).

This package keeps what protocol/client, protocol/server, io-stats and
the brick daemon call.  The JAX package's incident capture on disk
(``maybe_capture``, the ``diagnostics.incident-*`` keys), per-process
sections, the gf_event tap and the SIGUSR2 capture door are not ported
yet.

Everything here honours the :mod:`core.tracing` DARK gate: a process
darkened by ``GFTPU_NO_OBSERVABILITY`` records nothing.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any

from . import tracing
from .metrics import REGISTRY

#: rides the same master gate as the span ring
ENABLED = tracing.ENABLED

_RING_DEFAULT = 512

#: the bounded record ring; record = {"ts", "kind", ...fields}
RING: collections.deque = collections.deque(maxlen=_RING_DEFAULT)

#: what this process calls itself in bundles ("brick", ...) — set once
#: at daemon startup, purely descriptive
ROLE = ""

_record_counts: dict[str, int] = {}

REGISTRY.register(
    "gftpu_flight_records_total", "counter",
    "flight-recorder ring appends by record kind",
    lambda: [({"kind": k}, v) for k, v in sorted(_record_counts.items())])


def set_ring_size(n: int) -> None:
    """Rebound the record ring, keeping the newest entries."""
    global RING
    n = max(16, int(n))
    if RING.maxlen != n:
        RING = collections.deque(list(RING)[-n:], maxlen=n)


def set_role(role: str) -> None:
    global ROLE
    ROLE = str(role)


def record(kind: str, /, **fields) -> None:
    """Append one notable record to the ring (cheap, never raises).
    ``kind`` is positional-only so a field literally named "kind"
    cannot raise a TypeError; the ring's taxonomy key always wins the
    collision."""
    if not ENABLED:
        return
    try:
        rec = {"ts": round(time.time(), 6)}
        rec.update(fields)
        rec["kind"] = str(kind)
        RING.append(rec)
        _record_counts[kind] = _record_counts.get(kind, 0) + 1
    except Exception:  # noqa: BLE001 - the recorder must never hurt a fop
        pass


def snapshot(spans: int = 500, records: int = 0,
             metrics: bool = True) -> dict:
    """The bundle: record ring + span ring + metrics registry, one
    JSON-able dict."""
    out: dict[str, Any] = {
        "ts": round(time.time(), 6),
        "pid": os.getpid(),
        "role": ROLE,
        "enabled": ENABLED,
        "records": list(RING)[-records:] if records else list(RING),
        "spans": tracing.recent_spans(spans),
    }
    if metrics:
        out["metrics"] = REGISTRY.snapshot()
    return out


__all__ = ["ENABLED", "RING", "record", "snapshot", "set_ring_size",
           "set_role"]
