"""Trace-context propagation: per-request spans across the whole stack.

The reference threads a ``frame->root`` through every STACK_WIND so a
statedump can show which xlator a call is parked in (stack.h:283,
call-stub.c pending frames) — but it never crosses the wire: a slow
client readv cannot say whether the time went to the client graph, the
transport, the brick graph or the disk.  Here every OUTERMOST fop call
on a graph mints a 16-hex-char trace id; each timed layer method
(``core.layer._timed``) records a span ``(trace, depth, layer, op,
start, duration, err)`` into a bounded per-process ring; and
protocol/client ships the id as a trailing wire-frame field that
protocol/server re-arms before dispatching into the brick graph — so
the brick's spans carry the CLIENT's trace id and the two statedumps
join into one tree.  One trace per compound chain: the chain's
outermost ``compound`` call is the root and every link is a child span.

The carrier is a :mod:`contextvars` ContextVar (the asyncio-idiomatic
``frame->root``): awaits and ``asyncio.gather`` fan-outs inherit it,
tasks copy it, and nothing in the fop signatures changes.  The io-stats
layer owns the operator knobs (``diagnostics.slow-fop-threshold``,
``diagnostics.span-ring-size``, and the master ``ENABLED`` gate rides
metrics-off bench runs / ``GFTPU_NO_OBSERVABILITY``).

A root span exceeding ``SLOW_FOP_THRESHOLD`` logs the full span tree —
a slow wire readv finally says WHERE the time went.
"""

from __future__ import annotations

import collections
import contextvars
import os
import time

from . import gflog
from .metrics import REGISTRY

log = gflog.get_logger("core.trace")

#: process darkening (GFTPU_NO_OBSERVABILITY / bench metrics-off):
#: while True, observability stays off no matter what volume options
#: say — io-stats' latency-measurement default must not re-arm the
#: histograms on a deliberately darkened process (the bench's off
#: pass mounts volumes whose io-stats init would otherwise undo it)
DARK = os.environ.get("GFTPU_NO_OBSERVABILITY", "") == "1"

#: master gate: False skips ALL span work in the fop hot path (set by
#: bench metrics-off passes and the GFTPU_NO_OBSERVABILITY env, which
#: brick subprocesses inherit so a whole served volume can run dark)
ENABLED = not DARK

#: root spans slower than this (seconds) log their full tree; 0 = off
#: (diagnostics.slow-fop-threshold)
SLOW_FOP_THRESHOLD = 0.0

_RING_DEFAULT = 4096

#: the bounded per-process span ring (circ-buff.c event-history analog);
#: span = (trace_id, depth, layer, op, start_ts, duration_s, err)
SPANS: collections.deque = collections.deque(maxlen=_RING_DEFAULT)

#: (trace_id, depth) of the span currently open in this context
CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "gftpu_trace", default=None)

#: per-(layer, op) slow-fop counts — the {layer,op} labels say WHICH
#: door and verb keeps blowing the threshold, not just that one did
SLOW_FOP_COUNTS: dict[tuple[str, str], int] = {}

REGISTRY.register(
    "gftpu_slow_fops_total", "counter",
    "root fops that exceeded diagnostics.slow-fop-threshold, "
    "by layer and op",
    lambda: [({"layer": l, "op": o}, v)
             for (l, o), v in sorted(SLOW_FOP_COUNTS.items())])


def set_ring_size(n: int) -> None:
    """Rebound the span ring (diagnostics.span-ring-size), keeping the
    newest entries."""
    global SPANS
    n = max(64, int(n))
    if SPANS.maxlen != n:
        SPANS = collections.deque(list(SPANS)[-n:], maxlen=n)


def new_trace_id() -> str:
    return os.urandom(8).hex()


def current_id() -> str | None:
    cur = CURRENT.get()
    return cur[0] if cur is not None else None


def arm(trace_id: str) -> None:
    """Adopt a wire-carried trace id for the rest of this context (the
    protocol/server re-arm: brick-graph spans join the client's trace
    instead of minting their own)."""
    CURRENT.set((str(trace_id), 0))


def enter(layer_name: str, op: str):
    """Open a span: mint a trace at the outermost call, else nest.
    Returns the token tuple ``exit_span`` needs."""
    cur = CURRENT.get()
    if cur is None:
        tid, depth, root = new_trace_id(), 0, True
    else:
        tid, depth, root = cur[0], cur[1] + 1, False
    tok = CURRENT.set((tid, depth))
    return (tid, depth, root, tok, layer_name, op, time.time())


def exit_span(span, duration: float, err: bool) -> None:
    tid, depth, root, tok, layer_name, op, start = span
    try:
        CURRENT.reset(tok)
    except ValueError:
        pass  # context migrated (sync facade thread hop): root-only
    SPANS.append((tid, depth, layer_name, op, start, duration, err))
    if not root:
        return
    if SLOW_FOP_THRESHOLD and duration >= SLOW_FOP_THRESHOLD:
        key = (layer_name, op)
        SLOW_FOP_COUNTS[key] = SLOW_FOP_COUNTS.get(key, 0) + 1
        tree = render_tree(tid)
        log.warning(7, "slow fop: %s.%s took %.1fms (threshold %.1fms) "
                    "trace %s\n%s", layer_name, op, duration * 1e3,
                    SLOW_FOP_THRESHOLD * 1e3, tid, tree)


def spans_for(trace_id: str) -> list[tuple]:
    return [s for s in list(SPANS) if s[0] == trace_id]


def recent_spans(limit: int = 200) -> list[dict]:
    """Newest spans as dicts (statedump's trace_spans section)."""
    out = []
    for tid, depth, layer_name, op, start, dur, err in \
            list(SPANS)[-limit:]:
        out.append({"trace": tid, "depth": depth, "layer": layer_name,
                    "op": op, "start": round(start, 6),
                    "ms": round(dur * 1e3, 3), "err": err})
    return out


def render_tree(trace_id: str) -> str:
    """The trace's spans as an indented tree (slow-fop log format:
    one line per span, two spaces per depth, duration in ms)."""
    spans = sorted(spans_for(trace_id), key=lambda s: (s[4], s[1]))
    lines = []
    for _tid, depth, layer_name, op, _start, dur, err in spans:
        mark = " !!" if err else ""
        lines.append(f"{'  ' * depth}{layer_name}.{op} "
                     f"{dur * 1e3:.2f}ms{mark}")
    return "\n".join(lines)


__all__ = ["ENABLED", "SLOW_FOP_THRESHOLD", "SLOW_FOP_COUNTS", "SPANS",
           "CURRENT", "arm",
           "enter", "exit_span", "current_id", "new_trace_id",
           "recent_spans", "render_tree", "set_ring_size", "spans_for"]
