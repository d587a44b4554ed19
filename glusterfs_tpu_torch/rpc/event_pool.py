"""Concurrent event plane: keyed frame-turning worker pools.

Reference: libglusterfs/src/gf-event (event-epoll.c multithreaded epoll,
``server.event-threads`` / ``client.event-threads``) plus the
own-thread transport mode — N threads turn socket events concurrently,
with each socket's events handled by one thread at a time so a
connection's requests are never reordered.

Here the transports are asyncio streams, so the pool does not own the
sockets; it owns the CPU work of *turning a frame*: decode of an
arrived record (``wire.unpack``), encode of an outgoing reply
(``wire.pack_frames`` / ``pack_z``), and whatever payload handling
rides them (zlib inflate/deflate releases the GIL; the native wirec
codec and checksum paths do for their bulk sections).  The asyncio
loops keep doing what they are good at — socket readiness and fop
scheduling — while frame turning overlaps across connections on the
pool.

Ordering invariant (the own-thread analog): jobs submitted under the
same **key** (one key per connection) execute FIFO and never
concurrently; distinct keys proceed in parallel across the workers.
The brick's per-connection read loop additionally awaits each decode
before reading the next frame, so a connection's fops are *dispatched*
in arrival order no matter how many workers exist.

Observability: ``gftpu_event_threads`` / ``gftpu_event_threads_busy``
gauges and a per-worker ``gftpu_event_frames_total`` counter family on
the unified registry (docs/event_threads.md).

Sizing is live: ``resize()`` grows by spawning workers and shrinks by
retiring them as they come off a job — in-flight and queued work is
never dropped (the reconfigure contract the tests pin).
"""

from __future__ import annotations

import asyncio
import collections
import itertools
import queue
import threading
import time
from typing import Any, Callable

from ..core import gflog
from ..core import metrics as _metrics

log = gflog.get_logger("rpc.event")

#: frames below this turn inline on the event loop: a lookup record is
#: ~100 bytes and the thread handoff costs more than the decode (the
#: reference's epoll threads have no such floor because they own the
#: whole socket; here the handoff is explicit, so it must pay for
#: itself).
TURN_MIN = 4096

#: live pools, scraped by the unified registry (weakref: a stopped
#: server's pool ages out with the GC)
_LIVE_POOLS = _metrics.REGISTRY.register_objects(
    "gftpu_event_threads", "gauge",
    "configured frame-turning workers per event pool "
    "(server.event-threads / client.event-threads)",
    lambda p: [({"pool": p.name}, p.size)])
_metrics.REGISTRY.register_objects(
    "gftpu_event_threads_busy", "gauge",
    "event-pool workers currently turning a frame",
    lambda p: [({"pool": p.name}, p.busy)], live=_LIVE_POOLS)
_metrics.REGISTRY.register_objects(
    "gftpu_event_frames_total", "counter",
    "frames turned per event-pool worker",
    lambda p: [({"pool": p.name, "worker": w}, n)
               for w, n in sorted(p.frames_turned.items())],
    live=_LIVE_POOLS)


class _Job:
    __slots__ = ("fn", "args", "loop", "future")

    def __init__(self, fn, args, loop, future):
        self.fn = fn
        self.args = args
        self.loop = loop
        self.future = future


class EventPool:
    """N worker threads turning jobs with per-key FIFO serialization.

    A key (one per connection) owns at most one running job at a time;
    its backlog drains in submission order.  Distinct keys spread over
    the workers.  This is the scheduling shape of the reference's
    own-thread socket dispatch expressed over a shared pool."""

    def __init__(self, threads: int, name: str = "event"):
        self.name = name
        self._lock = threading.Lock()
        # key-id -> deque of queued jobs; a key present in the dict is
        # either running or queued on _runq (never both idle and listed)
        self._keyed: dict[int, collections.deque] = {}
        self._runq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._workers: list[threading.Thread] = []
        self._target = 0
        self._seq = itertools.count(1)
        self.busy = 0
        self.frames_turned: dict[str, int] = {}
        self._shutdown = False
        self.resize(threads)
        _LIVE_POOLS.add(self)

    # -- sizing -----------------------------------------------------------

    @property
    def size(self) -> int:
        return self._target

    @property
    def closed(self) -> bool:
        return self._shutdown

    def resize(self, threads: int) -> None:
        """Grow by spawning, shrink by retiring workers as they come
        off a job — queued/in-flight work is never dropped."""
        threads = max(0, int(threads))
        with self._lock:
            if self._shutdown:
                return
            self._target = threads
            self._workers = [w for w in self._workers if w.is_alive()]
            while len(self._workers) < threads:
                wname = f"{self.name}-evt-{next(self._seq)}"
                t = threading.Thread(target=self._worker_main,
                                     args=(wname,), name=wname,
                                     daemon=True)
                self._workers.append(t)
                t.start()
            excess = len(self._workers) - threads
        # wake exactly the excess workers so they can notice retirement
        # (a worker blocked on an empty queue would otherwise linger)
        for _ in range(max(0, excess)):
            self._runq.put(None)

    def ensure(self, threads: int) -> None:
        """Cheap per-use reconcile: resize only when the configured
        value changed (one int compare on the hot path)."""
        if threads != self._target:
            self.resize(threads)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._target = 0
            n = len(self._workers)
        for _ in range(n):
            self._runq.put(None)

    # -- submission -------------------------------------------------------

    def submit(self, key: Any, fn: Callable, *args) -> "asyncio.Future":
        """Schedule ``fn(*args)`` on the pool, serialized FIFO against
        other jobs with the same key.  Returns an asyncio Future
        resolved on the submitting loop."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        job = _Job(fn, args, loop, fut)
        kid = id(key)
        with self._lock:
            if self._shutdown or self._target <= 0:
                pending = None  # turn inline below, outside the lock
            else:
                pending = self._keyed.get(kid)
                if pending is None:
                    # key idle: claim it and enqueue for a worker
                    self._keyed[kid] = collections.deque()
                    self._runq.put((kid, job))
                else:
                    pending.append(job)
                return fut
        # inline fallback (pool disabled mid-flight): still answer
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 - mirrored to caller
            fut.set_exception(e)
        return fut

    async def turn(self, key: Any, fn: Callable, *args) -> Any:
        """Await ``fn(*args)`` turned on the pool (or inline when the
        pool is sized to zero — the event-threads=0 escape hatch)."""
        if self._target <= 0:
            return fn(*args)
        return await self.submit(key, fn, *args)

    # -- worker -----------------------------------------------------------

    def _worker_main(self, wname: str) -> None:
        self.frames_turned.setdefault(wname, 0)
        while True:
            item = self._runq.get()
            if item is None:
                with self._lock:
                    alive = [w for w in self._workers if w.is_alive()]
                    over = self._shutdown or len(alive) > self._target
                    # a retirement that would leave queued keyed work
                    # with NO surviving worker (target 0 / shutdown)
                    # must drain first: an orphaned job's future would
                    # never resolve and its connection would wedge.
                    # target > 0 always leaves >= 1 survivor (resize
                    # posts exactly `excess` tokens).
                    drain_first = over and self._target <= 0 \
                        and bool(self._keyed)
                    if over and not drain_first:
                        me = threading.current_thread()
                        self._workers = [w for w in alive if w is not me]
                        return
                if drain_first:
                    # repost the token and serve the backlog first
                    self._runq.put(None)
                    time.sleep(0.001)
                continue  # spurious wake (resize race): keep serving
            kid, job = item
            with self._lock:
                self.busy += 1
            try:
                result, exc = job.fn(*job.args), None
            except BaseException as e:  # noqa: BLE001 - mirrored
                result, exc = None, e
            finally:
                with self._lock:
                    self.busy -= 1
                    self.frames_turned[wname] = \
                        self.frames_turned.get(wname, 0) + 1
            self._resolve(job, result, exc)
            # hand the key's NEXT job back through the run queue (not
            # drained inline): FIFO per key — the per-connection
            # ordering invariant — with round-robin fairness across
            # keys.  At most one job per key is ever on the run queue,
            # which is what makes same-key jobs mutually exclusive.
            with self._lock:
                backlog = self._keyed.get(kid)
                if backlog:
                    self._runq.put((kid, backlog.popleft()))
                else:
                    self._keyed.pop(kid, None)

    @staticmethod
    def _resolve(job: _Job, result, exc) -> None:
        def done():
            if job.future.cancelled():
                return
            if exc is not None:
                job.future.set_exception(exc)
            else:
                job.future.set_result(result)
        try:
            job.loop.call_soon_threadsafe(done)
        except RuntimeError:
            pass  # submitting loop closed mid-turn (teardown race)

    def dump(self) -> dict:
        return {"threads": self._target,
                "busy": self.busy,
                "keys_active": len(self._keyed),
                "frames_turned": dict(self.frames_turned)}


# -- the shared client-side pool (client.event-threads) -------------------
#
# The reference sizes event threads PER PROCESS (one gf-event pool per
# glusterfs process, every transport shares it); protocol/client mirrors
# that: all client layers in a process share one pool, created on first
# use and sized to the largest request seen (reconfigure resizes it
# directly — the operator's latest `volume set` wins, as it does for the
# reference's process-wide knob).

_client_pool: EventPool | None = None
_client_pool_lock = threading.Lock()


def client_pool(threads: int) -> EventPool | None:
    """The process-wide reply-turning pool, grown to ``threads`` (never
    implicitly shrunk — several graphs share it).  ``threads <= 0``
    returns the existing pool for INTROSPECTION only (callers wanting
    inline decode must gate on their own option, not on this return —
    a 0-configured layer must not ride a pool another graph grew).
    Lock-free when the pool is already big enough: this runs per large
    frame on every connection's receive path."""
    global _client_pool
    pool = _client_pool
    if threads <= 0:
        return pool if pool is not None and pool.size > 0 else None
    if pool is not None and pool.size >= threads:
        return pool  # hot path: no lock, no resize
    with _client_pool_lock:
        if _client_pool is None:
            _client_pool = EventPool(threads, name="client")
        elif _client_pool.size < threads:
            _client_pool.resize(threads)
    return _client_pool


def client_pool_resize(threads: int) -> None:
    """Explicit resize (live reconfigure of client.event-threads):
    unlike the connect-time max-wins growth, the operator's latest
    value applies exactly — including shrink."""
    global _client_pool
    with _client_pool_lock:
        if _client_pool is None:
            if threads > 0:
                _client_pool = EventPool(threads, name="client")
        else:
            _client_pool.resize(threads)


__all__ = ["EventPool", "TURN_MIN", "client_pool", "client_pool_resize"]
