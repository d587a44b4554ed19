"""performance/io-threads — brick-side worker threads + admission
control with priority classes.

Reference: xlators/performance/io-threads (1.7k LoC; io-threads.c:64-89
priority map, :236 iot_worker): a worker pool with 4 priority queues
(fast/normal/slow/least) classified by fop, whose whole point is that a
slow disk syscall occupies a worker thread, never the brick's event
engine.  Two mechanisms here:

* a REAL ``ThreadPoolExecutor`` (``thread-count`` workers) injected into
  the storage/posix descendant, which routes its blocking data-plane
  syscalls through it — one stuck pread no longer stalls every
  connection on the brick;
* bounded-concurrency gates per priority class on the async side, so
  lookups/stats preempt bulk data (the queue-priority scheduling
  intent).

With the concurrent event plane (server.event-threads) this
layer is the brick's real parallel dispatcher: the event pool feeds
independent fops from different connections into the graph
concurrently, the priority gates admit them side by side, and the
injected executor runs their posix syscalls on parallel worker
threads.  Both pools resize LIVE: ``reconfigure`` grows/shrinks the
executor (a fresh pool swaps in; in-flight syscalls finish on the old
one) and the gates (a :class:`ResizableGate` re-admits parked waiters
when its limit grows), never dropping queued work.  ``inflight`` /
``peak_inflight`` make the achieved parallelism observable
(dump_private + the callpool status plane)."""

from __future__ import annotations

import asyncio
import collections
import errno
from concurrent.futures import ThreadPoolExecutor

from ..core.fops import Fop, FopError
from ..core.layer import Layer, register
from ..core.options import Option
from ..core import metrics as _metrics

_PRIO_NAMES = ("fast", "normal", "slow", "least")

#: live io-threads layers, scraped by the unified registry (weak: a
#: retired graph's layers age out with the GC); both families hang off
#: the one population
_LIVE_IOT_LAYERS = _metrics.REGISTRY.register_objects(
    "gftpu_io_threads_queued", "gauge",
    "fops currently queued or executing per priority class",
    lambda l: [({"layer": l.name, "prio": _PRIO_NAMES[i]}, v)
               for i, v in enumerate(l.queued)])
_metrics.REGISTRY.register_objects(
    "gftpu_io_threads_executed_total", "counter",
    "fops admitted through each priority gate",
    lambda l: [({"layer": l.name, "prio": _PRIO_NAMES[i]}, v)
               for i, v in enumerate(l.executed)],
    live=_LIVE_IOT_LAYERS)
_metrics.REGISTRY.register_objects(
    "gftpu_io_threads_deadline_dropped_total", "counter",
    "queued fops dropped at gate admission because the client's "
    "propagated deadline budget had already expired (the client "
    "abandoned the call — answering would burn a worker for nothing)",
    lambda l: [({"layer": l.name}, l.deadline_dropped)],
    live=_LIVE_IOT_LAYERS)

# fop -> priority class (io-threads.c:64-89)
FAST = {Fop.LOOKUP, Fop.STAT, Fop.FSTAT, Fop.ACCESS, Fop.READLINK,
        Fop.OPEN, Fop.OPENDIR, Fop.STATFS, Fop.GETXATTR, Fop.FGETXATTR}
NORMAL = {Fop.READV, Fop.WRITEV, Fop.FLUSH, Fop.FSYNC, Fop.CREATE,
          Fop.MKDIR, Fop.UNLINK, Fop.RMDIR, Fop.RENAME, Fop.LINK,
          Fop.SYMLINK, Fop.MKNOD, Fop.TRUNCATE, Fop.FTRUNCATE,
          Fop.SETXATTR, Fop.FSETXATTR, Fop.XATTROP, Fop.FXATTROP,
          Fop.SETATTR, Fop.FSETATTR,
          # the write vocabulary's long tail rides the same queue as
          # its siblings: allocation fops beside truncate, put/
          # copy_file_range beside writev, removexattr beside
          # setxattr, icreate/namelink beside mknod — graft-lint GL01
          # caught all nine silently falling to the slow queue, which
          # would invert them vs sibling writes of the SAME workload
          Fop.FALLOCATE, Fop.DISCARD, Fop.ZEROFILL, Fop.PUT,
          Fop.COPY_FILE_RANGE, Fop.REMOVEXATTR, Fop.FREMOVEXATTR,
          Fop.ICREATE, Fop.NAMELINK,
          # parity-delta applies are data-path write work: the slow
          # queue would invert them vs the sibling data writevs of
          # the SAME delta wave
          Fop.XORV,
          # fused chains are data-path work (create+writev+flush);
          # the slow queue would invert their priority vs their links
          Fop.COMPOUND}
# everything else -> slow; readdirp/rchecksum explicitly least
LEAST = {Fop.READDIRP, Fop.RCHECKSUM}
# Lock fops are NEVER admission-gated: an inodelk can legitimately
# block until another client unlocks — if waiters held gate slots, the
# unlock that frees them could queue behind them and deadlock the brick
# (the reference parks lock waits off-thread in features/locks, without
# occupying an iot worker).
UNGATED = {Fop.INODELK, Fop.FINODELK, Fop.ENTRYLK, Fop.FENTRYLK, Fop.LK,
           Fop.GETACTIVELK, Fop.SETACTIVELK, Fop.LEASE}


def _prio(fop: Fop) -> int:
    if fop in FAST:
        return 0
    if fop in NORMAL:
        return 1
    if fop in LEAST:
        return 3
    return 2


class ResizableGate:
    """A counting gate whose limit can change live (asyncio.Semaphore
    cannot): shrink applies as holders release, grow re-admits parked
    waiters immediately — queued fops are never dropped either way
    (the live-reconfigure contract of performance.*-prio-threads)."""

    __slots__ = ("limit", "_active", "_waiters")

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._active = 0
        self._waiters: collections.deque = collections.deque()

    def resize(self, limit: int) -> None:
        self.limit = int(limit)
        self._kick()

    def _kick(self) -> None:
        while self._waiters and self._active < self.limit:
            fut = self._waiters.popleft()
            if not fut.done():
                self._active += 1
                fut.set_result(None)

    async def __aenter__(self):
        if self._active < self.limit and not self._waiters:
            self._active += 1
            return self
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        try:
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # granted and cancelled in the same tick: hand the
                # slot on, or it leaks forever
                self._active -= 1
                self._kick()
            else:
                try:
                    self._waiters.remove(fut)
                except ValueError:
                    pass
            raise
        return self

    async def __aexit__(self, *exc):
        self._active -= 1
        self._kick()


@register("performance/io-threads")
class IoThreadsLayer(Layer):
    OPTIONS = (
        Option("thread-count", "int", default=16, min=1, max=64),
        Option("high-prio-threads", "int", default=16, min=1, max=64),
        Option("normal-prio-threads", "int", default=16, min=1, max=64,
               description="concurrency of the normal queue "
                           "(performance.normal-prio-threads; the pool "
                           "itself stays thread-count wide)"),
        Option("low-prio-threads", "int", default=8, min=1, max=64),
        Option("least-prio-threads", "int", default=1, min=1, max=64),
        Option("enable-least-priority", "bool", default="on",
               description="off: least-priority fops (readdirp, "
                           "rchecksum scrub reads) ride the normal "
                           "queue instead of the starvable one "
                           "(performance.enable-least-priority)"),
    )

    _GATE_KEYS = ("high-prio-threads", "normal-prio-threads",
                  "low-prio-threads", "least-prio-threads")

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._gates = [ResizableGate(self.opts[k])
                       for k in self._GATE_KEYS]
        self.queued = [0, 0, 0, 0]
        self.executed = [0, 0, 0, 0]
        # achieved parallelism (the "real parallel dispatch" proof
        # counters): fops currently inside the gates, and the high
        # watermark since init
        self.inflight = 0
        self.peak_inflight = 0
        # abandoned work shed at admission (deadline propagation)
        self.deadline_dropped = 0
        self._pool: ThreadPoolExecutor | None = None
        self._pool_width = 0
        _LIVE_IOT_LAYERS.add(self)

    async def init(self):
        self._pool_width = self.opts["thread-count"]
        self._pool = ThreadPoolExecutor(
            max_workers=self._pool_width,
            thread_name_prefix=f"{self.name}-iot")
        # hand the worker pool to every storage/posix below us (the
        # reference's iot_worker continues the wind in a worker thread;
        # here the leaf offloads its blocking sections instead)
        self._set_executors(self._pool)
        await super().init()

    async def fini(self):
        self._set_executors(None)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        await super().fini()

    def reconfigure(self, options: dict) -> None:
        """Live pool geometry (performance.io-thread-count + the
        *-prio-threads gates): the executor is swapped — in-flight
        syscalls complete on the retiring pool, new ones land on the
        fresh one — and the gates resize in place, re-admitting parked
        waiters on growth.  Nothing queued is dropped."""
        super().reconfigure(options)
        for gate, key in zip(self._gates, self._GATE_KEYS):
            gate.resize(self.opts[key])
        want = self.opts["thread-count"]
        if self._pool is not None and want != self._pool_width:
            old = self._pool
            self._pool = ThreadPoolExecutor(
                max_workers=want, thread_name_prefix=f"{self.name}-iot")
            self._pool_width = want
            self._set_executors(self._pool)
            # retire without waiting: already-submitted syscalls run to
            # completion on the old pool's threads
            old.shutdown(wait=False)

    def _set_executors(self, pool) -> None:
        from ..core.layer import walk

        for layer in walk(self):
            hook = getattr(layer, "set_io_executor", None)
            if hook is not None:
                hook(pool)

    def dump_private(self) -> dict:
        return {"queued": list(self.queued),
                "executed": list(self.executed),
                "inflight": self.inflight,
                "peak_inflight": self.peak_inflight,
                "deadline_dropped": self.deadline_dropped,
                "pool_threads": self._pool_width or
                self.opts["thread-count"]}


def _gated(fop: Fop):
    pri = _prio(fop)
    name = fop.value

    async def fop_impl(self, *args, **kwargs):
        from ..rpc import wire as _wire

        p = pri
        if p != 3 and _wire.CURRENT_LANE.get() == "least":
            # per-client priority lane (features/qos): the server
            # demoted this request — a currently-shaped client or
            # rebalance-origin traffic rides the least-priority class
            # (io-threads' enable-least-priority model, applied per
            # REQUEST instead of per fop type)
            p = 3
        if p == 3 and not self.opts["enable-least-priority"]:
            p = 1  # least-priority disabled: ride the normal queue
        self.queued[p] += 1
        try:
            async with self._gates[p]:
                # abandoned-work shedding (network.deadline-propagation):
                # if the client's budget expired while this fop queued
                # behind the gate, drop it NOW — the reply would be
                # discarded by a caller that already raised ETIMEDOUT,
                # and the worker slot belongs to a live request
                dl = _wire.CURRENT_DEADLINE.get()
                if dl is not None and \
                        asyncio.get_running_loop().time() > dl:
                    self.deadline_dropped += 1
                    raise FopError(
                        errno.ETIMEDOUT,
                        f"{name} dropped at io-threads: client "
                        "deadline budget expired before dispatch")
                self.executed[p] += 1
                self.inflight += 1
                if self.inflight > self.peak_inflight:
                    self.peak_inflight = self.inflight
                try:
                    return await getattr(self.children[0],
                                         name)(*args, **kwargs)
                finally:
                    self.inflight -= 1
        finally:
            self.queued[p] -= 1
    fop_impl.__name__ = name
    return fop_impl


for _f in Fop:
    if _f not in UNGATED:
        setattr(IoThreadsLayer, _f.value, _gated(_f))
