"""features/locks — brick-side byte-range and internal locks.

Reference: xlators/features/locks (posix.c, inodelk.c, entrylk.c) with
named lock domains (common.h:61-82).  Three lock classes, same as the
reference:

* ``inodelk(domain, ...)`` — internal per-inode locks in named domains;
  the EC/AFR transaction engines serialize writers with these.
* ``entrylk(domain, loc, basename, ...)`` — internal per-dentry locks
  (directory-op serialization).
* ``lk(fd, ...)`` — POSIX advisory record locks for applications.

Locks are owner-keyed (``lk-owner`` in xdata, the frame lk_owner analog);
rd locks share, wr locks exclude, ranges conflict on overlap; blocking
requests queue FIFO on an asyncio future.
"""

from __future__ import annotations

import asyncio
import errno
import time as _time
from collections import defaultdict

from ..core.events import gf_event
from ..core.fops import FopError
from ..core.layer import FdObj, Layer, Loc, register
from ..core.options import Option
from ..core import metrics as _metrics

#: live locks layers, scraped by the unified registry (weak: retired
#: graphs age out with the GC).  The revocation counter and the wedge
#: gauges hang off one population.
_LIVE_LOCKS_LAYERS = _metrics.REGISTRY.register_objects(
    "gftpu_locks_revoked_total", "counter",
    "granted locks forcibly revoked, by trigger (age = holder older "
    "than features.locks-revocation-secs with waiters queued, "
    "max-blocked = blocked queue over features.locks-revocation-"
    "max-blocked, clear-locks = operator `volume clear-locks`)",
    lambda l: [({"layer": l.name, "reason": r}, v)
               for r, v in l.revoked_counts.items()])
_metrics.REGISTRY.register_objects(
    "gftpu_locks_blocked", "gauge",
    "lock requests currently parked in FIFO waiter queues, per table",
    lambda l: [({"layer": l.name, "kind": k}, v)
               for k, v in l._blocked_counts().items()],
    live=_LIVE_LOCKS_LAYERS)


class _Lock:
    __slots__ = ("owner", "ltype", "start", "end", "client",
                 "last_notify", "granted_at")

    def __init__(self, owner: bytes, ltype: str, start: int, end: int):
        self.owner = owner
        self.ltype = ltype  # "rd" | "wr"
        self.start = start
        self.end = end  # exclusive; -1 = EOF (whole rest)
        # grantee's RPC identity + last contention-upcall stamp (the
        # pl_inode_lock client_uid / contention_time analogs); client is
        # stamped at grant time by LocksLayer
        self.client: bytes | None = None
        self.last_notify = 0.0
        # monotonic grant stamp: the revocation monitor ages holders
        # from this (pl_inode_lock granted_time)
        self.granted_at = 0.0

    def overlaps(self, other: "_Lock") -> bool:
        a_end = self.end if self.end >= 0 else float("inf")
        b_end = other.end if other.end >= 0 else float("inf")
        return self.start < b_end and other.start < a_end

    def conflicts(self, other: "_Lock") -> bool:
        if self.owner == other.owner:
            return False
        if self.ltype == "rd" and other.ltype == "rd":
            return False
        return self.overlaps(other)

    def to_dict(self) -> dict:
        return {"owner": self.owner.hex(), "type": self.ltype,
                "start": self.start, "end": self.end}


class _LockDomain:
    """Granted locks + FIFO waiter queue for one (gfid, domain).
    Waiter entries are ``(req, fut, since)`` — the monotonic park stamp
    feeds the wedge view and the revocation monitor."""

    def __init__(self):
        self.granted: list[_Lock] = []
        self.waiters: list[tuple[_Lock, asyncio.Future, float]] = []

    def _grantable(self, req: _Lock) -> bool:
        return not any(g.conflicts(req) for g in self.granted)

    def _grant(self, req: _Lock) -> None:
        req.granted_at = _time.monotonic()
        self.granted.append(req)

    def try_lock(self, req: _Lock) -> bool:
        if self._grantable(req):
            self._grant(req)
            return True
        return False

    async def lock(self, req: _Lock) -> None:
        if self.try_lock(req):
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.waiters.append((req, fut, _time.monotonic()))
        await fut

    def unlock(self, owner: bytes, start: int, end: int) -> bool:
        for i, g in enumerate(self.granted):
            if g.owner == owner and g.start == start and g.end == end:
                del self.granted[i]
                self._wake()
                return True
        return False

    def release_owner(self, owner: bytes) -> int:
        n = len(self.granted)
        self.granted = [g for g in self.granted if g.owner != owner]
        if len(self.granted) != n:
            self._wake()
        return n - len(self.granted)

    def release_matching(self, pred) -> int:
        """Drop granted locks matching ``pred(lock)`` and evict matching
        waiters (their futures fail ENOTCONN so in-process callers
        unblock), then grant whoever became compatible."""
        n = len(self.granted)
        self.granted = [g for g in self.granted if not pred(g)]
        gone = n - len(self.granted)
        still = []
        for req, fut, since in self.waiters:
            if pred(req):
                if not fut.done():
                    fut.set_exception(FopError(
                        errno.ENOTCONN, "lock waiter's client went away"))
            else:
                still.append((req, fut, since))
        self.waiters = still
        if gone:
            self._wake()
        return gone

    def _wake(self) -> None:
        # grant queued requests in FIFO order while compatible
        still = []
        for req, fut, since in self.waiters:
            if not fut.cancelled() and self._grantable(req):
                self._grant(req)
                fut.set_result(None)
            elif not fut.cancelled():
                still.append((req, fut, since))
        self.waiters = still

    def oldest_holder_age(self) -> float:
        if not self.granted:
            return 0.0
        now = _time.monotonic()
        return max(now - g.granted_at for g in self.granted)

    def oldest_waiter_age(self) -> float:
        if not self.waiters:
            return 0.0
        now = _time.monotonic()
        return max(now - since for _r, _f, since in self.waiters)

    def empty(self) -> bool:
        return not self.granted and not self.waiters


@register("features/locks")
class LocksLayer(Layer):
    OPTIONS = (
        Option("trace", "bool", default="off"),
        Option("lock-timeout", "time", default="30",
               description="blocking lock wait limit (0 = forever)"),
        Option("notify-contention", "bool", default="on",
               description="push an upcall to the holder of a granted "
                           "inodelk when another request blocks on it "
                           "(inodelk_contention_notify, locks "
                           "common.c:1374-1455) — EC releases its eager "
                           "window on this event instead of sitting on "
                           "the lock for the full post-op delay"),
        Option("notify-contention-delay", "time", default="5",
               description="minimum seconds between contention upcalls "
                           "for one held lock (features.locks-notify-"
                           "contention-delay)"),
        Option("monkey-unlocking", "bool", default="off",
               description="TEST TOOL (pl monkey-unlocking): ~50% of "
                           "unlocks pretend success and leak the lock, "
                           "exercising stale-lock recovery paths"),
        Option("revocation-secs", "time", default="0",
               description="forced revocation of wedged holders "
                           "(features.locks-revocation-secs, reference "
                           "entrylk.c:129-173 + the inodelk twin): "
                           "while requests queue behind a granted lock "
                           "older than this, the monitor revokes the "
                           "domain's holders, drains the FIFO waiter "
                           "queue, and the revoked owner's next lock "
                           "fop gets EAGAIN with a 'lock-revoked' "
                           "notice in the error xdata.  0 = never "
                           "revoke (the reference default)"),
        Option("revocation-clear-all", "bool", default="off",
               description="on revocation also CLEAR the blocked queue "
                           "(features.locks-revocation-clear-all): "
                           "waiters fail EAGAIN instead of being "
                           "granted — the domain starts from empty"),
        Option("revocation-max-blocked", "int", default=0, min=0,
               description="revoke a domain's holders as soon as its "
                           "blocked queue exceeds this many waiters, "
                           "regardless of holder age (features.locks-"
                           "revocation-max-blocked); 0 = no queue "
                           "trigger"),
        Option("mandatory-locking", "enum", default="off",
               values=("off", "forced"),
               description="forced: data fops conflicting with another "
                           "owner's posix lock fail EAGAIN instead of "
                           "proceeding (locks.mandatory-locking, "
                           "pl_track_io semantics)"),
    )

    def _mandatory_check(self, gfid: bytes, xdata: dict | None,
                         start: int, end: int, write: bool) -> None:
        if self.opts["mandatory-locking"] != "forced":
            return
        dom = self._posixlk.get(gfid)
        if dom is None:
            return
        from ..rpc.wire import CURRENT_CLIENT

        owner = (xdata or {}).get("lk-owner")
        me = CURRENT_CLIENT.get()
        probe = _Lock(owner or b"", "wr" if write else "rd", start, end)
        for g in dom.granted:
            if not g.overlaps(probe):
                continue
            if not write and g.ltype == "rd":
                continue
            # the HOLDER's own I/O must pass: match by lk-owner when
            # the fop carries one, else by the requesting client
            # identity (data fops usually carry no owner)
            if owner is not None and g.owner == owner:
                continue
            if owner is None and g.client == me:
                continue
            raise FopError(errno.EAGAIN,
                           "mandatory lock held by another owner")

    async def readv(self, fd: FdObj, size: int, offset: int,
                    xdata: dict | None = None):
        self._mandatory_check(fd.gfid, xdata, offset,
                              offset + size, False)
        return await self.children[0].readv(fd, size, offset, xdata)

    async def writev(self, fd: FdObj, data, offset: int,
                     xdata: dict | None = None):
        self._mandatory_check(fd.gfid, xdata, offset,
                              offset + len(data), True)
        return await self.children[0].writev(fd, data, offset, xdata)

    async def xorv(self, fd: FdObj, data, offset: int,
                   xdata: dict | None = None):
        # the parity-delta apply is a write: mandatory locking must
        # fence it exactly like writev (same byte range)
        self._mandatory_check(fd.gfid, xdata, offset,
                              offset + len(data), True)
        return await self.children[0].xorv(fd, data, offset, xdata)

    # -- the rest of the content-mutating vocabulary (graft-lint GL01
    # fence parity: xorv above was itself an after-the-fact fence;
    # these siblings mutate byte ranges the same way) ----------------------

    _EOF = 1 << 62  # "to end of file" range bound (F_WRLCK l_len=0)

    async def truncate(self, loc, size: int, xdata: dict | None = None):
        # every byte from the new size to EOF changes (both directions)
        self._mandatory_check(loc.gfid, xdata, size, self._EOF, True)
        return await self.children[0].truncate(loc, size, xdata)

    async def ftruncate(self, fd: FdObj, size: int,
                        xdata: dict | None = None):
        self._mandatory_check(fd.gfid, xdata, size, self._EOF, True)
        return await self.children[0].ftruncate(fd, size, xdata)

    async def fallocate(self, fd: FdObj, mode: int, offset: int,
                        length: int, xdata: dict | None = None):
        self._mandatory_check(fd.gfid, xdata, offset, offset + length,
                              True)
        return await self.children[0].fallocate(fd, mode, offset,
                                                length, xdata)

    async def discard(self, fd: FdObj, offset: int, length: int,
                      xdata: dict | None = None):
        self._mandatory_check(fd.gfid, xdata, offset, offset + length,
                              True)
        return await self.children[0].discard(fd, offset, length, xdata)

    async def zerofill(self, fd: FdObj, offset: int, length: int,
                       xdata: dict | None = None):
        self._mandatory_check(fd.gfid, xdata, offset, offset + length,
                              True)
        return await self.children[0].zerofill(fd, offset, length,
                                               xdata)

    async def put(self, loc, data, *args, **kwargs):
        # whole-object body write (posix serves it as create+writev
        # BELOW this layer — the range check must happen here)
        self._mandatory_check(loc.gfid, kwargs.get("xdata"), 0,
                              self._EOF, True)
        return await self.children[0].put(loc, data, *args, **kwargs)

    async def copy_file_range(self, fd_in: FdObj, off_in: int,
                              fd_out: FdObj, off_out: int, length: int,
                              xdata: dict | None = None):
        # source half is a read, destination half a write — both fence
        self._mandatory_check(fd_in.gfid, xdata, off_in,
                              off_in + length, False)
        self._mandatory_check(fd_out.gfid, xdata, off_out,
                              off_out + length, True)
        return await self.children[0].copy_file_range(
            fd_in, off_in, fd_out, off_out, length, xdata)

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # (gfid, domain) -> _LockDomain for inodelks;
        # (gfid, domain, basename) for entrylks; gfid for posix lk
        self._inodelk: dict[tuple, _LockDomain] = defaultdict(_LockDomain)
        self._entrylk: dict[tuple, _LockDomain] = defaultdict(_LockDomain)
        self._posixlk: dict[bytes, _LockDomain] = defaultdict(_LockDomain)
        self._sink = None  # BrickServer's event-push callback
        self.contention_sent = 0
        # revocation plane (features.locks-revocation-*): per-trigger
        # revoked-lock counts (the gftpu_locks_revoked_total family)
        # and the pending owner notices — a revoked owner's NEXT lock
        # fop gets EAGAIN with the notice in the error xdata
        self.revoked_counts: dict[str, int] = {}
        self._revocation_notices: dict[bytes, dict] = {}
        self._monitor_task: asyncio.Task | None = None
        _LIVE_LOCKS_LAYERS.add(self)

    async def init(self):
        await super().init()
        # revocation monitor: age-triggered revocation must fire while
        # every party is parked (no new request would ever re-check), so
        # a ticker owns the deadline.  Started unconditionally — the
        # options are read per-tick so `volume set` arms it live
        self._monitor_task = asyncio.create_task(self._revocation_loop())

    async def fini(self):
        if self._monitor_task is not None:
            self._monitor_task.cancel()
            try:
                await self._monitor_task
            except (asyncio.CancelledError, Exception):
                pass
            self._monitor_task = None
        await super().fini()

    def set_upcall_sink(self, sink) -> None:
        self._sink = sink

    def _contend(self, gfid: bytes, domain: str, dom: _LockDomain,
                 req: _Lock) -> None:
        """A request just blocked: tell the holders (rate-limited per
        lock) so an eager-lock client can flush and release early."""
        if self._sink is None or not self.opts["notify-contention"]:
            return
        import time as _time

        now = _time.monotonic()
        delay = self.opts["notify-contention-delay"]
        targets = set()
        for g in dom.granted:
            if g.conflicts(req) and g.client is not None and \
                    now - g.last_notify >= delay:
                g.last_notify = now
                targets.add(g.client)
        if targets:
            self.contention_sent += 1
            self._sink(sorted(targets),
                       {"event": "inodelk-contention", "gfid": gfid,
                        "domain": domain})

    def contend_held_locks(self) -> int:
        """Fire a contention upcall at every held inodelk (snapshot
        quiesce: the barrier wants clients to commit + release their
        eager windows NOW rather than on the post-op-delay timer)."""
        if self._sink is None:
            return 0
        n = 0
        for (gfid, domain), dom in list(self._inodelk.items()):
            targets = {g.client for g in dom.granted
                       if g.client is not None}
            for t in sorted(targets):
                self._sink([t], {"event": "inodelk-contention",
                                 "gfid": gfid, "domain": domain})
                n += 1
        self.contention_sent += n
        return n

    def inodelk_holders(self, gfid: bytes,
                        but_not: bytes | None = None) -> set[bytes]:
        """Clients (other than ``but_not``) holding an inodelk on the
        gfid in ANY domain — the leases layer's grant path asks this to
        find open eager windows worth settling."""
        holders: set[bytes] = set()
        for (g, _domain), dom in self._inodelk.items():
            if g != gfid:
                continue
            holders.update(x.client for x in dom.granted
                           if x.client is not None
                           and x.client != but_not)
        return holders

    def contend_gfid(self, gfid: bytes,
                     but_not: bytes | None = None) -> int:
        """Fire a contention upcall at every inodelk holder on one gfid
        (a lease grant is a reader's registered interest: the holder's
        eager window should commit its delayed post-op NOW).  Same
        rate limit as _contend so a grant storm cannot flood a holder."""
        if self._sink is None:
            return 0
        import time as _time

        now = _time.monotonic()
        delay = self.opts["notify-contention-delay"]
        n = 0
        for (g, domain), dom in list(self._inodelk.items()):
            if g != gfid:
                continue
            targets = set()
            for x in dom.granted:
                if x.client is not None and x.client != but_not and \
                        now - x.last_notify >= delay:
                    x.last_notify = now
                    targets.add(x.client)
            for t in sorted(targets):
                self._sink([t], {"event": "inodelk-contention",
                                 "gfid": gfid, "domain": domain})
                n += 1
        self.contention_sent += n
        return n

    # -- forced revocation (features.locks-revocation-*; the reference's
    # entrylk.c:129-173 revocation machinery + the inodelk twin) ----------

    _TABLE_KINDS = ("inodelk", "entrylk", "posix")

    def _tables(self):
        return zip(self._TABLE_KINDS,
                   (self._inodelk, self._entrylk, self._posixlk))

    def _blocked_counts(self) -> dict[str, int]:
        return {kind: sum(len(d.waiters) for d in table.values())
                for kind, table in self._tables()}

    @staticmethod
    def _describe_key(kind: str, key) -> dict:
        if kind == "inodelk":
            return {"gfid": key[0].hex(), "domain": key[1]}
        if kind == "entrylk":
            return {"gfid": key[0].hex(), "domain": key[1],
                    "basename": key[2]}
        return {"gfid": key.hex() if isinstance(key, bytes) else str(key)}

    def _note_revoked(self, kind: str, key, lock: _Lock,
                      reason: str) -> None:
        """Remember the revocation for the owner's next lock fop (the
        EAGAIN + xdata notice).  Bounded FIFO: a dead owner that never
        returns must not pin entries forever."""
        note = {"reason": reason, "kind": kind, "ltype": lock.ltype,
                "start": lock.start, "end": lock.end,
                "held_secs": round(_time.monotonic() - lock.granted_at, 3),
                **self._describe_key(kind, key)}
        self._revocation_notices[lock.owner] = note
        while len(self._revocation_notices) > 512:
            self._revocation_notices.pop(
                next(iter(self._revocation_notices)))

    def _revoke_domain(self, kind: str, key, dom: _LockDomain,
                       reason: str, what: str = "all") -> int:
        """Revoke one domain: drop its granted locks (``what`` in
        granted/all), optionally flush its blocked queue (clear-all or
        ``what`` in blocked/all for the operator path), then drain the
        FIFO waiter queue through the usual grant path.  Returns how
        many locks were cleared (granted + flushed waiters)."""
        cleared = 0
        if what in ("granted", "all") and dom.granted:
            for g in dom.granted:
                self._note_revoked(kind, key, g, reason)
            cleared += len(dom.granted)
            dom.granted.clear()
        flush_blocked = what in ("blocked", "all") or \
            (reason != "clear-locks" and self.opts["revocation-clear-all"])
        if flush_blocked and dom.waiters:
            for _req, fut, _since in dom.waiters:
                if not fut.done():
                    fut.set_exception(FopError(
                        errno.EAGAIN, "blocked lock cleared by "
                                      "revocation",
                        xdata={"lock-revoked": {
                            "reason": reason, "kind": kind,
                            **self._describe_key(kind, key)}}))
            cleared += len(dom.waiters)
            dom.waiters.clear()
        # grant whoever is compatible now (the queue DRAIN the
        # revocation exists for)
        dom._wake()
        if cleared:
            self.revoked_counts[reason] = \
                self.revoked_counts.get(reason, 0) + cleared
            gf_event("LOCK_REVOKED", layer=self.name, kind=kind,
                     reason=reason, cleared=cleared,
                     waiters=len(dom.waiters),
                     **self._describe_key(kind, key))
        return cleared

    def _maybe_revoke(self, kind: str, key, dom: _LockDomain) -> None:
        """Apply the two automatic triggers to one domain.  Called from
        the monitor tick and at waiter-park time (the max-blocked
        trigger must fire on the block that crosses the line, not a
        second later)."""
        if not dom.waiters or not dom.granted:
            return
        maxb = int(self.opts["revocation-max-blocked"] or 0)
        if maxb and len(dom.waiters) > maxb:
            self._revoke_domain(kind, key, dom, "max-blocked", "granted")
            return
        secs = float(self.opts["revocation-secs"] or 0)
        if secs and dom.oldest_holder_age() >= secs:
            self._revoke_domain(kind, key, dom, "age", "granted")

    async def _revocation_loop(self) -> None:
        """The revocation monitor: scans domains carrying waiters on a
        tick scaled to the configured deadline (options re-read per
        tick, so ``volume set`` arms/disarms live)."""
        try:
            while True:
                secs = float(self.opts["revocation-secs"] or 0)
                tick = max(0.05, min(1.0, secs / 4)) if secs else 1.0
                await asyncio.sleep(tick)
                if not secs and not self.opts["revocation-max-blocked"]:
                    continue
                for kind, table in self._tables():
                    for key, dom in list(table.items()):
                        self._maybe_revoke(kind, key, dom)
                        if dom.empty():
                            table.pop(key, None)
        except asyncio.CancelledError:
            pass

    def _ensure_monitor(self) -> None:
        """(Re)start the monitor on the CURRENT loop: test harnesses
        activate graphs on one short-lived loop and run fops on another,
        which strands the init-time task on a dead loop."""
        t = self._monitor_task
        try:
            if t is not None and not t.done() and \
                    t.get_loop() is asyncio.get_running_loop():
                return
        except RuntimeError:
            return  # no running loop: nothing to park on either
        self._monitor_task = asyncio.create_task(self._revocation_loop())

    async def clear_locks(self, path: str, kind: str = "all",
                          xdata: dict | None = None) -> dict:
        """Operator-forced clearing (`volume clear-locks`, the
        reference's clear-locks command riding the same machinery):
        ``kind`` in blocked/granted/all; clears every lock table's
        domains for the path's gfid and drains the queues."""
        if kind not in ("blocked", "granted", "all"):
            raise FopError(errno.EINVAL,
                           f"clear-locks kind {kind!r} not one of "
                           "blocked/granted/all")
        gfid = await self._gfid_for(Loc(path))
        out = {"path": path, "kind": kind, "cleared": {}, "total": 0}
        for tkind, table in self._tables():
            n = 0
            for key, dom in list(table.items()):
                kg = key[0] if isinstance(key, tuple) else key
                if kg != gfid:
                    continue
                n += self._revoke_domain(tkind, key, dom,
                                         "clear-locks", kind)
                if dom.empty():
                    table.pop(key, None)
            if n:
                out["cleared"][tkind] = n
                out["total"] += n
        return out

    def _consume_notice(self, owner: bytes) -> None:
        """EAGAIN + notice for a revoked owner's next lock fop: the
        holder learns its lock is gone the moment it comes back for
        one (pairs with client.strict-locks, which already fails the
        lock-protected I/O path on handle loss)."""
        note = self._revocation_notices.pop(owner, None)
        if note is not None:
            raise FopError(errno.EAGAIN,
                           "lock revoked (features.locks-revocation)",
                           xdata={"lock-revoked": note})

    # -- helpers -----------------------------------------------------------

    async def _gfid_for(self, loc: Loc) -> bytes:
        if loc.gfid:
            return loc.gfid
        ia, _ = await self.children[0].lookup(loc)
        return ia.gfid

    @staticmethod
    def _owner(xdata: dict | None) -> bytes:
        return (xdata or {}).get("lk-owner", b"\0anon")

    async def _do(self, table: dict, key, cmd: str, req: _Lock):
        dom = table[key]
        if cmd == "unlock":
            if self.opts["monkey-unlocking"]:
                import random as _random

                if _random.random() < 0.5:
                    log_monkey = getattr(self, "monkey_dropped", 0) + 1
                    self.monkey_dropped = log_monkey
                    return {}  # lock leaks on purpose (test tool)
            if not dom.unlock(req.owner, req.start, req.end):
                raise FopError(errno.EINVAL, "no such lock")
            if dom.empty():
                table.pop(key, None)
            return {}
        from ..rpc.wire import CURRENT_CLIENT

        req.client = CURRENT_CLIENT.get()
        kind = next(k for k, t in self._tables() if t is table)
        # a revoked owner's next lock fop carries the notice (EAGAIN)
        self._consume_notice(req.owner)
        if cmd == "lock-nb":
            if not dom.try_lock(req):
                if table is self._inodelk:
                    self._contend(key[0], key[1], dom, req)
                raise FopError(errno.EAGAIN, "would block")
            return {}
        if cmd == "lock":
            timeout = self.opts["lock-timeout"]
            if not dom.try_lock(req):
                # blocked: nudge the holders before we park
                # (inodelk_contention_notify)
                if table is self._inodelk:
                    self._contend(key[0], key[1], dom, req)
                fut = asyncio.get_running_loop().create_future()
                dom.waiters.append((req, fut, _time.monotonic()))
                # the park that crosses revocation-max-blocked (or meets
                # an already-aged holder) fires the revocation NOW; the
                # monitor covers deadlines that pass while parked
                self._ensure_monitor()
                self._maybe_revoke(kind, key, dom)
                try:
                    await asyncio.wait_for(fut, timeout or None)
                except asyncio.TimeoutError:
                    # drop our (cancelled) waiter entry: the wedge
                    # gauges and max-blocked trigger must not count it
                    dom.waiters = [w for w in dom.waiters
                                   if w[1] is not fut]
                    raise FopError(errno.ETIMEDOUT,
                                   "lock wait timed out") from None
            return {}
        raise FopError(errno.EINVAL, f"bad lock cmd {cmd!r}")

    # -- fops --------------------------------------------------------------

    async def inodelk(self, domain: str, loc: Loc, cmd: str,
                      ltype: str = "wr", start: int = 0, end: int = -1,
                      xdata: dict | None = None):
        gfid = await self._gfid_for(loc)
        ret = await self._do(self._inodelk, (gfid, domain), cmd,
                             _Lock(self._owner(xdata), ltype, start, end))
        if cmd in ("lock", "lock-nb") and (xdata or {}).get("get-xattrs"):
            # lock-and-fetch: return the inode's xattrs with the grant,
            # saving the caller a separate metadata round trip (the
            # xdata-piggyback idiom the reference uses on lookups).
            # None on failure — callers must never mistake a failed
            # fetch for an inode with no xattrs
            try:
                return await self.children[0].getxattr(loc, None)
            except FopError:
                return None
        return ret

    async def finodelk(self, domain: str, fd: FdObj, cmd: str,
                       ltype: str = "wr", start: int = 0, end: int = -1,
                       xdata: dict | None = None):
        return await self._do(self._inodelk, (fd.gfid, domain), cmd,
                              _Lock(self._owner(xdata), ltype, start, end))

    async def create(self, loc: Loc, flags: int = 0, mode: int = 0o644,
                     xdata: dict | None = None):
        """Compound lock-on-create: a ``lock-inodelk`` payload takes the
        caller's transaction lock right after the create commits — the
        mirror of xattrop's compound unlock, saving EC's eager window
        its opening lock wave on the create-first write path.  Callers
        only attach it to O_EXCL creates: the file (and its fresh gfid)
        is born with this fop, so the non-blocking grant cannot
        conflict with anyone."""
        grant = (xdata or {}).get("lock-inodelk")
        if grant:
            xdata = {k: v for k, v in xdata.items()
                     if k != "lock-inodelk"}
        ret = await self.children[0].create(loc, flags, mode, xdata)
        if grant:
            domain, ltype, start, end, owner = grant
            fd = ret[0] if isinstance(ret, tuple) else ret
            await self._do(self._inodelk, (fd.gfid, domain), "lock-nb",
                           _Lock(owner, ltype, start, end))
        return ret

    async def xattrop(self, loc: Loc, op: str, xattrs: dict,
                      xdata: dict | None = None):
        """Compound post-op: an ``unlock-inodelk`` payload releases the
        caller's transaction lock right after the xattrop commits —
        clients fold the window-close unlock wave into the post-op wave
        (ordering preserved: counters land, then the lock drops)."""
        unlock = (xdata or {}).get("unlock-inodelk")
        if unlock:
            xdata = {k: v for k, v in xdata.items()
                     if k != "unlock-inodelk"}
        out = await self.children[0].xattrop(loc, op, xattrs, xdata)
        if unlock:
            domain, ltype, start, end, owner = unlock
            try:
                await self.inodelk(domain, loc, "unlock", ltype,
                                   start, end, {"lk-owner": owner})
            except FopError:
                pass  # already gone (restarted brick): nothing to drop
        return out

    async def entrylk(self, domain: str, loc: Loc, basename: str,
                      cmd: str, ltype: str = "wr",
                      xdata: dict | None = None):
        gfid = await self._gfid_for(loc)
        return await self._do(self._entrylk, (gfid, domain, basename), cmd,
                              _Lock(self._owner(xdata), ltype, 0, -1))

    async def fentrylk(self, domain: str, fd: FdObj, basename: str,
                       cmd: str, ltype: str = "wr",
                       xdata: dict | None = None):
        return await self._do(self._entrylk, (fd.gfid, domain, basename),
                              cmd, _Lock(self._owner(xdata), ltype, 0, -1))

    async def lk(self, fd: FdObj, cmd: str, flock: dict,
                 xdata: dict | None = None):
        """POSIX record locks: flock = {type: rd|wr|unlck, start, len}."""
        owner = self._owner(xdata)
        start = flock.get("start", 0)
        length = flock.get("len", 0)
        end = -1 if length == 0 else start + length
        ltype = flock.get("type", "wr")
        dom = self._posixlk[fd.gfid]
        if cmd == "getlk":
            probe = _Lock(owner, ltype, start, end)
            for g in dom.granted:
                if g.conflicts(probe):
                    return {"type": g.ltype, "start": g.start,
                            "end": g.end, "owner": g.owner.hex()}
            return {"type": "unlck"}
        if ltype == "unlck":
            dom.release_owner(owner)
            if dom.empty():
                self._posixlk.pop(fd.gfid, None)
            return {}
        mapped = {"setlk": "lock-nb", "setlkw": "lock"}.get(cmd)
        if mapped is None:
            raise FopError(errno.EINVAL, f"bad lk cmd {cmd!r}")
        return await self._do(self._posixlk, fd.gfid, mapped,
                              _Lock(owner, ltype, start, end))

    async def getactivelk(self, loc: Loc, xdata: dict | None = None):
        gfid = await self._gfid_for(loc)
        out = []
        for (g, dom_name), dom in self._inodelk.items():
            if g == gfid:
                out.extend({**lk.to_dict(), "domain": dom_name}
                           for lk in dom.granted)
        return out

    def release_client(self, owner: bytes) -> int:
        """Drop every lock held by a disconnected client (the reference
        cleans locks on client disconnect via client_t) and drain the
        freed queues WITHOUT waiting for revocation-secs.

        ``owner`` is either a bare lk-owner (in-process callers) or a
        connection identity: the wire scopes owners to
        ``identity + b"/" + lk-owner`` (protocol/server._scope_owner),
        so match the exact owner, the scoped prefix, AND the grant-time
        client identity — an identity-only match is what reaps wire
        clients' locks at all.  The dead client's own parked waiters
        are evicted too (nobody will ever collect their grant)."""
        prefix = owner + b"/"

        def dead(lk: _Lock) -> bool:
            return lk.owner == owner or lk.owner.startswith(prefix) or \
                lk.client == owner

        n = 0
        for _kind, table in self._tables():
            for key in list(table):
                n += table[key].release_matching(dead)
                if table[key].empty():
                    table.pop(key, None)
        # pending revocation notices die with the client
        for o in [o for o in self._revocation_notices
                  if o == owner or o.startswith(prefix)]:
            self._revocation_notices.pop(o, None)
        return n

    def lock_status(self) -> dict:
        """The wedge view (`volume status callpool` + dump_private):
        per-domain blocked-waiter counts and oldest-holder age, so an
        operator can SEE a wedge before revocation fires."""
        domains = []
        for kind, table in self._tables():
            for key, dom in table.items():
                if not dom.waiters and not dom.granted:
                    continue
                row = {"kind": kind, "granted": len(dom.granted),
                       "blocked": len(dom.waiters),
                       "oldest_holder_secs":
                           round(dom.oldest_holder_age(), 3),
                       "oldest_waiter_secs":
                           round(dom.oldest_waiter_age(), 3),
                       **self._describe_key(kind, key)}
                domains.append(row)
        # wedges first: most-blocked, then oldest holder
        domains.sort(key=lambda r: (-r["blocked"],
                                    -r["oldest_holder_secs"]))
        return {"blocked": self._blocked_counts(),
                "revoked": dict(self.revoked_counts),
                "domains": domains[:64]}

    def dump_private(self) -> dict:
        return {
            "inodelk_domains": len(self._inodelk),
            "entrylk_domains": len(self._entrylk),
            "posixlk_inodes": len(self._posixlk),
            "granted": sum(len(d.granted) for d in self._inodelk.values()),
            "waiting": sum(len(d.waiters) for d in self._inodelk.values()),
            **self.lock_status(),
        }
