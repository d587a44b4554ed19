"""features/upcall — server-side client registry + cache invalidation.

Reference: xlators/features/upcall/src/upcall.c:48-207
(upcall_client_cache_invalidate, add_upcall_client): the brick tracks
which clients recently touched each inode and, when another client
mutates it, calls back an invalidation that md-cache consumes — the
mechanism that keeps two clients on one volume metadata-coherent without
TTL waiting.

Here the layer sits in the brick stack.  The serving BrickServer injects
the current RPC peer identity through ``rpc.wire.CURRENT_CLIENT`` (a
ContextVar set per dispatch) and registers itself as the event sink; the
layer pushes ``MT_EVENT`` frames (rpc/wire.py:25) to every *other*
registered client within ``cache-invalidation-timeout`` of its last
access.  protocol/client surfaces the frames as ``Event.UPCALL`` graph
notifications; performance/md-cache invalidates on them.
"""

from __future__ import annotations

import time
from typing import Callable

from ..core.fops import Fop, FopError, WRITE_FOPS
from ..core.iatt import Iatt
from ..core.layer import FdObj, Layer, Loc, register
from ..core.options import Option
from ..core import gflog
from ..rpc.wire import CURRENT_CLIENT

log = gflog.get_logger("upcall")

# fops whose reply a client may cache -> register interest
#   (upcall.c upcall_local_init call sites)
_CACHE_FOPS = {Fop.LOOKUP, Fop.STAT, Fop.FSTAT, Fop.READV, Fop.GETXATTR,
               Fop.FGETXATTR, Fop.READDIR, Fop.READDIRP, Fop.OPEN,
               Fop.OPENDIR}


@register("features/upcall")
class UpcallLayer(Layer):
    OPTIONS = (
        Option("cache-invalidation", "bool", default="on"),
        Option("cache-invalidation-timeout", "time", default="60",
               description="forget a client's interest in an inode after "
                           "this idle time (features.cache-invalidation-"
                           "timeout)"),
    )

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # gfid -> {client identity -> last access time}
        self._reg: dict[bytes, dict[bytes, float]] = {}
        self._sink: Callable[[list[bytes], dict], None] | None = None
        self.sent = 0
        self._ops = 0  # amortized-sweep counter

    def set_upcall_sink(self, sink: Callable[[list[bytes], dict], None]):
        """BrickServer hands us its event-push callback at serve time."""
        self._sink = sink

    def release_client(self, identity: bytes) -> None:
        """Disconnect cleanup (client_t reap): drop all registrations."""
        for gfid in list(self._reg):
            regs = self._reg[gfid]
            regs.pop(identity, None)
            if not regs:
                del self._reg[gfid]

    # -- registry ----------------------------------------------------------

    def _touch(self, gfid: bytes, client: bytes) -> None:
        self._reg.setdefault(gfid, {})[client] = time.monotonic()
        # amortized registry sweep: read-only inodes are never visited
        # by _interested, so without this the registry would grow
        # without bound on a long-lived brick
        self._ops += 1
        if self._ops % 4096 == 0:
            self._sweep()

    def _sweep(self) -> None:
        horizon = time.monotonic() - self.opts["cache-invalidation-timeout"]
        for gfid in list(self._reg):
            regs = self._reg[gfid]
            for c in [c for c, t in regs.items() if t < horizon]:
                del regs[c]
            if not regs:
                del self._reg[gfid]

    def _interested(self, gfid: bytes, but_not: bytes | None) -> list[bytes]:
        regs = self._reg.get(gfid)
        if not regs:
            return []
        horizon = time.monotonic() - self.opts["cache-invalidation-timeout"]
        for c in [c for c, t in regs.items() if t < horizon]:
            del regs[c]
        if not regs:
            del self._reg[gfid]
            return []
        return [c for c in regs if c != but_not]

    def _notify_mutation(self, gfid: bytes, client: bytes | None,
                         fop: str) -> None:
        if self._sink is None or not self.opts["cache-invalidation"]:
            return
        targets = self._interested(gfid, client)
        if targets:
            self.sent += 1
            self._sink(targets, {"event": "cache-invalidation",
                                 "gfid": gfid, "fop": fop})

    @staticmethod
    def _gfids_of(args: tuple, ret) -> set[bytes]:
        out = set()
        for a in args:
            if isinstance(a, Loc) and a.gfid:
                out.add(a.gfid)
            elif isinstance(a, FdObj) and a.gfid:
                out.add(a.gfid)
        if isinstance(ret, Iatt) and ret.gfid:
            out.add(ret.gfid)
        elif isinstance(ret, tuple):
            for r in ret:
                if isinstance(r, Iatt) and r.gfid:
                    out.add(r.gfid)
        return out

    def dump_private(self) -> dict:
        return {"tracked_inodes": len(self._reg),
                "invalidations_sent": self.sent}


def _observing(op_name: str, mutates: bool):
    async def fop(self, *args, **kwargs):
        ret = await getattr(self.children[0], op_name)(*args, **kwargs)
        client = CURRENT_CLIENT.get(None)
        for gfid in self._gfids_of(args, ret):
            if mutates:
                self._notify_mutation(gfid, client, op_name)
            if client is not None:
                self._touch(gfid, client)
        return ret
    fop.__name__ = op_name
    return fop


for _f in _CACHE_FOPS:
    setattr(UpcallLayer, _f.value, _observing(_f.value, mutates=False))
for _f in WRITE_FOPS:
    setattr(UpcallLayer, _f.value, _observing(_f.value, mutates=True))


async def _upcall_rename(self, oldloc: Loc, newloc: Loc,
                         xdata: dict | None = None):
    """Rename needs more than the generic write wrapper: a REPLACED
    destination dies in the rename, but the args only carry the
    source's gfid — resolve the destination's current identity first
    (a local brick-graph lookup, no wire hop) so clients caching the
    victim get invalidated too (upcall.c does the same via the
    newloc inode)."""
    victim = None
    try:
        ia, _ = await self.children[0].lookup(
            Loc(newloc.path, parent=newloc.parent, name=newloc.name))
        victim = ia.gfid
    except FopError:
        pass  # fresh destination: nothing to invalidate
    ret = await self.children[0].rename(oldloc, newloc, xdata)
    client = CURRENT_CLIENT.get(None)
    gfids = self._gfids_of((oldloc, newloc), ret)
    if victim:
        gfids.add(victim)
    for gfid in gfids:
        self._notify_mutation(gfid, client, "rename")
        if client is not None:
            self._touch(gfid, client)
    return ret


UpcallLayer.rename = _upcall_rename
