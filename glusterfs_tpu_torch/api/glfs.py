"""Embeddable client API — the libgfapi analog.

Reference: api/src/glfs.c (glfs_new/init/fini, glfs.c:835,1140) and the
132 ``glfs_*`` calls in glfs.h.  A :class:`Client` wraps an activated
layer graph and exposes file operations; :class:`SyncClient` is the
synchronous facade (the reference's SYNCOP/ucontext machinery,
syncop.c:263, becomes an event loop on a worker thread).

Path resolution walks components through ``lookup`` with an inode/dentry
cache (glfs-resolve.c analog).

The handle-based surface (``h_*``, reference api/src/glfs-handles.h:
glfs_h_lookupat/extract_handle/create_from_handle/open/...) is what
NFS-Ganesha-class consumers build on: a :class:`Handle` is a portable
16-byte gfid — extract it on one client, reconstruct it on another, and
address the object without any path.  Handle ops resolve gfid -> current
volume path through the bricks' gfid2path records, so they keep working
across renames.  See docs/gfapi_coverage.md for the symbol map.
"""

from __future__ import annotations

import asyncio
import errno
import os
import threading
from typing import Any

from ..core.fops import FopError
from ..core.graph import Graph
from ..core.iatt import Iatt, ROOT_GFID
from ..core.inode import InodeTable
from ..core.layer import Event, FdObj, Loc, walk

# one-shot whole-file read window (readv truncates at EOF); files larger
# than this continue in a loop.  Kept moderate: page-granular perf
# layers walk `size/page` bookkeeping loops per request
_READ_ALL = 64 << 20


def _norm(path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    out = os.path.normpath(path)
    return "/" if out in (".", "//") else out


def _split(path: str) -> tuple[str, str]:
    path = _norm(path)
    if path == "/":
        return "", "/"
    parent, name = path.rsplit("/", 1)
    return (parent or "/"), name


async def _drain_graph(graph: Graph, timeout: float = 10.0) -> None:
    """Wait until the graph's transports have no in-flight RPCs for a
    few consecutive ticks — multi-RPC fops mid-flight get scheduler
    turns to issue their next call before the graph is retired."""
    from ..protocol.client import ClientLayer

    clients = [l for l in graph.by_name.values()
               if isinstance(l, ClientLayer)]
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    streak = 0
    while loop.time() < deadline:
        if any(l._pending for l in clients):
            streak = 0
        else:
            streak += 1
            if streak >= 3:
                return
        await asyncio.sleep(0.05)


async def wait_connected(graph: Graph, timeout: float = 15.0) -> bool:
    """Poll until every protocol/client layer in the graph has finished
    its handshake (the reference blocks the mount until CHILD_UP reaches
    the top).  Returns whether all connected within the deadline."""
    from ..protocol.client import ClientLayer

    prot = [l for l in graph.by_name.values()
            if isinstance(l, ClientLayer)]
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if all(p.connected for p in prot):
            return True
        await asyncio.sleep(0.05)
    return all(p.connected for p in prot)


class Handle:
    """Opaque portable file handle (glfs-handles.h glfs_object analog):
    the 16-byte gfid.  Extract with :meth:`Client.h_extract`, rebuild
    anywhere with :meth:`Client.h_create_from_handle`."""

    __slots__ = ("gfid",)

    def __init__(self, gfid: bytes):
        self.gfid = bytes(gfid)

    def __eq__(self, other) -> bool:
        return isinstance(other, Handle) and self.gfid == other.gfid

    def __hash__(self) -> int:
        return hash(self.gfid)

    def __repr__(self) -> str:
        return f"Handle({self.gfid.hex()})"


class File:
    """An open file (glfs_fd_t analog)."""

    def __init__(self, client: "Client", fd: FdObj, path: str):
        self._client = client
        self.fd = fd
        self.path = path
        self.closed = False
        self._dirty = False  # any write/truncate since open

    async def read(self, size: int, offset: int = 0) -> bytes:
        data = await self._client.graph.top.readv(self.fd, size, offset)
        # glfs_read hands the caller plain bytes; a memoryview off the
        # wire blob lane must not escape the library boundary (it pins
        # its RPC frame and breaks bytes-only callers)
        return data if isinstance(data, bytes) else bytes(data)

    async def write(self, data: bytes, offset: int = 0) -> int:
        self._dirty = True
        await self._client.graph.top.writev(self.fd, bytes(data), offset)
        return len(data)

    async def fstat(self) -> Iatt:
        return await self._client.graph.top.fstat(self.fd)

    async def fsync(self, datasync: bool = False) -> None:
        await self._client.graph.top.fsync(self.fd, int(datasync))

    async def ftruncate(self, size: int) -> None:
        self._dirty = True
        await self._client.graph.top.ftruncate(self.fd, size)

    async def fgetxattr(self, name: str | None = None):
        return await self._client.graph.top.fgetxattr(self.fd, name)

    async def fsetxattr(self, xattrs: dict, flags: int = 0) -> None:
        await self._client.graph.top.fsetxattr(self.fd, xattrs, flags)

    async def fremovexattr(self, name: str) -> None:
        await self._client.graph.top.fremovexattr(self.fd, name)

    async def copy_range(self, dst: "File", size: int,
                         src_offset: int = 0, dst_offset: int = 0,
                         window: int = 1 << 20) -> int:
        """glfs_copy_file_range analog: windowed read+write composition
        (no dedicated fop; the reference's also degrades to this when
        the backend lacks the syscall)."""
        if dst.fd.gfid == self.fd.gfid and \
                src_offset < dst_offset + size and \
                dst_offset < src_offset + size:
            # copy_file_range(2): overlapping same-file ranges are
            # EINVAL — windowed copying would re-read its own writes
            raise FopError(errno.EINVAL,
                           "overlapping copy_range on one file")
        done = 0
        while done < size:
            chunk = await self.read(min(window, size - done),
                                    src_offset + done)
            if not chunk:
                break
            await dst.write(chunk, dst_offset + done)
            done += len(chunk)
        return done

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            if self._dirty:
                # flush reports write-back errors at close (POSIX);
                # a read-only fd has nothing to report and skips the
                # fan-out (EC release still drains any eager window)
                await self._client.graph.top.flush(self.fd)
            release = getattr(self._client.graph.top, "release", None)
            if release is not None:
                await release(self.fd)


class HeldLeases:
    """Client-held lease registry (the glfs_lease state, reference
    api/src/glfs-handleops.c glfs_h_lease + leases client tables).

    The perf caches (md-cache/quick-read/io-cache) and the gateway
    object cache key zero-round-trip mode off :meth:`held`: while a
    gfid is here, cached state is served with NO wire revalidation —
    the brick's recall contract is the coherence story.  ``drop`` fires
    its ``on_drop`` callbacks *synchronously*, so everything keyed on
    the lease is gone before the recall is acked back to the brick."""

    __slots__ = ("_m", "on_drop")

    def __init__(self):
        self._m: dict[bytes, tuple[str, str]] = {}  # gfid -> (id, type)
        self.on_drop: list = []  # callbacks fired as (gfid) on drop

    def grant(self, gfid: bytes, lease_id: str, ltype: str) -> None:
        self._m[bytes(gfid)] = (lease_id, ltype)

    def held(self, gfid) -> bool:
        return gfid is not None and bytes(gfid) in self._m

    def get(self, gfid) -> tuple[str, str] | None:
        return self._m.get(bytes(gfid))

    def drop(self, gfid) -> tuple[str, str] | None:
        out = self._m.pop(bytes(gfid), None)
        if out is not None:
            for cb in self.on_drop:
                cb(bytes(gfid))
        return out

    def clear(self) -> None:
        for gfid in list(self._m):
            self.drop(gfid)

    def __len__(self) -> int:
        return len(self._m)


class _UpcallSink:
    """Top-of-graph event tap — the glfs upcall consumer (reference
    api/src/glfs-handleops.c glfs_h_poll_upcall / the mount's
    invalidate callbacks).  A server-pushed cache-invalidation drops
    this client's cached dentry + inode identity so the NEXT resolve
    refetches.  Without it, a second front door on the same volume
    (the object gateway) deleting and recreating a path leaves this
    client resolving the dead gfid out of its itable forever — the
    layer caches (md-cache/io-cache) revalidate on upcall, but the
    api-level dentry cache must too.

    Lease recalls land here LAST: ``notify`` propagates bottom-up, so
    by the time the recall reaches this top-of-graph tap every layer
    cache below has already dropped the gfid's state.  Dropping the
    held-lease entry here and only then scheduling the release ack is
    what makes "drop cached state synchronously before the ack" true
    by construction, not by convention."""

    __slots__ = ("itable", "invalidations", "client")

    def __init__(self, itable: InodeTable, client=None):
        import weakref

        self.itable = itable
        self.invalidations = 0
        self.client = weakref.ref(client) if client is not None else None

    def notify(self, event, source=None, data=None) -> None:
        if event is Event.UPCALL and isinstance(data, dict) and \
                data.get("gfid"):
            self.invalidations += 1
            self.itable.invalidate(data["gfid"])
            client = self.client() if self.client is not None else None
            if client is not None:
                # api-consumer invalidation hooks (the glfs upcall
                # callback surface): the gateway's ETag memo rides
                # here — any out-of-band change to a gfid must dirty
                # derived validators, not just the data caches
                for cb in client.on_invalidate:
                    try:
                        cb(bytes(data["gfid"]))
                    except Exception:  # noqa: BLE001 - tap isolation
                        pass
            if data.get("event") == "lease-recall":
                client = self.client() if self.client is not None \
                    else None
                if client is not None:
                    client._lease_recalled(data["gfid"],
                                           data.get("lease-id", ""),
                                           data.get("reason", ""))
        elif event is Event.CHILD_DOWN and self.client is not None:
            # a dropped connection means the brick is reaping our
            # grants (release_client) and any recall it pushed was
            # lost with the socket — zero-RT mode MUST end locally too
            client = self.client()
            if client is not None and len(client.leases):
                client.leases.clear()


class Client:
    """Async client over an activated graph (glfs_t analog)."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self.itable = InodeTable()
        self.mounted = False
        self.watchers: list = []  # background tasks (volfile watcher)
        self.upcall_sink = _UpcallSink(self.itable, client=self)
        # held-lease registry + this client's lease identity (one id
        # per glfs_t, minted once — the brick keys revocation poisoning
        # on (client, lease-id), so reusing the id across files is
        # fine and across a revoke is caught)
        self.leases = HeldLeases()
        self.lease_id = os.urandom(16).hex()
        # tri-state capability memo: None = unprobed, False = the stack
        # answered ENOTSUP (leases off / old brick) — stop asking
        self._lease_ok: bool | None = None
        self.lease_recalls = 0
        self._lease_tasks: set = set()  # in-flight release acks
        # api-consumer upcall hooks: callbacks fired as (gfid) on every
        # server-pushed invalidation (gateway ETag memo, embedders)
        self.on_invalidate: list = []
        # QoS traffic attribution (features/qos): set BEFORE mount()
        # so the first handshake already carries it; "" = ordinary
        # client, "rebalance" rides the brick's paced lane
        self.traffic_origin = ""

    def _apply_origin(self, top) -> None:
        """Stamp the origin onto every wire layer of a graph (applied
        at mount and re-applied after a reload swap — reconnects then
        re-send it in each fresh handshake's creds)."""
        if not self.traffic_origin:
            return
        for layer in walk(top):
            if hasattr(layer, "traffic_origin"):
                layer.traffic_origin = self.traffic_origin

    def _wire_lease_registry(self, top) -> None:
        """Hand every lease-aware cache layer the held-lease registry
        (zero-RT freshness checks consult it)."""
        for layer in walk(top):
            hook = getattr(layer, "set_lease_registry", None)
            if hook is not None:
                hook(self.leases)

    async def mount(self) -> None:
        # origin stamping precedes activation: the FIRST handshake of
        # every wire layer must already carry the attribution (tagging
        # after connect would leave a race window of unattributed fops)
        self._apply_origin(self.graph.top)
        if not self.graph.active:
            await self.graph.activate()
        if self.upcall_sink not in self.graph.top.parents:
            self.graph.top.parents.append(self.upcall_sink)
        self._wire_lease_registry(self.graph.top)
        self.mounted = True

    async def unmount(self) -> None:
        # cancel AND await the watchers: a mid-flight reload() must
        # finish its cleanup before we fini the graph under it
        for t in self.watchers:
            t.cancel()
        for t in self.watchers:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self.watchers.clear()
        # local lease state dies with the mount — the bricks reap our
        # grants through release_client when the connections drop
        self.leases.clear()
        for t in list(self._lease_tasks):
            t.cancel()
        if self.upcall_sink in self.graph.top.parents:
            self.graph.top.parents.remove(self.upcall_sink)
        if self.graph.active:
            await self.graph.fini()
        self.mounted = False

    async def reload(self, volfile_text: str) -> str:
        """Apply a changed volfile to the live mount (the reference's
        volfile-modified handling, graph.c:980-1089): same topology ->
        per-layer reconfigure in place; topology change -> build and
        activate the new graph, swap it in, retire the old one.  Open
        fds keep working through the new graph: their per-layer contexts
        miss, so every layer falls back to gfid-addressed anonymous fds
        (the reference migrates fds onto the new graph for the same
        reason)."""
        if self.graph.apply_volfile(volfile_text):
            return "reconfigured"
        new = Graph.construct(volfile_text)
        self._apply_origin(new.top)
        await new.activate()
        try:
            await wait_connected(new)
            old, self.graph = self.graph, new
            # the upcall tap follows the live graph (same reason fds
            # migrate: invalidations must keep landing after the swap)
            if self.upcall_sink in old.top.parents:
                old.top.parents.remove(self.upcall_sink)
            new.top.parents.append(self.upcall_sink)
            # leases were granted through the OLD graph's connections —
            # its bricks reap them at disconnect; the new stack starts
            # unleased and re-probes capability
            self.leases.clear()
            self._lease_ok = None
            self._wire_lease_registry(new.top)
        except BaseException:
            # cancelled/failed mid-swap: don't leak the half-built graph
            # (shielded — the fini must run even though we were cancelled)
            await asyncio.shield(new.fini())
            raise
        try:
            # fops that entered through the OLD graph must complete
            # before it is torn down — fini would unwind their in-flight
            # RPCs as spurious ENOTCONN (the reference drains old graphs
            # by refcount before cleanup, graph.c)
            await _drain_graph(old)
        finally:
            await asyncio.shield(old.fini())
        return "swapped"

    # -- resolution --------------------------------------------------------

    async def resolve(self, path: str) -> Loc:
        """Walk path components via lookup, populating the dentry cache."""
        path = _norm(path)
        parent_gfid = ROOT_GFID
        if path == "/":
            return Loc("/", gfid=ROOT_GFID, name="/")
        comps = path.lstrip("/").split("/")
        cur = ""
        gfid = ROOT_GFID
        for comp in comps:
            parent_gfid = gfid
            cur = f"{cur}/{comp}"
            ino = self.itable.find_dentry(parent_gfid, comp)
            if ino is not None:
                gfid = ino.gfid
                continue
            ia, _ = await self.graph.top.lookup(Loc(cur, parent=parent_gfid))
            self.itable.link(parent_gfid, comp, ia.gfid, ia.ia_type, ia)
            gfid = ia.gfid
        return Loc(path, gfid=gfid, parent=parent_gfid)

    async def _parent_loc(self, path: str) -> Loc:
        """Loc for a path that may not exist yet (parent must resolve)."""
        parent, name = _split(path)
        if not parent:
            raise FopError(errno.EINVAL, "cannot operate on /")
        ploc = await self.resolve(parent)
        return Loc(_norm(path), parent=ploc.gfid, name=name)

    # -- leases (glfs_lease analog) ----------------------------------------

    def _peers_lease_capable(self) -> bool:
        """Every protocol client in the stack advertised lease support
        at SETVOLUME (vacuously true for a wire-free local stack)."""
        from ..protocol.client import ClientLayer

        return all(l._peer_leases for l in walk(self.graph.top)
                   if isinstance(l, ClientLayer))

    async def lease_acquire(self, path: str, ltype: str = "rd") -> bool:
        """Take (or keep) a lease on *path*.  True means the caches may
        serve this gfid with zero wire fops until a recall drops it;
        False means the stack can't or won't grant (old brick, leases
        off, conflicting holder) and TTL revalidation stays the story.
        Never raises for "no lease" outcomes — callers treat the lease
        as a performance contract, not a lock."""
        loc = await self.resolve(path)
        gfid = bytes(loc.gfid)
        held = self.leases.get(gfid)
        if held is not None and (held[1] == ltype or held[1] == "rw"):
            return True
        if self._lease_ok is False:
            return False
        if not self._peers_lease_capable():
            self._lease_ok = False
            return False
        try:
            await self.graph.top.lease(loc, "grant", ltype,
                                       self.lease_id)
        except FopError as e:
            if e.err in (errno.ENOTSUP, errno.EOPNOTSUPP):
                self._lease_ok = False  # sticky: stop probing
            return False
        self._lease_ok = True
        self.leases.grant(gfid, self.lease_id, ltype)
        return True

    async def lease_release(self, path: str) -> None:
        """Voluntarily return the lease (and drop everything riding
        on it) — glfs_lease(UNLK)."""
        loc = await self.resolve(path)
        gfid = bytes(loc.gfid)
        held = self.leases.drop(gfid)
        if held is not None:
            await self.graph.top.lease(Loc(path, gfid=loc.gfid),
                                       "release", held[1], held[0])

    def _lease_recalled(self, gfid, lease_id: str,
                        reason: str = "") -> None:
        """Upcall-sink hook: the brick recalled (or expired) our
        lease.  The layer caches already dropped the gfid's state
        during the notify's bottom-up walk; drop the registry entry
        (ending zero-RT mode) and THEN ack by releasing — the brick's
        conflict gate unblocks only after nothing stale can be
        served."""
        gfid = bytes(gfid)
        held = self.leases.drop(gfid)
        if held is None:
            return
        self.lease_recalls += 1
        if reason == "expired":
            return  # the brick already dropped it; nothing to ack
        t = asyncio.ensure_future(
            self._lease_release_ack(gfid, held[1], held[0]))
        self._lease_tasks.add(t)
        t.add_done_callback(self._lease_tasks.discard)

    async def _lease_release_ack(self, gfid: bytes, ltype: str,
                                 lease_id: str) -> None:
        try:
            await self.graph.top.lease(Loc("", gfid=gfid), "release",
                                       ltype, lease_id)
        except Exception:
            pass  # the brick revokes on timeout; our state is gone

    # -- namespace ops -----------------------------------------------------

    async def stat(self, path: str) -> Iatt:
        loc = await self.resolve(path)
        return await self.graph.top.stat(loc)

    async def lookup(self, path: str) -> Iatt:
        loc = await self._parent_loc(path) if path != "/" else Loc("/")
        ia, _ = await self.graph.top.lookup(loc)
        return ia

    async def exists(self, path: str) -> bool:
        try:
            await self.resolve(path)
            return True
        except FopError as e:
            if e.err in (errno.ENOENT, errno.ESTALE):
                return False
            raise

    async def mkdir(self, path: str, mode: int = 0o755) -> Iatt:
        loc = await self._parent_loc(path)
        ia = await self.graph.top.mkdir(loc, mode)
        if hasattr(ia, "gfid"):
            # cache the fresh dentry like create does: the next resolve
            # under this directory must not pay a lookup round trip
            self.itable.link(loc.parent, loc.name, ia.gfid,
                             ia.ia_type, ia)
        return ia

    async def unlink(self, path: str) -> None:
        loc = await self.resolve(path)
        await self.graph.top.unlink(loc)
        self.itable.unlink(loc.parent, loc.name)

    async def rmdir(self, path: str) -> None:
        loc = await self.resolve(path)
        await self.graph.top.rmdir(loc)
        self.itable.unlink(loc.parent, loc.name)

    async def rename(self, old: str, new: str) -> None:
        oldloc = await self.resolve(old)
        newloc = await self._parent_loc(new)
        await self.graph.top.rename(oldloc, newloc)
        self.itable.unlink(oldloc.parent, oldloc.name)
        # a REPLACED destination's cached dentry now names the dead
        # gfid, and this client is the mutation's originator so no
        # upcall will correct it — drop it here
        self.itable.unlink(newloc.parent, newloc.name)

    async def symlink(self, target: str, path: str) -> Iatt:
        loc = await self._parent_loc(path)
        return await self.graph.top.symlink(target, loc)

    async def readlink(self, path: str) -> str:
        loc = await self.resolve(path)
        return await self.graph.top.readlink(loc)

    async def link(self, old: str, new: str) -> Iatt:
        oldloc = await self.resolve(old)
        newloc = await self._parent_loc(new)
        return await self.graph.top.link(oldloc, newloc)

    async def listdir(self, path: str = "/") -> list[str]:
        loc = await self.resolve(path)
        fd = await self.graph.top.opendir(loc)
        entries = await self.graph.top.readdir(fd, 0, 0)
        return [name for name, _ in entries]

    async def listdir_with_stat(self, path: str = "/"):
        loc = await self.resolve(path)
        fd = await self.graph.top.opendir(loc)
        return await self.graph.top.readdirp(fd, 0, 0)

    async def truncate(self, path: str, size: int) -> Iatt:
        loc = await self.resolve(path)
        return await self.graph.top.truncate(loc, size)

    async def statvfs(self, path: str = "/") -> dict:
        loc = await self.resolve(path)
        return await self.graph.top.statfs(loc)

    async def getxattr(self, path: str, name: str | None = None):
        loc = await self.resolve(path)
        return await self.graph.top.getxattr(loc, name)

    async def setxattr(self, path: str, xattrs: dict) -> None:
        loc = await self.resolve(path)
        await self.graph.top.setxattr(loc, xattrs)

    async def setattr(self, path: str, attrs: dict) -> Iatt:
        loc = await self.resolve(path)
        return await self.graph.top.setattr(loc, attrs)

    # -- file ops ------------------------------------------------------------

    def _use_compound(self) -> bool:
        """Is any layer of the mounted graph carrying
        ``compound-fops on``?  (volgen writes the key onto
        protocol/client and write-behind when
        cluster.use-compound-fops is set; re-checked per call so a
        live volume-set flips the fusers immediately.)"""
        from ..core.layer import walk

        for layer in walk(self.graph.top):
            v = layer.opts.get("compound-fops")
            if isinstance(v, str):
                v = v.strip().lower() in ("1", "on", "yes", "true",
                                          "enable", "enabled")
            if v:
                return True
        return False

    def _lazy_open_graph(self) -> bool:
        """Lazy open-behind makes plain open() ZERO round trips; the
        fused lookup+open (one round trip, real fd) would regress it."""
        from ..core.layer import walk

        for layer in walk(self.graph.top):
            if layer.type_name == "performance/open-behind" and \
                    layer.opts.get("lazy-open"):
                return True
        return False

    async def create(self, path: str, flags: int = os.O_RDWR,
                     mode: int = 0o644) -> File:
        loc = await self._parent_loc(path)
        fd, ia = await self.graph.top.create(loc, flags, mode)
        self.itable.link(loc.parent, loc.name, ia.gfid, ia.ia_type, ia)
        return File(self, fd, loc.path)

    async def open(self, path: str, flags: int = os.O_RDWR) -> File:
        if self._use_compound() and _norm(path) != "/" and \
                not self._lazy_open_graph():
            # lookup+open fused: the uncached leaf resolve and the open
            # ride one frame (two waves become one)
            loc = await self._parent_loc(path)
            replies = await self.graph.top.compound([
                ("lookup", (loc,), {}),
                ("open", (loc, flags), {})])
            from ..rpc import compound as cfop

            lk, fd = cfop.unwrap(replies)
            ia = lk[0] if isinstance(lk, (list, tuple)) else lk
            if hasattr(ia, "gfid"):
                self.itable.link(loc.parent, loc.name, ia.gfid,
                                 ia.ia_type, ia)
            return File(self, fd, loc.path)
        loc = await self.resolve(path)
        fd = await self.graph.top.open(loc, flags)
        return File(self, fd, loc.path)

    async def write_file(self, path: str, data: bytes) -> int:
        """Convenience: create/overwrite a file with data.

        Create-first (O_EXCL): the common fresh-file case pays no
        existence probe; an existing file falls back to the
        truncate+open overwrite path on EEXIST.

        With compound fops on, the fresh-file case is ONE chain —
        create+writev+flush+release fused into a single round trip
        where the graph carries it (the smallfile-create hot path)."""
        if self._use_compound():
            from ..rpc import compound as cfop

            loc = await self._parent_loc(path)
            replies = await self.graph.top.compound([
                ("create", (loc, os.O_RDWR | os.O_EXCL, 0o644), {}),
                ("writev", (cfop.FdRef(0), bytes(data), 0), {}),
                ("flush", (cfop.FdRef(0),), {}),
                ("release", (cfop.FdRef(0),), {})])
            err = cfop.first_error(replies)
            if err is None:
                created = replies[0][1]
                ia = created[1] if isinstance(created, (list, tuple)) \
                    and len(created) > 1 else None
                if hasattr(ia, "gfid"):
                    self.itable.link(loc.parent, loc.name, ia.gfid,
                                     ia.ia_type, ia)
                return len(data)
            if err.err != errno.EEXIST:
                raise err
            # existing file: straight to the truncate+open overwrite —
            # the chain already proved EEXIST, re-probing would waste
            # a round trip
            await self.truncate(path, 0)
            f = await self.open(path)
        else:
            try:
                f = await self.create(path, os.O_RDWR | os.O_EXCL)
            except FopError as e:
                if e.err != errno.EEXIST:
                    raise
                await self.truncate(path, 0)
                f = await self.open(path)
        try:
            return await f.write(data, 0)
        finally:
            await f.close()

    async def read_file(self, path: str, offset: int = 0,
                        size: int | None = None):
        """Whole-file read WITHOUT a leading stat wave: readv truncates
        at EOF (POSIX read semantics), so asking for a huge size in one
        call returns the file — the size probe's cluster-wide lookup
        fan-out was pure latency on every read.

        With compound fops on (and no lazy open-behind, whose open is
        already zero round trips), the whole pass is ONE chain —
        lookup+open+readv+release fused into a single round trip where
        the graph carries it (the smallfile-read hot path, the read
        mirror of write_file's create chain).

        Ranged form (``offset``/``size`` given, the glfs_pread window
        analog): the SAME single chain carries the window, and the
        return value is the RAW readv payload — an :class:`wire.SGBuf`
        of wire-frame/page-cache segment views, a memoryview, or bytes
        — NOT joined.  Callers that scatter the bytes onward (the HTTP
        gateway's ``writelines``, os.writev consumers) keep the
        zero-copy lane end to end; ``bytes(result)`` pays the one join
        where plain bytes are demanded.  The default whole-file call
        keeps returning owned ``bytes``."""
        ranged = offset != 0 or size is not None
        want = _READ_ALL if size is None else size
        if want <= 0:
            return b""
        if ranged and size is None:
            # open-ended tail (offset to EOF): loop _READ_ALL windows
            # so a >64MiB tail is never silently truncated, collecting
            # the raw windows into one unjoined segment vector
            from ..rpc.wire import SGBuf

            segs: list = []
            f = await self.open(path, os.O_RDONLY)
            try:
                pos = offset
                while True:
                    data = await self.graph.top.readv(f.fd, _READ_ALL,
                                                      pos)
                    n = len(data)
                    if n:
                        if isinstance(data, SGBuf):
                            segs.extend(data.segments)
                        else:
                            segs.append(data if isinstance(
                                data, memoryview) else memoryview(
                                    bytes(data)))
                    pos += n
                    if n < _READ_ALL:
                        break
            finally:
                await f.close()
            if not segs:
                return b""
            return segs[0] if len(segs) == 1 else SGBuf(segs)
        if self._use_compound() and _norm(path) != "/" and \
                not self._lazy_open_graph():
            from ..rpc import compound as cfop

            loc = await self._parent_loc(path)
            replies = await self.graph.top.compound([
                ("lookup", (loc,), {}),
                ("open", (loc, os.O_RDONLY), {}),
                ("readv", (cfop.FdRef(1), want, offset), {}),
                ("release", (cfop.FdRef(1),), {})])
            err = cfop.first_error(replies)
            if err is not None:
                raise err
            lk = replies[0][1]
            ia = lk[0] if isinstance(lk, (list, tuple)) else lk
            if hasattr(ia, "gfid"):
                self.itable.link(loc.parent, loc.name, ia.gfid,
                                 ia.ia_type, ia)
            data = replies[2][1]
            if ranged:
                return data  # raw window: segments stay unjoined
            out = data if isinstance(data, bytes) else bytes(data)
            if len(out) < _READ_ALL:
                return out
            # improbably huge file: keep the chain's window and read
            # on past it (re-reading from 0 would double the traffic)
            f = await self.open(path, os.O_RDONLY)
            try:
                parts = [out]
                while len(out) == _READ_ALL:
                    out = await f.read(_READ_ALL, sum(map(len, parts)))
                    parts.append(out)
                return b"".join(parts)
            finally:
                await f.close()
        f = await self.open(path, os.O_RDONLY)
        try:
            if ranged:
                # raw window through the graph top (File.read would
                # join to bytes — the ranged contract is segments)
                return await self.graph.top.readv(f.fd, want, offset)
            out = await f.read(_READ_ALL, 0)
            if len(out) < _READ_ALL:
                return out
            parts = [out]  # improbably huge file: keep reading
            while len(out) == _READ_ALL:
                out = await f.read(_READ_ALL, sum(map(len, parts)))
                parts.append(out)
            return b"".join(parts)
        finally:
            await f.close()

    async def removexattr(self, path: str, name: str) -> None:
        loc = await self.resolve(path)
        await self.graph.top.removexattr(loc, name)

    # -- handle-based API (glfs-handles.h: glfs_h_*) ----------------------

    async def h_lookupat(self, path: str) -> "Handle":
        """Path -> portable handle (glfs_h_lookupat + extract)."""
        ia = await self.stat(path)
        return Handle(ia.gfid)

    @staticmethod
    def h_extract(h: "Handle") -> bytes:
        """Handle -> 16 opaque bytes (glfs_h_extract_handle); ship them
        anywhere, rebuild with :meth:`h_create_from_handle`."""
        return bytes(h.gfid)

    async def h_create_from_handle(self, data: bytes) -> "Handle":
        """Opaque bytes -> live handle (glfs_h_create_from_handle);
        verifies the object still exists on this volume."""
        if len(data) != 16:
            raise FopError(errno.EINVAL, "handle must be 16 bytes")
        h = Handle(bytes(data))
        await self.h_stat(h)  # ESTALE/ENOENT if the object is gone
        return h

    async def _h_path(self, h: "Handle") -> str:
        """Current volume path of a handle via the bricks' gfid2path
        records (rename-safe: records track the object, not the name)."""
        from ..storage.posix import XA_GFID2PATH

        if bytes(h.gfid) == bytes(ROOT_GFID):
            return "/"
        out = await self.graph.top.getxattr(Loc("", gfid=h.gfid),
                                            XA_GFID2PATH)
        return out[XA_GFID2PATH].decode()

    async def h_stat(self, h: "Handle") -> Iatt:
        return await self.stat(await self._h_path(h))

    async def h_open(self, h: "Handle", flags: int = os.O_RDWR) -> File:
        return await self.open(await self._h_path(h), flags)

    async def h_opendir(self, h: "Handle") -> list[str]:
        return await self.listdir(await self._h_path(h))

    async def h_creat(self, parent: "Handle", name: str,
                      flags: int = os.O_RDWR,
                      mode: int = 0o644) -> tuple["Handle", File]:
        base = await self._h_path(parent)
        f = await self.create(f"{base.rstrip('/')}/{name}", flags, mode)
        ia = await f.fstat()
        return Handle(ia.gfid), f

    async def h_mkdir(self, parent: "Handle", name: str,
                      mode: int = 0o755) -> "Handle":
        base = await self._h_path(parent)
        ia = await self.mkdir(f"{base.rstrip('/')}/{name}", mode)
        return Handle(ia.gfid)

    async def h_unlink(self, parent: "Handle", name: str) -> None:
        base = await self._h_path(parent)
        await self.unlink(f"{base.rstrip('/')}/{name}")

    async def h_truncate(self, h: "Handle", size: int) -> Iatt:
        return await self.truncate(await self._h_path(h), size)

    async def h_setattrs(self, h: "Handle", attrs: dict) -> Iatt:
        return await self.setattr(await self._h_path(h), attrs)

    async def h_getxattrs(self, h: "Handle", name: str | None = None):
        return await self.getxattr(await self._h_path(h), name)

    async def h_setxattrs(self, h: "Handle", xattrs: dict) -> None:
        await self.setxattr(await self._h_path(h), xattrs)

    async def h_rename(self, src_parent: "Handle", oldname: str,
                       dst_parent: "Handle", newname: str) -> None:
        src = await self._h_path(src_parent)
        dst = await self._h_path(dst_parent)
        await self.rename(f"{src.rstrip('/')}/{oldname}",
                          f"{dst.rstrip('/')}/{newname}")

    async def h_link(self, h: "Handle", dst_parent: "Handle",
                     name: str) -> Iatt:
        base = await self._h_path(dst_parent)
        return await self.link(await self._h_path(h),
                               f"{base.rstrip('/')}/{name}")

    async def h_readlink(self, h: "Handle") -> str:
        return await self.readlink(await self._h_path(h))

    async def h_symlink(self, parent: "Handle", name: str,
                        target: str) -> "Handle":
        base = await self._h_path(parent)
        ia = await self.symlink(target, f"{base.rstrip('/')}/{name}")
        return Handle(ia.gfid)

    def h_root(self) -> "Handle":
        return Handle(bytes(ROOT_GFID))

    async def h_getattrs(self, h: "Handle") -> Iatt:
        return await self.h_stat(h)  # glfs_h_getattrs == stat shape

    async def h_removexattrs(self, h: "Handle", name: str) -> None:
        await self.removexattr(await self._h_path(h), name)

    async def h_statfs(self, h: "Handle") -> dict:
        return await self.statvfs(await self._h_path(h))

    async def h_mknod(self, parent: "Handle", name: str,
                      mode: int = 0o644) -> "Handle":
        base = await self._h_path(parent)
        path = f"{base.rstrip('/')}/{name}"
        loc = await self._parent_loc(path)
        ia = await self.graph.top.mknod(loc, mode, 0)
        self.itable.link(loc.parent, loc.name, ia.gfid, ia.ia_type, ia)
        return Handle(ia.gfid)

    async def h_anonymous_read(self, h: "Handle", size: int,
                               offset: int = 0) -> bytes:
        """One-shot read by handle, no fd held (glfs_h_anonymous_read)."""
        f = await self.h_open(h, os.O_RDONLY)
        try:
            return await f.read(size, offset)
        finally:
            await f.close()

    async def h_anonymous_write(self, h: "Handle", data: bytes,
                                offset: int = 0) -> int:
        f = await self.h_open(h, os.O_RDWR)
        try:
            return await f.write(data, offset)
        finally:
            await f.close()

    # -- introspection -------------------------------------------------------

    def statedump(self) -> dict:
        d = self.graph.statedump()
        d["itable"] = self.itable.dump()
        return d


class SyncClient:
    """Synchronous facade: runs the async client on a private loop thread
    (the reference's syncop/synctask analog, syncop.c:263,602)."""

    def __init__(self, graph: Graph):
        self._client = Client(graph)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        daemon=True)
        self._thread.start()

    def _run(self, coro) -> Any:
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

    def __getattr__(self, name: str):
        target = getattr(self._client, name)
        if asyncio.iscoroutinefunction(target):
            def call(*a, **kw):
                result = self._run(target(*a, **kw))
                return _SyncFile(self, result) if isinstance(result, File) \
                    else result
            return call
        return target

    def close(self) -> None:
        self._run(self._client.unmount())
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)


class _SyncFile:
    def __init__(self, owner: SyncClient, f: File):
        self._owner = owner
        self._f = f

    def __getattr__(self, name: str):
        target = getattr(self._f, name)
        if asyncio.iscoroutinefunction(target):
            return lambda *a, **kw: self._owner._run(target(*a, **kw))
        return target
