"""Same-host shared-memory bulk lane (the RDMA-transport analog).

Reference: rpc/rpc-transport/rdma registers buffers once and ships
only descriptors over the wire while socket.c stays the fallback.
Here the registered buffer is a pair of memfd arenas (one per
direction) exchanged over an AF_UNIX side-channel at SETVOLUME via
SCM_RIGHTS — "the fd mapped" is the same-host proof.  Bulk payload
bytes (readv replies, writev/xorv request data, compound chains,
SGBuf segments) are written ONCE by the producer into its TX arena
and handed to the consumer as memoryviews into the shared mapping;
only a small (seq, offset, length) descriptor table rides the socket
(``wire.FL_SHM`` records).  Control frames, ordering, deadlines, QoS
admission and trace propagation all stay on the existing wire — the
lane substitutes only where blob bytes travel.

Reclamation is an ack watermark realized IN shared memory: the
consumer writes the highest contiguously-released descriptor seq into
its RX arena header; the producer reads it before every allocation
and frees every slot at or below it.  Zero extra wire bytes, zero
extra round trips, and peer death reclaims everything through plain
fd-close semantics (each side's mmap dies with its process).

Fallback is per-frame and total: an arena that cannot hold a frame's
blobs right now (or a dead/corrupt lane) makes THAT frame ship inline
exactly as today — no mode flag, no renegotiation.

Arena layout (both directions identical)::

    [0:4)   magic b"GSHM"
    [4:8)   reserved (zeros)
    [8:16)  u64 BE consumer ack watermark (written by the RECEIVER)
    [16:)   ring data

Descriptors (``DESC``, 20 bytes each): seq u64, absolute arena offset
u64, length u32 — appended to the FL_SHM record in blob order.
"""

from __future__ import annotations

import ctypes
import errno
import mmap
import os
import socket
import struct
import sys
import threading
import weakref
from collections import deque

from ..core import metrics as _metrics
from .wire import ShmDecodeError

MAGIC = b"GSHM"
HDR_SIZE = 16
_WM = struct.Struct(">Q")       # watermark field at offset 8
DESC = struct.Struct(">QQI")    # seq, absolute offset, length
DEFAULT_ARENA = 16 * 1024 * 1024

# hot-path counter store; the unified registry reads it at scrape time
shm_stats = {"tx_bytes": 0, "rx_bytes": 0,
             "tx_frames": 0, "rx_frames": 0}
# why frames/connections fell back to the inline wire, by reason
fallback_stats: dict[str, int] = {}

# every live arena (tx and rx, both ends), for the occupancy gauge.  WeakSet: a torn-down lane's arenas age out with GC.
_LIVE_ARENAS: "weakref.WeakSet" = weakref.WeakSet()


def count_fallback(reason: str) -> None:
    fallback_stats[reason] = fallback_stats.get(reason, 0) + 1


def supported() -> bool:
    """Can this build arm the lane at all?  Linux memfd + SCM_RIGHTS
    fd passing (socket.send_fds/recv_fds, py3.9+) are required; any
    miss means the peer simply never advertises / never arms."""
    return (sys.platform.startswith("linux")
            and hasattr(os, "memfd_create")
            and hasattr(socket, "send_fds")
            and hasattr(socket, "recv_fds"))


_boot_id: str | None = None


def boot_id() -> str:
    """This host's boot identity, for the cheap cross-host screen
    (the fd exchange is the real proof; this avoids dialing a
    side-channel that cannot exist on another machine)."""
    global _boot_id
    if _boot_id is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                _boot_id = f.read().strip()
        except OSError:
            _boot_id = socket.gethostname()
    return _boot_id


def _create_mm(size: int) -> tuple[mmap.mmap, int]:
    """Mint one arena: anonymous memfd, sized, mapped, header stamped.
    Returns (mapping, fd) — the fd is the capability handed to the
    peer; the creator keeps only the mapping."""
    fd = os.memfd_create("gftpu-shm-arena", os.MFD_CLOEXEC)
    try:
        os.ftruncate(fd, size)
        mm = mmap.mmap(fd, size)
    except BaseException:
        os.close(fd)
        raise
    mm[0:4] = MAGIC
    return mm, fd


def _attach_mm(fd: int) -> tuple[mmap.mmap, int]:
    """Map a received arena fd; the magic check is the handshake's
    integrity screen (a wrong fd must not become a silent data lane)."""
    size = os.fstat(fd).st_size
    if size <= HDR_SIZE:
        raise OSError(errno.EINVAL, "shm arena too small")
    mm = mmap.mmap(fd, size)
    if bytes(mm[0:4]) != MAGIC:
        mm.close()
        raise OSError(errno.EINVAL, "shm arena magic mismatch")
    return mm, size


class ShmTx:
    """Producer half: a contiguous-slot ring allocator over the data
    area.  Slots are freed by the consumer's ack watermark (read from
    the shared header before every allocation); a frame whose blobs
    don't fit RIGHT NOW returns None and ships inline — the ring never
    blocks the wire."""

    role = "tx"

    def __init__(self, mm: mmap.mmap, size: int):
        self.mm = mm
        self.size = size
        self.cap = size - HDR_SIZE
        self.dead = False
        # allocation state, guarded: pack_frames runs on event-pool
        # threads and the loop concurrently
        self._lock = threading.Lock()
        self._allocs: deque = deque()  # (seq, start, end) data-relative
        self._head = 0
        self._used = 0
        self._seq = 0  # last descriptor seq issued
        _LIVE_ARENAS.add(self)

    @classmethod
    def create(cls, size: int) -> tuple["ShmTx", int]:
        mm, fd = _create_mm(size)
        return cls(mm, size), fd

    @classmethod
    def attach(cls, fd: int) -> "ShmTx":
        mm, size = _attach_mm(fd)
        return cls(mm, size)

    def used(self) -> int:
        return self._used

    def _reclaim_locked(self) -> None:
        wm = _WM.unpack_from(self.mm, 8)[0]
        if wm > self._seq:
            # a watermark past anything we issued is corruption (torn
            # write, hostile peer): disarm — inline forever after
            self.dead = True
            count_fallback("corrupt")
            return
        while self._allocs and self._allocs[0][0] <= wm:
            _, s, e = self._allocs.popleft()
            self._used -= e - s

    def _alloc_locked(self, n: int) -> int | None:
        """Contiguous ring allocation (data-relative start), or None.
        Frees happen strictly in seq order (the watermark is
        contiguous), so the oldest allocation's start is the tail."""
        if n > self.cap:
            return None
        if not self._allocs:
            start = self._head = 0
        else:
            tail = self._allocs[0][1]
            head = self._head
            if head >= tail:
                if n <= self.cap - head:
                    start = head
                elif n < tail:
                    start = 0  # wrap; the skipped gap frees with tail
                else:
                    return None
            elif n < tail - head:
                start = head
            else:
                return None
        self._head = start + n
        self._used += n
        return start

    def put_blobs(self, views: list) -> list | None:
        """Copy a frame's blobs into the arena.  Returns the packed
        descriptors (bytes, frame order) or None when the ring cannot
        hold them right now — the caller ships that frame inline (the
        per-frame fallback; nothing is renegotiated)."""
        if self.dead:
            return None
        descs: list = []
        total = 0
        with self._lock:
            self._reclaim_locked()
            if self.dead:
                return None
            head0, used0, seq0 = self._head, self._used, self._seq
            taken = 0
            for v in views:
                n = len(v)
                start = self._alloc_locked(n)
                if start is None:
                    # roll back the whole frame: the seqs were never
                    # shipped, so reusing them keeps the watermark
                    # contiguous
                    for _ in range(taken):
                        self._allocs.pop()
                    self._head, self._used, self._seq = head0, used0, seq0
                    count_fallback("arena-full")
                    return None
                self._seq += 1
                self._allocs.append((self._seq, start, start + n))
                taken += 1
                off = HDR_SIZE + start
                if n:
                    self.mm[off:off + n] = v
                descs.append(DESC.pack(self._seq, off, n))
                total += n
        shm_stats["tx_bytes"] += total
        shm_stats["tx_frames"] += 1
        return descs

    def close(self) -> None:
        self.dead = True
        try:
            self.mm.close()
        except (BufferError, ValueError):  # pragma: no cover
            pass


class ShmRx:
    """Consumer half: resolves descriptor tables into memoryviews that
    point INTO the shared mapping (zero consumer-side copies).  Each
    view's death — GC of the last reference, from any thread — marks
    its seq released; the highest contiguously-released seq is written
    back into the arena header as the producer's ack watermark."""

    role = "rx"

    def __init__(self, mm: mmap.mmap, size: int):
        self.mm = mm
        self.size = size
        self.cap = size - HDR_SIZE
        self._lock = threading.Lock()
        self._released: set = set()
        self._lens: dict[int, int] = {}  # outstanding seq -> length
        self._wm = 0
        self._out_bytes = 0
        self._closed = False
        self._close_pending = False
        _LIVE_ARENAS.add(self)

    @classmethod
    def create(cls, size: int) -> tuple["ShmRx", int]:
        mm, fd = _create_mm(size)
        return cls(mm, size), fd

    @classmethod
    def attach(cls, fd: int) -> "ShmRx":
        mm, size = _attach_mm(fd)
        return cls(mm, size)

    def used(self) -> int:
        return self._out_bytes

    def views_for(self, table) -> list:
        """Resolve one FL_SHM descriptor table.  Raises ShmDecodeError
        on any malformed descriptor — the transport answers that with
        EOPNOTSUPP so the peer downgrades, instead of serving bytes
        from the wrong offset."""
        if len(table) == 0 or len(table) % DESC.size:
            raise ShmDecodeError("malformed shm descriptor table")
        out: list = []
        total = 0
        for i in range(0, len(table), DESC.size):
            seq, off, n = DESC.unpack_from(table, i)
            if off < HDR_SIZE or off + n > self.size:
                raise ShmDecodeError("shm descriptor out of bounds")
            try:
                arr = (ctypes.c_char * n).from_buffer(self.mm, off)
            except (ValueError, BufferError) as e:
                raise ShmDecodeError(f"shm arena unavailable: {e}") \
                    from None
            # release rides GC: fires only when every derived
            # memoryview is gone (the view below, plus anything the
            # fop pipeline sliced from it)
            weakref.finalize(arr, self._release, seq)
            with self._lock:
                self._lens[seq] = n
                self._out_bytes += n
            out.append(memoryview(arr).cast("B"))
            total += n
        shm_stats["rx_bytes"] += total
        shm_stats["rx_frames"] += 1
        return out

    def _release(self, seq: int) -> None:
        # runs on whatever thread dropped the last reference
        with self._lock:
            self._out_bytes -= self._lens.pop(seq, 0)
            self._released.add(seq)
            wm = self._wm
            while wm + 1 in self._released:
                wm += 1
                self._released.discard(wm)
            if wm != self._wm:
                self._wm = wm
                if not self._closed:
                    _WM.pack_into(self.mm, 8, wm)
            if self._close_pending and not self._lens:
                self._close_locked()

    def close(self) -> None:
        """Tear down; deferred while consumer views are still alive
        (closing the mmap under them would be a BufferError — the last
        release completes the close instead)."""
        with self._lock:
            if self._closed:
                return
            if self._lens:
                self._close_pending = True
                return
            self._close_locked()

    def _close_locked(self) -> None:
        self._closed = True
        self._close_pending = False
        try:
            self.mm.close()
        except (BufferError, ValueError):  # pragma: no cover
            pass


# -- side-channel (SCM_RIGHTS fd exchange) ------------------------------

def fetch_fds(addr: str, token: str, timeout: float = 5.0) -> list[int]:
    """Client half of the fd exchange: dial the brick's AF_UNIX
    side-channel (abstract namespace when ``addr`` starts with '@'),
    present the one-shot token from the SETVOLUME advert, and receive
    the two arena memfds via SCM_RIGHTS as [c2s_fd, s2c_fd].  Blocking
    — call via asyncio.to_thread."""
    raw: str | bytes = addr
    if addr.startswith("@"):
        raw = b"\0" + addr[1:].encode()
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        s.settimeout(timeout)
        s.connect(raw)
        s.sendall(token.encode() + b"\n")
        msg, fds, _flags, _addr = socket.recv_fds(s, 16, 2)
        if len(fds) != 2 or not msg.startswith(b"ok"):
            for fd in fds:
                os.close(fd)
            raise OSError(errno.EPROTO, "shm side-channel refused")
        return list(fds)
    finally:
        s.close()


# -- unified registry families ------------------------------------------

def _arena_samples():
    totals: dict[tuple, int] = {}
    for a in list(_LIVE_ARENAS):
        mm = getattr(a, "mm", None)
        if mm is None or mm.closed:
            continue
        used = a.used()
        for state, v in (("used", used), ("free", a.cap - used)):
            totals[(a.role, state)] = totals.get((a.role, state), 0) + v
    return [({"role": r, "state": st}, v)
            for (r, st), v in sorted(totals.items())]


_metrics.REGISTRY.register(
    "gftpu_shm_tx_bytes_total", "counter",
    "payload bytes written into shared-memory arenas by this process",
    lambda: [({}, shm_stats["tx_bytes"])])
_metrics.REGISTRY.register(
    "gftpu_shm_rx_bytes_total", "counter",
    "payload bytes consumed from shared-memory arenas by this process",
    lambda: [({}, shm_stats["rx_bytes"])])
_metrics.REGISTRY.register(
    "gftpu_shm_fallback_total", "counter",
    "frames/connections that fell back to the inline wire, by reason",
    lambda: [({"reason": r}, v)
             for r, v in sorted(fallback_stats.items())])
_metrics.REGISTRY.register(
    "gftpu_shm_arena_bytes", "gauge",
    "shared-memory arena occupancy by role and state",
    _arena_samples)
