"""Wire codec + framing — the XDR analog.

Reference: rpc/xdr/src/*.x define the wire schema; rpc-lib frames records
over the socket.  Here: a small tagged binary codec for the value tree a
fop carries (ints, bytes, strings, lists, dicts, Iatt, Loc, fd handles,
errors) and length-prefixed frames.  No pickle — only the types below can
cross the wire (same property XDR gives the reference).

Frame: 4-byte big-endian length, then the record.
Record: 8-byte header (u32 xid, u8 mtype, u8 flags, 2 reserved) + body.

Bulk payloads (the iobref analog): the reference never XDR-encodes file
data — write payloads ride beside the header as raw iobufs
(rpc-lib/src/rpc-clnt.c iobref submit; socket.c's vectored writev).
Here the same: a :class:`Blob` in the value tree is encoded as a tiny
reference (tag + offset/length) and its bytes are shipped verbatim
AFTER the body (``FL_BLOBS`` record layout: header, u32 body length,
body, then the concatenated blob bytes).  ``pack_frames`` returns the
prefix plus the original buffer objects so the transport can
``writelines`` them with zero payload copies; ``unpack`` hands blobs
back as memoryviews into the received frame, so the receive side also
adds no copy beyond the socket read itself.
"""

from __future__ import annotations

import struct
import threading as _threading
from typing import Any

from ..core.fops import FopError
from ..core.iatt import IAType, Iatt
from ..core.layer import Loc

MT_CALL = 1
MT_REPLY = 2
MT_ERROR = 3
MT_EVENT = 4  # server -> client notifications (upcall channel analog)
# on-wire compression (the cdc/compress xlator analog): an MT_ZLIB
# record's body is the zlib deflate of a complete inner record
MT_ZLIB = 5

# The RPC peer identity of the request currently being dispatched
# (set per-call by protocol/server, read by brick-side layers that need
# to know WHO is asking — features/upcall's client registry; the
# reference threads this through frame->root->client).
import contextvars as _contextvars  # noqa: E402

CURRENT_CLIENT: "_contextvars.ContextVar" = _contextvars.ContextVar(
    "gftpu_current_client", default=None)

# The absolute (local event-loop clock) deadline of the request being
# dispatched, armed per-call by protocol/server from the client's
# propagated budget (network.deadline-propagation).  Brick-side queue
# layers (io-threads) read it to DROP work whose client has already
# timed the call out; None = no budget known.
CURRENT_DEADLINE: "_contextvars.ContextVar" = _contextvars.ContextVar(
    "gftpu_current_deadline", default=None)

# The io-threads priority lane of the request being dispatched, set
# per-call by protocol/server from the QoS engine's verdict
# (features/qos): "least" demotes the request to the least-priority
# class (rebalance-origin traffic, currently-shaped clients); "" keeps
# the per-fop priority table.
CURRENT_LANE: "_contextvars.ContextVar" = _contextvars.ContextVar(
    "gftpu_current_lane", default="")

_HDR = struct.Struct(">IBBxx")

# record flags (byte 5 of the header; 0 in pre-blob frames)
FL_BLOBS = 1
# blob payloads ride a shared-memory arena (rpc/shm): the record
# carries a (seq, offset, length) descriptor table instead of bytes
FL_SHM = 2

# value tags
_T_NONE, _T_TRUE, _T_FALSE = 0, 1, 2
_T_INT, _T_NEGINT, _T_FLOAT = 3, 4, 5
_T_BYTES, _T_STR = 6, 7
_T_LIST, _T_DICT = 8, 9
_T_IATT, _T_LOC, _T_FD, _T_ERR = 10, 11, 12, 13
_T_BLOBREF = 14

# observability: how many payload bytes rode the zero-copy lane vs were
# inlined through the tagged codec (bench asserts the lane is actually
# taken; the reference counts iobref hits the same way in io-stats).
# rx_* mirror the receive side: blob bytes decoded as views into the
# frame (the read pipeline's zero-copy proof counter).
blob_stats = {"tx_blobs": 0, "tx_bytes": 0, "inline_bytes": 0,
              "rx_frames": 0, "rx_bytes": 0}

# absorbed into the unified registry (core/metrics.py): the dict stays
# the hot-path counter store, the registry reads it at scrape time
from ..core import metrics as _metrics  # noqa: E402

_metrics.REGISTRY.register(
    "gftpu_wire_blob_stats", "counter",
    "payload bytes/frames by wire lane (blob vs inline, tx vs rx)",
    lambda: _metrics.labeled(blob_stats))


class Blob:
    """A bulk payload shipped out-of-band (iobuf analog).

    Wrap file data in a Blob before handing the value tree to
    ``pack_frames`` and the bytes never pass through the codec; without
    a collector (plain ``pack`` / compressed frames) it degrades to an
    inline _T_BYTES, so every path stays correct."""

    __slots__ = ("view",)

    def __init__(self, data):
        self.view = data if isinstance(data, memoryview) \
            else memoryview(data)

    def __len__(self):
        return len(self.view)


class WireError(Exception):
    pass


class ShmDecodeError(WireError):
    """An FL_SHM record that cannot be served from a local arena (lane
    not armed, malformed descriptor, mapping gone).  Transports answer
    this with EOPNOTSUPP + an ``shm-unsupported`` xdata notice so the
    peer downgrades to inline frames, instead of dropping the
    connection over a recoverable capability mismatch."""


#: wire spelling of a scatter-gather payload: a one-key dict whose value
#: is the ordered segment list.  A plain dict (not a new value tag) so
#: both codecs — and any recorded frame — stay format-compatible.
SG_KEY = "__sg__"


class SGBuf:
    """A scatter-gather payload: an ordered vector of buffer segments
    (the iovec/iobref-list analog).  Produced by layers that already
    hold the reply as several buffers — cached pages, per-link chain
    replies, EC fragment windows — so the bytes are never joined just
    to hand them on.

    Joining happens exactly once, at a boundary that demands plain
    bytes (``bytes(sg)``: the glfs API edge)."""

    __slots__ = ("segments",)

    def __init__(self, segments):
        self.segments = [s if isinstance(s, memoryview) else memoryview(s)
                         for s in segments]

    def __len__(self) -> int:
        return sum(len(s) for s in self.segments)

    def __bytes__(self) -> bytes:
        return b"".join(self.segments)

    def tobytes(self) -> bytes:
        return b"".join(self.segments)

    def __eq__(self, other) -> bool:
        if isinstance(other, SGBuf):
            return self.tobytes() == other.tobytes()
        if isinstance(other, (bytes, bytearray, memoryview)):
            return self.tobytes() == bytes(other)
        return NotImplemented

    __hash__ = None  # eq without hash: segments are mutable

    def __repr__(self):  # pragma: no cover
        return f"SGBuf({len(self.segments)} segs, {len(self)}B)"


def as_single_buffer(data):
    """A buffer-protocol view of any readv result shape (bytes,
    memoryview, SGBuf) — what np.frombuffer / os.pwrite consumers call
    before touching payload bytes.  Single-segment SGBufs stay
    zero-copy; multi-segment ones pay their one join here."""
    if isinstance(data, SGBuf):
        if len(data.segments) == 1:
            return data.segments[0]
        return data.tobytes()
    return data


def serve_pages(pages, offset: int, end: int, psz: int):
    """Assemble [offset, end) from a page map as zero-copy views — the
    shared serve loop of the page-granular read caches (io-cache,
    read-ahead).  Pages are immutable bytes keyed by index; a missing
    or short page is EOF.  Returns b'' / a single bytes-or-view / an
    SGBuf, never joining multi-page answers (small single-page answers
    come back as owned bytes: the view wrapper costs more than it
    saves)."""
    segs = []
    pos = offset
    while pos < end:
        idx = pos // psz
        page = pages.get(idx)
        if page is None:
            break  # EOF
        start = pos - idx * psz
        if start >= len(page):
            break  # EOF inside this page
        take = memoryview(page)[start: min(len(page),
                                           start + (end - pos))]
        segs.append(take)
        if len(page) < psz:  # short page = EOF
            break
        pos += len(take)
    if not segs:
        return b""
    if len(segs) == 1:
        return bytes(segs[0]) if len(segs[0]) < 4096 else segs[0]
    return SGBuf(segs)


class FdHandle:
    """A remote fd reference (server-side fd table slot) carrying the fd
    identity so the client can reconstruct a local FdObj."""

    __slots__ = ("fdid", "gfid", "path")

    def __init__(self, fdid: int, gfid: bytes = b"", path: str = ""):
        self.fdid = fdid
        self.gfid = gfid
        self.path = path

    def __repr__(self):  # pragma: no cover
        return f"FdHandle({self.fdid})"


def _enc_uint(out: bytearray, n: int) -> None:
    # LEB128-ish varint
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _dec_uint(buf: memoryview, pos: int) -> tuple[int, int]:
    n = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def encode_value(v: Any, out: bytearray,
                 blobs: list | None = None) -> None:
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int):
        if v >= 0:
            out.append(_T_INT)
            _enc_uint(out, v)
        else:
            out.append(_T_NEGINT)
            _enc_uint(out, -v)
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out += struct.pack(">d", v)
    elif isinstance(v, Blob):
        if blobs is None:  # no out-of-band lane: inline (compressed path)
            out.append(_T_BYTES)
            _enc_uint(out, len(v.view))
            out += v.view
            blob_stats["inline_bytes"] += len(v.view)
        else:
            out.append(_T_BLOBREF)
            _enc_uint(out, len(v.view))
            blobs.append(v.view)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        out.append(_T_BYTES)
        b = bytes(v)
        _enc_uint(out, len(b))
        out += b
    elif isinstance(v, str):
        out.append(_T_STR)
        # surrogateescape: filenames come off the kernel/disk as raw
        # bytes; non-UTF-8 names must round-trip the wire losslessly
        b = v.encode("utf-8", "surrogateescape")
        _enc_uint(out, len(b))
        out += b
    elif isinstance(v, (list, tuple)):
        out.append(_T_LIST)
        _enc_uint(out, len(v))
        for item in v:
            encode_value(item, out, blobs)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        _enc_uint(out, len(v))
        for k, val in v.items():
            encode_value(k, out, blobs)
            encode_value(val, out, blobs)
    elif isinstance(v, Iatt):
        out.append(_T_IATT)
        encode_value([v.gfid, v.ia_type.value, v.mode, v.nlink, v.uid,
                      v.gid, v.size, v.blocks, v.atime, v.mtime, v.ctime,
                      v.rdev, v.blksize], out)
    elif isinstance(v, Loc):
        out.append(_T_LOC)
        encode_value([v.path, v.gfid, v.parent, v.name], out)
    elif isinstance(v, FdHandle):
        out.append(_T_FD)
        encode_value([v.fdid, v.gfid, v.path], out)
    elif isinstance(v, FopError):
        out.append(_T_ERR)
        msg = str(v.args[1]) if len(v.args) > 1 else ""
        xd = getattr(v, "xdata", None)
        # two-field shape unless an error xdata rides along (the
        # lock-revocation notice): a third element old decoders ignore
        encode_value([v.err, msg, xd] if xd else [v.err, msg], out)
    else:
        raise WireError(f"unencodable type {type(v).__name__}")


def decode_value(buf: memoryview, pos: int,
                 blobs: list | None = None) -> tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_INT:
        return _dec_uint(buf, pos)
    if tag == _T_NEGINT:
        n, pos = _dec_uint(buf, pos)
        return -n, pos
    if tag == _T_FLOAT:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if tag == _T_BYTES:
        n, pos = _dec_uint(buf, pos)
        return bytes(buf[pos:pos + n]), pos + n
    if tag == _T_BLOBREF:
        n, pos = _dec_uint(buf, pos)
        if blobs is None:
            raise WireError("blob reference outside a FL_BLOBS record")
        region, off = blobs
        if isinstance(region, list):
            # FL_SHM record: refs resolve by INDEX into the arena views
            # the descriptor table named (``off`` counts refs here).
            # Lengths must agree — a mismatch means the table and the
            # body disagree about the frame's shape
            if off >= len(region) or len(region[off]) != n:
                raise ShmDecodeError("shm descriptor/blobref mismatch")
            blobs[1] = off + 1
            return region[off], pos
        if off + n > len(region):
            raise WireError("blob reference beyond record")
        blobs[1] = off + n
        # a memoryview INTO the received frame: the payload is never
        # copied again on this side (posix pwrite / np.frombuffer both
        # take buffer views)
        return region[off:off + n], pos
    if tag == _T_STR:
        n, pos = _dec_uint(buf, pos)
        return bytes(buf[pos:pos + n]).decode("utf-8", "surrogateescape"), \
            pos + n
    if tag == _T_LIST:
        n, pos = _dec_uint(buf, pos)
        out = []
        for _ in range(n):
            item, pos = decode_value(buf, pos, blobs)
            out.append(item)
        return out, pos
    if tag == _T_DICT:
        n, pos = _dec_uint(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = decode_value(buf, pos, blobs)
            v, pos = decode_value(buf, pos, blobs)
            d[k] = v
        return d, pos
    if tag == _T_IATT:
        vals, pos = decode_value(buf, pos)
        ia = Iatt(gfid=vals[0], ia_type=IAType(vals[1]), mode=vals[2],
                  nlink=vals[3], uid=vals[4], gid=vals[5], size=vals[6],
                  blocks=vals[7], atime=vals[8], mtime=vals[9],
                  ctime=vals[10], rdev=vals[11], blksize=vals[12])
        return ia, pos
    if tag == _T_LOC:
        vals, pos = decode_value(buf, pos)
        return Loc(vals[0], gfid=vals[1], parent=vals[2], name=vals[3]), pos
    if tag == _T_FD:
        vals, pos = decode_value(buf, pos)
        return FdHandle(vals[0], vals[1], vals[2]), pos
    if tag == _T_ERR:
        vals, pos = decode_value(buf, pos)
        return FopError(vals[0], vals[1],
                        vals[2] if len(vals) > 2 else None), pos
    raise WireError(f"bad tag {tag}")


# ---------------------------------------------------------------------
# C codec (native/src/wirec.c — the XDR-is-generated-C analog): the same
# format bit for bit, built with gcc at first use.  There is no
# fallback: a failed build raises with gcc's stderr.  encode_value /
# decode_value above are its plain version (the tests hold the two
# equal) and still decode FL_SHM records, whose blob refs resolve by
# index into arena views.
# ---------------------------------------------------------------------

_wirec = None
_wirec_lock = _threading.Lock()


def _c():
    """The C codec module, built and registered on first use."""
    global _wirec
    if _wirec is not None:
        return _wirec
    with _wirec_lock:
        if _wirec is None:
            from .. import native as _native

            mod = _native.wirec_module()
            mod.register(
                Iatt, Loc, FdHandle, FopError, Blob,
                lambda v: Iatt(gfid=v[0], ia_type=IAType(v[1]), mode=v[2],
                               nlink=v[3], uid=v[4], gid=v[5], size=v[6],
                               blocks=v[7], atime=v[8], mtime=v[9],
                               ctime=v[10], rdev=v[11], blksize=v[12]),
                lambda v: Loc(v[0], gfid=v[1], parent=v[2], name=v[3]),
                lambda v: FdHandle(v[0], v[1], v[2]),
                lambda v: FopError(v[0], v[1],
                                   v[2] if len(v) > 2 else None),
                WireError, blob_stats)
            _wirec = mod
    return _wirec


def _encode_body(payload: Any, blobs: list | None) -> bytes:
    return _c().encode(payload, blobs)


def _decode_body(buf, pos: int, blobs: list | None = None):
    if blobs is None or isinstance(blobs[0], memoryview):
        return _c().decode(buf, pos, blobs)
    return decode_value(buf, pos, blobs)


def pack(xid: int, mtype: int, payload: Any) -> bytes:
    rec = _HDR.pack(xid, mtype, 0) + _encode_body(payload, None)
    return struct.pack(">I", len(rec)) + rec


def pack_frames(xid: int, mtype: int, payload: Any,
                shm_tx=None) -> list:
    """Frame a record with payload blobs out-of-band.

    Returns a list of buffers for ``StreamWriter.writelines``: one
    prefix (length, header, body-length, body) followed by the blob
    buffers THEMSELVES — file data crosses into the transport without
    ever being copied into the frame.

    With an armed ``shm_tx`` arena (rpc/shm), the blobs are written
    once into shared memory instead and the record carries only their
    descriptor table (FL_SHM) — zero payload bytes on the socket.  An
    arena that can't hold this frame right now returns the frame to
    the FL_BLOBS path: fallback is per-frame, never a mode switch."""
    blobs: list = []
    body = _encode_body(payload, blobs)
    if not blobs:
        rec = _HDR.pack(xid, mtype, 0) + body
        return [struct.pack(">I", len(rec)) + rec]
    if shm_tx is not None:
        descs = shm_tx.put_blobs(blobs)
        if descs is not None:
            table = b"".join(descs)
            rec_len = _HDR.size + 4 + len(body) + len(table)
            return [struct.pack(">I", rec_len)
                    + _HDR.pack(xid, mtype, FL_SHM)
                    + struct.pack(">I", len(body)) + body + table]
    blob_len = sum(len(b) for b in blobs)
    rec_len = _HDR.size + 4 + len(body) + blob_len
    prefix = (struct.pack(">I", rec_len)
              + _HDR.pack(xid, mtype, FL_BLOBS)
              + struct.pack(">I", len(body)) + body)
    blob_stats["tx_blobs"] += len(blobs)
    blob_stats["tx_bytes"] += blob_len
    return [prefix, *blobs]


# inflation cap: a few-KB zlib bomb must not materialize gigabytes
# pre-auth (zlib ratios reach ~1000:1)
_MAX_INFLATED = 256 << 20


def peek_xid(rec: bytes) -> int:
    """The xid of a framed record, without decoding it — how a
    transport answers a frame whose BODY failed to decode (an FL_SHM
    record on an unarmed lane must still be ANSWERED, or the peer's
    call hangs out its whole deadline)."""
    return _HDR.unpack_from(rec, 0)[0]


def unpack(rec: bytes, shm_rx=None) -> tuple[int, int, Any]:
    xid, mtype, flags = _HDR.unpack_from(rec, 0)
    if mtype == MT_ZLIB:
        import zlib

        d = zlib.decompressobj()
        inner = d.decompress(rec[_HDR.size:], _MAX_INFLATED)
        if d.unconsumed_tail:
            raise WireError("compressed frame exceeds inflation cap")
        if len(inner) >= 4 + _HDR.size and \
                _HDR.unpack_from(inner, 4)[1] == MT_ZLIB:
            raise WireError("nested compression refused")
        return unpack(inner[4:])  # strip the inner length prefix
    mv = memoryview(rec)
    if flags & FL_SHM:
        # shared-memory record: the frame carries body + descriptor
        # table only; payload bytes live in the peer-shared arena
        if shm_rx is None:
            raise ShmDecodeError("shm record without an armed lane")
        (body_len,) = struct.unpack_from(">I", rec, _HDR.size)
        start = _HDR.size + 4
        if start + body_len > len(rec):
            raise WireError("shm record body overruns frame")
        views = shm_rx.views_for(mv[start + body_len:])
        # a list region routes _T_BLOBREF decoding by index — and
        # keeps the decode on the pure-Python codec (the C codec only
        # understands contiguous FL_BLOBS regions)
        payload, _ = decode_value(mv[:start + body_len], start,
                                  [views, 0])
        return xid, mtype, payload
    if flags & FL_BLOBS:
        (body_len,) = struct.unpack_from(">I", rec, _HDR.size)
        start = _HDR.size + 4
        if start + body_len > len(rec):
            raise WireError("blob record body overruns frame")
        blobs = [mv[start + body_len:], 0]
        blob_stats["rx_frames"] += 1
        blob_stats["rx_bytes"] += len(blobs[0])
        payload, _ = _decode_body(mv[:start + body_len], start, blobs)
        return xid, mtype, payload
    payload, _ = _decode_body(mv, _HDR.size)
    return xid, mtype, payload


def pack_z(xid: int, mtype: int, payload: Any,
           min_size: int = 512, level: int = 1) -> bytes:
    """Compressed pack: deflate the whole record when it is worth it
    (small frames ship plain — zlib would grow them).  ``level`` is the
    cdc xlator's compression-level (-1 = zlib default)."""
    import zlib

    plain = pack(xid, mtype, payload)
    if len(plain) < min_size:
        return plain
    body = zlib.compress(plain, level)
    rec = _HDR.pack(xid, MT_ZLIB, 0) + body
    return struct.pack(">I", len(rec)) + rec


async def read_frame(reader) -> bytes:
    hdr = await reader.readexactly(4)
    (length,) = struct.unpack(">I", hdr)
    if length > (1 << 30):
        raise WireError(f"frame too large: {length}")
    return await reader.readexactly(length)
