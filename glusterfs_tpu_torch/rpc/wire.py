"""Scatter-gather payload buffers of the wire layer.

The local served path needs only the reply-buffer shapes a readv can
return (bytes, memoryview, :class:`SGBuf`); the tagged codec, framing
and blob lane of the full wire layer belong to the protocol client and
server, which are not part of this package yet.
"""

from __future__ import annotations


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
