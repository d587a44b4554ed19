"""Compound fops: fused request chains on the wire.

Reference: the GF_FOP_COMPOUND machinery (glusterfs-fops.h compound
entries; afr/ec used it to fuse xattrop+writev waves before it was
retired upstream in favor of xdata piggybacks).  This build keeps the
xdata piggybacks (lock-on-create, pre-xattrop) AND revives the general
mechanism, because the smallfile budget is dominated by serialized RPC
waves: a create+writev+flush+release of one 4 KiB file costs ~4 round
trips as singles and exactly one as a chain.

A chain is an ordered list of links ``(fop_name, args, kwargs)``.
Links may reference the fd produced by an EARLIER link through
:class:`FdRef` (create->writev fd plumbing); on the wire the reference
travels as ``{"__fd_link__": index}``.  Execution is strictly in order
with short-circuit-on-first-error; the result is a REPLY VECTOR that
maps 1:1 onto the links:

    ["ok",   value]   — link executed, value is its return
    ["err",  FopError]— link failed; every later link is skipped
    ["skip", None]    — not executed (an earlier link failed)

The vector never raises by itself — callers that want plain values use
:func:`unwrap`, which raises the first error.  Two invariants keep fd
lifecycle airtight:

* a failed chain releases every fd it created itself (no orphan
  fd-table entries or OS handles from half-applied chains), and the
  surviving "ok" entries are stripped of those fds;
* a ``release`` link may only target an :class:`FdRef` (an fd created
  by this same chain) — releasing a caller-owned fd mid-chain would
  race the caller's own view of it.

Graph semantics: :meth:`Layer.compound` forwards a chain INTACT to its
first child only when the layer overrides none of the chain's fops
(checked against the generated default-passthrough methods), and
otherwise DECOMPOSES it — each link runs through the layer's own fop
methods, so gating/caching/transaction layers keep their exact
semantics at the cost of fusion from that point down.  Layers whose
per-fop behavior is cheap to replay (io-stats accounting, md-cache
invalidation, write-behind draining) override ``compound`` to forward
the chain and replay that behavior around it, which is what carries a
chain from the mount entry points all the way onto one wire frame.
"""

from __future__ import annotations

import errno
from typing import Any

from ..core.fops import Fop, FopError
from ..core.layer import FdObj

#: abuse bound: one frame must not smuggle an unbounded work queue past
#: the server's outstanding-rpc accounting (a chain occupies ONE slot)
MAX_LINKS = 64

#: wire spelling of an FdRef (survives the tagged codec as a dict)
FD_LINK_KEY = "__fd_link__"

#: links whose results can carry a brand-new fd (create returns
#: (fd, iatt); open/opendir return the fd itself)
FD_PRODUCERS = ("create", "open", "opendir")

_FOP_NAMES = {f.value for f in Fop}
#: release is not a wire fop but is legal as a chain tail so a one-shot
#: create+writev+flush+release never registers a client-visible fd
ALLOWED = _FOP_NAMES | {"release"}


class FdRef:
    """Placeholder for the fd produced by link ``index`` of this chain."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = int(index)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FdRef({self.index})"


class ChainError(FopError):
    """A malformed chain (caller bug, not a storage condition)."""

    def __init__(self, msg: str):
        super().__init__(errno.EINVAL, msg)


def _is_ref(v: Any) -> FdRef | None:
    if isinstance(v, FdRef):
        return v
    if isinstance(v, dict) and len(v) == 1 and FD_LINK_KEY in v:
        return FdRef(v[FD_LINK_KEY])
    return None


def validate(links: Any) -> list[tuple[str, tuple, dict]]:
    """Normalize + validate a chain: wire-form links (lists, dict fd
    markers) become ``(fop, args, kwargs)`` tuples with FdRef objects;
    forward references, unknown fops, nested compounds and non-FdRef
    release targets are refused up front."""
    if not isinstance(links, (list, tuple)) or not links:
        raise ChainError("compound chain must be a non-empty list")
    if len(links) > MAX_LINKS:
        raise ChainError(f"compound chain exceeds {MAX_LINKS} links")
    out: list[tuple[str, tuple, dict]] = []
    for i, raw in enumerate(links):
        if not isinstance(raw, (list, tuple)) or len(raw) < 2:
            raise ChainError(f"link {i}: not a [fop, args, kwargs] triple")
        fop = raw[0]
        args = tuple(raw[1])
        kwargs = dict(raw[2] or {}) if len(raw) > 2 and raw[2] else {}
        if fop not in ALLOWED:
            raise ChainError(f"link {i}: unknown fop {fop!r}")
        if fop == Fop.COMPOUND.value:
            raise ChainError("nested compound chains are refused")
        for v in list(args) + list(kwargs.values()):
            ref = _is_ref(v)
            if ref is not None and not 0 <= ref.index < i:
                raise ChainError(
                    f"link {i}: fd reference to link {ref.index} is not "
                    f"an earlier link")
        if fop == "release" and _is_ref(args[0] if args else None) is None:
            raise ChainError(
                f"link {i}: release may only target an in-chain FdRef")
        out.append((fop, args, kwargs))
    return out


def fd_of(result: Any) -> FdObj | None:
    """The fd carried by a link result ((fd, iatt) from create, the fd
    itself from open/opendir)."""
    if isinstance(result, FdObj):
        return result
    if isinstance(result, (tuple, list)):
        for item in result:
            if isinstance(item, FdObj):
                return item
    return None


def _subst(value: Any, results: list) -> Any:
    ref = _is_ref(value)
    if ref is not None:
        fd = fd_of(results[ref.index]) if ref.index < len(results) else None
        if fd is None:
            raise ChainError(
                f"fd reference to link {ref.index}, which produced no fd")
        return fd
    if isinstance(value, list):
        return [_subst(v, results) for v in value]
    if isinstance(value, dict) and FD_LINK_KEY not in value:
        return {k: _subst(v, results) for k, v in value.items()}
    return value


def _strip_fds(value: Any, dead: set[int]) -> Any:
    """Replace released/cleaned-up FdObjs in a reply value with None —
    a handle the chain already closed must never reach the caller."""
    if isinstance(value, FdObj) and id(value) in dead:
        return None
    if isinstance(value, (tuple, list)):
        return [_strip_fds(v, dead) for v in value]
    return value


def first_error(replies: list) -> FopError | None:
    for entry in replies:
        if entry[0] == "err":
            return entry[1]
    return None


def unwrap(replies: list) -> list:
    """Reply vector -> plain per-link values, raising the first error."""
    err = first_error(replies)
    if err is not None:
        raise err
    return [entry[1] for entry in replies]


async def decompose(layer, links, xdata: dict | None = None) -> list:
    """Execute a chain link-by-link through ``layer``'s own fop methods
    (the always-correct path: every layer from here down sees ordinary
    fops).  Returns the reply vector; never raises for per-link
    failures.  On a mid-chain error, fds created by earlier links are
    released through the layer so the short-circuit leaves no orphan
    handle anywhere below.

    ``xdata`` is CHAIN-scoped: it rides the frame to wherever the
    chain executes (the client ships it, the server hands it to the
    brick graph) but is never merged into the links — per-link xdata
    belongs in each link's own kwargs.  It exists for chain-level
    piggybacks (the reference's compound dict_t)."""
    links = validate(links)
    results: list = []
    replies: list = []
    error: FopError | None = None
    chain_fds: list[FdObj] = []   # fds this chain itself created
    dead: set[int] = set()        # ids of fds already released
    for fop, args, kwargs in links:
        if error is not None:
            replies.append(["skip", None])
            continue
        try:
            rargs = tuple(_subst(a, results) for a in args)
            rkw = {k: _subst(v, results) for k, v in kwargs.items()}
            if fop == "release":
                fd = rargs[0]
                await layer.release(fd)
                dead.add(id(fd))
                results.append(None)
                replies.append(["ok", None])
                continue
            ret = await getattr(layer, fop)(*rargs, **rkw)
            if fop in FD_PRODUCERS:
                fd = fd_of(ret)
                if fd is not None:
                    chain_fds.append(fd)
            results.append(ret)
            replies.append(["ok", ret])
        except FopError as e:
            error = e
            results.append(None)
            replies.append(["err", e])
        except Exception as e:  # noqa: BLE001 - keep the vector shape
            error = FopError(errno.EIO, f"compound link {fop}: {e!r}")
            results.append(None)
            replies.append(["err", error])
    if error is not None:
        # short-circuit cleanup: close every fd the chain minted
        for fd in chain_fds:
            if id(fd) in dead:
                continue
            dead.add(id(fd))
            try:
                await layer.release(fd)
            except Exception:  # noqa: BLE001 - cleanup is best-effort
                pass
    if dead:
        replies = [[st, _strip_fds(val, dead)] if st == "ok" else [st, val]
                   for st, val in replies]
    return replies


#: the write-class links whose forwarded execution must still run a
#: caching layer's invalidation (shared by quick-read/io-cache replay)
WRITE_INVALIDATING = ("writev", "ftruncate", "truncate", "discard",
                      "zerofill", "fallocate")


def replay_write_invalidation(links, replies, invalidate) -> None:
    """Run ``invalidate(gfid)`` for every object a forwarded write link
    touched — the per-fop override logic the intact chain skipped.
    One shared copy so the fop list cannot drift between layers."""
    for (fop, args, _kw), (st, val) in zip(links, replies):
        if fop not in WRITE_INVALIDATING:
            continue
        for a in args:
            if isinstance(a, FdObj) and a.gfid:
                invalidate(a.gfid)
        if st == "ok" and hasattr(val, "gfid"):
            invalidate(val.gfid)


def is_default_fop(cls: type, name: str) -> bool:
    """True when ``cls`` serves ``name`` with the generated default
    passthrough (it neither defines nor inherits a real override)."""
    meth = getattr(cls, name, None)
    if meth is None:
        return False
    inner = getattr(meth, "__wrapped__", meth)
    return bool(getattr(inner, "_gf_default", False))


def transparent_for(cls: type, links) -> bool:
    """A layer may forward a chain intact iff it adds no behavior to any
    fop the chain contains.  ``release`` links are exempt: they only
    ever target fds the chain itself created BELOW this layer, which
    therefore never acquired per-layer context here."""
    for raw in links:
        fop = raw[0]
        if fop == "release":
            continue
        if not is_default_fop(cls, fop):
            return False
    return True
