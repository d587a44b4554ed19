"""features/index — the persisted pending-heal index (brick-side).

Reference: xlators/features/index/src/index.c (index_add :656,
index_del :686, xattrop_index_action :1020, option xattrop64-watchlist).
There, every xattrop whose result leaves a pending/dirty marker nonzero
links the file's GFID under ``.glusterfs/indices/xattrop/`` and removes
the link once the markers return to zero; the self-heal daemon crawls
that directory instead of the whole volume, which is what makes heal
O(pending) rather than O(files).

Same contract here (the virtual xattr names and the index directory are
the JAX package's, so either package reads the other's bricks):

* watches the cluster layers' accounting keys (``trusted.ec.dirty``,
  ``trusted.afr.dirty`` — the watchlist option) on xattrop/fxattrop and
  setxattr/fsetxattr results;
* nonzero marker  -> touch ``<index-base>/xattrop/<gfid-hex>``;
  all markers zero -> unlink it;
* the index is listed through a virtual xattr
  (``glusterfs_tpu.index.xattrop`` -> newline-joined gfid hexes) — the
  reference exposes the same data as a virtual gfid directory
  (index.c index_readdir); a virtual setxattr
  (``glusterfs_tpu.index.prune`` = hex) drops a stale entry, which the
  shd uses when an indexed gfid no longer resolves.

``index-base`` defaults to ``<posix-root>/.glusterfs_tpu/indices`` found
by walking down to the storage/posix descendant.
"""

from __future__ import annotations

import os

from ..core.fops import FopError
from ..core.layer import FdObj, Layer, Loc, register
from ..core.options import Option
from ..core import gflog

log = gflog.get_logger("index")

XA_INDEX_LIST = "glusterfs_tpu.index.xattrop"
XA_INDEX_COUNT = "glusterfs_tpu.index.count"
XA_INDEX_PRUNE = "glusterfs_tpu.index.prune"

DEFAULT_WATCH = "trusted.ec.dirty,trusted.afr.dirty"


def _nonzero(val: bytes) -> bool:
    return any(val)


@register("features/index")
class IndexLayer(Layer):
    OPTIONS = (
        Option("index-base", "path", default="",
               description="index store directory (default: "
                           "<posix-root>/.glusterfs_tpu/indices)"),
        Option("watchlist", "str", default=DEFAULT_WATCH,
               description="comma-separated pending xattr keys "
                           "(reference xattrop64-watchlist)"),
    )

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.watch = tuple(k.strip() for k in
                           str(self.opts["watchlist"]).split(",") if k.strip())
        self._dir: str | None = None

    async def init(self):
        base = self.opts.get("index-base")
        if not base:
            posix = self._find_posix(self)
            if posix is None:
                raise ValueError(f"{self.name}: no index-base and no "
                                 f"storage/posix descendant")
            base = os.path.join(posix.root, ".glusterfs_tpu", "indices")
        self._dir = os.path.join(os.path.abspath(base), "xattrop")
        os.makedirs(self._dir, exist_ok=True)
        await super().init()

    @staticmethod
    def _find_posix(layer: Layer):
        stack = list(layer.children)
        while stack:
            l = stack.pop()
            if l.type_name == "storage/posix":
                return l
            stack.extend(l.children)
        return None

    # -- the index itself ----------------------------------------------------

    def _entry(self, gfid: bytes) -> str:
        return os.path.join(self._dir, gfid.hex())

    def _add(self, gfid: bytes) -> None:
        try:
            with open(self._entry(gfid), "x"):
                pass
        except FileExistsError:
            pass
        except OSError as e:
            log.error(1, "%s: index add %s failed: %s",
                      self.name, gfid.hex(), e)

    def _del(self, gfid: bytes) -> None:
        try:
            os.unlink(self._entry(gfid))
        except FileNotFoundError:
            pass

    def list_entries(self) -> list[str]:
        try:
            return sorted(os.listdir(self._dir))
        except OSError:
            return []

    # -- tracking ------------------------------------------------------------

    async def _gfid_for(self, loc: Loc | None, fd: FdObj | None) -> bytes | None:
        if fd is not None and fd.gfid:
            return fd.gfid
        if loc is not None:
            if loc.gfid:
                return loc.gfid
            try:
                ia, _ = await self.children[0].lookup(loc)
                return ia.gfid
            except FopError:
                return None
        return None

    async def _track(self, loc: Loc | None, fd: FdObj | None,
                     values: dict) -> None:
        """Re-evaluate the index entry after watched keys changed to
        ``values`` (absolute resulting values, xattrop result or setxattr
        payload)."""
        touched = {k: v for k, v in values.items() if k in self.watch}
        if not touched:
            return
        gfid = await self._gfid_for(loc, fd)
        if gfid is None:
            return
        if any(_nonzero(v if isinstance(v, bytes) else bytes(v))
               for v in touched.values()):
            self._add(gfid)
            return
        # the touched markers are zero; the entry may only be dropped when
        # EVERY watched marker is zero (another cluster layer may still
        # have a pending mark on the same object)
        try:
            allx = await self.children[0].getxattr(
                Loc(loc.path if loc else "", gfid=gfid), None)
        except FopError:
            allx = {}
        if any(_nonzero(allx.get(k, b"")) for k in self.watch):
            return
        self._del(gfid)

    # -- intercepted fops ------------------------------------------------------

    async def xattrop(self, loc: Loc, op: str, xattrs: dict,
                      xdata: dict | None = None):
        out = await self.children[0].xattrop(loc, op, xattrs, xdata)
        await self._track(loc, None, out)
        return out

    async def fxattrop(self, fd: FdObj, op: str, xattrs: dict,
                       xdata: dict | None = None):
        out = await self.children[0].fxattrop(fd, op, xattrs, xdata)
        await self._track(None, fd, out)
        return out

    async def writev(self, fd: FdObj, data, offset: int = 0,
                     xdata: dict | None = None):
        """Compound pre-op: a ``pre-xattrop`` payload in xdata applies
        (and index-tracks) the dirty marker in the SAME brick round as
        the data write — the client saves a full fan-out wave, the
        crash-ordering guarantee is unchanged (marker lands before the
        data, both inside this one brick op)."""
        pre = (xdata or {}).get("pre-xattrop")
        if pre:
            xdata = {k: v for k, v in xdata.items() if k != "pre-xattrop"}
            await self.fxattrop(fd, "add64", dict(pre), None)
        return await self.children[0].writev(fd, data, offset, xdata)

    async def setxattr(self, loc: Loc, xattrs: dict, flags: int = 0,
                       xdata: dict | None = None):
        if XA_INDEX_PRUNE in xattrs:
            val = xattrs[XA_INDEX_PRUNE]
            hexgfid = (val.decode() if isinstance(val, bytes) else str(val))
            self._del(bytes.fromhex(hexgfid))
            return {}
        out = await self.children[0].setxattr(loc, xattrs, flags, xdata)
        await self._track(loc, None, xattrs)
        return out

    async def fsetxattr(self, fd: FdObj, xattrs: dict, flags: int = 0,
                        xdata: dict | None = None):
        out = await self.children[0].fsetxattr(fd, xattrs, flags, xdata)
        await self._track(None, fd, xattrs)
        return out

    async def getxattr(self, loc: Loc, name: str | None = None,
                       xdata: dict | None = None):
        if name == XA_INDEX_LIST:
            return {name: "\n".join(self.list_entries()).encode()}
        if name == XA_INDEX_COUNT:
            return {name: str(len(self.list_entries())).encode()}
        return await self.children[0].getxattr(loc, name, xdata)

    def dump_private(self) -> dict:
        return {"dir": self._dir, "pending": len(self.list_entries()),
                "watch": list(self.watch)}
