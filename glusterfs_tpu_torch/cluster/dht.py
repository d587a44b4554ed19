"""cluster/distribute — consistent-hash distribution of the namespace (DHT).

The port's copy of the JAX package's ``cluster/dht.py``: the same class,
options, hash and on-disk layout xattrs, so a distributed-disperse
volume places every file on the same group in both packages and each
mounts the bricks the other wrote.  Reference: xlators/cluster/dht.
Behaviors kept:

* **Placement** (dht-hashfn.c:72, dht-layout.c:20-94): a file lives on the
  subvolume whose hash range covers ``hash(basename)``; directories exist
  on every subvolume.  Per-directory hash ranges are PERSISTED in a
  ``trusted.glusterfs.dht`` xattr on each subvolume's copy of the
  directory (written at mkdir, read at first use, cached with a TTL);
  a directory without the xattr falls back to the derived even split.
  ``fix_layout`` rewrites ranges — optionally weighted — over the
  current child set (dht-selfheal.c layout set + fix-layout).
* **Linkto files** (dht-linkfile.c:95): after rename, a file whose data
  lives off its hashed subvolume leaves a zero-byte pointer file there
  carrying ``trusted.glusterfs.dht.linkto = <real subvol>``; lookup
  follows it.
* **Global lookup** (dht fan-out lookup): hashed-subvol miss falls back
  to an everywhere-lookup, healing the linkto.

Not in this package: rebalance and file migration
(dht-rebalance.c:39 dht_migrate_file), which need ``features/trash``
and ``mgmt/svcutil``.  :meth:`DistributeLayer.rebalance` raises; the
``rebal-*`` options are accepted and have no effect.

The hash is a Davies-Meyer-style 32-bit construction over the basename
(same family as the reference's gf_dm_hashfn; exact bit-compat is not
required since layouts are never exchanged with the reference).
"""

from __future__ import annotations

import errno
import os
import struct
import time

from ..core.fops import FopError
from ..core.iatt import IAType, gfid_new
from ..core.layer import FdObj, Layer, Loc, register
from ..core.options import Option
from ..core import gflog

log = gflog.get_logger("dht")

XA_LINKTO = "trusted.glusterfs.dht.linkto"
XA_LAYOUT = "trusted.glusterfs.dht"
# packed per-subvol range: (version, commit, start, stop) — the shape of
# the reference's on-disk layout record (dht-layout.c:20-94); commit is
# the layout generation (reference vol_commit_hash): when it matches the
# CURRENT child set, a miss at the range owner is authoritative and the
# everywhere-lookup is skipped (cluster.lookup-optimize semantics)
_LAYOUT_FMT = ">IIII"
LAYOUT_TTL = 5.0  # seconds a cached directory layout stays trusted


def dm_hash(name: str) -> int:
    """Davies-Meyer-style 32-bit hash over the basename."""
    h = 0x9747B28C
    for b in name.encode():
        # one DM round: encrypt h with byte-derived key, xor back in
        k = (b * 0x01000193) & 0xFFFFFFFF
        e = (h ^ k) & 0xFFFFFFFF
        e = (e * 0x85EBCA6B + 0xC2B2AE35) & 0xFFFFFFFF
        e ^= e >> 13
        h = (h ^ e) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x7FEB352D) & 0xFFFFFFFF
    h ^= h >> 15
    return h


class DhtFdCtx:
    __slots__ = ("idx", "child_fd")

    def __init__(self, idx: int, child_fd: FdObj):
        self.idx = idx
        self.child_fd = child_fd


@register("cluster/distribute")
class DistributeLayer(Layer):
    OPTIONS = (
        Option("lookup-unhashed", "bool", default="on",
               description="fan-out lookup on hashed-subvol miss"),
        Option("min-free-disk", "percent", default=10.0),
        Option("decommissioned", "str", default="",
               description="comma-separated child names leaving the "
               "volume (remove-brick start): excluded from the layout "
               "so no NEW data lands on them while rebalance drains "
               "them (dht decommission_node_map)"),
        Option("lookup-optimize", "bool", default="on",
               description="skip the everywhere-lookup on a miss when "
               "the directory's layout commit matches the current "
               "child set (cluster.lookup-optimize)"),
        Option("rebal-throttle", "enum", default="normal",
               values=("lazy", "normal", "aggressive"),
               description="migrator concurrency for rebalance/drain "
               "(cluster.rebal-throttle, dht-rebalance.c:3269: lazy "
               "yields to client I/O, aggressive saturates); "
               "reconfigurable mid-run"),
        Option("min-free-inodes", "percent", default=5.0,
               description="divert new files off a child whose free "
                           "inode share fell under this "
                           "(cluster.min-free-inodes, "
                           "dht_is_subvol_filled)"),
        Option("readdir-optimize", "bool", default="off",
               description="list DIRECTORY entries only from the first "
                           "up child — dirs exist on every child, the "
                           "other copies are redundant "
                           "(cluster.readdir-optimize; same caveat as "
                           "the reference: a dir missing there until "
                           "heal is briefly not listed)"),
        Option("rsync-hash-regex", "str", default="rsync",
               description="hash this capture instead of the raw name "
                           "('rsync' = the built-in ^\\.(.+)\\.[^.]+$ "
                           "pattern, 'none' = off): rsync temp names "
                           "land where their final name will "
                           "(cluster.rsync-hash-regex, dht extract_"
                           "regex)"),
        Option("extra-hash-regex", "str", default="none",
               description="second rename-pattern capture tried after "
                           "rsync-hash-regex (cluster.extra-hash-regex)"),
        Option("subvols-per-directory", "int", default=0, min=0,
               description="each directory's layout spans only this "
                           "many children, rotated by the path hash "
                           "(cluster.subvols-per-directory; 0 = all): "
                           "bounds per-dir fan-out on very wide "
                           "volumes"),
        Option("weighted-rebalance", "bool", default="on",
               description="fix-layout sizes hash ranges by child "
                           "capacity instead of evenly "
                           "(cluster.weighted-rebalance, "
                           "dht_get_du_info)"),
        Option("rebalance-stats", "bool", default="off",
               description="per-file timing in rebalance status "
                           "(cluster.rebalance-stats)"),
        Option("rebal-migrate-window", "size", default="4MB",
               description="copy window for file migration: the "
                           "migrator streams a file in windows of "
                           "this size instead of materializing it "
                           "whole (cluster.rebal-migrate-window)"),
    )

    #: reserved temp suffix for in-flight migration copies (hidden
    #: from listings like linkto files; the gateway reserves
    #: .gftpu.upload~ the same way)
    MIGRATE_SUFFIX = ".rebalance~"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.n = len(self.children)
        if self.n < 1:
            raise ValueError(f"{self.name}: needs >= 1 child")
        # persisted-layout cache: dirpath -> (expiry, ranges) where
        # ranges = [(start, stop, child_idx)] or None (= derived split)
        self._layouts: dict[str, tuple[float, list | None]] = {}
        self._recompute_active()

    def _recompute_active(self) -> None:
        gone = {s.strip() for s in
                self.opts["decommissioned"].split(",") if s.strip()}
        self._active = [i for i, c in enumerate(self.children)
                        if c.name not in gone]
        if not self._active:
            raise ValueError(f"{self.name}: every child decommissioned")
        # cached layouts (and their authoritative flags) were judged
        # against the OLD active set: a stale authoritative=True would
        # let lookup-optimize ENOENT files that moved routing
        self._layouts.clear()

    def reconfigure(self, options: dict) -> None:
        super().reconfigure(options)
        self._recompute_active()

    # -- placement ---------------------------------------------------------

    _RSYNC_RE = None  # compiled lazily; class-level cache

    def _munge_name(self, name: str) -> str:
        """cluster.rsync-hash-regex / extra-hash-regex: hash a rename
        pattern's capture so temp names hash where the final name will
        (dht_munge_name) — rsync's .NAME.XXXXXX otherwise lands on a
        random child and the final rename pays a migration."""
        import re

        for key in ("rsync-hash-regex", "extra-hash-regex"):
            spec = str(self.opts[key]).strip()
            if not spec or spec == "none":
                continue
            pat = r"^\.(.+)\.[^.]+$" if spec == "rsync" else spec
            try:
                m = re.match(pat, name)
            except re.error:
                continue
            if m and m.groups() and m.group(1):
                return m.group(1)
        return name

    def hashed_idx(self, name: str) -> int:
        """Even split of the 2^32 hash space over the ACTIVE children
        (dht_layout_t ranges; decommissioned nodes hold no range) —
        the DERIVED layout used when a directory has no persisted one."""
        span = (1 << 32) // len(self._active)
        return self._active[min(dm_hash(self._munge_name(name)) // span,
                                len(self._active) - 1)]

    def _hashed(self, loc: Loc) -> int:
        return self.hashed_idx(loc.name or loc.path.rsplit("/", 1)[-1])

    # -- persisted per-directory layouts (dht-layout.c / dht-selfheal.c) --

    @staticmethod
    def _parent_of(loc: Loc) -> str:
        p = loc.path.rstrip("/")
        return p.rsplit("/", 1)[0] or "/"

    def compute_ranges(self, weights: dict[str, float] | None = None,
                       seed: int = 0) -> list[tuple[int, int, int]]:
        """Split the 2^32 space over active children, proportionally to
        ``weights`` (by child NAME; missing = 1.0) — the weighted-layout
        capability derived layouts cannot express.

        cluster.subvols-per-directory: the split covers only that many
        children, rotated by ``seed`` (the directory path hash) so wide
        volumes spread directories without every dir spanning every
        child (dht_selfheal_layout_alloc spread-count)."""
        active = self._active
        spread = int(self.opts["subvols-per-directory"])
        if 0 < spread < len(active):
            start = seed % len(active)
            rot = active[start:] + active[:start]
            active = sorted(rot[:spread])
        ws = [max(0.0, float((weights or {}).get(
            self.children[i].name, 1.0))) for i in active]
        total = sum(ws) or float(len(active))
        ranges: list[tuple[int, int, int]] = []
        cursor = 0
        for pos, i in enumerate(active):
            stop = (1 << 32) - 1 if pos == len(active) - 1 else \
                cursor + max(1, int((1 << 32) * ws[pos] / total)) - 1
            stop = min(stop, (1 << 32) - 1)
            ranges.append((cursor, stop, i))
            cursor = stop + 1
            if cursor > (1 << 32) - 1:
                ranges.extend((0, -1, j) for j in active[pos + 1:])
                break
        return [r for r in ranges if r[1] >= r[0]]

    def _active_commit(self) -> int:
        """Layout generation for the CURRENT active child set (the
        vol_commit_hash analog): stored into every written layout, so a
        later child-set change makes old layouts non-authoritative."""
        return dm_hash("|".join(self.children[i].name
                                for i in self._active))

    async def _dir_meta(self, dirpath: str) -> tuple[list | None, bool]:
        """(persisted layout of ``dirpath`` or None, authoritative?).

        None layout = no child carries the xattr, or the union is
        anomalous (holes/overlap -> derived fallback; the reference
        treats those as needing a layout heal).  Authoritative = every
        record's commit matches the current child set, so a miss at the
        range owner proves absence (lookup-optimize)."""
        import time as _time

        hit = self._layouts.get(dirpath)
        now = _time.monotonic()
        if hit is not None and hit[0] > now:
            return hit[1], hit[2]
        loc = Loc(dirpath)
        ranges: list[tuple[int, int, int]] = []
        commits: set[int] = set()
        holders: list[int] = []
        found = False
        for i in range(self.n):
            try:
                out = await self.children[i].getxattr(loc, XA_LAYOUT)
            except FopError as e:
                if e.err not in (errno.ENOENT, errno.ESTALE):
                    # unreadable is not proof of absence (child down)
                    holders.append(i)
                continue
            holders.append(i)
            try:
                _v, commit, start, stop = struct.unpack(
                    _LAYOUT_FMT, out[XA_LAYOUT])
            except (KeyError, struct.error):
                continue
            found = True
            commits.add(commit)
            if stop >= start:
                ranges.append((start, stop, i))
        layout: list | None = None
        if found:
            ranges.sort()
            ok = bool(ranges) and ranges[0][0] == 0 and \
                ranges[-1][1] == (1 << 32) - 1 and \
                all(ranges[j][1] + 1 == ranges[j + 1][0]
                    for j in range(len(ranges) - 1))
            if ok:
                layout = ranges
            else:
                log.warning(2, "%s: anomalous layout on %s (%d ranges):"
                            " derived fallback", self.name, dirpath,
                            len(ranges))
        elif holders and len(holders) < self.n:
            # NO child carries a layout xattr and the directory exists
            # on a strict subset of children: a just-grown volume (the
            # pre-add-brick namespace had a single leg and no dht
            # records) before fix-layout reaches this directory.
            # Hashing over ALL children here would route new names at
            # a child with no parent to create them under; the
            # reference keeps such a directory on its existing subvols
            # until fix-layout stamps fresh ranges, so derive an even
            # split over the HOLDERS (never authoritative — a miss at
            # the derived owner proves nothing).
            span = (1 << 32) // len(holders)
            layout = [(j * span,
                       (1 << 32) - 1 if j == len(holders) - 1
                       else (j + 1) * span - 1, i)
                      for j, i in enumerate(holders)]
            commits.add(-1)
        authoritative = layout is not None and \
            commits == {self._active_commit()}
        self._layouts[dirpath] = (now + LAYOUT_TTL, layout, authoritative)
        if len(self._layouts) > 4096:  # bound: every entry re-derivable
            for k in list(self._layouts)[:2048]:
                self._layouts.pop(k, None)
        return layout, authoritative

    async def _dir_layout(self, dirpath: str) -> list | None:
        return (await self._dir_meta(dirpath))[0]

    async def _write_layout(self, dirpath: str,
                            ranges: list[tuple[int, int, int]]) -> None:
        """Persist one range per owning child on ITS copy of the dir;
        children that LOST their range (decommission + fix-layout) get
        the record removed, else the stale range overlaps the new union
        and every read degrades to the anomalous-layout fallback."""
        loc = Loc(dirpath)
        commit = self._active_commit()
        by_child = {idx: (start, stop) for start, stop, idx in ranges}
        for i in range(self.n):
            try:
                if i in by_child:
                    start, stop = by_child[i]
                    await self.children[i].setxattr(loc, {
                        XA_LAYOUT: struct.pack(_LAYOUT_FMT, 1, commit,
                                               start, stop)})
                else:
                    await self.children[i].removexattr(loc, XA_LAYOUT)
            except FopError as e:
                if e.err not in (errno.ENODATA, errno.ENOENT,
                                 errno.ESTALE):
                    log.warning(2, "%s: layout write on %s child %d: "
                                "%s", self.name, dirpath, i, e)
        import time as _time

        self._layouts[dirpath] = (_time.monotonic() + LAYOUT_TTL,
                                  sorted(ranges), True)

    async def _placed(self, loc: Loc) -> int:
        """Owning subvol for a basename per the parent's PERSISTED
        layout; derived split when none exists."""
        name = loc.name or loc.path.rsplit("/", 1)[-1]
        layout = await self._dir_layout(self._parent_of(loc))
        if layout:
            h = dm_hash(self._munge_name(name))
            for start, stop, idx in layout:
                if start <= h <= stop:
                    # a decommissioned child keeps its range until
                    # fix-layout; route around it like the derived path
                    return idx if idx in self._active else \
                        self.hashed_idx(name)
        return self.hashed_idx(name)

    async def fix_layout_dir(self, path: str,
                             weights: dict[str, float] | None = None
                             ) -> list[str]:
        """ONE directory's share of ``rebalance fix-layout``: create
        missing directory copies (a just-added brick has none),
        pre-place linktos for names the new ranges re-home, persist
        the new ranges.  No recursion — the rebalance daemon drives
        this per directory so its walk can CHECKPOINT between
        directories; returns the subdirectory names for the caller's
        descent.  Data stays put — only NEW names follow the new
        layout; the migration phase moves existing files."""
        loc = Loc(path)
        src = None
        for i in range(self.n):
            try:
                ia, _ = await self.children[i].lookup(loc)
                src = (i, ia)
                break
            except FopError:
                continue
        if src is None:
            raise FopError(errno.ENOENT, path)
        for i in self._active:
            if i == src[0]:
                continue
            try:
                await self.children[i].lookup(loc)
            except FopError:
                try:
                    await self.children[i].mkdir(
                        loc, src[1].mode & 0o7777,
                        {"gfid-req": src[1].gfid})
                except FopError:
                    pass
        ranges = self.compute_ranges(weights, seed=dm_hash(path))

        def owner_of(name: str) -> int:
            h = dm_hash(self._munge_name(name))
            for start, stop, idx in ranges:
                if start <= h <= stop:
                    return idx
            return self.hashed_idx(name)

        # walk under the OLD layout first: names the NEW ranges re-home
        # get a linkto at their new owner (dht_linkfile) BEFORE the new
        # layout goes live, so lookup-optimize's authoritative miss can
        # never lose a pre-fix file — its new position either holds the
        # file or points at it
        fd = await self.opendir(loc)
        try:
            entries = await self.readdirp(fd)
        finally:
            await self.release(fd)
        subdirs: list[str] = []
        for name, ia in entries:
            if ia is not None and ia.ia_type is IAType.DIR:
                subdirs.append(name)
                continue
            child = path.rstrip("/") + "/" + name
            cloc = Loc(child)
            try:
                cur = await self._cached_idx(cloc)
            except FopError:
                continue
            new_owner = owner_of(name)
            if new_owner != cur:
                try:
                    await self.children[new_owner].lookup(cloc)
                except FopError:
                    gfid = (await self.children[cur].lookup(cloc))[0].gfid
                    await self._make_linkto(new_owner, cloc, cur, gfid)
        await self._write_layout(path, ranges)
        return subdirs

    async def fix_layout(self, path: str = "/",
                         weights: dict[str, float] | None = None) -> dict:
        """Recompute + persist every directory's ranges over the CURRENT
        active children (``rebalance fix-layout``), recursively —
        the one-shot in-process form; the managed rebalance daemon
        runs the same per-directory step under its checkpointed walk."""
        if weights is None and self.opts["weighted-rebalance"]:
            weights = await self._capacity_weights()
        subdirs = await self.fix_layout_dir(path, weights)
        fixed = 1
        for name in subdirs:
            sub = await self.fix_layout(
                path.rstrip("/") + "/" + name, weights)
            fixed += sub["fixed"]
        return {"fixed": fixed, "path": path}

    async def _cached_idx(self, loc: Loc) -> int:
        """Subvol actually holding the file: hashed, linkto target, or
        global-lookup result (dht cached-subvol resolution)."""
        hi = await self._placed(loc)
        try:
            ia, _ = await self.children[hi].lookup(loc)
            if ia.ia_type is IAType.DIR:
                return hi
            link = await self._linkto(hi, loc)
            if link is not None:
                return link
            return hi
        except FopError as e:
            if e.err not in (errno.ENOENT, errno.ESTALE):
                raise
        if not self.opts["lookup-unhashed"]:
            raise FopError(errno.ENOENT, loc.path)
        if self.opts["lookup-optimize"] and loc.path:
            # an up-to-date persisted layout proves absence: every name
            # placed under it went to its range owner, and fix-layout
            # leaves linktos there for names the layout re-homed — the
            # fan-out would find nothing (cluster.lookup-optimize).
            # gfid-only locs (handle API) carry no name to place, so
            # they always take the everywhere pass.
            _, authoritative = await self._dir_meta(self._parent_of(loc))
            if authoritative:
                raise FopError(errno.ENOENT, loc.path)
        for i in range(self.n):  # everywhere-lookup
            if i == hi:
                continue
            try:
                await self.children[i].lookup(loc)
                return i
            except FopError:
                continue
        raise FopError(errno.ENOENT, loc.path)

    async def _linkto(self, idx: int, loc: Loc) -> int | None:
        try:
            out = await self.children[idx].getxattr(loc, XA_LINKTO)
        except FopError:
            return None
        target = out[XA_LINKTO].decode()
        for i, c in enumerate(self.children):
            if c.name == target:
                return i
        return None

    # -- namespace fops ----------------------------------------------------

    async def _with_cached(self, loc: Loc, call):
        """Resolve + run with ONE re-resolution retry: a file being
        migrated can have its pointer torn down between our resolution
        and the fop (linkto followed to the source just as the
        migrator dropped it) — the reference heals this with
        lookup-everywhere on ESTALE (dht_lookup_everywhere); here the
        re-resolution finds the committed destination."""
        idx = await self._cached_idx(loc)
        try:
            return await call(idx)
        except FopError as e:
            if e.err not in (errno.ENOENT, errno.ESTALE):
                raise
            idx2 = await self._cached_idx(loc)
            if idx2 == idx:
                raise
            return await call(idx2)

    async def lookup(self, loc: Loc, xdata: dict | None = None):
        return await self._with_cached(
            loc, lambda i: self.children[i].lookup(loc, xdata))

    async def stat(self, loc: Loc, xdata: dict | None = None):
        return await self._with_cached(
            loc, lambda i: self.children[i].stat(loc, xdata))

    async def lease(self, loc: Loc, cmd: str, ltype: str = "rd",
                    lease_id: str = "", xdata: dict | None = None):
        # leases must live where the writes land: route to the cached
        # subvol (the default first-child wind would park the lease on
        # a brick the hashed writer never touches, so conflicting
        # writes would never recall it)
        return await self._with_cached(
            loc, lambda i: self.children[i].lease(loc, cmd, ltype,
                                                  lease_id, xdata))

    async def fstat(self, fd: FdObj, xdata: dict | None = None):
        ctx: DhtFdCtx = fd.ctx_get(self)
        if ctx is None:
            return await self.stat(Loc(fd.path, gfid=fd.gfid), xdata)
        return await self.children[ctx.idx].fstat(ctx.child_fd, xdata)

    async def mkdir(self, loc: Loc, mode: int = 0o755,
                    xdata: dict | None = None):
        self._check_reserved(loc)
        xdata = dict(xdata or {})
        xdata.setdefault("gfid-req", gfid_new())
        results = []
        errs = []
        for i in range(self.n):  # directories live everywhere
            try:
                results.append(await self.children[i].mkdir(loc, mode, xdata))
            except FopError as e:
                errs.append(e)
        if not results:
            raise errs[0]
        # persist the new directory's hash ranges (dht_selfheal_dir:
        # every fresh dir gets a layout written at creation)
        await self._write_layout(loc.path,
                                 self.compute_ranges(
                                     seed=dm_hash(loc.path)))
        return results[0]

    async def rmdir(self, loc: Loc, flags: int = 0,
                    xdata: dict | None = None):
        last = None
        ok = 0
        for i in range(self.n):
            try:
                await self.children[i].rmdir(loc, flags, xdata)
                ok += 1
            except FopError as e:
                if e.err != errno.ENOENT:
                    last = e
        if ok == 0 and last:
            raise last
        return {}

    async def _sched(self, loc: Loc) -> int:
        """Which subvol NEW files land on: the parent's persisted
        layout, DIVERTED when that child is over the free-space or
        free-inode floor (dht_is_subvol_filled / dht_free_disk_
        available_subvol: the create lands on the roomiest child and
        the hashed position gets a linkto).  The nufa/switch variants
        override this with their policy placement (dht_methods)."""
        idx = await self._placed(loc)
        if await self._subvol_filled(idx):
            best, best_free = None, -1.0
            for i in self._active:
                if i == idx or await self._subvol_filled(i):
                    continue
                free = (self._du.get(i) or (0, 0.0, 0.0))[1]
                if free > best_free:
                    best, best_free = i, free
            if best is not None:
                return best
        return idx

    _DU_TTL = 5.0  # seconds a child's statfs sample stays trusted

    async def _subvol_filled(self, i: int) -> bool:
        """Cached per-child statfs vs cluster.min-free-disk/-inodes."""
        du = getattr(self, "_du", None)
        if du is None:
            du = self._du = {}
        ent = du.get(i)
        now = time.monotonic()
        if ent is None or now - ent[0] > self._DU_TTL:
            try:
                sv = await self.children[i].statfs(Loc("/"))
                blocks = max(1, sv.get("blocks", 1))
                files = max(1, sv.get("files", 1) or 1)
                ent = (now, sv.get("bavail", blocks) / blocks * 100.0,
                       sv.get("ffree", files) / files * 100.0)
            except (FopError, AttributeError):
                ent = (now, 100.0, 100.0)  # unknowable: don't divert
            du[i] = ent
        return ent[1] < float(self.opts["min-free-disk"]) or \
            ent[2] < float(self.opts["min-free-inodes"])

    async def _capacity_weights(self) -> dict[str, float]:
        """cluster.weighted-rebalance: child capacity shares for
        fix-layout range sizing (dht_get_du_info)."""
        out: dict[str, float] = {}
        for i in self._active:
            try:
                sv = await self.children[i].statfs(Loc("/"))
                out[self.children[i].name] = float(
                    max(1, sv.get("blocks", 1)))
            except (FopError, AttributeError):
                out[self.children[i].name] = 1.0
        total = sum(out.values())
        return {k: v / total * len(out) for k, v in out.items()}

    def _check_reserved(self, loc: Loc) -> None:
        """Refuse user names carrying the reserved migration suffix:
        such a name would be hidden from every listing (the temp
        filter) and then unconditionally reclaimed by the rebalance
        orphan sweep — accepted, it silently hides and later silently
        DELETES user data.  The migrator itself never enters through
        this layer (it drives the children directly)."""
        name = loc.path.rstrip("/").rpartition("/")[2]
        if name.endswith(self.MIGRATE_SUFFIX):
            raise FopError(
                errno.EPERM,
                f"{loc.path}: the {self.MIGRATE_SUFFIX!r} suffix is "
                "reserved for migration temps")

    async def create(self, loc: Loc, flags: int = 0, mode: int = 0o644,
                     xdata: dict | None = None):
        self._check_reserved(loc)
        if flags & os.O_EXCL:
            # O_EXCL must see the file ANYWHERE: the scheduler may
            # target a subvol other than the holder (nufa/switch local
            # placement, layout drift), and creating there would FORK
            # the file — two data copies, the old one orphaned.
            # Resolution costs one child probe under an authoritative
            # layout (linktos stand in for re-homed names).
            try:
                await self._cached_idx(loc)
            except FopError as e:
                if e.err not in (errno.ENOENT, errno.ESTALE):
                    raise
            else:
                raise FopError(errno.EEXIST, loc.path)
        idx = await self._sched(loc)
        fd_c, ia = await self.children[idx].create(loc, flags, mode, xdata)
        hi = await self._placed(loc)
        if hi != idx:
            # scheduled off the hashed subvol: leave the lookup pointer
            # (dht_linkfile_create in nufa_create_cbk / switch)
            await self._make_linkto(hi, loc, idx, ia.gfid)
        fd = FdObj(ia.gfid, flags, path=loc.path)
        fd.ctx_set(self, DhtFdCtx(idx, fd_c))
        return fd, ia

    async def open(self, loc: Loc, flags: int = 0, xdata: dict | None = None):
        fds: dict = {}

        async def one(i):
            fds["idx"] = i
            return await self.children[i].open(loc, flags, xdata)

        fd_c = await self._with_cached(loc, one)
        fd = FdObj(fd_c.gfid, flags, path=loc.path)
        fd.ctx_set(self, DhtFdCtx(fds["idx"], fd_c))
        return fd

    async def mknod(self, loc: Loc, mode: int = 0o644, rdev: int = 0,
                    xdata: dict | None = None):
        self._check_reserved(loc)
        idx = await self._sched(loc)
        ia = await self.children[idx].mknod(loc, mode, rdev, xdata)
        hi = await self._placed(loc)
        if hi != idx:
            await self._make_linkto(hi, loc, idx, ia.gfid)
        return ia

    async def symlink(self, target: str, loc: Loc, xdata: dict | None = None):
        self._check_reserved(loc)
        return await self.children[await self._placed(loc)].symlink(
            target, loc, xdata)

    async def readlink(self, loc: Loc, xdata: dict | None = None):
        idx = await self._cached_idx(loc)
        return await self.children[idx].readlink(loc, xdata)

    async def unlink(self, loc: Loc, xdata: dict | None = None):
        idx = await self._cached_idx(loc)
        hi = await self._placed(loc)
        if idx != hi:  # drop the linkto too
            try:
                await self.children[hi].unlink(loc, xdata)
            except FopError:
                pass
        return await self.children[idx].unlink(loc, xdata)

    async def link(self, oldloc: Loc, newloc: Loc, xdata: dict | None = None):
        self._check_reserved(newloc)
        idx = await self._cached_idx(oldloc)
        return await self.children[idx].link(oldloc, newloc, xdata)

    async def rename(self, oldloc: Loc, newloc: Loc,
                     xdata: dict | None = None):
        self._check_reserved(newloc)
        src = await self._cached_idx(oldloc)
        ia, _ = await self.children[src].lookup(oldloc)
        if ia.ia_type is IAType.DIR:  # dirs: rename everywhere
            out = None
            for i in range(self.n):
                try:
                    out = await self.children[i].rename(oldloc, newloc, xdata)
                except FopError:
                    pass
            if out is None:
                raise FopError(errno.EIO, "dir rename failed everywhere")
            return out
        dst_hashed = await self._placed(newloc)
        # POSIX rename overwrites an existing destination.  The rename on
        # src only replaces a same-subvol dst; a live dst file elsewhere
        # must be unlinked, or _make_linkto would silently convert it into
        # a pointer and orphan its data (reference dht_rename unlinks the
        # dst cached file).  Resolve dst BEFORE the rename (afterwards the
        # lookup would find the renamed file) but unlink only AFTER it
        # succeeds — a failed rename must leave dst intact.
        try:
            dst_cached = await self._cached_idx(newloc)
        except FopError:
            dst_cached = None
        out = await self.children[src].rename(oldloc, newloc, xdata)
        for i in {dst_cached, dst_hashed} - {None, src}:
            try:
                await self.children[i].unlink(newloc)
            except FopError:
                pass
        if dst_hashed != src:
            # data stayed on src subvol: leave a linkto pointer at the
            # dst-hashed subvol (dht-linkfile.c:95)
            await self._make_linkto(dst_hashed, newloc, src, ia.gfid)
        # stale linkto at old hashed location?
        old_hashed = await self._placed(oldloc)
        if old_hashed != src:
            try:
                await self.children[old_hashed].unlink(oldloc)
            except FopError:
                pass
        return out

    async def _make_linkto(self, idx: int, loc: Loc, target: int,
                           gfid: bytes) -> None:
        try:
            await self.children[idx].mknod(loc, 0o1000, 0,
                                           {"gfid-req": gfid})
        except FopError as e:
            if e.err != errno.EEXIST:
                raise
        await self.children[idx].setxattr(
            loc, {XA_LINKTO: self.children[target].name.encode()})

    # -- data fops (forward to cached subvol) ------------------------------

    async def _fd_target(self, fd: FdObj) -> tuple[int, FdObj]:
        ctx: DhtFdCtx | None = fd.ctx_get(self)
        if ctx is not None:
            return ctx.idx, ctx.child_fd
        # fd from a retired graph (hot graph swap) or anonymous: resolve
        # the cached subvol again and address by gfid (the reference
        # migrates fds onto the new graph; anonymous fds carry it here)
        if not fd.path and not fd.gfid:
            raise FopError(errno.EBADF, "dht: unknown fd")
        idx = await self._cached_idx(Loc(fd.path, gfid=fd.gfid))
        cfd = FdObj(fd.gfid, fd.flags, path=fd.path, anonymous=True)
        fd.ctx_set(self, DhtFdCtx(idx, cfd))
        return idx, cfd

    async def readv(self, fd: FdObj, size: int, offset: int,
                    xdata: dict | None = None):
        i, cfd = await self._fd_target(fd)
        return await self.children[i].readv(cfd, size, offset, xdata)

    async def writev(self, fd: FdObj, data, offset: int,
                     xdata: dict | None = None):
        i, cfd = await self._fd_target(fd)
        return await self.children[i].writev(cfd, data, offset, xdata)

    async def xorv(self, fd: FdObj, data, offset: int,
                   xdata: dict | None = None):
        # routed like writev (fd-addressed data fop): the base-class
        # first-child default would land the delta on the wrong subvol
        i, cfd = await self._fd_target(fd)
        return await self.children[i].xorv(cfd, data, offset, xdata)

    async def flush(self, fd: FdObj, xdata: dict | None = None):
        i, cfd = await self._fd_target(fd)
        return await self.children[i].flush(cfd, xdata)

    async def fsync(self, fd: FdObj, datasync: int = 0,
                    xdata: dict | None = None):
        i, cfd = await self._fd_target(fd)
        return await self.children[i].fsync(cfd, datasync, xdata)

    async def ftruncate(self, fd: FdObj, size: int,
                        xdata: dict | None = None):
        i, cfd = await self._fd_target(fd)
        return await self.children[i].ftruncate(cfd, size, xdata)

    async def fallocate(self, fd: FdObj, mode: int, offset: int,
                        length: int, xdata: dict | None = None):
        i, cfd = await self._fd_target(fd)
        return await self.children[i].fallocate(cfd, mode, offset, length,
                                                xdata)

    async def discard(self, fd: FdObj, offset: int, length: int,
                      xdata: dict | None = None):
        i, cfd = await self._fd_target(fd)
        return await self.children[i].discard(cfd, offset, length, xdata)

    async def zerofill(self, fd: FdObj, offset: int, length: int,
                       xdata: dict | None = None):
        i, cfd = await self._fd_target(fd)
        return await self.children[i].zerofill(cfd, offset, length, xdata)

    async def seek(self, fd: FdObj, offset: int, what: str = "data",
                   xdata: dict | None = None):
        i, cfd = await self._fd_target(fd)
        return await self.children[i].seek(cfd, offset, what, xdata)

    async def release(self, fd: FdObj):
        ctx = fd.ctx_del(self)
        if isinstance(ctx, dict):
            # directory fd (opendir fans out): one child fd per subvol
            for i, cfd in ctx.items():
                rel = getattr(self.children[i], "release", None)
                if rel:
                    await rel(cfd)
        elif ctx:
            rel = getattr(self.children[ctx.idx], "release", None)
            if rel:
                await rel(ctx.child_fd)

    async def truncate(self, loc: Loc, size: int, xdata: dict | None = None):
        idx = await self._cached_idx(loc)
        return await self.children[idx].truncate(loc, size, xdata)

    async def setattr(self, loc: Loc, attrs: dict, valid: int = 0,
                      xdata: dict | None = None):
        idx = await self._cached_idx(loc)
        ia, _ = await self.children[idx].lookup(loc)
        if ia.ia_type is IAType.DIR:
            out = None
            for i in range(self.n):
                try:
                    out = await self.children[i].setattr(loc, attrs, valid,
                                                         xdata)
                except FopError:
                    pass
            return out
        return await self.children[idx].setattr(loc, attrs, valid, xdata)

    async def setxattr(self, loc: Loc, xattrs: dict, flags: int = 0,
                       xdata: dict | None = None):
        idx = await self._cached_idx(loc)
        return await self.children[idx].setxattr(loc, xattrs, flags, xdata)

    async def getxattr(self, loc: Loc, name: str | None = None,
                       xdata: dict | None = None):
        idx = await self._cached_idx(loc)
        out = await self.children[idx].getxattr(loc, name, xdata)
        if name is None:
            out.pop(XA_LINKTO, None)
        return out

    async def removexattr(self, loc: Loc, name: str,
                          xdata: dict | None = None):
        idx = await self._cached_idx(loc)
        return await self.children[idx].removexattr(loc, name, xdata)

    async def statfs(self, loc: Loc, xdata: dict | None = None):
        """Aggregate capacity across subvols (dht sums them)."""
        out = None
        for i in range(self.n):
            try:
                sv = await self.children[i].statfs(loc, xdata)
            except FopError:
                continue
            if out is None:
                out = dict(sv)
            else:
                for k in ("blocks", "bfree", "bavail", "files", "ffree"):
                    out[k] += sv[k]
        if out is None:
            raise FopError(errno.ENOTCONN, "no children for statfs")
        return out

    # -- directory reads: merge all subvols --------------------------------

    async def opendir(self, loc: Loc, xdata: dict | None = None):
        fds = {}
        gfid = None
        for i in range(self.n):
            try:
                cfd = await self.children[i].opendir(loc, xdata)
                fds[i] = cfd
                gfid = gfid or cfd.gfid
            except FopError:
                continue
        if not fds:
            raise FopError(errno.ENOENT, loc.path)
        fd = FdObj(gfid, path=loc.path)
        fd.ctx_set(self, fds)
        return fd

    async def readdir(self, fd: FdObj, size: int = 0, offset: int = 0,
                      xdata: dict | None = None):
        fds: dict = fd.ctx_get(self) or {}
        seen: set[str] = set()
        out = []
        rd_opt = self.opts["readdir-optimize"]
        first_up = None  # first child that actually ANSWERS readdir
        for i, cfd in fds.items():
            try:
                entries = await self.children[i].readdir(cfd, size, 0, xdata)
            except FopError:
                continue
            if first_up is None:
                first_up = i
            for name, ia in entries:
                if name in seen:
                    continue
                if name.endswith(self.MIGRATE_SUFFIX):
                    # in-flight (or crash-orphaned) migration copy:
                    # reserved namespace, never listed — like the
                    # linkto pointers below
                    continue
                if rd_opt and i != first_up and ia is not None and \
                        ia.ia_type is IAType.DIR:
                    # cluster.readdir-optimize: directories exist on
                    # every child — list them from the first one only
                    # (dht_readdirp_cbk; same caveat as the reference:
                    # a dir copy pending heal there goes unlisted)
                    continue
                # hide linkto pointer files
                if await self._is_linkto(i, fd.path, name):
                    continue
                seen.add(name)
                out.append((name, ia))
        out.sort(key=lambda e: e[0])
        return out[offset:]

    async def _is_linkto(self, idx: int, dirpath: str, name: str) -> bool:
        child = dirpath.rstrip("/") + "/" + name
        try:
            await self.children[idx].getxattr(Loc(child), XA_LINKTO)
            return True
        except FopError:
            return False

    async def readdirp(self, fd: FdObj, size: int = 0, offset: int = 0,
                       xdata: dict | None = None):
        entries = await self.readdir(fd, size, offset, xdata)
        out = []
        for name, ia in entries:
            if ia is None:
                try:
                    ia = await self.stat(
                        Loc(fd.path.rstrip("/") + "/" + name))
                except FopError:
                    pass
            out.append((name, ia))
        return out

    async def rebalance(self, path: str = "/") -> dict:
        """Not in this package: migration needs features/trash (its
        internal-op unlinks) and mgmt/svcutil (its throttle), which the
        port does not have yet."""
        raise NotImplementedError(
            f"{self.name}: rebalance and file migration are not ported "
            "to glusterfs_tpu_torch (they need features/trash and "
            "mgmt/svcutil)")

    async def compound(self, links, xdata: dict | None = None) -> list:
        """Single-subvolume fast path: on a one-brick distribute volume
        a self-contained chain (every fd it creates is released by a
        later link of the same chain) forwards intact — there is no
        alternative placement, no linkto bookkeeping, and no dht fd
        context can leak.  Everything else decomposes through the
        normal routed fops."""
        from ..rpc import compound as cfop

        if len(self.children) == 1 and len(self._active) == 1:
            produced = set()
            released = set()
            for i, (fop, args, _kw) in enumerate(links):
                if fop in cfop.FD_PRODUCERS:
                    produced.add(i)
                elif fop == "release" and args and \
                        isinstance(args[0], cfop.FdRef):
                    released.add(args[0].index)
            if produced <= released:
                # translate caller-owned fds to the CHILD fd (the
                # per-fop _fd_target step) — forwarding the dht-level
                # FdObj would silently degrade every fused write to an
                # anonymous gfid-addressed fd re-opened per op
                fwd = []
                for fop, args, kwargs in links:
                    nargs = []
                    for a in args:
                        if isinstance(a, FdObj):
                            _idx, a = await self._fd_target(a)
                        nargs.append(a)
                    nkw = {}
                    for k, v in kwargs.items():
                        if isinstance(v, FdObj):
                            _idx, v = await self._fd_target(v)
                        nkw[k] = v
                    fwd.append((fop, tuple(nargs), nkw))
                return await self.children[0].compound(fwd, xdata)
        return await cfop.decompose(self, links, xdata)

    def dump_private(self) -> dict:
        span = (1 << 32) // len(self._active)
        ranges = {idx: [j * span, (j + 1) * span - 1]
                  for j, idx in enumerate(self._active)}
        return {"subvolumes": self.n,
                "layout": [{"subvol": c.name,
                            "range": ranges.get(i, "decommissioned")}
                           for i, c in enumerate(self.children)]}
