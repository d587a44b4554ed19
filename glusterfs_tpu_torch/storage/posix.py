"""storage/posix — the brick: maps fops to a local filesystem directory.

Reference: xlators/storage/posix (posix-inode-fd-ops.c:1999 posix_writev,
posix-helpers.c:1352 GFID handle store).  Same responsibilities here:

* every object gets a GFID at creation.  Identity store, mirroring the
  reference's ``.glusterfs/xx/yy/gfid`` hardlink farm (posix-handle.h):
  - ``.glusterfs_tpu/handle/<hex>`` — a HARDLINK to the inode for regular
    files and symlinks.  fd-based fops resolve through it, so they stay
    correct when the path changes under them (rename, one of several hard
    links removed) and the inode cannot be reused while its gfid lives.
  - ``.glusterfs_tpu/gfid/<hex>`` — a text record: line 1 the dev:ino
    sidecar key, rest the current path (a best-effort hint for files, the
    authoritative mapping for directories, which cannot be hardlinked).
  Renaming a directory updates its own record; records of objects deeper
  in the tree keep working for files (handles) but directory hints below
  a renamed directory go stale — the reference's ancestry symlinks solve
  this; path-based fops (the normal access) are unaffected.
* xattrs (the version/dirty/size accounting written by EC/AFR) live in a
  sidecar JSON per GFID under ``.glusterfs_tpu/xattr/`` — independent of
  host-FS xattr support, atomically replaced on update.
* ``xattrop`` implements the atomic read-modify-write arithmetic the
  cluster layers' transactions depend on (reference posix xattrop).

Fops run under the layer's asyncio context; filesystem calls are blocking
but local (the io-threads analog can wrap this layer with a thread pool).
"""

from __future__ import annotations

import asyncio
import errno
import json
import os
import struct
import time
import zlib

from ..core.fops import FopError
from ..core.iatt import IAType, Iatt, ROOT_GFID, gfid_new
from ..core.layer import FdObj, Layer, Loc, register
from ..core.options import Option
from ..core import gflog

log = gflog.get_logger("posix")

META_DIR = ".glusterfs_tpu"

# virtual xattr: resolve a gfid-loc to its recorded volume path
# (reference glusterfs.gfid2path, posix-inode-fd-ops.c); the shd's
# gfid -> healable-path step rides on it
XA_GFID2PATH = "glusterfs_tpu.gfid2path"
# virtual xattr prefix: list gfids carrying a given xattr key
XA_SCAN_PREFIX = "glusterfs_tpu.scan."


def _fop_errno(e: OSError) -> FopError:
    return FopError(e.errno or errno.EIO, str(e))


FALLOC_FL_KEEP_SIZE = 0x01
FALLOC_FL_PUNCH_HOLE = 0x02

try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL(None, use_errno=True)
    _libc_fallocate = _libc.fallocate
except (OSError, AttributeError):  # non-Linux: posix_fallocate fallback
    _libc_fallocate = None


def _hex_val(v) -> str:
    """Canonical sidecar encoding of one xattr value (bytes -> hex;
    anything else through its str form) — create's init-xattrs and
    setxattr must stay byte-identical."""
    return (v if isinstance(v, bytes) else str(v).encode()).hex()


def split_gfid_record(content: str) -> tuple[str, str]:
    """Parse a gfid record -> (inokey, relpath).  Modern records are
    'dev:ino\\nrelpath' with a possibly-EMPTY key line (root is recorded
    before its first bind); legacy single-line records are the path
    alone (paths may legally contain newlines, which is why the key
    comes first and is validated, not the path)."""
    inokey, sep, relpath = content.partition("\n")
    if not sep:
        return "", content  # legacy single-line path
    if inokey and (":" not in inokey
                   or not inokey.replace(":", "").isdigit()):
        return "", content  # legacy path that itself contains newlines
    return inokey, relpath


def fold_journal(root: str) -> None:
    """Materialize a (quiesced/copied) brick store's sidecar journal:
    xattr records into the per-gfid JSON files, binding records into
    gfid pointer files.  Only safe on a store no live brick process is
    appending to (a snapshot copy, a restore target)."""
    xattr_dir = os.path.join(root, META_DIR, "xattr")
    gfid_dir = os.path.join(root, META_DIR, "gfid")
    journal = os.path.join(xattr_dir, "journal.jsonl")
    if not os.path.exists(journal):
        return
    with open(journal) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if "b" in rec:
                ghex, key, rel = rec["b"]
                gp = os.path.join(gfid_dir, ghex)
                # surrogateescape like _gfid_set: non-UTF-8 filenames
                # round-trip the journal as surrogates and a strict
                # text write would crash the fold mid-journal
                fd = os.open(gp + ".tmp",
                             os.O_CREAT | os.O_WRONLY | os.O_TRUNC,
                             0o644)
                try:
                    os.write(fd, (key + "\n" + rel)
                             .encode("utf-8", "surrogateescape"))
                finally:
                    os.close(fd)
                os.replace(gp + ".tmp", gp)
                continue
            if "u" in rec:
                try:
                    os.unlink(os.path.join(gfid_dir, rec["u"]))
                except OSError:
                    pass
                continue
            p = os.path.join(xattr_dir, rec["g"] + ".json")
            if rec["x"] is None:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            else:
                with open(p + ".tmp", "w") as g:
                    json.dump(rec["x"], g)
                os.replace(p + ".tmp", p)
    os.unlink(journal)


def _journal_ino_map(xattr_dir: str) -> dict[str, str]:
    """dev:ino -> gfid hex from a journal's binding records (read-only:
    for indexing a LIVE source store whose journal we must not fold)."""
    out: dict[str, str] = {}
    try:
        with open(os.path.join(xattr_dir, "journal.jsonl")) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if "b" in rec:
                    ghex, key, _rel = rec["b"]
                    out[key] = ghex
                elif "u" in rec:
                    dead = rec["u"]
                    for k in [k for k, v in out.items() if v == dead]:
                        del out[k]
    except FileNotFoundError:
        pass
    return out


def rebuild_identity(root: str) -> int:
    """Re-key a brick store's identity after a file-level copy (snapshot
    restore): the dev:ino sidecars and the handle hardlink farm both
    refer to the ORIGINAL inodes, so every gfid would resolve stale and
    lookups would mint fresh gfids over the copied xattrs.  Walk the
    gfid records, rebind each to the copied file, and rebuild the
    handles.  Returns the number of rebound objects.  (The reference
    avoids this by snapshotting at the block layer — LVM preserves
    inodes; a store-level copy cannot.)"""
    gfid_dir = os.path.join(root, META_DIR, "gfid")
    xattr_dir = os.path.join(root, META_DIR, "xattr")
    handle_dir = os.path.join(root, META_DIR, "handle")
    if not os.path.isdir(gfid_dir):
        return 0
    # fold any sidecar journal into the materialized files first, so
    # the rebinding walk below sees the real final state.  Binding
    # records ("b"/"u") materialize as gfid pointer files — the ino-
    # sidecars they'd also produce are about to be wiped and rebuilt
    # against the copied inodes anyway.
    fold_journal(root)
    for d, pred in ((xattr_dir, lambda n: n.startswith("ino-")),
                    (handle_dir, lambda n: True)):
        if os.path.isdir(d):
            for n in os.listdir(d):
                if pred(n):
                    try:
                        os.unlink(os.path.join(d, n))
                    except OSError:
                        pass
    os.makedirs(handle_dir, exist_ok=True)
    count = 0
    for hexg in os.listdir(gfid_dir):
        if hexg.endswith(".tmp"):
            continue
        rec = os.path.join(gfid_dir, hexg)
        try:
            with open(rec) as f:
                _, relpath = split_gfid_record(f.read())
        except OSError:
            continue
        ap = os.path.normpath(os.path.join(root, relpath.lstrip("/")))
        if not os.path.lexists(ap):
            # object not in this copy: drop the orphaned identity
            for p in (rec, os.path.join(xattr_dir, hexg + ".json")):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            continue
        st = os.lstat(ap)
        key = f"{st.st_dev}:{st.st_ino}"
        with open(os.path.join(xattr_dir, "ino-" + key), "wb") as f:
            f.write(bytes.fromhex(hexg))
        with open(rec + ".tmp", "w") as f:
            f.write(key + "\n" + relpath)
        os.replace(rec + ".tmp", rec)
        if not os.path.isdir(ap):
            try:
                os.link(ap, os.path.join(handle_dir, hexg),
                        follow_symlinks=False)
            except OSError:
                pass
        count += 1
    return count


def snapshot_copy(src_root: str, dst_root: str) -> None:
    """Copy a brick store for a snapshot (glusterd-snapshot.c analog at
    the store level).  The handle hardlink farm is skipped — in a
    file-level copy it would duplicate every file's bytes; it is
    rebuilt by :func:`rebuild_identity` at restore.  The copied gfid
    records' path hints are then refreshed from a live dev:ino walk of
    the source: hints go stale under directory renames (only the
    renamed object's own record is rewritten), and a stale hint at
    restore would silently drop that object's identity and versioning
    xattrs.  Run under an armed barrier so the tree is stable."""
    import shutil

    def _skip_handles(d, names):
        return names if os.path.normpath(d).endswith(
            os.path.join(META_DIR, "handle")) else []

    shutil.copytree(src_root, dst_root, ignore=_skip_handles,
                    symlinks=True)
    # the copy carries the source's journal: materialize it in the COPY
    # (ours to mutate) so the pointer records below exist even for
    # journal-only bindings; the live source's journal is only INDEXED
    # in memory for the ino walk
    fold_journal(dst_root)
    xattr_dir = os.path.join(src_root, META_DIR, "xattr")
    gfid_dir = os.path.join(dst_root, META_DIR, "gfid")
    if not os.path.isdir(xattr_dir) or not os.path.isdir(gfid_dir):
        return
    ino_map = _journal_ino_map(xattr_dir)
    for dirpath, dirnames, filenames in os.walk(src_root):
        if dirpath == src_root and META_DIR in dirnames:
            dirnames.remove(META_DIR)
        for nm in dirnames + filenames:
            ap = os.path.join(dirpath, nm)
            try:
                st = os.lstat(ap)
            except OSError:
                continue
            key = f"{st.st_dev}:{st.st_ino}"
            hexg = ino_map.get(key)
            if hexg is None:
                try:
                    with open(os.path.join(xattr_dir, "ino-" + key),
                              "rb") as f:
                        hexg = f.read(16).hex()
                except OSError:
                    continue
            rec = os.path.join(gfid_dir, hexg)
            rel = "/" + os.path.relpath(ap, src_root)
            try:
                with open(rec) as f:
                    inokey, relpath = split_gfid_record(f.read())
            except OSError:
                continue
            if relpath != rel:
                with open(rec + ".tmp", "w") as f:
                    f.write(inokey + "\n" + rel)
                os.replace(rec + ".tmp", rec)


def _sys_fallocate(fdno: int, mode: int, offset: int, length: int) -> None:
    """fallocate(2) honoring mode flags (KEEP_SIZE, PUNCH_HOLE)."""
    if _libc_fallocate is None:
        if mode:
            raise OSError(errno.EOPNOTSUPP, "fallocate flags unsupported")
        os.posix_fallocate(fdno, offset, length)
        return
    if _libc_fallocate(_ctypes.c_int(fdno), _ctypes.c_int(mode),
                       _ctypes.c_long(offset), _ctypes.c_long(length)) != 0:
        err = _ctypes.get_errno()
        raise OSError(err, os.strerror(err))


@register("storage/posix")
class PosixLayer(Layer):
    """Bottom-of-brick storage layer."""

    OPTIONS = (
        Option("directory", "path", description="brick root directory"),
        Option("o-direct", "bool", default="off"),
        Option("update-link-count-parent", "bool", default="off"),
        Option("health-check-interval", "time", default="30",
               description="seconds between backend probes (0 = off); "
               "a failing backend marks the brick down "
               "(posix_health_check_thread_proc)"),
        Option("health-check-timeout", "time", default="10",
               description="a single probe hanging past this (D-state "
                           "disk) counts as failure "
                           "(storage.health-check-timeout)"),
        Option("create-mask", "str", default="0777",
               description="octal AND-mask on file create modes "
                           "(storage.create-mask, posix-metadata)"),
        Option("create-directory-mask", "str", default="0777",
               description="octal AND-mask on mkdir modes "
                           "(storage.create-directory-mask)"),
        Option("force-create-mode", "str", default="0000",
               description="octal bits OR-ed onto every created file "
                           "(storage.force-create-mode)"),
        Option("force-directory-mode", "str", default="0000",
               description="octal bits OR-ed onto every mkdir "
                           "(storage.force-directory-mode)"),
        Option("max-hardlinks", "int", default=100, min=0,
               description="EMLINK past this many links to one inode "
                           "(storage.max-hardlinks; 0 = unlimited)"),
        Option("reserve", "percent", default="1",
               description="refuse writes/creates when free space falls "
                           "under this percent (storage.reserve; reads "
                           "and deletes still pass so the operator can "
                           "recover)"),
        Option("owner-uid", "int", default=-1, min=-1,
               description="chown the brick root at init "
                           "(storage.owner-uid; -1 = leave)"),
        Option("owner-gid", "int", default=-1, min=-1,
               description="storage.owner-gid; -1 = leave"),
        Option("fips-mode-rchecksum", "bool", default="on",
               description="sha256 strong checksums (FIPS-allowed); "
                           "off = legacy md5 "
                           "(storage.fips-mode-rchecksum)"),
    )

    # journal records between sidecar compactions (the xattr write-path
    # cost model: one O_APPEND write per update instead of the four
    # syscalls of open+write+close+replace; same durability — neither
    # path fsyncs, both live in the page cache until the OS flushes)
    XATTR_COMPACT_EVERY = 4096
    # cache bounds: clean entries evict once past these, so a brick
    # serving millions of files stays O(cap) resident, not O(files);
    # dirty xattr entries are pinned until compaction persists them
    XATTR_CACHE_MAX = 65536
    INO_CACHE_MAX = 262144

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        root = self.opts.get("directory")
        if not root:
            raise ValueError(f"{self.name}: option directory is required")
        self.root = os.path.abspath(root)
        self._gfid_dir = os.path.join(self.root, META_DIR, "gfid")
        self._xattr_dir = os.path.join(self.root, META_DIR, "xattr")
        self._handle_dir = os.path.join(self.root, META_DIR, "handle")
        self._executor = None  # worker pool injected by io-threads
        # xattr sidecar cache + append journal (posix-metadata.c keeps
        # metadata in ONE xattr blob; the analog here is one in-memory
        # dict per gfid, journaled on update, compacted to the per-gfid
        # JSON files every XATTR_COMPACT_EVERY records)
        self._xa_cache: dict[bytes, dict] = {}
        self._xa_dirty: set[bytes] = set()
        self._ino_cache: dict[str, bytes] = {}  # "dev:ino" -> gfid
        # gfid bindings ride the SAME journal (this host's open(2) is
        # sandbox-priced at ~175us, so the old two-files-per-create
        # binding dominated the smallfile budget): journal-only until
        # compaction materializes the ino-/pointer files.  _gfid_mem
        # holds uncompacted bindings (bounded by the compaction
        # interval); files stay authoritative for everything older.
        self._gfid_mem: dict[bytes, tuple[str, str]] = {}
        self._bind_dirty: set[bytes] = set()
        self._xa_journal_path = os.path.join(self._xattr_dir,
                                             "journal.jsonl")
        self._xa_journal_fd: int | None = None
        self._xa_records = 0
        # compound batching: while a chain executes, journal records
        # accumulate here and land in ONE appended write at chain end
        # (a create+writev+fsetattr chain is one handle-farm
        # transaction instead of per-fop journal syscalls)
        self._jrnl_batch: list[str] | None = None

    def set_io_executor(self, executor) -> None:
        """io-threads hands us its worker pool; data-plane syscalls run
        there so a slow disk op cannot stall the brick's event loop
        (io-threads.c:236 iot_worker intent).  Metadata/sidecar fops stay
        on the loop — their read-modify-write sections rely on its
        serialization."""
        self._executor = executor

    async def _io(self, fn, *args):
        if self._executor is None:
            return fn(*args)
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, fn, *args)

    async def init(self):
        os.makedirs(self.root, exist_ok=True)
        os.makedirs(self._gfid_dir, exist_ok=True)
        os.makedirs(self._xattr_dir, exist_ok=True)
        os.makedirs(self._handle_dir, exist_ok=True)
        self._xa_replay_journal()
        # root of the brick always has the fixed ROOT_GFID
        if not os.path.exists(self._gfid_path(ROOT_GFID)):
            self._gfid_set(ROOT_GFID, "/")
        if self.opts["owner-uid"] >= 0 or self.opts["owner-gid"] >= 0:
            try:  # storage.owner-uid/-gid: brand the brick root
                os.chown(self.root, self.opts["owner-uid"],
                         self.opts["owner-gid"])
            except OSError as e:
                log.warning(9, "%s: owner-uid/gid chown failed: %s",
                            self.name, e)
        self._mode_opts()
        self._reserve_checked = 0.0
        self._reserve_full = False
        self._failed_health: str | None = None
        if float(self.opts["health-check-interval"]) > 0:
            self._health_task = asyncio.create_task(self._health_loop())
        await super().init()

    def _mode_opts(self) -> None:
        """Parse the octal mode-mask options once (hot create path)."""

        def octal(key: str, dflt: int) -> int:
            try:
                return int(str(self.opts[key]), 8) & 0o7777
            except ValueError:
                log.warning(9, "%s: %s=%r is not octal; using %o",
                            self.name, key, self.opts[key], dflt)
                return dflt

        self._fmask = octal("create-mask", 0o777)
        self._dmask = octal("create-directory-mask", 0o777)
        self._fforce = octal("force-create-mode", 0)
        self._dforce = octal("force-directory-mode", 0)

    def _file_mode(self, mode: int) -> int:
        return (mode & self._fmask) | self._fforce

    def _dir_mode(self, mode: int) -> int:
        return (mode & self._dmask) | self._dforce

    @property
    def _mode_policy_active(self) -> bool:
        # with masks/forced bits configured the EXACT mode must land —
        # chmod after create, because the process umask (which the
        # reference's brick daemon zeroes at startup) filters open(2)'s
        # mode argument
        return (self._fforce or self._dforce or self._fmask != 0o777
                or self._dmask != 0o777)

    def _check_reserve(self) -> None:
        """storage.reserve: writes/creates fail with ENOSPC below the
        floor; reads and deletes pass (the operator's way out).  The
        statvfs is cached ~2s — this sits on the data hot path."""
        pct = float(self.opts["reserve"])
        if pct <= 0:
            return
        now = time.monotonic()
        if now - self._reserve_checked > 2.0:
            self._reserve_checked = now
            try:
                st = os.statvfs(self.root)
                free = st.f_bavail / max(1, st.f_blocks) * 100.0
                self._reserve_full = free < pct
            except OSError:
                self._reserve_full = False
        if self._reserve_full:
            raise FopError(errno.ENOSPC,
                           f"brick under storage.reserve floor "
                           f"({self.opts['reserve']}%)")

    async def fini(self):
        t = getattr(self, "_health_task", None)
        if t is not None:
            t.cancel()
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
            self._health_task = None
        # clean shutdown folds the xattr journal into the JSON files
        # (a kill skips this; init replays the journal instead)
        try:
            self._xa_compact()
        except OSError:
            pass
        await super().fini()

    def reconfigure(self, options: dict) -> None:
        old = float(self.opts["health-check-interval"])
        super().reconfigure(options)
        self._mode_opts()
        self._reserve_checked = 0.0  # re-probe under the new floor
        new = float(self.opts["health-check-interval"])
        if new == old or getattr(self, "_failed_health", None):
            return  # a failed brick stays down until respawn
        t = getattr(self, "_health_task", None)
        if t is not None:
            t.cancel()
            self._health_task = None
        if new > 0:
            try:
                self._health_task = asyncio.create_task(
                    self._health_loop())
            except RuntimeError:
                pass  # no running loop (offline reconfigure)

    # -- health checker (posix_health_check_thread_proc analog) ------------
    # The reference stats + writes a probe under .glusterfs every
    # interval; a failing backend (dead disk, unmounted FS) kills the
    # brick so clients fail over instead of hanging on EIO storage.
    # Here the brick marks itself down: every fop raises ENOTCONN and
    # CHILD_DOWN propagates up to the serving graph.

    async def _health_loop(self) -> None:
        from ..core.layer import Event

        interval = float(self.opts["health-check-interval"])
        probe = os.path.join(self.root, META_DIR, "health_check")
        while True:
            await asyncio.sleep(interval)
            try:
                def check() -> None:
                    os.statvfs(self.root)
                    with open(probe, "w") as f:
                        f.write(str(time.time()))
                        f.flush()
                        os.fsync(f.fileno())

                to = float(self.opts["health-check-timeout"])
                await asyncio.wait_for(asyncio.to_thread(check),
                                       to if to > 0 else None)
            except asyncio.CancelledError:
                raise
            except (OSError, asyncio.TimeoutError) as e:
                self._failed_health = str(e)
                log.error(9, "%s: backend health check failed: %s — "
                          "marking brick down", self.name, e)
                # events.h EVENT_POSIX_HEALTH_CHECK_FAILED: the
                # operator's page for "this brick's disk is dying"
                from ..core.events import gf_event

                gf_event("POSIX_HEALTH_CHECK_FAILED", brick=self.name,
                         path=self.root, error=str(e))
                self.notify(Event.CHILD_DOWN, None, None)
                return

    # -- path / gfid helpers ----------------------------------------------

    def _health_gate(self) -> None:
        """Every resolution path funnels here once the checker marks
        the backend dead: a brick must fail loudly (ENOTCONN), never
        serve stale metadata or record bookkeeping on a dead disk."""
        if getattr(self, "_failed_health", None):
            raise FopError(errno.ENOTCONN,
                           f"brick backend failed health check: "
                           f"{self._failed_health}")

    def _abs(self, path: str) -> str:
        self._health_gate()
        rel = path.lstrip("/")
        if rel.split("/", 1)[0] == META_DIR:
            raise FopError(errno.EPERM, "reserved namespace")
        out = os.path.normpath(os.path.join(self.root, rel))
        if not (out == self.root or out.startswith(self.root + os.sep)):
            raise FopError(errno.EPERM, f"path escapes brick: {path}")
        return out

    def _gfid_path(self, gfid: bytes) -> str:
        return os.path.join(self._gfid_dir, gfid.hex())

    def _gfid_set(self, gfid: bytes, relpath: str,
                  inokey: str | None = None) -> None:
        """Write the gfid pointer file: line 1 = the dev:ino binding key
        (so _gfid_del can clean up the ino- sidecar and inode-number
        reuse can't resurrect a deleted gfid), rest = relpath verbatim
        (paths may legally contain newlines, so the path goes last).
        Raw os.open: this sits on the per-create hot path and a
        buffered file object costs ~3x the syscalls."""
        tmp = self._gfid_path(gfid) + ".tmp"
        fd = os.open(tmp, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        try:
            os.write(fd, ((inokey or "") + "\n" + relpath)
                     .encode("utf-8", "surrogateescape"))
        finally:
            os.close(fd)
        os.replace(tmp, self._gfid_path(gfid))

    def _gfid_read(self, gfid: bytes) -> tuple[str, str]:
        """-> (inokey, relpath); raises ESTALE when the gfid is unknown."""
        ent = self._gfid_mem.get(gfid)
        if ent is not None:
            return ent  # journal-only binding (not yet compacted)
        try:
            with open(self._gfid_path(gfid)) as f:
                return split_gfid_record(f.read())
        except FileNotFoundError:
            raise FopError(errno.ESTALE, f"no such gfid {gfid.hex()}") from None

    def _gfid_resolve(self, gfid: bytes) -> str:
        """GFID -> volume-relative path ('/a/b'): the recorded hint.
        Authoritative for directories; for files prefer _gfid_access."""
        return self._gfid_read(gfid)[1]

    def _handle_path(self, gfid: bytes) -> str:
        return os.path.join(self._handle_dir, gfid.hex())

    def _gfid_access(self, gfid: bytes) -> str:
        """GFID -> ABSOLUTE path for I/O.  Regular files/symlinks go via
        the handle hardlink (immune to rename/unlink of any one name);
        directories via the recorded path."""
        self._health_gate()
        hp = self._handle_path(gfid)
        if os.path.lexists(hp):
            return hp
        return self._abs(self._gfid_resolve(gfid))

    def _iatt_gfid(self, gfid: bytes) -> Iatt:
        try:
            st = os.lstat(self._gfid_access(gfid))
        except OSError as e:
            raise _fop_errno(e)
        return Iatt.from_stat(st, gfid)

    def _gfid_del(self, gfid: bytes) -> None:
        try:
            inokey, _ = self._gfid_read(gfid)
            if inokey:
                self._ino_cache.pop(inokey, None)
                os.unlink(os.path.join(self._xattr_dir, "ino-" + inokey))
        except (FopError, FileNotFoundError):
            pass
        if self._gfid_mem.pop(gfid, None) is not None or \
                gfid in self._bind_dirty:
            self._bind_dirty.add(gfid)
            self._journal_rec({"u": gfid.hex()})
        for p in (self._handle_path(gfid), self._gfid_path(gfid)):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
        self._xattr_del(gfid)

    def _gfid_of(self, path: str) -> bytes | None:
        """Read the per-object gfid marker (sidecar next to xattr store).
        dev:ino -> gfid is immutable for an inode's lifetime, so a hit
        in the in-memory map skips the sidecar read every stat pays."""
        try:
            st = os.lstat(self._abs(path))
        except OSError as e:
            raise _fop_errno(e)
        key = f"{st.st_dev}:{st.st_ino}"
        g = self._ino_cache.get(key)
        if g is not None:
            return g
        p = os.path.join(self._xattr_dir, "ino-" + key)
        try:
            fd = os.open(p, os.O_RDONLY)
        except FileNotFoundError:
            return None
        try:
            g = os.read(fd, 16)
        finally:
            os.close(fd)
        if len(g) != 16:  # torn record from a crash mid-write
            return None
        if len(self._ino_cache) >= self.INO_CACHE_MAX:
            # shed an arbitrary half — but never a journal-only binding
            # (its ino- file doesn't exist yet; dropping the cache entry
            # would read as 'unbound' until compaction)
            shed = 0
            for k in list(self._ino_cache):
                if self._ino_cache[k] in self._bind_dirty:
                    continue
                del self._ino_cache[k]
                shed += 1
                if shed >= self.INO_CACHE_MAX // 2:
                    break
        self._ino_cache[key] = g
        return g

    def _gfid_bind(self, path: str, gfid: bytes) -> None:
        ap = self._abs(path)
        try:
            st = os.lstat(ap)
        except OSError as e:
            raise _fop_errno(e)
        key = f"{st.st_dev}:{st.st_ino}"
        rel = path if path.startswith("/") else "/" + path
        # journal-only binding (ONE appended record on the already-open
        # journal fd): the ino- and pointer files materialize at
        # compaction — creating two files per bind priced every create
        # at 2x open(2) on this sandboxed host
        self._ino_cache[key] = gfid
        self._gfid_mem[gfid] = (key, rel)
        self._bind_dirty.add(gfid)
        self._journal_rec({"b": [gfid.hex(), key, rel]})
        # handle hardlink for anything hardlinkable (reference
        # posix_handle_hard); directories keep the text record only
        if not os.path.isdir(ap):
            hp = self._handle_path(gfid)
            try:
                os.link(ap, hp, follow_symlinks=False)
            except FileExistsError:
                if not os.path.samestat(st, os.lstat(hp)):
                    os.unlink(hp)  # stale handle from a recycled gfid
                    os.link(ap, hp, follow_symlinks=False)
            except OSError as e:
                log.warning(2, "handle link failed for %s: %s", path, e)

    def _require_gfid(self, path: str) -> bytes:
        g = self._gfid_of(path)
        if g is None:  # legacy object: heal a fresh gfid (posix_gfid_set)
            g = gfid_new() if path not in ("/", "") else ROOT_GFID
            self._gfid_bind(path, g)
        return g

    def _loc_path(self, loc: Loc) -> str:
        if loc.path:
            return loc.path
        if loc.gfid:
            return self._gfid_resolve(loc.gfid)
        raise FopError(errno.EINVAL, "loc has neither path nor gfid")

    def _iatt(self, path: str, *, follow: bool = False) -> Iatt:
        try:
            st = os.stat(self._abs(path)) if follow else os.lstat(self._abs(path))
        except OSError as e:
            raise _fop_errno(e)
        return Iatt.from_stat(st, self._require_gfid(path))

    # -- xattr sidecar (in-memory cache + append journal) ------------------
    # Updates append ONE record to a per-brick journal and mutate the
    # cache; the per-gfid JSON files are rewritten only at compaction.
    # A killed brick replays the journal over the JSON files at init —
    # byte-for-byte the state an uncached store would have had, because
    # neither path fsyncs (page-cache durability either way).  All xattr
    # mutation runs on the brick event loop (see set_io_executor), so
    # the cache needs no locking.

    def _xattr_path(self, gfid: bytes) -> str:
        return os.path.join(self._xattr_dir, gfid.hex() + ".json")

    def _xa_replay_journal(self) -> None:
        try:
            with open(self._xa_journal_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail record from a kill
                    if "b" in rec:  # gfid binding
                        ghex, key, rel = rec["b"]
                        g = bytes.fromhex(ghex)
                        self._gfid_mem[g] = (key, rel)
                        self._ino_cache[key] = g
                        self._bind_dirty.add(g)
                        self._xa_records += 1
                        continue
                    if "u" in rec:  # unbind
                        g = bytes.fromhex(rec["u"])
                        ent = self._gfid_mem.pop(g, None)
                        if ent is not None:
                            self._ino_cache.pop(ent[0], None)
                        self._bind_dirty.add(g)
                        self._xa_records += 1
                        continue
                    g = bytes.fromhex(rec["g"])
                    if rec["x"] is None:
                        self._xa_cache.pop(g, None)
                        try:
                            os.unlink(self._xattr_path(g))
                        except OSError:
                            pass
                    else:
                        self._xa_cache[g] = rec["x"]
                    self._xa_dirty.add(g)
                    self._xa_records += 1
        except FileNotFoundError:
            return

    def _journal_rec(self, rec: dict) -> None:
        if self._jrnl_batch is not None:
            # inside a compound chain: defer to one write (and defer
            # compaction too — it folds from memory, which already
            # holds this record's effect)
            self._jrnl_batch.append(json.dumps(rec) + "\n")
            self._xa_records += 1
            return
        if self._xa_journal_fd is None:
            self._xa_journal_fd = os.open(
                self._xa_journal_path,
                os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
        os.write(self._xa_journal_fd, (json.dumps(rec) + "\n").encode())
        self._xa_records += 1
        if self._xa_records >= self.XATTR_COMPACT_EVERY:
            self._xa_compact()

    def journal_batch(self):
        """Context manager: while held, journal records accumulate and
        land in ONE appended write at exit (compaction deferred with
        them).  Same page-cache durability as the per-record appends —
        neither path fsyncs — and the flush runs even on failure,
        because the records mirror state the in-memory caches already
        hold.  Nesting is a no-op; the brick's fops all run on one
        event loop, so records from interleaved requests simply join
        the batch in order.  protocol/server wraps every compound
        dispatch in this, so the batching engages no matter where in
        the brick graph the chain decomposed."""
        import contextlib

        @contextlib.contextmanager
        def batch():
            if self._jrnl_batch is not None:  # nested: already batching
                yield
                return
            self._jrnl_batch = []
            try:
                yield
            finally:
                buf, self._jrnl_batch = self._jrnl_batch, None
                if buf:
                    if self._xa_journal_fd is None:
                        self._xa_journal_fd = os.open(
                            self._xa_journal_path,
                            os.O_CREAT | os.O_WRONLY | os.O_APPEND,
                            0o644)
                    os.write(self._xa_journal_fd, "".join(buf).encode())
                if self._xa_records >= self.XATTR_COMPACT_EVERY:
                    self._xa_compact()

        return batch()

    async def compound(self, links, xdata: dict | None = None) -> list:
        """Chains land as one handle-farm transaction: every link runs
        through this layer's ordinary fops under one journal batch."""
        from ..rpc import compound as cfop

        with self.journal_batch():
            return await cfop.decompose(self, links, xdata)

    def _xa_append(self, gfid: bytes, xattrs: dict | None) -> None:
        self._xa_dirty.add(gfid)
        self._journal_rec({"g": gfid.hex(), "x": xattrs})

    def _xa_compact(self) -> None:
        """Fold the journal into the per-gfid JSON files (xattrs) and
        the ino-/pointer files (bindings), then truncate."""
        for g in self._xa_dirty:
            p = self._xattr_path(g)
            cur = self._xa_cache.get(g)
            if cur is None:
                try:
                    os.unlink(p)
                except OSError:
                    pass
                continue
            with open(p + ".tmp", "w") as f:
                json.dump(cur, f)
            os.replace(p + ".tmp", p)
        self._xa_dirty.clear()
        for g in self._bind_dirty:
            ent = self._gfid_mem.pop(g, None)
            if ent is None:
                # unbound since: drop any materialized remnants
                for p in (self._handle_path(g), self._gfid_path(g)):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
                continue
            key, rel = ent
            fd = os.open(os.path.join(self._xattr_dir, "ino-" + key),
                         os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
            try:
                os.write(fd, g)
            finally:
                os.close(fd)
            self._gfid_set(g, rel, inokey=key)
        self._bind_dirty.clear()
        self._xa_records = 0
        if self._xa_journal_fd is not None:
            os.close(self._xa_journal_fd)
            self._xa_journal_fd = None
        try:
            os.truncate(self._xa_journal_path, 0)
        except OSError:
            pass

    def drop_caches(self) -> None:
        """Forget all in-memory sidecar state and re-read the store —
        exactly what a kill + respawn does.  For tooling/tests that
        mutate the brick backend out-of-band under a live layer (a real
        brick replacement respawns the process, making this implicit).
        Nothing is written: the store may have been wiped/replaced, and
        compacting stale memory into it would resurrect dead state."""
        self._xa_cache.clear()
        self._xa_dirty.clear()
        self._ino_cache.clear()
        self._gfid_mem.clear()
        self._bind_dirty.clear()
        if self._xa_journal_fd is not None:
            os.close(self._xa_journal_fd)
            self._xa_journal_fd = None
        self._xa_records = 0
        self._xa_replay_journal()  # whatever journal the store now has

    def _xa_evict(self) -> None:
        """Bound the cache: shed clean entries once past the cap (dirty
        ones carry journal-only state and stay pinned to compaction)."""
        if len(self._xa_cache) <= self.XATTR_CACHE_MAX:
            return
        for g in list(self._xa_cache):
            if g not in self._xa_dirty:
                del self._xa_cache[g]
                if len(self._xa_cache) <= self.XATTR_CACHE_MAX // 2:
                    break

    def _xattr_load(self, gfid: bytes) -> dict[str, str]:
        cur = self._xa_cache.get(gfid)
        if cur is None:
            try:
                with open(self._xattr_path(gfid)) as f:
                    cur = json.load(f)
            except FileNotFoundError:
                cur = {}
            self._xa_cache[gfid] = cur
            self._xa_evict()
        return dict(cur)  # callers mutate-then-store; never alias cache

    def _xattr_store(self, gfid: bytes, xattrs: dict[str, str]) -> None:
        self._xa_cache[gfid] = dict(xattrs)
        self._xa_append(gfid, xattrs)
        self._xa_evict()

    def _xattr_del(self, gfid: bytes) -> None:
        """Drop a gfid's xattrs entirely (unlink/nuke paths)."""
        self._xa_cache.pop(gfid, None)
        self._xa_append(gfid, None)
        try:
            os.unlink(self._xattr_path(gfid))
        except OSError:
            pass

    # -- namespace fops ----------------------------------------------------

    async def lookup(self, loc: Loc, xdata: dict | None = None):
        path = self._loc_path(loc)
        ia = self._iatt(path)
        if (xdata or {}).get("get-xattrs"):
            # xdata piggyback (the reference's dict_t request keys on
            # lookup): the reply carries the inode's xattrs so cluster
            # layers fold their metadata fan-out into the lookup wave
            try:
                return ia, dict(await self.getxattr(loc, None))
            except FopError:
                pass
        return ia, {}

    async def stat(self, loc: Loc, xdata: dict | None = None):
        return self._iatt(self._loc_path(loc))

    async def fstat(self, fd: FdObj, xdata: dict | None = None):
        return self._iatt_gfid(fd.gfid)

    async def mkdir(self, loc: Loc, mode: int = 0o755,
                    xdata: dict | None = None):
        self._check_reserve()
        path = self._loc_path(loc)
        try:
            os.mkdir(self._abs(path), self._dir_mode(mode))
            if self._mode_policy_active:
                os.chmod(self._abs(path), self._dir_mode(mode))
        except OSError as e:
            raise _fop_errno(e)
        gfid = (xdata or {}).get("gfid-req") or gfid_new()
        self._gfid_bind(path, gfid)
        return self._iatt(path)

    async def mknod(self, loc: Loc, mode: int = 0o644, rdev: int = 0,
                    xdata: dict | None = None):
        path = self._loc_path(loc)
        try:
            # regular files only (block/char nodes are out of scope)
            fdno = os.open(self._abs(path),
                           os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                           self._file_mode(mode))
            if self._mode_policy_active:
                os.fchmod(fdno, self._file_mode(mode))
            os.close(fdno)
        except OSError as e:
            raise _fop_errno(e)
        gfid = (xdata or {}).get("gfid-req") or gfid_new()
        self._gfid_bind(path, gfid)
        return self._iatt(path)

    async def create(self, loc: Loc, flags: int = 0, mode: int = 0o644,
                     xdata: dict | None = None):
        self._check_reserve()
        path = self._loc_path(loc)
        mode = self._file_mode(mode)
        try:
            # brick fds are always RDWR regardless of the client's access
            # mode (blindly OR-ing O_RDWR onto O_WRONLY yields the
            # can-do-nothing accmode 3): EC/AFR RMW and heal need read
            # access on write-only client fds, like the reference's ec
            # open-flag rewrite.  O_APPEND is stripped too — Linux
            # pwrite(2) ignores the offset on O_APPEND fds, which would
            # send EC's positional fragment writes to EOF
            fdno = os.open(self._abs(path),
                           (flags & ~(os.O_ACCMODE | os.O_APPEND))
                           | os.O_CREAT | os.O_RDWR, mode)
            if self._mode_policy_active:
                os.fchmod(fdno, mode)
        except OSError as e:
            raise _fop_errno(e)
        gfid = (xdata or {}).get("gfid-req") or gfid_new()
        self._gfid_bind(path, gfid)
        init = (xdata or {}).get("init-xattrs")
        if init:
            # cluster layers seed their counter xattrs in the SAME fop
            # as the create — one wave instead of create + setxattr
            self._xattr_store(gfid,
                              {k: _hex_val(v) for k, v in init.items()})
        else:
            # a just-bound gfid has no sidecar JSON: seed the cache so
            # the first getxattr doesn't pay a guaranteed-miss open
            self._xa_cache.setdefault(gfid, {})
        fd = FdObj(gfid, flags, path=path)
        fd.ctx_set(self, fdno)
        return fd, self._iatt(path)

    async def symlink(self, target: str, loc: Loc, xdata: dict | None = None):
        path = self._loc_path(loc)
        try:
            os.symlink(target, self._abs(path))
        except OSError as e:
            raise _fop_errno(e)
        gfid = (xdata or {}).get("gfid-req") or gfid_new()
        self._gfid_bind(path, gfid)
        return self._iatt(path)

    async def readlink(self, loc: Loc, xdata: dict | None = None):
        try:
            return os.readlink(self._abs(self._loc_path(loc)))
        except OSError as e:
            raise _fop_errno(e)

    async def link(self, oldloc: Loc, newloc: Loc, xdata: dict | None = None):
        oldp, newp = self._loc_path(oldloc), self._loc_path(newloc)
        maxl = self.opts["max-hardlinks"]
        if maxl:
            try:
                if os.stat(self._abs(oldp)).st_nlink >= maxl:
                    raise FopError(errno.EMLINK,
                                   f"storage.max-hardlinks ({maxl})")
            except OSError as e:
                raise _fop_errno(e)
        try:
            os.link(self._abs(oldp), self._abs(newp))
        except OSError as e:
            raise _fop_errno(e)
        return self._iatt(newp)

    async def unlink(self, loc: Loc, xdata: dict | None = None):
        path = self._loc_path(loc)
        gfid = self._gfid_of(path)
        try:
            os.unlink(self._abs(path))
        except OSError as e:
            raise _fop_errno(e)
        if gfid is not None:
            self._maybe_reap(gfid)
        return {}

    def _maybe_reap(self, gfid: bytes) -> None:
        """Drop the identity when no user-visible name remains: the handle
        hardlink holding nlink==1 means only the handle is left (reference
        posix janitor semantics)."""
        hp = self._handle_path(gfid)
        try:
            if os.lstat(hp).st_nlink > 1:
                return  # another hard link still names this inode
        except FileNotFoundError:
            pass  # directory or legacy object: no handle
        self._gfid_del(gfid)

    async def rmdir(self, loc: Loc, flags: int = 0, xdata: dict | None = None):
        path = self._loc_path(loc)
        gfid = self._gfid_of(path)
        try:
            os.rmdir(self._abs(path))
        except OSError as e:
            raise _fop_errno(e)
        if gfid is not None:
            self._gfid_del(gfid)
        return {}

    async def rename(self, oldloc: Loc, newloc: Loc, xdata: dict | None = None):
        oldp, newp = self._loc_path(oldloc), self._loc_path(newloc)
        gfid = self._gfid_of(oldp)
        try:
            dst_gfid = self._gfid_of(newp)
        except FopError:
            dst_gfid = None
        try:
            os.replace(self._abs(oldp), self._abs(newp))
        except OSError as e:
            raise _fop_errno(e)
        if dst_gfid is not None and dst_gfid != gfid:
            # overwritten destination: identity dies unless another hard
            # link still names its inode
            self._maybe_reap(dst_gfid)
        if gfid is not None:
            self._gfid_bind(newp, gfid)  # refresh path hint + dev:ino key
        return self._iatt(newp)

    # -- fd fops -----------------------------------------------------------

    async def open(self, loc: Loc, flags: int = os.O_RDWR,
                   xdata: dict | None = None):
        path = self._loc_path(loc)
        base = flags & ~(os.O_CREAT | os.O_ACCMODE | os.O_APPEND)
        try:
            # same access-mode/O_APPEND normalization as create
            # (directories reject O_RDWR; they come through opendir)
            try:
                fdno = os.open(self._abs(path), base | os.O_RDWR)
            except PermissionError:
                if flags & os.O_ACCMODE != os.O_RDONLY:
                    raise
                # a file the brick cannot write (0444 etc.): serve the
                # client's read-only open rather than failing it
                fdno = os.open(self._abs(path), base | os.O_RDONLY)
        except OSError as e:
            raise _fop_errno(e)
        fd = FdObj(self._require_gfid(path), flags, path=path)
        fd.ctx_set(self, fdno)
        return fd

    async def opendir(self, loc: Loc, xdata: dict | None = None):
        path = self._loc_path(loc)
        if not os.path.isdir(self._abs(path)):
            raise FopError(errno.ENOTDIR, path)
        fd = FdObj(self._require_gfid(path), path=path)
        fd.ctx_set(self, None)  # directory fds need no OS handle
        return fd

    def _os_fd(self, fd: FdObj) -> int:
        # a cached os-level fd would happily keep writing into the
        # dead backend's orphaned inodes — fd fops must fail like the
        # path fops so the layers above record blame and fail over
        # (the reference gets this by killing the brick)
        self._health_gate()
        fdno = fd.ctx_get(self)
        if fdno is None:
            # anonymous fd: open on demand via the handle hardlink
            try:
                fdno = os.open(self._gfid_access(fd.gfid), os.O_RDWR)
            except OSError as e:
                raise _fop_errno(e)
            fd.ctx_set(self, fdno)
        return fdno

    async def readv(self, fd: FdObj, size: int, offset: int,
                    xdata: dict | None = None):
        fdno = self._os_fd(fd)  # resolve on the loop (may open-on-demand)
        try:
            out = await self._io(os.pread, fdno, size, offset)
            at = (xdata or {}).get("frame-time-atime")
            if at is not None:  # ctime.noatime off: stamp client atime
                st = await self._io(os.fstat, fdno)
                await self._io(os.utime, fdno, (at, st.st_mtime))
            return out
        except OSError as e:
            raise _fop_errno(e)

    async def writev(self, fd: FdObj, data: bytes, offset: int,
                     xdata: dict | None = None):
        self._check_reserve()
        pre = (xdata or {}).get("pre-xattrop")
        if pre:
            # fallback for graphs with no features/index above (which
            # normally consumes the key): marker before data, same op
            await self.fxattrop(fd, "add64", dict(pre), None)
        fdno = self._os_fd(fd)

        def work():
            view = memoryview(data)
            pos = offset
            while view:
                n = os.pwrite(fdno, view, pos)
                if n <= 0:  # a 0-byte pwrite would loop forever
                    raise FopError(errno.EIO, "short write")
                view = view[n:]
                pos += n

        try:
            await self._io(work)
            ft = (xdata or {}).get("frame-time")
            if ft is not None:
                # client-stamped mtime (features/utime): every brick
                # stores the same instant instead of its own clock's;
                # atime is preserved (POSIX: write leaves atime alone)
                st = await self._io(os.fstat, fdno)
                await self._io(os.utime, fdno, (st.st_atime, ft))
        except OSError as e:
            raise _fop_errno(e)
        return self._iatt_gfid(fd.gfid)

    async def xorv(self, fd: FdObj, data: bytes, offset: int,
                   xdata: dict | None = None):
        """Read-xor-write at a byte offset (the parity-delta write
        plane's brick half, ISSUE 10): the stored bytes become
        ``stored ⊕ data`` in one local pass, so a parity-fragment
        update costs the client ZERO read round trips.  Bytes past EOF
        read as zeros (``0 ⊕ d = d``), so a delta landing on a sparse
        or short region degenerates to a plain write.  The whole op
        runs under one journal batch (the pre-xattrop marker's sidecar
        append coalesces with it).  Write-class and NEVER blindly
        retried: XOR self-cancels on double-apply."""
        self._check_reserve()
        with self.journal_batch():
            pre = (xdata or {}).get("pre-xattrop")
            if pre:
                await self.fxattrop(fd, "add64", dict(pre), None)
            fdno = self._os_fd(fd)

            def work():
                old = b""
                pos = offset
                want = len(data)
                while len(old) < want:
                    chunk = os.pread(fdno, want - len(old),
                                     pos + len(old))
                    if not chunk:
                        break  # EOF: the rest XORs against zeros
                    old += chunk
                buf = bytearray(data)
                if old:
                    x = int.from_bytes(old, "little") ^ \
                        int.from_bytes(buf[: len(old)], "little")
                    buf[: len(old)] = x.to_bytes(len(old), "little")
                view = memoryview(buf)
                pos = offset
                while view:
                    n = os.pwrite(fdno, view, pos)
                    if n <= 0:
                        raise FopError(errno.EIO, "short write")
                    view = view[n:]
                    pos += n

            try:
                await self._io(work)
            except OSError as e:
                raise _fop_errno(e)
        return self._iatt_gfid(fd.gfid)

    async def truncate(self, loc: Loc, size: int, xdata: dict | None = None):
        path = self._loc_path(loc)
        try:
            await self._io(os.truncate, self._abs(path), size)
            ft = (xdata or {}).get("frame-time")
            if ft is not None:
                st = await self._io(os.stat, self._abs(path))
                await self._io(os.utime, self._abs(path),
                               (st.st_atime, ft))
        except OSError as e:
            raise _fop_errno(e)
        return self._iatt(path)

    async def ftruncate(self, fd: FdObj, size: int, xdata: dict | None = None):
        try:
            await self._io(os.ftruncate, self._os_fd(fd), size)
        except OSError as e:
            raise _fop_errno(e)
        return self._iatt_gfid(fd.gfid)

    async def flush(self, fd: FdObj, xdata: dict | None = None):
        return {}

    async def fsync(self, fd: FdObj, datasync: int = 0,
                    xdata: dict | None = None):
        try:
            fdno = fd.ctx_get(self)
            if fdno is not None:
                await self._io(os.fdatasync if datasync else os.fsync, fdno)
        except OSError as e:
            raise _fop_errno(e)
        return {}

    async def fsyncdir(self, fd: FdObj, datasync: int = 0,
                       xdata: dict | None = None):
        return {}

    async def release(self, fd: FdObj) -> None:
        """Close the OS handle (not a wire fop; called by fd tables)."""
        fdno = fd.ctx_del(self)
        if fdno is not None:
            try:
                os.close(fdno)
            except OSError:
                pass

    async def readdir(self, fd: FdObj, size: int = 0, offset: int = 0,
                      xdata: dict | None = None):
        path = self._gfid_resolve(fd.gfid)
        try:
            names = sorted(os.listdir(self._abs(path)))
        except OSError as e:
            raise _fop_errno(e)
        names = [n for n in names if n != META_DIR]
        return [(n, None) for n in names[offset:]]

    async def readdirp(self, fd: FdObj, size: int = 0, offset: int = 0,
                       xdata: dict | None = None):
        path = self._gfid_resolve(fd.gfid)
        entries = await self.readdir(fd, size, offset, xdata)
        out = []
        for name, _ in entries:
            child = path.rstrip("/") + "/" + name
            try:
                out.append((name, self._iatt(child)))
            except FopError:
                continue
        return out

    # -- attrs / xattrs ----------------------------------------------------

    @staticmethod
    def _apply_attrs(ap: str, attrs: dict) -> None:
        if "mode" in attrs:
            os.chmod(ap, attrs["mode"])
        if "uid" in attrs or "gid" in attrs:
            os.chown(ap, attrs.get("uid", -1), attrs.get("gid", -1))
        if "atime" in attrs or "mtime" in attrs:
            st = os.stat(ap)
            now = time.time()  # value None = UTIME_NOW
            a = attrs.get("atime", st.st_atime)
            m = attrs.get("mtime", st.st_mtime)
            os.utime(ap, (now if a is None else a,
                          now if m is None else m))

    async def setattr(self, loc: Loc, attrs: dict, valid: int = 0,
                      xdata: dict | None = None):
        path = self._loc_path(loc)
        try:
            self._apply_attrs(self._abs(path), attrs)
        except OSError as e:
            raise _fop_errno(e)
        return self._iatt(path)

    async def fsetattr(self, fd: FdObj, attrs: dict, valid: int = 0,
                       xdata: dict | None = None):
        try:
            self._apply_attrs(self._gfid_access(fd.gfid), attrs)
        except OSError as e:
            raise _fop_errno(e)
        return self._iatt_gfid(fd.gfid)

    async def setxattr(self, loc: Loc, xattrs: dict, flags: int = 0,
                       xdata: dict | None = None):
        """Values are bytes on the wire (str accepted, stored utf-8).
        flags carry setxattr(2) semantics: XATTR_CREATE fails EEXIST on
        a present key, XATTR_REPLACE fails ENODATA on a missing one
        (lock-like xattr protocols through the mount depend on them)."""
        gfid = self._require_gfid(self._loc_path(loc))
        cur = self._xattr_load(gfid)
        for k, v in xattrs.items():
            if flags & os.XATTR_CREATE and k in cur:
                raise FopError(errno.EEXIST, k)
            if flags & os.XATTR_REPLACE and k not in cur:
                raise FopError(errno.ENODATA, k)
            cur[k] = _hex_val(v)
        self._xattr_store(gfid, cur)
        return {}

    async def fsetxattr(self, fd: FdObj, xattrs: dict, flags: int = 0,
                        xdata: dict | None = None):
        return await self.setxattr(Loc("", gfid=fd.gfid), xattrs, flags, xdata)

    async def getxattr(self, loc: Loc, name: str | None = None,
                       xdata: dict | None = None):
        """Returns {name: bytes}.  The virtual name
        ``glusterfs_tpu.gfid2path`` resolves the loc's gfid to its
        recorded volume path (reference glusterfs.gfid2path virtual
        xattr, posix-inode-fd-ops.c posix_get_gfid2path) — the self-heal
        daemon turns indexed gfids into healable paths with it."""
        if name == XA_GFID2PATH:
            if not loc.gfid:
                raise FopError(errno.EINVAL, "gfid2path needs a gfid loc")
            return {name: self._gfid_resolve(loc.gfid).encode()}
        if name and name.startswith(XA_SCAN_PREFIX):
            # which gfids carry xattr <key>?  (newline-joined hexes) —
            # lets brick layers rebuild in-memory state after a restart
            # (bit-rot-stub's quarantine set)
            key = name[len(XA_SCAN_PREFIX):]
            hexes = []
            # union of compacted files and the live cache (journal-only
            # gfids have no JSON file yet); cache wins on overlap
            cached = {g.hex() for g in self._xa_cache}
            for n in os.listdir(self._xattr_dir):
                if not n.endswith(".json") or n[:-5] in cached:
                    continue
                try:
                    with open(os.path.join(self._xattr_dir, n)) as f:
                        if key in json.load(f):
                            hexes.append(n[:-5])
                except (OSError, ValueError):
                    continue
            for g, xs in self._xa_cache.items():
                if key in xs:
                    hexes.append(g.hex())
            return {name: "\n".join(hexes).encode()}
        gfid = self._require_gfid(self._loc_path(loc))
        cur = self._xattr_load(gfid)
        if name is None:
            return {k: bytes.fromhex(v) for k, v in cur.items()}
        if name not in cur:
            raise FopError(errno.ENODATA, name)
        return {name: bytes.fromhex(cur[name])}

    async def fgetxattr(self, fd: FdObj, name: str | None = None,
                        xdata: dict | None = None):
        return await self.getxattr(Loc("", gfid=fd.gfid), name, xdata)

    async def removexattr(self, loc: Loc, name: str,
                          xdata: dict | None = None):
        gfid = self._require_gfid(self._loc_path(loc))
        cur = self._xattr_load(gfid)
        if name not in cur:
            raise FopError(errno.ENODATA, name)
        del cur[name]
        self._xattr_store(gfid, cur)
        return {}

    async def fremovexattr(self, fd: FdObj, name: str,
                           xdata: dict | None = None):
        return await self.removexattr(Loc("", gfid=fd.gfid), name, xdata)

    async def xattrop(self, loc: Loc, op: str, xattrs: dict,
                      xdata: dict | None = None):
        """Atomic arithmetic on xattr values (reference posix xattrop):
        op 'add64' adds int64s element-wise; 'set' stores; 'mixed' takes
        per-key ``[op, value]`` pairs so independent counters and
        absolute values (EC's version + size) commit in ONE atomic store
        — the reference packs them into a single xattrop dict the same
        way (ec_update_info).  Returns the resulting values."""
        gfid = self._require_gfid(self._loc_path(loc))
        cur = self._xattr_load(gfid)
        out: dict[str, bytes] = {}
        for key, spec in xattrs.items():
            if op == "mixed":
                kop, val = spec[0], spec[1]
            else:
                kop, val = op, spec
            if kop == "add64":
                old = bytes.fromhex(cur.get(key, "")) if key in cur else b""
                n = max(len(old), len(val)) // 8
                olds = list(struct.unpack(f">{n}q", old.ljust(n * 8, b"\0")))
                adds = struct.unpack(f">{n}q", val.ljust(n * 8, b"\0"))
                news = [a + b for a, b in zip(olds, adds)]
                res = struct.pack(f">{n}q", *news)
            elif kop == "set":
                res = val
            else:
                raise FopError(errno.EINVAL, f"xattrop op {kop!r}")
            cur[key] = res.hex()
            out[key] = res
        self._xattr_store(gfid, cur)
        return out

    async def fxattrop(self, fd: FdObj, op: str, xattrs: dict,
                       xdata: dict | None = None):
        return await self.xattrop(Loc("", gfid=fd.gfid), op, xattrs, xdata)

    # -- misc --------------------------------------------------------------

    async def access(self, loc: Loc, mask: int = 0, xdata: dict | None = None):
        if not os.access(self._abs(self._loc_path(loc)), mask):
            raise FopError(errno.EACCES, self._loc_path(loc))
        return {}

    async def statfs(self, loc: Loc, xdata: dict | None = None):
        # a dead disk's cached statvfs would keep min-free-disk
        # placing data here
        self._health_gate()
        try:
            sv = os.statvfs(self.root)
        except OSError as e:
            raise _fop_errno(e)
        return {"bsize": sv.f_bsize, "blocks": sv.f_blocks,
                "bfree": sv.f_bfree, "bavail": sv.f_bavail,
                "files": sv.f_files, "ffree": sv.f_ffree}

    async def seek(self, fd: FdObj, offset: int, what: str = "data",
                   xdata: dict | None = None):
        whence = os.SEEK_DATA if what == "data" else os.SEEK_HOLE
        try:
            return os.lseek(self._os_fd(fd), offset, whence)
        except OSError as e:
            raise _fop_errno(e)

    async def fallocate(self, fd: FdObj, mode: int, offset: int, length: int,
                        xdata: dict | None = None):
        """fallocate(2) with real mode flags via libc (posix_fallocate
        ignores FALLOC_FL_KEEP_SIZE and would grow the file)."""
        try:
            await self._io(_sys_fallocate, self._os_fd(fd), mode, offset,
                           length)
        except OSError as e:
            raise _fop_errno(e)
        return self._iatt_gfid(fd.gfid)

    async def discard(self, fd: FdObj, offset: int, length: int,
                      xdata: dict | None = None):
        """Punch a hole: FALLOC_FL_PUNCH_HOLE|KEEP_SIZE frees the blocks
        (posix_discard); falls back to zero-writing where the filesystem
        cannot punch."""
        fdno = self._os_fd(fd)
        try:
            await self._io(_sys_fallocate, fdno,
                           FALLOC_FL_PUNCH_HOLE | FALLOC_FL_KEEP_SIZE,
                           offset, length)
            return self._iatt_gfid(fd.gfid)
        except OSError:
            return await self.zerofill(fd, offset, length, xdata)

    async def zerofill(self, fd: FdObj, offset: int, length: int,
                       xdata: dict | None = None):
        try:
            await self._io(os.pwrite, self._os_fd(fd), b"\0" * length,
                           offset)
        except OSError as e:
            raise _fop_errno(e)
        return self._iatt_gfid(fd.gfid)

    async def rchecksum(self, fd: FdObj, offset: int, length: int,
                        xdata: dict | None = None):
        """Weak (adler32) + strong (sha256) checksum of a byte range —
        the posix_rchecksum fop (libglusterfs checksum.c): heal
        compares block checksums across bricks instead of shipping
        the bytes."""
        from ..ops.checksum import rchecksum as _rck

        data = await self.readv(fd, length, offset)
        return {**_rck(data, fips=self.opts["fips-mode-rchecksum"]),
                "len": len(data)}

    async def ipc(self, op: int = 0, xdata: dict | None = None):
        return {}

    async def icreate(self, loc: Loc, mode: int = 0o644,
                      xdata: dict | None = None):
        return await self.mknod(loc, mode, 0, xdata)

    async def put(self, loc: Loc, data: bytes, flags: int = 0,
                  mode: int = 0o644, xattrs: dict | None = None,
                  xdata: dict | None = None):
        fd, ia = await self.create(loc, flags, mode, xdata)
        try:
            await self.writev(fd, data, 0)
            if xattrs:
                await self.setxattr(loc, xattrs)
            return self._iatt(self._loc_path(loc))
        finally:
            await self.release(fd)

    async def copy_file_range(self, fd_in: FdObj, off_in: int, fd_out: FdObj,
                              off_out: int, length: int,
                              xdata: dict | None = None):
        data = await self.readv(fd_in, length, off_in)
        await self.writev(fd_out, data, off_out)
        return len(data)

    def dump_private(self) -> dict:
        return {"root": self.root,
                "gfids": len(os.listdir(self._gfid_dir))
                if os.path.isdir(self._gfid_dir) else 0}
