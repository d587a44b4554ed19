"""cluster/disperse — Reed-Solomon erasure coding across N brick subvolumes.

The reference's cluster/ec xlator (reference xlators/cluster/ec/src/) in
accelerator-build form.  Capabilities kept, mechanisms re-designed:

* **Geometry** (ec-types.h:627-680): N = K + R children; every file is
  striped in ``stripe = K*512`` byte stripes; brick i stores fragment i —
  512 bytes per stripe — at ``offset/K``.  Non-systematic code: every
  fragment (including the first K) is matrix output (ec-method.c:284-287).
* **Write path** (ec-inode-write.c:2141-2231): partial-stripe head/tail
  read-modify-write, encode via the unified card codec (ops/codec.py — the
  ``disperse.cpu-extensions`` analog), dispatch-all fragment writes,
  op_ret rescaled to user bytes.
* **Read path** (ec-inode-read.c:1148-1230): dispatch-min — read any K
  fragments per read-policy, decode, trim head/tail; degraded reads pick
  surviving bricks by the same path.
* **Transactions** (ec-common.c:2377, doc afr-style): per-write pre-op
  ``dirty+1`` / post-op ``version+1, dirty-1`` xattrop on each brick;
  version divergence marks heal candidates; quorum below K fails the fop
  (ec.c:308-316 down_count semantics).
* **Heal** (ec-heal.c:1658,2048): compare versions, decode from the good
  K, re-encode onto the bad bricks, reset their version/size/dirty.

Xattr schema on each brick (trusted.ec.* like the reference):
``trusted.ec.version`` = 2 big-endian u64 (data, metadata);
``trusted.ec.size`` = u64 true file size; ``trusted.ec.dirty`` = 2 u64.
"""

from __future__ import annotations

import asyncio
import errno
import struct
from collections import Counter

import numpy as np

from ..core.fops import FopError
from ..core.iatt import IAType, Iatt, gfid_new
from ..core.layer import Event, FdObj, Layer, Loc, register
from ..core import metrics as _metrics

#: live disperse layers, scraped (not owned) by the unified registry —
#: weak so a retired graph's layers age out with the GC
_LIVE_EC_LAYERS = _metrics.REGISTRY.register_objects(
    "gftpu_ec_read_fanout_total", "counter",
    "EC readv fan-outs by mode (fast = zero-staging systematic "
    "reassembly, staged = decode through the frags array)",
    lambda l: [({"layer": l.name, "mode": m}, v)
               for m, v in l.read_fanout.items()])
_metrics.REGISTRY.register_objects(
    "gftpu_ec_readv_coalesced_total", "counter",
    "adjacent readv chain links merged into single ranged fragment "
    "fan-outs (chains = merged dispatches, links = member readvs "
    "absorbed)",
    lambda l: [({"layer": l.name, "what": m}, v)
               for m, v in l.read_coalesced.items()],
    live=_LIVE_EC_LAYERS)
# parity-delta write plane (ISSUE 10): which path each unaligned write
# took, and what the delta path saved over the full read-modify-write
_metrics.REGISTRY.register_objects(
    "gftpu_ec_delta_writes_total", "counter",
    "sub-stripe writes served by the parity-delta path (touched data "
    "slices + brick-side parity xorv; no k-fragment decode)",
    lambda l: [({"layer": l.name, "origin": o}, v)
               for o, v in l.delta_origin.items()],
    live=_LIVE_EC_LAYERS)
_metrics.REGISTRY.register_objects(
    "gftpu_ec_rmw_writes_total", "counter",
    "unaligned writes that paid the full read-modify-write (degraded, "
    "non-systematic, EOF-crossing, delta-writes off, or a peer "
    "without xorv)",
    lambda l: [({"layer": l.name}, l.write_path["rmw"])],
    live=_LIVE_EC_LAYERS)
_metrics.REGISTRY.register_objects(
    "gftpu_ec_delta_bytes_saved_total", "counter",
    "fragment bytes the delta path did NOT move versus the full RMW "
    "it replaced (dir=read: decode-source bytes not read; dir=write: "
    "fragment bytes not rewritten)",
    lambda l: [({"layer": l.name, "dir": d}, v)
               for d, v in l.delta_saved.items()],
    live=_LIVE_EC_LAYERS)
from ..core.options import Option
from ..core import gflog
from ..core import tracing as _tracing
from ..rpc import wire

import time as _time

log = gflog.get_logger("ec")


class _DeltaFallback(Exception):
    """Internal: the parity-delta path bailed before committing
    anything it cannot undo (live-downgraded peer, failed internal
    read) — the caller redoes the write through the full-RMW path,
    which rewrites every fragment of the region and converges any
    partially-applied wave."""

XA_VERSION = "trusted.ec.version"
XA_SIZE = "trusted.ec.size"
XA_DIRTY = "trusted.ec.dirty"

CHUNK = 512

#: xdata flag on heal rebuild writes (the bit-rot stub's HEAL_WRITE key:
#: the same string, so bricks of either package read it alike)
HEAL_WRITE = "glusterfs_tpu.heal-write"


def _u64x2(data: bytes | None) -> tuple[int, int]:
    if not data:
        return (0, 0)
    return struct.unpack(">QQ", data.ljust(16, b"\0")[:16])


def _pack_u64x2(a: int, b: int) -> bytes:
    return struct.pack(">QQ", a, b)


class ECFdCtx:
    """Per-EC-fd state: one child fd per brick (index -> FdObj|None)."""

    __slots__ = ("child_fds", "flags")

    def __init__(self, child_fds: dict[int, FdObj], flags: int):
        self.child_fds = child_fds
        self.flags = flags


class _EagerState:
    """One held eager transaction window (the ec_lock_t analog,
    ec-common.c:2176 eager-lock reuse + delayed post-op): the cluster
    inodelk stays held across consecutive fops on the same inode, the
    (candidates, size) metadata is cached under it, the pre-op dirty
    mark is set once, and ONE combined version+size+dirty xattrop
    commits at window close."""

    __slots__ = ("owner", "locked", "pre", "good", "candidates", "size",
                 "delta", "timer", "opened", "inflight", "idle",
                 "pre_landed", "ranges", "rseq")

    def __init__(self, owner: bytes, locked: list[int],
                 candidates: list[int], size: int, good: set[int],
                 opened: float):
        self.owner = owner
        self.locked = locked          # bricks holding our inodelk
        self.pre: set[int] = set()    # bricks that got the dirty+1 pre-op
        self.good = good              # bricks that took EVERY write so far
        self.candidates = candidates  # consistent read rows (cached meta)
        self.size = size              # current true size (cached meta)
        self.delta = 0                # pending data-version increments
        self.timer = None             # deferred-release handle
        self.opened = opened          # loop time: bounds total hold
        # parallel-writes state (ec_is_range_conflict, ec-common.c:185):
        # non-conflicting write waves run outside the local gfid lock
        self.inflight = 0             # write-class waves mid-dispatch
        self.idle = asyncio.Event()   # set while inflight == 0
        self.idle.set()
        self.pre_landed = asyncio.Event()  # dirty+1 is ON the bricks
        self.ranges: dict[int, tuple[int, int, asyncio.Future]] = {}
        self.rseq = 0

    def conflict(self, a_off: int, a_end: int) -> "asyncio.Future | None":
        """Completion future of an overlapping in-flight write, if any."""
        for off, end, fut in self.ranges.values():
            if off < a_end and a_off < end:
                return fut
        return None

    def add_range(self, a_off: int, a_end: int) -> int:
        self.rseq += 1
        fut = asyncio.get_running_loop().create_future()
        self.ranges[self.rseq] = (a_off, a_end, fut)
        return self.rseq

    def del_range(self, token: int) -> None:
        """Lock-free on purpose: waiters may hold the gfid lock while
        they wait for us (quiesce), so removal must not need it."""
        ent = self.ranges.pop(token, None)
        if ent is not None and not ent[2].done():
            ent[2].set_result(None)


@register("cluster/disperse")
class DisperseLayer(Layer):
    OPTIONS = (
        Option("redundancy", "int", default=2, min=1, max=8),
        Option("cpu-extensions", "enum", default="auto",
               values=("auto", "cuda", "cuda-mma", "torch", "torch-mma",
                       "native", "ref"),
               description="codec backend (reference disperse.cpu-extensions"
                           " {none,auto,x64,sse,avx} -> auto = cuda, the "
                           "hand-written kernels on the card; cuda-mma = "
                           "non-systematic encode and decode on the "
                           "tensor-core kernel; torch, torch-mma = their "
                           "plain PyTorch versions on the CPU; native = "
                           "the host's AVX2 codec; ref = the NumPy "
                           "oracle)"),
        Option("read-policy", "enum", default="round-robin",
               values=("round-robin", "gfid-hash", "first-k")),
        Option("ec-read-mask", "str", default="",
               description="comma-separated child indices allowed to "
                           "serve reads (ec_assign_read_mask, "
                           "ec.c:717-775): keeps a slow or suspect "
                           "brick out of the read set.  Strict, like "
                           "the reference (fop->mask &= read_mask, "
                           "ec-inode-read.c:1375): a masked-out brick "
                           "never serves reads, even degraded.  Must "
                           "name at least K ids; invalid masks log and "
                           "clear"),
        Option("parallel-writes", "bool", default="on",
               description="writes touching disjoint stripe ranges of "
                           "one inode dispatch concurrently inside the "
                           "eager window instead of serializing "
                           "(disperse.parallel-writes, ec.c:284,868 + "
                           "ec_is_range_conflict ec-common.c:185)"),
        Option("quorum-count", "int", default=0, min=0,
               description="extra write quorum (0 = K)"),
        Option("delta-writes", "bool", default="on",
               description="parity-delta sub-stripe writes "
                           "(cluster.delta-writes, op-version 12): on a "
                           "HEALTHY systematic volume an unaligned "
                           "write inside the file reads back only the "
                           "bytes it overwrites from the touched data "
                           "fragments, forms Δ = old ⊕ new, and "
                           "dispatches the touched data slices as "
                           "writev plus parity(Δ) as brick-side xorv — "
                           "one wave, no k-fragment decode, no "
                           "n-fragment rewrite (the classic RAID "
                           "parity-logging result; linearity: "
                           "frag(old ⊕ Δ) = frag(old) ⊕ frag(Δ)).  "
                           "Degraded / non-systematic / EOF-crossing "
                           "writes (and peers without xorv) keep the "
                           "full read-modify-write path byte-"
                           "identically"),
        Option("systematic", "bool", default="off",
               description="systematic generator matrix "
                           "(gf256.systematic_matrix): data fragments "
                           "are raw stripe chunks, so healthy reads "
                           "skip decode entirely, encode ships only "
                           "parity to the device, and degraded reads "
                           "reconstruct only missing rows — the "
                           "device-first layout when the accelerator sits "
                           "behind a bandwidth-bound link.  The "
                           "reference's code is non-systematic "
                           "(ec-method.c:393-433; every read decodes). "
                           "Fragment formats are incompatible: fixed "
                           "at volume create, immutable live"),
        Option("self-heal-window-size", "size", default="1M"),
        Option("stripe-cache", "bool", default="on",
               description="coalesce concurrent fop codec work into one "
                           "device batch per tick (ec.c:286 analog)"),
        Option("stripe-cache-window", "int", default=0, min=0,
               description="batching window in microseconds; 0 = "
                           "same-tick coalescing (flush on the next "
                           "loop pass — concurrent fops still batch, "
                           "a lone sequential writer never waits)"),
        Option("stripe-cache-min-batch", "size", default="256KB",
               description="batches below this run on the CPU ladder "
                           "(the native codec); at or above it the "
                           "calibrated timing models pick the card or "
                           "the CPU per flush, and the card takes them "
                           "until calibration (after a quiet gap) has "
                           "fitted the models; 0 pins every flush to "
                           "the card.  The floor is the one rule before "
                           "calibration and bounds a poor fit, which "
                           "could send flushes of a few stripes over the "
                           "link; the default lies below the break-even "
                           "measured on an H100's host"),
        Option("eager-lock", "bool", default="on",
               description="hold the txn inodelk across consecutive fops "
                           "on one inode with a delayed combined post-op "
                           "(disperse.eager-lock, ec-common.c:2176)"),
        Option("other-eager-lock", "bool", default="on",
               description="non-write fops (reads) share the eager "
                           "window too (disperse.other-eager-lock): "
                           "consecutive reads on one inode pay one lock "
                           "wave total.  The window's inodelk is "
                           "exclusive, so cross-CLIENT concurrent "
                           "readers of one file serialize on lock "
                           "handoffs — turn this off for that workload "
                           "(reads then take shared rd locks per fop), "
                           "same tradeoff the reference documents"),
        Option("eager-lock-timeout", "time", default="0.2",
               description="idle window before the eager lock releases "
                           "(reference post-op-delay semantics)"),
        Option("other-eager-lock-timeout", "time", default="0.2",
               description="separate release timeout for CLEAN "
                           "(read-only) windows "
                           "(disperse.other-eager-lock-timeout)"),
        Option("eager-lock-max-hold", "time", default="1",
               description="hard cap on one window's total hold time — "
                           "bounds how long a continuous writer can "
                           "starve other clients of the inodelk (the "
                           "reference yields on contention upcall; "
                           "brick locks queue FIFO, so the waiting "
                           "client gets the lock at the cap)"),
    )

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.n = len(self.children)
        self.r = self.opts["redundancy"]
        self.k = self.n - self.r
        if self.k < 1 or self.r < 1:
            raise ValueError(
                f"{self.name}: need K>=1, R>=1 (n={self.n}, r={self.r})")
        if self.k > 16:
            raise ValueError(f"{self.name}: K={self.k} exceeds max 16")
        if str(self.opts.get("mesh-codec", "off")).lower() in \
                ("on", "yes", "true", "enable", "1"):
            raise ValueError(f"{self.name}: mesh-codec is not available "
                             "in this package (single-card codec only)")
        self.codec = self._make_codec()
        self._batching = self.opts["stripe-cache"]
        # default origin label for this layer's codec traffic on the
        # batch/mesh metrics families: "serve" for a client mount; the
        # rebalance daemon tags its PRIVATE graph "rebalance" so mesh
        # launches and counters attribute migration I/O (the shd heal
        # precedent — explicit origin="heal" call sites still win)
        self.traffic_origin = "serve"
        self.stripe = self.k * CHUNK
        self.up = [True] * self.n  # xl_up bitmask (ec.c:571 notify)
        self._locks: dict[bytes, asyncio.Lock] = {}
        self._rr = 0  # read-policy round-robin cursor
        from ..core.iatt import gfid_new as _g

        self._lk_owner = _g()  # this client's lk-owner identity
        self._locks_supported: bool | None = None  # lazily probed
        self._eager: dict[bytes, _EagerState] = {}  # gfid -> held window
        self._bg: set[asyncio.Task] = set()  # strong refs to drain tasks
        self._read_mask = self._parse_read_mask()
        # read fan-out accounting (ISSUE 3): "fast" = healthy systematic
        # reassembly straight from fragment buffers (no staging copy),
        # "staged" = the decode path through the frags array
        self.read_fanout = {"fast": 0, "staged": 0}
        # fragment-readv coalescing (ROADMAP item 7): adjacent readv
        # links of one compound chain merged into ONE ranged brick
        # read per fan-out
        self.read_coalesced = {"chains": 0, "links": 0}
        # parity-delta write plane (ISSUE 10): path taken per unaligned
        # write + fragment bytes the delta path saved over full RMW
        self.write_path = {"delta": 0, "rmw": 0}
        # delta writes split by traffic_origin ("serve" vs "rebalance"
        # vs "heal"): write_path["delta"] stays the total; this dict
        # feeds the per-origin samples on the registry family so an
        # operator can see migration I/O riding the delta plane
        self.delta_origin = {"serve": 0}
        self.delta_saved = {"read": 0, "write": 0}
        # live-downgrade memory: a parity brick answering EOPNOTSUPP to
        # xorv parks the WHOLE layer on the RMW path (parity rows are
        # fixed brick indices — one refusing brick breaks every delta)
        self._xorv_ok = True
        # last announced "≥K children up" state (events.h
        # EVENT_EC_MIN_BRICKS_UP / _NOT_UP fire on the transition)
        self._min_up_ok = True
        _LIVE_EC_LAYERS.add(self)  # unified-registry scrape target

    def reconfigure(self, options: dict) -> None:
        """Live option apply (ec_reconfigure, ec.c:254): codec backend /
        batching options rebuild the codec; geometry (redundancy) is
        immutable on a live volume."""
        old = dict(self.opts)
        super().reconfigure(options)
        if self.opts["redundancy"] != self.r:
            log.warning(3, "%s: redundancy is immutable live (%d -> %d "
                        "ignored)", self.name, self.r,
                        self.opts["redundancy"])
            self.opts["redundancy"] = self.r
        if self.opts["systematic"] != old["systematic"]:
            # the fragment format on the bricks: flipping it live would
            # make every existing file decode to garbage
            log.warning(3, "%s: systematic is immutable live (ignored)",
                        self.name)
            self.opts["systematic"] = old["systematic"]
        codec_keys = ("cpu-extensions", "stripe-cache-window",
                      "stripe-cache-min-batch")
        if any(self.opts[k] != old[k] for k in codec_keys):
            self.codec.close()  # release the replaced codec's pool
            self.codec = self._make_codec()
        self._batching = self.opts["stripe-cache"]
        self._read_mask = self._parse_read_mask()
        if self.opts["delta-writes"]:
            # re-arm the downgrade memory on ANY reconfigure that
            # leaves the key on: volume-set is the operator's "bricks
            # were upgraded, try again" signal, and a still-downgraded
            # peer re-parks at the client-side capability gate for the
            # cost of one local EOPNOTSUPP (no round trip)
            self._xorv_ok = True

    def _make_codec(self):
        """The layer's batching codec; ``cpu-extensions torch`` and
        ``torch-mma`` are the volume's explicit request for the CPU."""
        from ..ops.batch import BatchingCodec

        backend = self.opts["cpu-extensions"]
        return BatchingCodec(
            self.k, self.r, backend,
            window=self.opts["stripe-cache-window"] / 1e6,
            min_batch=self.opts["stripe-cache-min-batch"],
            systematic=self.opts["systematic"],
            device="cpu" if backend.startswith("torch") else None,
            name=self.name)

    def _parse_read_mask(self) -> frozenset[int] | None:
        """ec_assign_read_mask (ec.c:717-775): parse + validate — every
        id a real child index, at least K ids total.  The reference
        fails the option set; our reconfigure path logs and clears."""
        raw = str(self.opts["ec-read-mask"] or "").strip()
        if not raw:
            return None
        try:
            ids = frozenset(int(p) for p in raw.split(",") if p.strip())
        except ValueError:
            log.warning(3, "%s: ec-read-mask %r has a non-integer id; "
                        "ignoring mask", self.name, raw)
            return None
        if any(i < 0 or i >= self.n for i in ids):
            log.warning(3, "%s: ec-read-mask %r id out of range [0-%d]; "
                        "ignoring mask", self.name, raw, self.n - 1)
            return None
        if len(ids) < self.k:
            log.warning(3, "%s: ec-read-mask %r names fewer than K=%d "
                        "ids; ignoring mask", self.name, raw, self.k)
            return None
        return ids

    # -- child state -------------------------------------------------------

    def notify(self, event: Event, source=None, data=None):
        if event is Event.UPCALL:
            if isinstance(data, dict) and \
                    data.get("event") == "inodelk-contention" and \
                    data.get("gfid") in self._eager:
                # another client (or a snapshot quiesce) wants our
                # inodelk: commit the delayed post-op and release NOW
                # instead of sitting out the post-op delay
                # (ec_upcall GF_UPCALL_INODELK_CONTENTION ->
                # ec_lock_release, ec-common.c:2576-2582)
                gfid = data["gfid"]
                t = asyncio.get_event_loop().create_task(
                    self._eager_drain(Loc("", gfid=gfid), gfid))
                self._bg.add(t)
                t.add_done_callback(self._bg.discard)
            # upcalls pass through untranslated (ec_notify forwards
            # GF_EVENT_UPCALL to parents as-is)
            for p in self.parents:
                p.notify(event, self, data)
            return
        if source in self.children:
            idx = self.children.index(source)
            if event is Event.CHILD_DOWN:
                self.up[idx] = False
                log.warning(1, "%s: child %s down (%d/%d up)", self.name,
                            source.name, sum(self.up), self.n)
            elif event is Event.CHILD_UP:
                self.up[idx] = True
            ok = sum(self.up) >= self.k
            if ok != self._min_up_ok:
                # read-quorum edge (ec_notify, ec.c:571): below K the
                # disperse set can neither read nor write
                self._min_up_ok = ok
                from ..core.events import gf_event

                gf_event("EC_MIN_BRICKS_UP" if ok
                         else "EC_MIN_BRICKS_NOT_UP",
                         subvol=self.name, up=sum(self.up), k=self.k,
                         children=self.n)
            if sum(self.up) >= self.k:
                for p in self.parents:
                    p.notify(Event.CHILD_UP if event is Event.CHILD_UP
                             else Event.SOME_DESCENDENT_DOWN, self, data)
            else:
                for p in self.parents:
                    p.notify(Event.CHILD_DOWN, self, data)
            return
        super().notify(event, source, data)

    def set_child_up(self, idx: int, up: bool) -> None:
        """Test/heal hook: mark a brick up/down."""
        self.up[idx] = up

    def _up_idx(self) -> list[int]:
        return [i for i, u in enumerate(self.up) if u]

    def _write_quorum(self) -> int:
        q = self.opts["quorum-count"]
        return max(self.k, q) if q else self.k

    def _lock(self, key: bytes) -> asyncio.Lock:
        lk = self._locks.get(key)
        if lk is None:
            lk = self._locks[key] = asyncio.Lock()
        return lk

    # -- cluster-wide transaction locks (ec-locks.c / ec_lock analog) ------

    async def _inodelk_wind(self, loc: Loc, ltype: str,
                            owner: bytes | None = None,
                            start: int = 0, end: int = -1,
                            collect: dict | None = None) -> list[int]:
        """Take an inodelk on every up child (brick-side features/locks);
        children without a locks layer (EOPNOTSUPP) are skipped.  Locks
        are wound in index order — all clients use the same order, so
        cross-client deadlock cannot occur (ec-locks.c ordering).
        ``start``/``end`` bound the byte range (end exclusive, -1 =
        EOF): writes lock the whole file, heal locks one window at a
        time (ec_heal_inodelk offset/size, ec-heal.c:251).
        ``collect``: lock-and-fetch — each grant returns the inode's
        xattrs (collect[i] = dict), folding the window's metadata
        fan-out into the lock wave."""
        if self._locks_supported is False:
            return []
        xd = {"lk-owner": owner or self._lk_owner}
        if collect is not None:
            xd["get-xattrs"] = True

        def absorb(i: int, ret) -> None:
            # only trust fetches that carry real counter state: a failed
            # fetch (None), a locks layer predating get-xattrs (None
            # grant return), or a brick whose counters are simply absent
            # must NOT be parsed as "clean version 0, size 0" — that
            # fabricated entry could win _pick_meta's vote and corrupt
            # the recorded size.  Missing entries force the caller back
            # to the classic metadata wave.
            if collect is not None and isinstance(ret, dict) \
                    and XA_VERSION in ret:
                collect[i] = ret

        # Fast path (ec-locks.c / afr_lock: try NON-BLOCKING on every
        # child in ONE parallel wave; conflicts fall back to the ordered
        # blocking walk).  The sequential walk alone costs up-count
        # round trips of pure latency per transaction.
        ups = self._up_idx()
        res = await self._dispatch(
            ups, "inodelk",
            lambda i: (("ec.transaction", loc, "lock-nb", ltype, start,
                        end, xd), {}))
        granted = [i for i, r in res.items()
                   if not isinstance(r, BaseException)]
        errs = {i: r for i, r in res.items() if isinstance(r, BaseException)}
        if all(isinstance(e, FopError) and e.err == errno.EOPNOTSUPP
               for e in errs.values()):
            for i in granted:
                absorb(i, res[i])
            if self._locks_supported is None:
                self._locks_supported = bool(granted)
            return sorted(granted)
        # somebody holds a conflicting lock (or a brick failed): release
        # what we took and walk children in index order with BLOCKING
        # locks — all clients use the same order, so cross-client
        # deadlock cannot occur (ec-locks.c ordering)
        await self._inodelk_unwind(loc, sorted(granted), owner, start, end)
        if collect is not None:
            collect.clear()
        locked: list[int] = []
        try:
            for i in ups:
                try:
                    ret = await self.children[i].inodelk(
                        "ec.transaction", loc, "lock", ltype, start, end,
                        xd)
                    locked.append(i)
                    absorb(i, ret)
                except FopError as e:
                    if e.err == errno.EOPNOTSUPP:
                        continue
                    raise
        except FopError:
            await self._inodelk_unwind(loc, locked, owner, start, end)
            raise
        if self._locks_supported is None:
            self._locks_supported = bool(locked)
        return locked

    async def _inodelk_unwind(self, loc: Loc, locked: list[int],
                              owner: bytes | None = None,
                              start: int = 0, end: int = -1) -> None:
        if not locked:
            return
        xd = {"lk-owner": owner or self._lk_owner}
        # one parallel wave; failures (restarted brick: lock already
        # reaped) are ignored per child
        await self._dispatch(
            list(locked), "inodelk",
            lambda i: (("ec.transaction", loc, "unlock", "wr", start, end,
                        xd), {}))

    class _Txn:
        """Write-transaction scope: local serialization + cluster inodelk.

        ``start``/``end`` bound the locked byte range (end exclusive,
        -1 = EOF).  Writes use the full range; heal uses one window per
        txn so writers interleave between windows (ec-heal.c:251)."""

        def __init__(self, ec: "DisperseLayer", loc: Loc, gfid: bytes,
                     ltype: str = "wr", start: int = 0, end: int = -1,
                     fetch: bool = False):
            self.ec = ec
            self.loc = loc
            self.gfid = gfid
            self.ltype = ltype
            self.start = start
            self.end = end
            self.locked: list[int] = []
            # lock-and-fetch: grants carry the inode's xattrs so the
            # caller's metadata wave folds into the lock wave
            self.fetched: dict[int, dict] = {} if fetch else None
            self.local = ltype == "wr" or ec._locks_supported is False
            # Per-transaction lk-owner (reference frame->root->lk_owner):
            # with a per-client owner this client's reads would never
            # conflict with its own in-flight writes brick-side and could
            # decode a mix of old and new fragments mid-write.
            from ..core.iatt import gfid_new as _g

            self.owner = _g()

        async def __aenter__(self):
            if self.local:
                await self.ec._lock(self.gfid).acquire()
                # Flush any eager window NOW, while holding the local
                # lock, before winding our own inodelk: the window holds
                # a conflicting brick lock whose deferred drain needs
                # the local lock we hold — waiting on the brick lock
                # here would deadlock until the lock timeout (and no new
                # window can open while we hold the local lock).
                if self.gfid in self.ec._eager:
                    await self.ec._eager_flush(self.loc, self.gfid)
            try:
                self.locked = await self.ec._inodelk_wind(
                    self.loc, self.ltype, self.owner, self.start,
                    self.end, collect=self.fetched)
            except BaseException:
                if self.local:
                    self.ec._lock(self.gfid).release()
                raise
            if not self.locked and not self.local:
                # no brick-side locks available: fall back to local mutex
                self.local = True
                await self.ec._lock(self.gfid).acquire()
            return self

        async def __aexit__(self, *exc):
            await self.ec._inodelk_unwind(self.loc, self.locked,
                                          self.owner, self.start,
                                          self.end)
            if self.local:
                self.ec._lock(self.gfid).release()
            return False

    # -- eager lock window (ec-common.c:2176 ec_lock_reuse + delayed
    # post-op ec-common.c:2377) ---------------------------------------------

    async def _eager_begin(self, loc: Loc, gfid: bytes) -> _EagerState:
        """Open (or join) the eager window.  Caller holds the local gfid
        lock.  First entry pays the inodelk + metadata fan-out; joiners
        pay nothing."""
        st = self._eager.get(gfid)
        if st is not None:
            if st.timer is not None:
                st.timer.cancel()
                st.timer = None
            return st
        owner = gfid_new()
        fetched: dict[int, dict] = {}
        locked = await self._inodelk_wind(loc, "wr", owner,
                                          collect=fetched)
        try:
            if locked and set(self._up_idx()) <= set(fetched):
                # lock-and-fetch covered every up child: the lock wave
                # WAS the metadata wave
                candidates, size = self._pick_meta(
                    {i: self._parse_meta(r) for i, r in fetched.items()})
            else:
                candidates, size = await self._read_meta(loc)
        except BaseException:
            await self._inodelk_unwind(loc, locked, owner)
            raise
        st = _EagerState(owner, locked, candidates, size,
                         set(self._up_idx()),
                         asyncio.get_running_loop().time())
        self._eager[gfid] = st
        return st

    async def _eager_end(self, loc: Loc, gfid: bytes) -> None:
        """Leave the window: flush now (eager-lock off, or the max-hold
        cap reached) or arm the deferred release timer.  Caller holds
        the local gfid lock."""
        st = self._eager.get(gfid)
        if st is None:
            return
        loop = asyncio.get_running_loop()
        clean = st.delta == 0 and not st.pre
        timeout = 0
        if self.opts["eager-lock"]:
            timeout = self.opts["other-eager-lock-timeout"] if clean \
                else self.opts["eager-lock-timeout"]
        if timeout <= 0 or \
                loop.time() - st.opened >= self.opts["eager-lock-max-hold"]:
            await self._eager_flush(loc, gfid)
            return
        if st.timer is not None:
            st.timer.cancel()
        st.timer = loop.call_later(timeout, self._eager_timer_cb, loc, gfid)

    def _eager_timer_cb(self, loc: Loc, gfid: bytes) -> None:
        """Timer fired: drain in a task we keep a strong reference to
        (the loop holds pending tasks only weakly — an unreferenced
        flush task could be garbage-collected mid-flight, leaking the
        cluster lock)."""
        t = asyncio.get_event_loop().create_task(
            self._eager_drain(loc, gfid))
        self._bg.add(t)
        t.add_done_callback(self._bg.discard)

    async def _eager_drain(self, loc: Loc, gfid: bytes) -> None:
        """Take the local lock and flush the window (timer path, and any
        fop that needs committed counters: fsync/heal/truncate)."""
        if gfid not in self._eager:
            return
        async with self._lock(gfid):
            await self._eager_flush(loc, gfid)

    async def _quiesce_writes(self, st: _EagerState) -> None:
        """Wait out in-flight parallel write waves.  Callers hold the
        local gfid lock, so no NEW wave can register while we wait
        (registration needs that lock); completion is lock-free."""
        while st.ranges:
            await next(iter(st.ranges.values()))[2]
        while st.inflight:
            await st.idle.wait()

    async def _eager_flush(self, loc: Loc, gfid: bytes) -> None:
        """Commit the delayed post-op in ONE mixed xattrop (version
        add64 + size set + dirty release, atomic on each brick) and drop
        the cluster lock.  Dirty is released only when every brick took
        every write in the window.  Caller holds the local gfid lock."""
        st = self._eager.get(gfid)
        if st is None:
            return
        if st.timer is not None:
            st.timer.cancel()
            st.timer = None
        # quiesce parallel-writes waves first: the post-op must describe
        # a settled window.  New waves can't start — registration needs
        # the gfid lock we hold; removal is lock-free so they can drain.
        await self._quiesce_writes(st)
        self._eager.pop(gfid, None)
        # commit gfid-addressed, NOT by the window-open path: a rename
        # while the post-op was deferred makes that path a lie, and the
        # per-child ENOENTs would silently strand the size/version
        # commit (the file then reads as empty forever — the chaos
        # harness caught exactly this through the gateway's temp+rename
        # PUT).  The reference never has this problem because its
        # xattrop addresses the inode; gfid is our inode identity.
        if gfid:
            loc = Loc("", gfid=gfid)
        unlocked: set[int] = set()
        try:
            post: dict = {}
            if st.delta:
                post[XA_VERSION] = ["add64", _pack_u64x2(st.delta, 0)]
                post[XA_SIZE] = ["set", struct.pack(">Q", st.size)]
            if st.pre and st.good == st.pre and len(st.good) == self.n:
                post[XA_DIRTY] = ["add64",
                                  _pack_u64x2(-1 & 0xFFFFFFFFFFFFFFFF, 0)]
            targets = sorted(st.good & set(self._up_idx()))
            if post and targets:
                # compound unlock: the brick releases this window's
                # inodelk right after committing the post-op (handled by
                # features/locks) — one wave instead of two per window
                lockset = set(st.locked)
                xd = {"unlock-inodelk": ["ec.transaction", "wr", 0, -1,
                                         st.owner]}
                res = await self._dispatch(
                    targets, "xattrop",
                    lambda i: ((loc, "mixed", dict(post)),
                               {"xdata": dict(xd)}
                               if i in lockset else {}))
                unlocked = {i for i, r in res.items()
                            if i in lockset
                            and not isinstance(r, BaseException)}
        finally:
            rest = [i for i in st.locked if i not in unlocked]
            await self._inodelk_unwind(loc, rest, st.owner)

    async def _eager_drain_fd(self, fd: FdObj, force: bool = True) -> None:
        if fd.gfid in self._eager:
            if not force:
                # flush/release are NOT durability points: the delayed
                # post-op outlives them and commits on the deferred-
                # release timer (reference post-op-delay + ec_lock_reuse
                # semantics — the lock and pending xattrop persist past
                # the fop, dropping on timeout/contention; a crash in
                # the window leaves dirty set and heal settles it).
                # This keeps the commit wave off the close latency path
                # and lets an immediate re-open join the live window.
                # fsync (and _Txn entry) still force the drain.
                loc = Loc(fd.path, gfid=fd.gfid)
                async with self._lock(fd.gfid):
                    await self._eager_end(loc, fd.gfid)
                return
            await self._eager_drain(Loc(fd.path, gfid=fd.gfid), fd.gfid)

    # -- dispatch + combine (ec-common.c:816-900, ec-combine.c) ------------

    @property
    def _local_children(self) -> bool:
        """True when no child subtree crosses a wire: awaiting them in
        sequence costs nothing in latency (same event loop does all the
        work anyway) and skips one task creation + wakeup per child per
        wave — a measurable share of the smallfile budget.  Wire
        children keep the concurrent gather so RTTs overlap."""
        cached = getattr(self, "_local_cached", None)
        if cached is None:
            from ..core.layer import walk

            cached = all(l.type_name != "protocol/client"
                         for ch in self.children for l in walk(ch))
            self._local_cached = cached
        return cached

    async def _dispatch(self, idxs: list[int], op: str, argfn):
        """Run fop on children idxs concurrently; returns {idx: result or
        exception}.  argfn(i) -> (args, kwargs) per child."""
        return await self._dispatch_multi(
            {i: (op, *argfn(i)) for i in idxs}, order=idxs)

    async def _dispatch_multi(self, wave: dict[int, tuple],
                              order: list[int] | None = None):
        """Concurrent dispatch with a (possibly) DIFFERENT fop per
        child: ``wave[i] = (op, args, kwargs)`` — the delta write
        path's one mixed wave of data-slice writev + parity xorv, and
        the engine under :meth:`_dispatch`."""
        idxs = sorted(wave) if order is None else order
        if self._local_children:
            out = {}
            for i in idxs:
                op, args, kwargs = wave[i]
                try:
                    out[i] = await getattr(self.children[i], op)(*args,
                                                                 **kwargs)
                except Exception as e:
                    out[i] = e
            return out

        async def one(i):
            op, args, kwargs = wave[i]
            return await getattr(self.children[i], op)(*args, **kwargs)

        results = await asyncio.gather(*(one(i) for i in idxs),
                                       return_exceptions=True)
        return dict(zip(idxs, results))

    def _combine(self, res: dict, min_ok: int | None = None):
        """Pick the quorum answer: enough successes -> representative
        result + list of good indices; else raise the most common error
        (ec_fop_prepare_answer semantics)."""
        min_ok = self.k if min_ok is None else min_ok
        good = {i: r for i, r in res.items()
                if not isinstance(r, BaseException)}
        if len(good) >= min_ok:
            return good
        errs = [r.err for r in res.values() if isinstance(r, FopError)]
        if errs:
            raise FopError(Counter(errs).most_common(1)[0][0],
                           f"{len(good)}/{len(res)} children succeeded")
        for r in res.values():
            if isinstance(r, BaseException):
                raise r
        raise FopError(errno.EIO, "quorum failure")

    # -- xattr counters ----------------------------------------------------

    @staticmethod
    def _parse_meta(r: dict) -> dict:
        return {
            "version": _u64x2(r.get(XA_VERSION)),
            "size": struct.unpack(
                ">Q", r.get(XA_SIZE, b"\0" * 8).ljust(8, b"\0"))[0],
            "dirty": _u64x2(r.get(XA_DIRTY)),
        }

    async def _get_meta(self, idxs, loc: Loc):
        """Per-child (version, size, dirty) from xattrs."""
        res = await self._dispatch(idxs, "getxattr", lambda i: ((loc, None), {}))
        return {i: (r if isinstance(r, BaseException)
                    else self._parse_meta(r))
                for i, r in res.items()}

    async def _xattrop(self, idxs, loc: Loc, deltas: dict[str, bytes]):
        return await self._dispatch(
            idxs, "xattrop", lambda i: ((loc, "add64", dict(deltas)), {}))

    # -- size helpers ------------------------------------------------------

    @staticmethod
    def _vote_size(values) -> int | None:
        """Most-common decoded trusted.ec.size among raw xattr values
        (ONE copy of the unpack + vote semantics for every caller)."""
        sizes = [struct.unpack(">Q", v.ljust(8, b"\0"))[0]
                 for v in values]
        if not sizes:
            return None
        return Counter(sizes).most_common(1)[0][0]

    async def _true_size(self, loc: Loc, idxs=None) -> int:
        idxs = idxs if idxs is not None else self._up_idx()
        res = await self._dispatch(idxs, "getxattr",
                                   lambda i: ((loc, XA_SIZE), {}))
        vote = self._vote_size(
            r[XA_SIZE] for r in res.values()
            if not isinstance(r, BaseException) and XA_SIZE in r)
        return 0 if vote is None else vote

    def _frag_len(self, nbytes: int) -> int:
        """Fragment bytes covering nbytes of user data (stripe padded)."""
        stripes = (nbytes + self.stripe - 1) // self.stripe
        return stripes * CHUNK

    # -- fd plumbing -------------------------------------------------------

    def _child_fd(self, fd: FdObj, i: int) -> FdObj:
        ctx: ECFdCtx | None = fd.ctx_get(self)
        if ctx is None or ctx.child_fds.get(i) is None:
            # anonymous child fd by gfid (reference anonymous fds)
            return FdObj(fd.gfid, fd.flags, path=fd.path, anonymous=True)
        return ctx.child_fds[i]

    # -- namespace fops: dispatch-all + combine ----------------------------

    async def lookup(self, loc: Loc, xdata: dict | None = None):
        # ask every child to piggyback its xattrs on the reply: the
        # true-size vote then needs no second fan-out (the reference
        # loads trusted.ec.* through lookup's dict_t request keys,
        # ec-generic.c ec_lookup)
        xd_req = dict(xdata or {})
        xd_req["get-xattrs"] = True
        res = await self._dispatch(self._up_idx(), "lookup",
                                   lambda i: ((loc, xd_req), {}))
        good = self._combine(res)
        ia, xd = next(iter(good.values()))
        ia = Iatt(**{**ia.__dict__})
        if ia.ia_type is IAType.REG:
            st = self._eager.get(ia.gfid)
            # an open eager window caches the authoritative size (the
            # size xattr commit is deferred to window close)
            if st is not None:
                ia.size = st.size
            else:
                vote = self._vote_size(
                    r[1][XA_SIZE] for r in good.values()
                    if isinstance(r[1], dict) and XA_SIZE in r[1])
                ia.size = vote if vote is not None \
                    else await self._true_size(loc, list(good))
        if isinstance(xd, dict) and xd:
            # the piggybacked counters are EC-internal: never leak
            # trusted.ec.* into upper caches / user-visible xattrs
            xd = {k: v for k, v in xd.items()
                  if not k.startswith("trusted.ec.")}
        return ia, xd

    async def stat(self, loc: Loc, xdata: dict | None = None):
        ia, _ = await self.lookup(loc, xdata)
        return ia

    async def fstat(self, fd: FdObj, xdata: dict | None = None):
        loc = Loc(fd.path, gfid=fd.gfid)
        return await self.stat(loc, xdata)

    async def _dispatch_all_simple(self, op: str, *args, **kw):
        res = await self._dispatch(self._up_idx(), op,
                                   lambda i: (args, kw))
        good = self._combine(res)
        return next(iter(good.values()))

    async def mkdir(self, loc: Loc, mode: int = 0o755,
                    xdata: dict | None = None):
        from ..core.iatt import gfid_new

        xdata = dict(xdata or {})
        xdata.setdefault("gfid-req", gfid_new())  # same gfid on all bricks
        return await self._dispatch_all_simple("mkdir", loc, mode, xdata)

    async def unlink(self, loc: Loc, xdata: dict | None = None):
        return await self._dispatch_all_simple("unlink", loc, xdata)

    async def rmdir(self, loc: Loc, flags: int = 0,
                    xdata: dict | None = None):
        return await self._dispatch_all_simple("rmdir", loc, flags, xdata)

    async def rename(self, oldloc: Loc, newloc: Loc,
                     xdata: dict | None = None):
        return await self._dispatch_all_simple("rename", oldloc, newloc, xdata)

    async def symlink(self, target: str, loc: Loc, xdata: dict | None = None):
        from ..core.iatt import gfid_new

        xdata = dict(xdata or {})
        xdata.setdefault("gfid-req", gfid_new())
        return await self._dispatch_all_simple("symlink", target, loc, xdata)

    async def readlink(self, loc: Loc, xdata: dict | None = None):
        res = await self._dispatch(self._up_idx()[:1], "readlink",
                                   lambda i: ((loc, xdata), {}))
        good = self._combine(res, min_ok=1)
        return next(iter(good.values()))

    async def link(self, oldloc: Loc, newloc: Loc, xdata: dict | None = None):
        return await self._dispatch_all_simple("link", oldloc, newloc, xdata)

    async def mknod(self, loc: Loc, mode: int = 0o644, rdev: int = 0,
                    xdata: dict | None = None):
        from ..core.iatt import gfid_new

        xdata = dict(xdata or {})
        xdata.setdefault("gfid-req", gfid_new())
        return await self._dispatch_all_simple("mknod", loc, mode, rdev, xdata)

    async def setattr(self, loc: Loc, attrs: dict, valid: int = 0,
                      xdata: dict | None = None):
        return await self._dispatch_all_simple("setattr", loc, attrs, valid,
                                               xdata)

    async def setxattr(self, loc: Loc, xattrs: dict, flags: int = 0,
                       xdata: dict | None = None):
        if any(k.startswith("trusted.ec.") for k in xattrs):
            raise FopError(errno.EPERM, "reserved xattr namespace")
        return await self._dispatch_all_simple("setxattr", loc, xattrs,
                                               flags, xdata)

    async def getxattr(self, loc: Loc, name: str | None = None,
                       xdata: dict | None = None):
        res = await self._dispatch(self._up_idx(), "getxattr",
                                   lambda i: ((loc, name), {}))
        good = self._combine(res, min_ok=1)
        out = next(iter(good.values()))
        # hide internal accounting (reference filters trusted.ec.*)
        return {k: v for k, v in out.items()
                if not k.startswith("trusted.ec.")} if name is None else out

    async def removexattr(self, loc: Loc, name: str,
                          xdata: dict | None = None):
        if name.startswith("trusted.ec."):
            raise FopError(errno.EPERM, "reserved xattr namespace")
        return await self._dispatch_all_simple("removexattr", loc, name, xdata)

    async def statfs(self, loc: Loc, xdata: dict | None = None):
        res = await self._dispatch(self._up_idx(), "statfs",
                                   lambda i: ((loc, xdata), {}))
        good = self._combine(res, min_ok=1)
        # capacity = min over bricks, scaled by K (user bytes per frag byte)
        agg = min(good.values(), key=lambda s: s["bavail"] * s["bsize"])
        out = dict(agg)
        out["blocks"] *= self.k
        out["bfree"] *= self.k
        out["bavail"] *= self.k
        return out

    async def opendir(self, loc: Loc, xdata: dict | None = None):
        res = await self._dispatch(self._up_idx(), "opendir",
                                   lambda i: ((loc, xdata), {}))
        good = self._combine(res)
        fd = FdObj(next(iter(good.values())).gfid, path=loc.path)
        fd.ctx_set(self, ECFdCtx(dict(good), 0))
        return fd

    async def readdir(self, fd: FdObj, size: int = 0, offset: int = 0,
                      xdata: dict | None = None):
        # one subvol serves readdir (reference ec-dir-read.c)
        for i in self._up_idx():
            try:
                return await self.children[i].readdir(
                    self._child_fd(fd, i), size, offset, xdata)
            except FopError:
                continue
        raise FopError(errno.ENOTCONN, "no child for readdir")

    async def readdirp(self, fd: FdObj, size: int = 0, offset: int = 0,
                       xdata: dict | None = None):
        entries = await self.readdir(fd, size, offset, xdata)
        out = []
        base = fd.path.rstrip("/")
        for name, _ in entries:
            try:
                ia = await self.stat(Loc(f"{base}/{name}"))
            except FopError:
                ia = None
            out.append((name, ia))
        return out

    # -- open/create -------------------------------------------------------

    async def create(self, loc: Loc, flags: int = 0, mode: int = 0o644,
                     xdata: dict | None = None):
        from ..core.iatt import gfid_new

        import os as _os

        xdata = dict(xdata or {})
        xdata.setdefault("gfid-req", gfid_new())
        # counters ride the create itself (storage/posix init-xattrs):
        # one wave instead of create + setxattr
        xdata["init-xattrs"] = {
            XA_VERSION: _pack_u64x2(0, 0),
            XA_SIZE: struct.pack(">Q", 0),
            XA_DIRTY: _pack_u64x2(0, 0)}
        # compound lock-on-create (O_EXCL only: the file and its fresh
        # gfid are born with this fop, so the non-blocking grant cannot
        # conflict): the eager window opens WITH the create — the first
        # write then pays only the fragment wave
        # only once brick-side locks are KNOWN present (first txn
        # probes them): on a lockless graph the compound key would pass
        # through storage untouched and the window would believe in
        # locks nobody holds
        owner = None
        if self.opts["eager-lock"] and flags & _os.O_EXCL and \
                self._locks_supported:
            owner = gfid_new()
            xdata["lock-inodelk"] = ["ec.transaction", "wr", 0, -1,
                                     owner]
        idxs = self._up_idx()
        res = await self._dispatch(idxs, "create",
                                   lambda i: ((loc, flags, mode, xdata), {}))
        try:
            good = self._combine(res, min_ok=self._write_quorum())
        except BaseException:
            if owner is not None:
                # below quorum: the bricks whose create DID land hold
                # our compound-granted whole-file lock — unwind it or
                # it outlives this failed create forever (the winner of
                # a racing O_EXCL create would then hang on it)
                ok = [i for i, r in res.items()
                      if not isinstance(r, BaseException)]
                await self._inodelk_unwind(
                    Loc(loc.path, gfid=xdata["gfid-req"]), ok, owner)
            raise
        child_fds = {i: r[0] for i, r in good.items()}
        ia = next(iter(good.values()))[1]
        fd = FdObj(ia.gfid, flags, path=loc.path)
        fd.ctx_set(self, ECFdCtx(child_fds, flags))
        if owner is not None:
            gfid = ia.gfid
            async with self._lock(gfid):
                if gfid not in self._eager:
                    locked = sorted(good)
                    self._eager[gfid] = _EagerState(
                        owner, locked, locked, 0, set(good),
                        asyncio.get_running_loop().time())
                    await self._eager_end(Loc(loc.path, gfid=gfid),
                                          gfid)
        return fd, ia

    async def open(self, loc: Loc, flags: int = 0, xdata: dict | None = None):
        idxs = self._up_idx()
        res = await self._dispatch(idxs, "open",
                                   lambda i: ((loc, flags), {}))
        good = self._combine(res)
        fd = FdObj(next(iter(good.values())).gfid, flags, path=loc.path)
        fd.ctx_set(self, ECFdCtx(dict(good), flags))
        return fd

    async def flush(self, fd: FdObj, xdata: dict | None = None):
        """Close-path flush: every data wave in this framework is
        synchronous (errors were already reported per-write), and the
        reference's delayed post-op deliberately OUTLIVES flush
        (post-op-delay) — so flush neither fans out to bricks (posix
        flush is a no-op, reference posix_flush returns 0) nor forces
        the commit wave; it just re-arms the deferred release.  fsync
        is the durability point that forces the drain."""
        await self._eager_drain_fd(fd, force=False)
        return {}

    async def fsync(self, fd: FdObj, datasync: int = 0,
                    xdata: dict | None = None):
        await self._eager_drain_fd(fd)  # durability point: commit post-op
        idxs = self._up_idx()
        res = await self._dispatch(
            idxs, "fsync", lambda i: ((self._child_fd(fd, i), datasync), {}))
        self._combine(res)
        return {}

    async def release(self, fd: FdObj):
        # dirty windows still flush at close (deterministic commit
        # point the tests and heal flows rely on); clean ones defer
        await self._eager_drain_fd(fd, force=False)
        ctx: ECFdCtx | None = fd.ctx_del(self)
        if ctx:
            # one parallel wave, not one round trip per child
            async def one(i, cfd):
                rel = getattr(self.children[i], "release", None)
                if rel:
                    try:
                        await rel(cfd)
                    except Exception:
                        pass

            await asyncio.gather(*(one(i, cfd)
                                   for i, cfd in ctx.child_fds.items()))

    # -- the data path -----------------------------------------------------

    async def _txn_meta(self, txn: "_Txn") -> tuple[list[int], int]:
        """Metadata for a fetch=True transaction: use the xattrs that
        rode the lock grants when every up child answered; fall back to
        the classic metadata wave otherwise."""
        if txn.locked and txn.fetched is not None and \
                set(self._up_idx()) <= set(txn.fetched):
            return self._pick_meta({i: self._parse_meta(r)
                                    for i, r in txn.fetched.items()})
        return await self._read_meta(txn.loc)

    async def _read_meta(self, loc: Loc) -> tuple[list[int], int]:
        """(consistent candidate rows, true size) in ONE metadata fan-out.

        Reads must not mix stale fragments: candidates are the up children
        agreeing on (version, size) (the read-txn source selection,
        reference afr-read-txn.c:94 / ec answer grouping).  Clean bricks
        (dirty == 0) are preferred; if no clean quorum exists the largest
        (version, size) group is used regardless of dirty — matching the
        reference's degraded behavior after an unresolved partial write."""
        ups = self._up_idx()
        meta = await self._get_meta(ups, loc)
        vals = {i: m for i, m in meta.items()
                if not isinstance(m, BaseException)}
        return self._pick_meta(vals)

    def _pick_meta(self, vals: dict[int, dict]) -> tuple[list[int], int]:
        if not vals:
            raise FopError(errno.ENOTCONN, "no readable children")
        clean = {i: m for i, m in vals.items() if m["dirty"] == (0, 0)}
        pool = clean if len(clean) >= self.k else vals
        best = Counter((m["version"], m["size"])
                       for m in pool.values()).most_common(1)[0][0]
        rows = [i for i, m in pool.items()
                if (m["version"], m["size"]) == best]
        return rows, best[1]

    def _read_children(self, candidates: list[int], gfid: bytes = b"",
                       mask: bool = False) -> list[int]:
        """Pick K children per read-policy (ec.c read-policy option).
        With ``mask`` the operator's read-mask restricts the set
        (strict, like fop->mask &= ec->read_mask at dispatch) — but
        only inode-READ fops pass it (ec-inode-read.c:1375): a write's
        internal RMW reads and heal reconstruction must never be
        failed by a read-tuning knob."""
        if mask and self._read_mask is not None:
            candidates = [i for i in candidates if i in self._read_mask]
        if len(candidates) < self.k:
            raise FopError(errno.ENOTCONN,
                           f"only {len(candidates)}/{self.n} consistent "
                           f"children, need {self.k}")
        if self.opts["systematic"]:
            # data rows ARE the bytes: when all k survive, the read is
            # a pure reassembly — no decode on any backend, no device
            # round trip on the card route.  Spreading load over parity
            # bricks (read-policy) would buy balance at the price of a
            # reconstruction per read; the systematic layout exists to
            # avoid exactly that
            data_rows = [i for i in candidates if i < self.k]
            if len(data_rows) == self.k:
                return data_rows
        policy = self.opts["read-policy"]
        if policy == "first-k":
            return candidates[: self.k]
        if policy == "gfid-hash" and gfid:
            start = int.from_bytes(gfid[-4:], "big") % len(candidates)
        else:  # round-robin
            self._rr = (self._rr + 1) % len(candidates)
            start = self._rr
        rot = candidates[start:] + candidates[:start]
        return sorted(rot[: self.k])

    async def _read_aligned(self, fd: FdObj, a_off: int, a_len: int,
                            candidates: list[int] | None = None,
                            mask: bool = False) -> np.ndarray:
        """Read+decode an aligned region [a_off, a_off+a_len); fragment
        files shorter than the range zero-fill (sparse tails).  ``mask``
        only for user-facing reads (see _read_children)."""
        if a_len == 0:
            return np.zeros(0, dtype=np.uint8)
        f_off = a_off // self.k
        f_len = a_len // self.k
        if candidates is None:
            candidates, _ = await self._read_meta(Loc(fd.path, gfid=fd.gfid))
        excluded: set[int] = set()
        last_err: FopError | None = None
        for _ in range(1 + self.r):  # retry with failing bricks excluded
            avail = [i for i in candidates if i not in excluded]
            rows = self._read_children(avail, fd.gfid, mask=mask)
            res = await self._dispatch(
                rows, "readv",
                lambda i: ((self._child_fd(fd, i), f_len, f_off), {}))
            good = {i: r for i, r in res.items()
                    if not isinstance(r, BaseException)}
            if len(good) < self.k:
                last_err = FopError(errno.EIO, "fragment reads failed")
                # exclude failing bricks for this fop only (transient
                # errors must not poison the up mask; CHILD_DOWN handles
                # real outages)
                excluded.update(i for i, r in res.items()
                                if isinstance(r, BaseException))
                continue
            rows_sorted = sorted(good)
            bufs = [wire.as_single_buffer(good[i]) for i in rows_sorted]
            # healthy systematic fan-out: the fragment buffers (wire
            # blob-lane memoryviews) land DIRECTLY in the codec's
            # reassembly — no per-fragment staging copy (ISSUE 3; the
            # reference's ec_readv answer iobrefs feed dispatch the
            # same way)
            fast = self.codec.reassemble(bufs, rows_sorted, f_len)
            if fast is not None:
                self.read_fanout["fast"] += 1
                return fast
            self.read_fanout["staged"] += 1
            frags = np.zeros((self.k, f_len), dtype=np.uint8)
            for j, buf in enumerate(bufs):
                arr = np.frombuffer(buf, dtype=np.uint8)
                frags[j, : arr.size] = arr
            data = await self._codec_decode(frags, rows_sorted)
            return data
        raise last_err or FopError(errno.EIO, "read failed")

    async def _readv_window(self, fd: FdObj, size: int, offset: int,
                            candidates: list[int], true_size: int):
        if offset >= true_size:
            return b""
        size = min(size, true_size - offset)
        a_off = offset // self.stripe * self.stripe
        end = offset + size
        a_end = (end + self.stripe - 1) // self.stripe * self.stripe
        data = await self._read_aligned(fd, a_off, a_end - a_off,
                                        list(candidates), mask=True)
        # a VIEW of the decoded array, not .tobytes(): the answer rides
        # the stack (and /dev/fuse, via writev) without another copy —
        # the view pins the decode buffer, which lives exactly as long
        # as the caller holds the data
        data = np.ascontiguousarray(data, dtype=np.uint8)
        return memoryview(data)[offset - a_off: offset - a_off + size]

    async def readv(self, fd: FdObj, size: int, offset: int,
                    xdata: dict | None = None):
        loc = Loc(fd.path, gfid=fd.gfid)
        if self.opts["eager-lock"] and self.opts["other-eager-lock"]:
            # reads share the eager window (disperse.other-eager-lock):
            # the first read on an inode pays one lock-and-fetch wave,
            # consecutive reads pay ONLY the fragment wave — without
            # this every kernel-readahead chunk through the mount costs
            # lock + meta + unlock waves of pure latency.  Same-inode
            # ops serialize on the local gfid lock (the reference
            # chains same-inode fops on the lock owner too).
            while True:
                async with self._lock(fd.gfid):
                    st = await self._eager_begin(loc, fd.gfid)
                    # a parallel write mid-dispatch over our range could
                    # hand us a torn stripe (half old, half new
                    # fragments) — wait it out like a conflicting write
                    a_off = offset // self.stripe * self.stripe
                    a_end = (offset + size + self.stripe - 1) \
                        // self.stripe * self.stripe
                    blocker = st.conflict(a_off, a_end)
                    if blocker is None:
                        try:
                            return await self._readv_window(
                                fd, size, offset, st.candidates, st.size)
                        finally:
                            await self._eager_end(loc, fd.gfid)
                await blocker
        async with self._Txn(self, loc, fd.gfid, "rd",
                             fetch=True) as txn:
            candidates, true_size = await self._txn_meta(txn)
            return await self._readv_window(fd, size, offset, candidates,
                                            true_size)

    # one coalesced fan-out must stay a sane allocation: chains whose
    # union range exceeds this decompose normally (read-ahead windows
    # are <= a few MiB; this is an abuse bound, not a tuning knob)
    COALESCE_MAX = 16 << 20

    def _coalescable_readvs(self, links):
        """(fd, [(size, offset), ...], lo, hi) when every link of the
        chain is a readv on ONE fd and their stripe-aligned ranges
        tile a single contiguous region — else None.

        This is ROADMAP item 7: the demand+window chains read-ahead
        emits (readv+readv, one wire frame) decompose at this layer
        into SEPARATE fragment fan-outs, so adjacent stripe reads hit
        the same brick as two readvs.  Merged, each brick serves ONE
        ranged fragment read per fan-out (the disperse read analog of
        write-behind aggregation)."""
        if len(links) < 2:
            return None
        fd = None
        spans = []
        for fop, args, kwargs in links:
            if fop != "readv" or len(args) < 3:
                return None
            lfd, size, offset = args[0], args[1], args[2]
            if not isinstance(lfd, FdObj) or \
                    not isinstance(size, int) or \
                    not isinstance(offset, int) or size < 0 or offset < 0:
                return None
            if fd is None:
                fd = lfd
            elif lfd is not fd and (lfd.gfid != fd.gfid or not fd.gfid):
                return None
            spans.append((size, offset))
        spans_sorted = sorted(spans, key=lambda s: s[1])
        lo = spans_sorted[0][1] // self.stripe * self.stripe
        hi = 0
        cur_end = lo
        for size, offset in spans_sorted:
            a_off = offset // self.stripe * self.stripe
            a_end = (offset + size + self.stripe - 1) \
                // self.stripe * self.stripe
            if a_off > cur_end:
                return None  # a hole: two fan-outs are cheaper
            cur_end = max(cur_end, a_end)
            hi = max(hi, offset + size)
        if hi - lo > self.COALESCE_MAX:
            return None
        return fd, spans, lo, hi

    async def compound(self, links, xdata: dict | None = None) -> list:
        """Chains of adjacent readvs (read-ahead's demand+window frame)
        merge into ONE ranged fragment fan-out: one lock/meta wave, one
        readv per brick covering the union, per-link answers sliced as
        views of the single decode.  Anything else decomposes through
        the normal per-fop path."""
        from ..rpc import compound as cfop

        try:
            links_v = cfop.validate(links)
        except FopError:
            return await super().compound(links, xdata)
        merged = self._coalescable_readvs(links_v)
        if merged is None:
            return await super().compound(links, xdata)
        fd, spans, lo, hi = merged
        # per-link piggybacks (the demand link's xdata carries the
        # trace span) must not vanish when the chain merges: the first
        # link's xdata rides the union fan-out — one dispatch, one
        # span, same propagation the decomposed path would give the
        # demand readv
        xd = next((kw.get("xdata") for _f, _a, kw in links_v
                   if kw.get("xdata")), None)
        try:
            data = await self.readv(fd, hi - lo, lo, xdata=xd)
        except FopError as e:
            # decompose semantics: first link errs, the rest skip
            return [["err", e]] + [["skip", None]] * (len(spans) - 1)
        self.read_coalesced["chains"] += 1
        self.read_coalesced["links"] += len(spans)
        if isinstance(data, wire.SGBuf):  # single join, then slice
            view = memoryview(data.tobytes())
        elif isinstance(data, memoryview):
            view = data
        else:
            view = memoryview(data)
        out = []
        for size, offset in spans:
            start = offset - lo
            if start >= len(view):
                out.append(["ok", b""])
            else:
                out.append(["ok", view[start: start + size]])
        return out

    async def _window_op(self, fd: FdObj, loc: Loc, st: _EagerState,
                         op: str, argfn) -> dict:
        """One write-class wave through the open eager window: pre-op
        once per window, poison-across-dispatch (a torn-off wave must
        never let the flush release dirty over diverged fragments),
        good-set intersection, quorum, version delta."""
        targets = sorted(st.good & set(self._up_idx()))
        if not st.pre:
            # pre-op once per window: dirty+1 (ec-common.c:2377).  For
            # the common case — first fop is a write and every pre
            # target is in the wave — the marker rides the write itself
            # (compound pre-xattrop, applied brick-side before the
            # data), saving one full fan-out wave per window
            pre_targets = sorted(st.good)
            if op == "writev" and pre_targets == targets:
                base = argfn

                def argfn(i, _b=base):
                    args, kw = _b(i)
                    xd = dict(kw.get("xdata") or {})
                    xd["pre-xattrop"] = {XA_DIRTY: _pack_u64x2(1, 0)}
                    return args, {**kw, "xdata": xd}
            else:
                await self._xattrop(pre_targets, loc,
                                    {XA_DIRTY: _pack_u64x2(1, 0)})
            st.pre = set(pre_targets)
        st.inflight += 1
        st.idle.clear()
        ok: set[int] | None = None
        try:
            res = await self._dispatch(targets, op, argfn)
            ok = {i for i, r in res.items()
                  if not isinstance(r, BaseException)}
        finally:
            # a brick that missed ANY wave in the window stays out: it
            # is inconsistent until healed (down bricks miss the wave
            # too — they were never targeted).  A torn-off wave
            # (cancel) poisons its whole target set — the serial path
            # got the same protection by clearing good across the
            # dispatch, but expressed per-wave it survives concurrent
            # parallel-writes waves without clobbering their tracking
            if ok is None:
                st.good -= set(targets)
            else:
                st.good &= ok
            st.inflight -= 1
            if st.inflight == 0:
                st.idle.set()
        if len(ok) < self._write_quorum():
            # surface the bricks' dominant errno (ec_fop_prepare_answer
            # groups answers and picks the most common op_errno) so
            # EDQUOT/ENOSPC reach the caller instead of a generic EIO
            errs = [r.err for r in res.values()
                    if isinstance(r, FopError)]
            err = Counter(errs).most_common(1)[0][0] if errs else errno.EIO
            raise FopError(err,
                           f"{op} quorum lost ({len(ok)}/{self.n})")
        st.delta += 1
        st.candidates = sorted(st.good)
        if st.pre:
            # the dirty mark is committed on the bricks: parallel-writes
            # followers may now dispatch outside the serial first wave
            st.pre_landed.set()
        return {i: r for i, r in res.items() if i in ok}

    # -- parity-delta sub-stripe writes (ISSUE 10) -------------------------

    def _delta_eligible(self, st: _EagerState, data, offset: int) -> bool:
        """May this write take the parity-delta path?  Healthy
        systematic volumes only, write strictly inside the true size,
        unaligned (an aligned write is a pure encode already), key on,
        and no brick has refused xorv.  Everything else keeps the
        full-RMW path byte-identically."""
        if not (data and self.opts["systematic"]
                and self.opts["delta-writes"] and self._xorv_ok):
            return False
        end = offset + len(data)
        if offset % self.stripe == 0 and end % self.stripe == 0:
            return False  # aligned: no RMW to beat
        if end > st.size:
            return False  # EOF-crossing/extending (zero tails, size)
        every = set(range(self.n))
        # a stale fragment XOR'd with a parity delta diverges from the
        # codeword forever: every brick must be up, in the window's
        # good set, and meta-consistent
        return st.good == every and set(st.candidates) == every \
            and all(self.up)

    def _delta_plan(self, data_len: int, offset: int):
        """Map a write [offset, offset+data_len) onto the systematic
        layout: per touched data fragment j, the list of copy pieces
        ``(frag_off, ulo, uhi)`` — user bytes [ulo, uhi) live verbatim
        at fragment byte ``frag_off`` (chunk j of each stripe).  Pieces
        of one fragment tile a single contiguous fragment range (one
        contiguous user interval intersects each 512-byte chunk window
        at most once per stripe, and consecutive stripes are adjacent
        in fragment space)."""
        end = offset + data_len
        a_off = offset // self.stripe * self.stripe
        a_end = (end + self.stripe - 1) // self.stripe * self.stripe
        pieces: dict[int, list[tuple[int, int, int]]] = {}
        for s in range(a_off // self.stripe, a_end // self.stripe):
            base = s * self.stripe
            for j in range(self.k):
                u0 = base + j * CHUNK
                lo, hi = max(u0, offset), min(u0 + CHUNK, end)
                if lo < hi:
                    pieces.setdefault(j, []).append(
                        (s * CHUNK + (lo - u0), lo, hi))
        return a_off, a_end, pieces

    async def _writev_delta(self, fd: FdObj, loc: Loc, st: _EagerState,
                            data: bytes, offset: int):
        """The parity-delta wave: read back ONLY the overwritten bytes
        from the touched data fragments, form Δ = old ⊕ new, then ONE
        wave of touched-data writev + parity xorv(parity(Δ)) — no
        k-fragment decode, no n-fragment rewrite.  Untouched data
        bricks see no fop and KEEP their good status (their chunks did
        not change; the window's post-op version wave still covers
        them).  Rides the same pre-op/good-set/poison/quorum machinery
        as every write wave."""
        end = offset + len(data)
        a_off, a_end, pieces = self._delta_plan(len(data), offset)
        a_len = a_end - a_off
        f_len = a_len // self.k
        intervals: dict[int, tuple[int, int]] = {}
        for j, ps in pieces.items():
            lo = ps[0][0]
            hi = ps[-1][0] + (ps[-1][2] - ps[-1][1])
            if hi - lo != sum(uhi - ulo for _f, ulo, uhi in ps):
                raise _DeltaFallback()  # non-contiguous (cannot happen)
            intervals[j] = (lo, hi)
        span = _tracing.enter(self.name, "delta-write") \
            if _tracing.ENABLED else None
        t0 = _time.perf_counter()
        failed = True
        try:
            # old bytes: one ranged readv per touched data fragment —
            # internal write reads, never subject to the read mask
            res = await self._dispatch(
                sorted(intervals), "readv",
                lambda i: ((self._child_fd(fd, i),
                            intervals[i][1] - intervals[i][0],
                            intervals[i][0]), {}))
            if any(isinstance(r, BaseException) for r in res.values()):
                raise _DeltaFallback()  # read trouble: RMW sorts it out
            newbuf = np.zeros(a_len, dtype=np.uint8)
            newbuf[offset - a_off: end - a_off] = np.frombuffer(
                bytes(data), dtype=np.uint8)
            delta = newbuf.copy()  # becomes old ⊕ new inside the range
            read_bytes = 0
            for j, ps in pieces.items():
                lo = intervals[j][0]
                arr = np.frombuffer(wire.as_single_buffer(res[j]),
                                    dtype=np.uint8)
                read_bytes += intervals[j][1] - lo
                for frag_off, ulo, uhi in ps:
                    piece = arr[frag_off - lo:
                                frag_off - lo + (uhi - ulo)]
                    if piece.size:  # a short tail XORs against zeros
                        delta[ulo - a_off:
                              ulo - a_off + piece.size] ^= piece
            pdeltas = await self._codec_delta(delta)
            f_off = a_off // self.k
            wave: dict[int, tuple] = {}
            data_write_bytes = 0
            for j, ps in pieces.items():
                lo, hi = intervals[j]
                wbuf = np.concatenate(
                    [newbuf[ulo - a_off: uhi - a_off]
                     for _f, ulo, uhi in ps])
                data_write_bytes += wbuf.size
                wave[j] = ("writev", (self._child_fd(fd, j),
                                      wbuf.tobytes(), lo), {})
            for p in range(self.k, self.n):
                wave[p] = ("xorv", (self._child_fd(fd, p),
                                    pdeltas[p - self.k].tobytes(),
                                    f_off), {})
            if not st.pre:
                # pre-op once per window (the writev piggyback does not
                # apply: the wave targets a subset of the pre set)
                pre_targets = sorted(st.good)
                await self._xattrop(pre_targets, loc,
                                    {XA_DIRTY: _pack_u64x2(1, 0)})
                st.pre = set(pre_targets)
            st.inflight += 1
            st.idle.clear()
            ok: set[int] | None = None
            unsupported: set[int] = set()
            res = {}
            try:
                res = await self._dispatch_multi(wave)
                unsupported = {i for i, r in res.items()
                               if isinstance(r, FopError)
                               and r.err == errno.EOPNOTSUPP
                               and wave[i][0] == "xorv"}
                ok = {i for i, r in res.items()
                      if not isinstance(r, BaseException)}
            finally:
                # DELIBERATELY narrower poison than _window_op's
                # `good &= ok`: this wave targets a SUBSET of good, and
                # the untargeted data bricks are still current (their
                # chunks did not change), so only targeted failures
                # drop.  _window_op's full wave targets good∩up, where
                # dropping every non-ok brick (down ones included) is
                # the right call — keep both semantics in view when
                # editing either site.
                if ok is None:
                    st.good -= set(wave)  # torn-off wave: poison all
                else:
                    # an EOPNOTSUPP brick applied NOTHING, and the
                    # immediate full-RMW redo rewrites every fragment
                    # of this region on all good bricks — keep it good
                    st.good -= set(wave) - ok - unsupported
                st.inflight -= 1
                if st.inflight == 0:
                    st.idle.set()
            if unsupported:
                self._xorv_ok = False
                log.warning(3, "%s: brick(s) %s have no xorv (live "
                            "downgrade?) — parity-delta writes off, "
                            "full RMW from here", self.name,
                            sorted(unsupported))
                raise _DeltaFallback()
            # quorum over SURVIVING good bricks, not wave oks: the
            # untargeted data bricks count toward the file's
            # consistent set (under _window_op's full wave the two
            # formulations coincide — targets ARE good∩up there)
            if len(st.good & set(self._up_idx())) < self._write_quorum():
                errs = [r.err for r in res.values()
                        if isinstance(r, FopError)]
                err = Counter(errs).most_common(1)[0][0] if errs \
                    else errno.EIO
                raise FopError(err, f"delta write quorum lost "
                                    f"({len(st.good)}/{self.n})")
            st.delta += 1
            st.candidates = sorted(st.good)
            if st.pre:
                st.pre_landed.set()
            # what the replaced RMW would have moved: a k-fragment
            # aligned-region read + an n-fragment rewrite
            rmw_read = max(
                0, min(a_end, self._frag_len(st.size) * self.k) - a_off)
            self.write_path["delta"] += 1
            o = self.traffic_origin
            self.delta_origin[o] = self.delta_origin.get(o, 0) + 1
            self.delta_saved["read"] += max(0, rmw_read - read_bytes)
            self.delta_saved["write"] += max(
                0, self.n * f_len
                - (data_write_bytes + self.r * f_len))
            ia = next(r for r in res.values()
                      if not isinstance(r, BaseException))
            ia = Iatt(**{**ia.__dict__})
            st.size = max(st.size, end)
            ia.size = st.size
            failed = False
            return ia
        finally:
            if span is not None:
                _tracing.exit_span(span, _time.perf_counter() - t0,
                                   failed)

    async def _writev_in_window(self, fd: FdObj, loc: Loc, st: _EagerState,
                                data: bytes, offset: int,
                                allow_delta: bool = True):
        if allow_delta and self._delta_eligible(st, data, offset):
            try:
                return await self._writev_delta(fd, loc, st, data,
                                                offset)
            except _DeltaFallback:
                pass  # downgraded peer / read trouble: full RMW below
        true_size = st.size
        end = offset + len(data)
        a_off = offset // self.stripe * self.stripe
        a_end = (end + self.stripe - 1) // self.stripe * self.stripe
        buf = np.zeros(a_end - a_off, dtype=np.uint8)
        # RMW: pull existing stripes overlapping the aligned region
        if true_size > a_off and (offset % self.stripe or
                                  end % self.stripe or
                                  offset > true_size):
            have_end = min(a_end, self._frag_len(true_size) * self.k)
            if have_end > a_off:
                self.write_path["rmw"] += 1
                old = await self._read_aligned(
                    fd, a_off, have_end - a_off, list(st.candidates))
                buf[: old.size] = old
                # trim stale bytes beyond true size (padding zeros)
                if true_size - a_off < old.size:
                    buf[max(0, true_size - a_off): old.size] = 0
        buf[offset - a_off: end - a_off] = np.frombuffer(
            bytes(data), dtype=np.uint8)
        frags = await self._codec_encode(buf)
        f_off = a_off // self.k
        good = await self._window_op(
            fd, loc, st, "writev",
            lambda i: ((self._child_fd(fd, i),
                        frags[i].tobytes(), f_off), {}))
        # re-read st.size (not the wave-start snapshot): a concurrent
        # parallel write past our range may have grown it meanwhile
        st.size = max(st.size, end)
        ia = next(iter(good.values()))
        ia = Iatt(**{**ia.__dict__})
        ia.size = st.size
        return ia

    async def writev(self, fd: FdObj, data: bytes, offset: int,
                     xdata: dict | None = None):
        """Write under the eager window: first fop on an inode pays
        inodelk + metadata + pre-op; followers pay only the fragment
        write wave; the combined post-op commits at window close
        (ec-inode-write.c:2141 + ec-common.c:2176,2377).

        parallel-writes (ec.c:284 + ec_is_range_conflict,
        ec-common.c:185): once the window's dirty pre-op has landed,
        writes touching disjoint aligned stripe ranges dispatch
        concurrently — the local gfid lock covers only window
        bookkeeping, not the RMW/encode/write wave itself."""
        loc = Loc(fd.path, gfid=fd.gfid)
        if not self.opts["parallel-writes"]:
            async with self._lock(fd.gfid):
                st = await self._eager_begin(loc, fd.gfid)
                # waves registered before a live parallel-writes->off
                # reconfigure may still be dispatching: settle them
                await self._quiesce_writes(st)
                try:
                    return await self._writev_in_window(fd, loc, st,
                                                        data, offset)
                finally:
                    await self._eager_end(loc, fd.gfid)
        end = offset + len(data)
        a_off = offset // self.stripe * self.stripe
        a_end = (end + self.stripe - 1) // self.stripe * self.stripe
        while True:
            async with self._lock(fd.gfid):
                st = await self._eager_begin(loc, fd.gfid)
                if not st.pre_landed.is_set():
                    # the window's first write runs solo under the lock:
                    # it carries the compound pre-op, and dirty+1 must
                    # be ON the bricks before any concurrent data wave
                    try:
                        return await self._writev_in_window(
                            fd, loc, st, data, offset)
                    finally:
                        await self._eager_end(loc, fd.gfid)
                blocker = st.conflict(a_off, a_end)
                if blocker is None:
                    token = st.add_range(a_off, a_end)
                    break
            await blocker  # overlapping write in flight: wait, retry
        try:
            return await self._writev_in_window(fd, loc, st, data, offset)
        finally:
            st.del_range(token)  # lock-free: wakes conflict waiters
            async with self._lock(fd.gfid):
                await self._eager_end(loc, fd.gfid)

    # -- allocation-class fops (ec-inode-write.c fallocate/discard/
    # zerofill; zeros are a fixed point of the linear code: a zero user
    # stripe encodes to zero fragments, so zero ranges ride the normal
    # write path and fragment holes stay holes) -------------------------

    async def _zero_in_window(self, fd: FdObj, loc: Loc, st: _EagerState,
                              offset: int, length: int) -> None:
        """Zero a user range through the window write path (RMW at the
        stripe edges), in bounded chunks."""
        window = max(self.stripe,
                     int(self.opts["self-heal-window-size"]))
        while length > 0:
            n = min(window, length)
            # allocation-class edges keep the full-RMW path (ISSUE 10
            # fallback matrix): zerofill semantics are size-coupled and
            # the RMW path is their long-proven shape
            await self._writev_in_window(fd, loc, st, b"\0" * n, offset,
                                         allow_delta=False)
            offset += n
            length -= n

    async def fallocate(self, fd: FdObj, mode: int, offset: int,
                        length: int, xdata: dict | None = None):
        """Reserve space; extend the file when FALLOC_FL_KEEP_SIZE (bit
        0) is not set (ec_fallocate, ec-inode-write.c).  Allocation maps
        to KEEP_SIZE fragment-range fallocate on every brick (pure
        allocation: fragment content and sizes never change); the
        extension region past EOF becomes encoded zeros via the window
        write path, all under the inode's lock."""
        if mode & ~1:
            # punch/zero modes carve inside stripes; route them through
            # discard/zerofill, which do the edge RMW (the reference
            # also rejects unsupported fallocate modes, ec_fallocate)
            raise FopError(errno.EOPNOTSUPP,
                           "EC fallocate supports only KEEP_SIZE")
        loc = Loc(fd.path, gfid=fd.gfid)
        async with self._lock(fd.gfid):
            st = await self._eager_begin(loc, fd.gfid)
            await self._quiesce_writes(st)  # settle parallel waves
            try:
                end = offset + length
                f_off = offset // self.stripe * CHUNK
                f_end = (end + self.stripe - 1) // self.stripe * CHUNK
                idxs = self._up_idx()
                res = await self._dispatch(
                    idxs, "fallocate",
                    lambda i: ((self._child_fd(fd, i), mode | 1, f_off,
                                f_end - f_off), {}))
                self._combine(res, min_ok=self._write_quorum())
                if not (mode & 1) and end > st.size:
                    await self._zero_in_window(fd, loc, st, st.size,
                                               end - st.size)
            finally:
                await self._eager_end(loc, fd.gfid)
        ia, _ = await self.lookup(loc)
        return ia

    async def discard(self, fd: FdObj, offset: int, length: int,
                      xdata: dict | None = None):
        """Punch a hole WITHOUT growing the file (ec_discard): the
        stripe-aligned interior punches fragment holes brick-side (child
        discard, O(1) data motion); the unaligned edges re-encode as
        zeros through the window."""
        loc = Loc(fd.path, gfid=fd.gfid)
        async with self._lock(fd.gfid):
            st = await self._eager_begin(loc, fd.gfid)
            await self._quiesce_writes(st)  # settle parallel waves
            try:
                end = min(offset + length, st.size)
                if end > offset:
                    a_lo = (offset + self.stripe - 1) \
                        // self.stripe * self.stripe
                    a_hi = end // self.stripe * self.stripe
                    if a_hi > a_lo:
                        f_off, f_len = a_lo // self.k, (a_hi - a_lo) // self.k
                        await self._window_op(
                            fd, loc, st, "discard",
                            lambda i: ((self._child_fd(fd, i), f_off,
                                        f_len), {}))
                    head_end = min(a_lo, end)
                    if offset < head_end:
                        await self._zero_in_window(fd, loc, st, offset,
                                                   head_end - offset)
                    # a range inside ONE stripe is fully covered by the
                    # head zeroing; start the tail after it
                    tail_start = max(a_hi, head_end)
                    if tail_start < end:
                        await self._zero_in_window(fd, loc, st, tail_start,
                                                   end - tail_start)
            finally:
                await self._eager_end(loc, fd.gfid)
        ia, _ = await self.lookup(loc)
        return ia

    async def zerofill(self, fd: FdObj, offset: int, length: int,
                       xdata: dict | None = None):
        """Zero the range, extending the file if it ends past EOF
        (ec_zerofill)."""
        loc = Loc(fd.path, gfid=fd.gfid)
        async with self._lock(fd.gfid):
            st = await self._eager_begin(loc, fd.gfid)
            await self._quiesce_writes(st)  # settle parallel waves
            try:
                if length > 0:
                    await self._zero_in_window(fd, loc, st, offset, length)
            finally:
                await self._eager_end(loc, fd.gfid)
        ia, _ = await self.lookup(loc)
        return ia

    async def seek(self, fd: FdObj, offset: int, what: str = "data",
                   xdata: dict | None = None):
        """SEEK_DATA/SEEK_HOLE over fragments (ec_seek,
        ec-inode-read.c): ask one consistent brick, scale the fragment
        offset back to user space at stripe granularity — data/holes in
        user space land on the same stripes in every fragment because
        zero stripes encode to zero fragments."""
        loc = Loc(fd.path, gfid=fd.gfid)
        async with self._Txn(self, loc, fd.gfid, "rd"):
            candidates, true_size = await self._read_meta(loc)
            if offset >= true_size:
                raise FopError(errno.ENXIO, "offset beyond EOF")
            f_off = offset // self.stripe * CHUNK
            last: FopError | None = None
            for i in self._read_children(candidates, fd.gfid, mask=True):
                try:
                    r = await self.children[i].seek(
                        self._child_fd(fd, i), f_off, what)
                except FopError as e:
                    if e.err == errno.ENXIO:
                        if what == "data":
                            raise  # no data at/after offset
                        return true_size  # implicit hole at EOF
                    last = e
                    continue
                user = r // CHUNK * self.stripe
                out = max(offset, user)
                return min(out, true_size)
            raise last or FopError(errno.ENOTCONN, "no child for seek")

    async def truncate(self, loc: Loc, size: int, xdata: dict | None = None):
        fd = FdObj((await self.lookup(loc))[0].gfid, path=loc.path,
                   anonymous=True)
        return await self.ftruncate(fd, size, xdata)

    async def ftruncate(self, fd: FdObj, size: int,
                        xdata: dict | None = None):
        loc = Loc(fd.path, gfid=fd.gfid)
        async with self._Txn(self, loc, fd.gfid, "wr"):
            candidates, true_size = await self._read_meta(loc)
            a_size = (size + self.stripe - 1) // self.stripe * self.stripe
            tail = b""
            if size < true_size and size % self.stripe:
                # re-encode the final partial stripe zero-padded
                old = await self._read_aligned(
                    fd, a_size - self.stripe, self.stripe, candidates)
                buf = np.zeros(self.stripe, dtype=np.uint8)
                keep = size - (a_size - self.stripe)
                buf[:keep] = old[:keep]
                tail = buf.tobytes()
            idxs = self._up_idx()
            f_size = a_size // self.k
            await self._xattrop(idxs, loc, {XA_DIRTY: _pack_u64x2(1, 0)})
            res = await self._dispatch(
                idxs, "ftruncate",
                lambda i: ((self._child_fd(fd, i), f_size), {}))
            good = [i for i, r in res.items()
                    if not isinstance(r, BaseException)]
            if len(good) < self._write_quorum():
                raise FopError(errno.EIO, "truncate quorum lost")
            if tail:
                frags = await self._codec_encode(
                    np.frombuffer(tail, dtype=np.uint8))
                f_off = (a_size - self.stripe) // self.k
                await self._dispatch(
                    good, "writev",
                    lambda i: ((self._child_fd(fd, i),
                                frags[i].tobytes(), f_off), {}))
            # one atomic mixed xattrop: version +1, size absolute, dirty
            # released only on full participation
            post = {XA_VERSION: ["add64", _pack_u64x2(1, 0)],
                    XA_SIZE: ["set", struct.pack(">Q", size)]}
            if len(good) == self.n:
                post[XA_DIRTY] = ["add64",
                                  _pack_u64x2(-1 & 0xFFFFFFFFFFFFFFFF, 0)]
            await self._dispatch(
                good, "xattrop", lambda i: ((loc, "mixed", dict(post)), {}))
            ia, _ = await self.lookup(loc)
            return ia

    # -- heal (ec-heal.c analog) -------------------------------------------

    async def heal_info(self, loc: Loc) -> dict:
        """Which bricks disagree on version/size (heal candidates).

        Direction logic (reference ec_heal_data_find_direction,
        ec-heal.c:1658): bricks are grouped by (data version, size); the
        source group is the one with the HIGHEST version that still has
        >= K members — never a dirty-but-stale brick that only saw the
        pre-op.  Dirty flags do not disqualify a source: after a partial
        write the surviving bricks keep dirty set on purpose (that is
        what feeds the pending index), yet they hold both the data and
        the post-op version bump."""
        if self._eager:
            # judge committed counters, not an open window's deferred ones
            try:
                gfid = (await self.lookup(loc))[0].gfid
                if gfid in self._eager:
                    await self._eager_drain(Loc(loc.path, gfid=gfid), gfid)
            except FopError:
                pass
        meta = await self._get_meta(list(range(self.n)), loc)
        versions = {}
        for i, m in meta.items():
            if isinstance(m, BaseException):
                versions[i] = None
            else:
                versions[i] = (m["version"], m["size"], m["dirty"])
        ok = {i: v for i, v in versions.items() if v is not None}
        if not ok:
            raise FopError(errno.ENOTCONN, "no bricks reachable")
        groups: dict[tuple, list[int]] = {}
        for i, v in ok.items():
            groups.setdefault((v[0], v[1]), []).append(i)
        viable = [vs for vs, members in groups.items()
                  if len(members) >= self.k]
        good_vs = max(viable) if viable else max(groups)
        good = sorted(groups[good_vs])
        bad = [i for i in range(self.n) if i not in good]
        dirty = any(v[2] != (0, 0) for v in ok.values())
        return {"good": good, "bad": bad, "version": good_vs,
                "per_brick": versions, "dirty": dirty}

    async def heal_file(self, path: str) -> dict:
        """Region-locked re-encode heal: decode from good K, rewrite bad
        fragments, align counters (ec_rebuild_data, ec-heal.c:2048).

        Locking is per heal window, not whole-file (ec_heal_inodelk
        takes offset/size, ec-heal.c:251): direction + file creation run
        under a brief full-range txn, each window rebuild under a txn
        covering only that window's byte range, and the final counter
        alignment under a full-range txn again.  Writers — who lock the
        full range per fop — wait at most one window, so a multi-GiB
        heal never freezes I/O to the file.  This is safe because live
        writes dispatch to ALL up bricks (including the ones being
        healed), so regions the heal already rebuilt stay current; if
        the version moved while healing (a write landed), dirty is left
        set so the next shd pass re-verifies instead of force-clearing
        counters under a concurrent writer."""
        loc = Loc(path)
        info = await self.heal_info(loc)
        good, bad = info["good"], info["bad"]
        if len(good) < self.k:
            raise FopError(errno.EIO,
                           f"unhealable: only {len(good)} good copies")
        if not bad:
            if not info.get("dirty"):
                return {"healed": [], "skipped": True}
            # Dirty with no version skew does NOT mean converged content:
            # a quorum-lost write leaves a mix of old and new fragments
            # behind identical version/size xattrs.  Rebuild the
            # non-source bricks from K sources before releasing dirty —
            # the reference re-runs data heal whenever dirty is set
            # (ec_heal_data, ec-heal.c:2048), never just unmarks.
            bad = good[self.k:]
            good = good[: self.k]
        gfid = (await self.lookup(loc))[0].gfid
        fd = FdObj(gfid, path=path, anonymous=True)
        async with self._Txn(self, loc, gfid, "wr"):
            meta = await self._get_meta(good, loc)
            rep = next((m for m in meta.values()
                        if not isinstance(m, BaseException)), None)
            if rep is None:
                raise FopError(errno.EIO, "heal: no readable source meta")
            true_size = rep["size"]
            version = rep["version"]
            # ensure bad bricks have the file at all
            for i in bad:
                try:
                    await self.children[i].lookup(loc)
                except FopError:
                    try:
                        await self.children[i].mknod(
                            loc, 0o644, 0, {"gfid-req": gfid})
                    except FopError:
                        continue
        window = int(self.opts["self-heal-window-size"])
        window = max(self.stripe, window // self.stripe * self.stripe)
        healed = []
        a_total = self._frag_len(true_size) * self.k
        rows = good[: self.k]
        rows_sorted = sorted(rows)
        off = 0
        while off < a_total:
            length = min(window, a_total - off)
            # one ranged txn per window: writers (full-range locks)
            # interleave between windows instead of waiting out the
            # whole rebuild
            async with self._Txn(self, loc, gfid, "wr",
                                 start=off, end=off + length):
                f_off, f_len = off // self.k, length // self.k
                res = await self._dispatch(
                    rows, "readv",
                    lambda i: ((self._child_fd(fd, i), f_len, f_off), {}))
                frags_in = np.zeros((self.k, f_len), dtype=np.uint8)
                for j, i in enumerate(rows_sorted):
                    r = res[i]
                    if isinstance(r, BaseException):
                        raise FopError(errno.EIO,
                                       "heal source read failed")
                    b = np.frombuffer(r, dtype=np.uint8)
                    frags_in[j, : b.size] = b
                # heal traffic is tagged so the mesh families (and the
                # MULTICHIP dryrun) can tell shd re-encode from serving
                data = await self._codec_decode(frags_in, rows_sorted,
                                                origin="heal")
                frags_out = await self._codec_encode(data, origin="heal")
                await self._dispatch(
                    bad, "writev",
                    lambda i: ((self._child_fd(fd, i),
                                frags_out[i].tobytes(), f_off),
                               {"xdata": {HEAL_WRITE: True}}))
            off += length
        async with self._Txn(self, loc, gfid, "wr"):
            # counters: re-read under the full lock.  Untouched version
            # -> the heal saw every byte as of `version`: align bad and
            # clear dirty (the pre-region-lock behavior).  Version moved
            # -> writes landed mid-heal; their data DID reach the bad
            # bricks (writes go to all up children) so align version/
            # size to the current good value, but leave dirty for the
            # next shd pass: a write that failed on a brick mid-heal
            # after its window was rebuilt is only detectable there.
            meta2 = await self._get_meta(good, loc)
            rep2 = next((m for m in meta2.values()
                         if not isinstance(m, BaseException)), None)
            if rep2 is None:
                raise FopError(errno.EIO, "heal: source meta lost")
            fix = {XA_VERSION: _pack_u64x2(*rep2["version"]),
                   XA_SIZE: struct.pack(">Q", rep2["size"])}
            stable = rep2["version"] == version
            if stable:
                fix[XA_DIRTY] = _pack_u64x2(0, 0)
            await self._dispatch(bad, "setxattr",
                                 lambda i: ((loc, dict(fix)), {}))
            if stable:
                await self._dispatch(good, "setxattr", lambda i: (
                    (loc, {XA_DIRTY: _pack_u64x2(0, 0)}), {}))
            for i in bad:
                healed.append(i)
            return {"healed": healed, "skipped": False,
                    "size": rep2["size"], "stable": stable}

    async def _codec_encode(self, buf, origin: str | None = None):
        if self._batching:
            return await self.codec.encode_async(
                buf, origin=origin or self.traffic_origin)
        return self.codec.encode(buf)

    async def _codec_delta(self, buf, origin: str | None = None):
        """Parity-rows-only delta encode through the batching window
        (coalesced delta flushes ride the same batching window)."""
        if self._batching:
            return await self.codec.encode_delta_async(
                buf, origin=origin or self.traffic_origin)
        return self.codec.encode_delta(buf)

    async def _codec_decode(self, frags, rows,
                            origin: str | None = None):
        if self._batching:
            return await self.codec.decode_async(
                frags, rows, origin=origin or self.traffic_origin)
        return self.codec.decode(frags, rows)

    async def fini(self):
        for gfid in list(self._eager):
            try:
                await self._eager_drain(Loc("", gfid=gfid), gfid)
            except Exception:
                pass
        self.codec.close()
        await super().fini()

    def dump_private(self) -> dict:
        return {
            "fragments": self.k, "redundancy": self.r,
            "stripe_size": self.stripe,
            "backend": self.codec.backend,
            "up": self.up, "up_count": sum(self.up),
            "read_fanout": dict(self.read_fanout),
            "read_coalesced": dict(self.read_coalesced),
            "write_path": dict(self.write_path),
            "delta_saved": dict(self.delta_saved),
            "xorv_ok": self._xorv_ok,
            "eager_windows": len(self._eager),
            "stripe_cache": self.codec.dump_stats(),
        }
