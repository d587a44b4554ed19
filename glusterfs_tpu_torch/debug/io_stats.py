"""debug/io-stats — per-fop counters + latency profile at a graph position
(reference xlators/debug/io-stats/io-stats.c:129-197; backs ``volume
profile``/``volume top``).  The base Layer already counts per-fop
count/errors/latency (xlator_t.stats analog); io-stats adds interval
snapshots, byte counters for read/write, and a dump API."""

from __future__ import annotations

import time

from ..core.layer import FdObj, Layer, Loc, register
from ..core.options import Option
from ..core import gflog

log = gflog.get_logger("io-stats")


@register("debug/io-stats")
class IoStatsLayer(Layer):
    OPTIONS = (
        Option("count-fop-hits", "bool", default="on"),
        Option("latency-measurement", "bool", default="on"),
        Option("fd-hard-limit", "int", default=2048,
               description="max distinct paths tracked for `volume "
                           "top` (io-stats ios_stat_list cap)"),
        Option("log-level", "enum", default="INFO",
               values=("TRACE", "DEBUG", "INFO", "WARNING", "ERROR",
                       "CRITICAL"),
               description="process log threshold — io-stats carries "
                           "the log-level option in the reference too "
                           "(diagnostics.brick-log-level / "
                           "client-log-level, io-stats.c); applied "
                           "live at reconfigure"),
        Option("dump-fd-stats", "bool", default="off",
               description="log per-path counters when a tracked "
                           "file's activity retires "
                           "(diagnostics.dump-fd-stats)"),
        Option("ios-dump-interval", "time", default="0",
               description="periodically log the profile snapshot "
                           "(diagnostics.stats-dump-interval; 0 = "
                           "off)"),
        Option("fop-sample-interval", "int", default=0, min=0,
               description="record every Nth fop into the sample ring "
                           "(diagnostics.fop-sample-interval; 0 = "
                           "off)"),
        Option("fop-sample-buf-size", "int", default=65535, min=1,
               description="sample ring capacity "
                           "(diagnostics.fop-sample-buf-size)"),
        Option("slow-fop-threshold", "time", default="0",
               description="log the full span tree of any fop slower "
                           "than this (diagnostics.slow-fop-threshold; "
                           "0 = off).  Applied process-wide: a slow "
                           "wire readv's log names the layer the time "
                           "went to (core/tracing.py)"),
        Option("span-ring-size", "int", default=4096, min=64,
               max=1 << 20,
               description="bound on the per-process trace-span ring "
                           "(diagnostics.span-ring-size)"),
        Option("incident-dir", "str", default="",
               description="directory for auto-captured incident "
                           "bundles (diagnostics.incident-dir; empty "
                           "disables capture — the flight-recorder "
                           "ring itself is always on, core/flight.py)"),
        Option("incident-max-bytes", "size", default="64MB",
               description="total size bound on the incident dir; "
                           "oldest bundles pruned first "
                           "(diagnostics.incident-max-bytes)"),
        Option("incident-min-interval", "time", default="60",
               description="min seconds between auto-captured bundles "
                           "— one outage, one bundle, not one per "
                           "breaker flap "
                           "(diagnostics.incident-min-interval)"),
        Option("flight-ring-size", "int", default=512, min=16,
               max=1 << 16,
               description="bound on the flight-recorder record ring "
                           "(diagnostics.flight-ring-size)"),
        Option("access-log", "bool", default="off",
               description="gateway structured access-log lines "
                           "(method, path, status, bytes, ms, trace) "
                           "per HTTP request "
                           "(diagnostics.access-log)"),
        Option("history-interval", "time", default="10",
               description="metrics history sampler cadence, seconds "
                           "(diagnostics.history-interval; the ring "
                           "clamps to a 0.05s floor) — each tick "
                           "captures one delta-compressed registry "
                           "snapshot (core/history.py)"),
        Option("history-retention", "time", default="600",
               description="how far back the metrics history ring "
                           "reaches, seconds "
                           "(diagnostics.history-retention; sample "
                           "count additionally hard-bounded)"),
        Option("slo-rules", "str", default="",
               description="JSON array of SLO alert rules evaluated "
                           "against the local history ring every "
                           "sampler tick (diagnostics.slo-rules; "
                           "empty = no alerting, the default — "
                           "core/slo.py documents the rule grammar)"),
    )

    _LOG_LEVELS = {"TRACE": 5, "DEBUG": 10, "INFO": 20, "WARNING": 30,
                   "ERROR": 40, "CRITICAL": 50}

    def _apply_log_level(self) -> None:
        import logging

        # scope to THIS framework's logger tree — the embedding app's
        # root logger configuration is not ours to overwrite
        logging.getLogger("glusterfs_tpu_torch").setLevel(
            self._LOG_LEVELS.get(self.opts["log-level"], 20))

    #: diagnostics.* options accepted for volfile compatibility whose
    #: planes are not in this package yet (incident capture, the gateway
    #: access log, the metrics history ring and SLO alerts)
    _NOT_PORTED = ("incident-dir", "incident-max-bytes",
                   "incident-min-interval", "access-log",
                   "history-interval", "history-retention", "slo-rules")

    def _apply_observability(self) -> None:
        """Push the process-wide observability knobs this layer owns
        (io-stats carries the diagnostics.* options in the reference
        too): histogram gate, slow-fop threshold, span-ring and
        flight-ring bounds.  A darkened process (GFTPU_NO_OBSERVABILITY)
        wins over the option defaults: latency-measurement's default
        'on' must not re-arm histograms at mount time.  An option of
        :attr:`_NOT_PORTED` set away from its default is logged, not
        applied."""
        from ..core import flight
        from ..core import layer as layer_mod
        from ..core import tracing

        layer_mod.HISTOGRAMS_ENABLED = bool(
            self.opts["latency-measurement"]) and not tracing.DARK
        tracing.SLOW_FOP_THRESHOLD = float(
            self.opts["slow-fop-threshold"])
        tracing.set_ring_size(int(self.opts["span-ring-size"]))
        flight.set_ring_size(int(self.opts["flight-ring-size"]))
        defaults = {o.name: o for o in self.OPTIONS}
        for key in self._NOT_PORTED:
            if self.opts[key] != defaults[key].parse(defaults[key].default):
                log.warning(6, "%s: option %s is not applied: its plane "
                            "is not ported", self.name, key)

    def _restart_dump_task(self) -> None:
        """Cancel + respawn the periodic profile dump so a live
        ``diagnostics.stats-dump-interval`` change takes effect (the
        old task would sleep on the stale interval forever)."""
        import asyncio

        t = getattr(self, "_dump_task", None)
        if t is not None:
            t.cancel()
            self._dump_task = None
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (offline reconfigure): init will arm it
        if float(self.opts["ios-dump-interval"]) > 0:
            self._dump_task = asyncio.create_task(self._dump_loop())

    def reconfigure(self, options: dict) -> None:
        old = self.opts["log-level"]
        old_interval = float(self.opts["ios-dump-interval"])
        super().reconfigure(options)
        if self.opts["log-level"] != old:
            self._apply_log_level()
        self._apply_observability()
        if float(self.opts["ios-dump-interval"]) != old_interval:
            self._restart_dump_task()

    def __init__(self, *args, **kw):
        from collections import OrderedDict

        super().__init__(*args, **kw)
        self.read_bytes = 0
        self.write_bytes = 0
        self.started = time.time()
        self._interval_base: dict = {}
        # per-path counters backing `volume top` (ios_stat_head): path
        # -> {opens, reads, writes, read_bytes, write_bytes}; LRU so
        # eviction at the cap is O(1), not a full scan per hot fop
        self._per_path: "OrderedDict[str, dict]" = OrderedDict()

    def _path_stat(self, path: str | None) -> dict | None:
        if not path:
            return None
        st = self._per_path.get(path)
        if st is None:
            if len(self._per_path) >= self.opts["fd-hard-limit"]:
                # bounded like the reference's fixed-size stat list:
                # evict the least-recently-touched path
                old_path, old = self._per_path.popitem(last=False)
                if self.opts["dump-fd-stats"]:
                    # diagnostics.dump-fd-stats: a retiring file's
                    # counters go to the log (io_stats_dump_fd)
                    log.info(4, "%s: fd-stats %s: %s", self.name,
                             old_path, old)
            st = self._per_path[path] = {
                "opens": 0, "reads": 0, "writes": 0,
                "read_bytes": 0, "write_bytes": 0}
        else:
            self._per_path.move_to_end(path)
        return st

    def _sample(self, op: str, path: str | None) -> None:
        """diagnostics.fop-sample-interval: every Nth data fop lands in
        a bounded ring (ios_sample_buf) readable via statedump."""
        n = int(self.opts["fop-sample-interval"])
        if not n:
            return
        self._fop_seen = getattr(self, "_fop_seen", 0) + 1
        if self._fop_seen % n:
            return
        import collections

        ring = getattr(self, "_samples", None)
        cap = int(self.opts["fop-sample-buf-size"])
        if ring is None or ring.maxlen != cap:
            ring = collections.deque(
                list(ring or ())[-cap:], maxlen=cap)
            self._samples = ring
        ring.append({"ts": round(time.time(), 3), "op": op,
                     "path": path or ""})

    async def _dump_loop(self):
        import asyncio

        while True:
            await asyncio.sleep(float(self.opts["ios-dump-interval"]))
            log.info(5, "%s: profile %s", self.name,
                     self.profile(interval=True))

    async def init(self):
        import asyncio

        await super().init()
        if self.opts["log-level"] != "INFO":
            # only an explicit operator setting touches the level: the
            # default must not override an embedding app's config
            self._apply_log_level()
        self._apply_observability()
        self._dump_task = None
        if float(self.opts["ios-dump-interval"]) > 0:
            self._dump_task = asyncio.create_task(self._dump_loop())

    async def fini(self):
        t = getattr(self, "_dump_task", None)
        if t is not None:
            t.cancel()
            self._dump_task = None
        await super().fini()

    async def open(self, loc: Loc, flags: int = 0,
                   xdata: dict | None = None):
        fd = await self.children[0].open(loc, flags, xdata)
        self._sample("open", loc.path)
        st = self._path_stat(loc.path)
        if st is not None:
            st["opens"] += 1
        return fd

    async def create(self, loc: Loc, flags: int = 0, mode: int = 0o644,
                     xdata: dict | None = None):
        out = await self.children[0].create(loc, flags, mode, xdata)
        self._sample("create", loc.path)
        st = self._path_stat(loc.path)
        if st is not None:
            st["opens"] += 1
        return out

    async def readv(self, fd: FdObj, size: int, offset: int,
                    xdata: dict | None = None):
        data = await self.children[0].readv(fd, size, offset, xdata)
        self._sample("readv", getattr(fd, "path", None))
        self.read_bytes += len(data)
        st = self._path_stat(getattr(fd, "path", None))
        if st is not None:
            st["reads"] += 1
            st["read_bytes"] += len(data)
        return data

    async def writev(self, fd: FdObj, data, offset: int,
                     xdata: dict | None = None):
        ret = await self.children[0].writev(fd, data, offset, xdata)
        self._sample("writev", getattr(fd, "path", None))
        self.write_bytes += len(data)
        st = self._path_stat(getattr(fd, "path", None))
        if st is not None:
            st["writes"] += 1
            st["write_bytes"] += len(data)
        return ret

    async def compound(self, links, xdata: dict | None = None) -> list:
        """Forward chains intact (accounting is side-effect-free) and
        replay the per-fop byte/open counters from the reply vector —
        fused traffic must not vanish from `volume profile`."""
        from ..rpc import compound as cfop

        def link_path(args) -> str | None:
            """Best path for a link's per-path counters: its own
            Loc/FdObj, or — for FdRef links (the fd is minted BY the
            chain) — the producer link's Loc.  Resolving through the
            reply vector would miss: released chain fds are stripped
            from the replies before they get here."""
            for a in args:
                if isinstance(a, Loc):
                    return a.path
                if isinstance(a, FdObj):
                    return getattr(a, "path", None)
                ref = a if isinstance(a, cfop.FdRef) else None
                if ref is None and isinstance(a, dict) and \
                        len(a) == 1 and cfop.FD_LINK_KEY in a:
                    ref = cfop.FdRef(a[cfop.FD_LINK_KEY])
                if ref is not None and 0 <= ref.index < len(links):
                    for pa in links[ref.index][1]:
                        if isinstance(pa, Loc):
                            return pa.path
                    return None
            return None

        replies = await self.children[0].compound(links, xdata)
        for (fop, args, _kw), (st, val) in zip(links, replies):
            if st != "ok":
                continue
            path = link_path(args)
            self._sample(fop, path)
            st_rec = self._path_stat(path)
            if fop in ("open", "create") and st_rec is not None:
                st_rec["opens"] += 1
            elif fop == "writev":
                data = args[1] if len(args) > 1 else b""
                n = len(data) if isinstance(
                    data, (bytes, bytearray, memoryview)) else 0
                self.write_bytes += n
                if st_rec is not None:
                    st_rec["writes"] += 1
                    st_rec["write_bytes"] += n
            elif fop == "readv":
                # reply-value bytes: fused read chains must not
                # vanish from `volume profile` — the reply is bytes, a
                # frame memoryview, or an SGBuf, all sized by len()
                try:
                    n = len(val) if val is not None else 0
                except TypeError:
                    n = 0
                self.read_bytes += n
                if st_rec is not None:
                    st_rec["reads"] += 1
                    st_rec["read_bytes"] += n
        return replies

    # -- `volume top` backend (io-stats ios_stat_list) ---------------------

    def top(self, metric: str = "open", count: int = 10) -> list:
        """Top paths by metric: open | read | write | read-bytes |
        write-bytes (gluster volume top semantics)."""
        key = {"open": "opens", "read": "reads", "write": "writes",
               "read-bytes": "read_bytes",
               "write-bytes": "write_bytes"}.get(metric)
        if key is None:
            raise ValueError(f"unknown top metric {metric!r}")
        ranked = sorted(self._per_path.items(),
                        key=lambda kv: kv[1][key], reverse=True)
        return [{"path": p, **st} for p, st in ranked[:count]
                if st[key] > 0]

    async def top_stats(self, metric: str = "open",
                        count: int = 10) -> list:
        """RPC surface for ``gluster volume top`` (the brick server
        resolves this by graph walk, like quota_usage)."""
        return self.top(metric, count)

    async def metrics_dump(self) -> dict:
        """RPC surface for ``gftpu volume metrics`` (resolved by graph
        walk like top_stats): this process's unified-registry scrape —
        counters/gauges/histograms from every subsystem that registered
        (core/metrics.py)."""
        from ..core.metrics import REGISTRY

        return REGISTRY.snapshot()

    # -- profile API (volume profile incremental/cumulative analog) --------

    def profile(self, *, interval: bool = False) -> dict:
        cur = {op: st.to_dict() for op, st in self.stats.items()}
        out = {
            "uptime_s": time.time() - self.started,
            "read_bytes": self.read_bytes,
            "write_bytes": self.write_bytes,
            "fops": cur,
        }
        if interval:
            base = self._interval_base
            delta = {}
            for op, st in cur.items():
                prev = base.get("fops", {}).get(op, {})
                delta[op] = {k: st[k] - prev.get(k, 0)
                             for k in ("count", "errors")}
            out["interval"] = delta
            self._interval_base = {"fops": cur}
        return out

    def dump_private(self) -> dict:
        out = self.profile()
        ring = getattr(self, "_samples", None)
        if ring:
            out["fop_samples"] = list(ring)[-64:]  # bounded dump slice
        return out
