"""protocol/client — the fop->RPC bridge layer with failure detection.

Reference: xlators/protocol/client (client.c:171 client_submit_request,
client-handshake.c SETVOLUME, rpc-clnt-ping.c heartbeat).  A Layer whose
every fop serializes to the wire and whose connection state drives
CHILD_UP / CHILD_DOWN notifications:

* connect + handshake -> CHILD_UP
* ping every ``ping-interval``; no pong within ``ping-timeout`` ->
  disconnect -> CHILD_DOWN (rpc-clnt-ping.c:125 semantics)
* auto-reconnect with backoff (rpc_clnt reconnect timer)
* in-flight calls fail with ENOTCONN on disconnect (saved_frames unwind,
  rpc-clnt.c:198)
* on reconnect, every tracked open fd is RE-OPENED server-side and held
  locks are re-acquired BEFORE CHILD_UP is announced
  (client-handshake.c:30,68-97 client_reopen_done /
  client_child_up_reopen_done, reopen_fd_count) — a long-lived fd
  against a bounced brick keeps working instead of silently degrading
  that brick out of every fop until the file is re-opened.

Fd objects map to server-side FdHandles kept in the local fd ctx.
"""

from __future__ import annotations

import asyncio
import errno
import itertools
import os
from typing import Any

from ..core.events import gf_event
from ..core.fops import Fop, FopError
from ..core.iatt import gfid_new
from ..core.layer import Event, FdObj, Layer, Loc, register
from ..core.options import Option
from ..core import flight, gflog, tracing
from ..core import metrics as _metrics
from ..rpc import shm as _shm
from ..rpc import wire
from ..rpc import event_pool as _evt

log = gflog.get_logger("protocol.client")

# live client layers, scraped by the unified registry (weakref): the
# client half of the wire accounting — per-connection bytes match the
# brick's per-client counters from the other end of the same socket
_LIVE_CLIENT_LAYERS = _metrics.REGISTRY.register_objects(
    "gftpu_client_wire_bytes_total", "counter",
    "wire bytes exchanged by each protocol/client connection",
    lambda l: [({"layer": l.name, "dir": "tx"}, l.bytes_tx),
               ({"layer": l.name, "dir": "rx"}, l.bytes_rx)])
_metrics.REGISTRY.register_objects(
    "gftpu_client_reconnects_total", "counter",
    "successful SETVOLUME handshakes per protocol/client (first "
    "connect counts as one)",
    lambda l: [({"layer": l.name}, l.connects)],
    live=_LIVE_CLIENT_LAYERS)

# failure-containment plane: per-brick circuit state, the
# idempotent-retry volume, and failfast transport bails — the health
# plane's view of which bricks are shedding load
_CB_STATES = {"closed": 0, "open": 1, "half-open": 2}
_metrics.REGISTRY.register_objects(
    "gftpu_client_circuit_state", "gauge",
    "per-brick circuit breaker state (0 closed / 1 open / 2 half-open)",
    lambda l: [({"layer": l.name}, _CB_STATES.get(l._cb_state, 0))],
    live=_LIVE_CLIENT_LAYERS)
_metrics.REGISTRY.register_objects(
    "gftpu_client_retries_total", "counter",
    "idempotent fops re-dispatched after a transport-class failure "
    "(capped exponential backoff through the circuit breaker)",
    lambda l: [({"layer": l.name}, l.retries_total)],
    live=_LIVE_CLIENT_LAYERS)
_metrics.REGISTRY.register_objects(
    "gftpu_client_failfast_total", "counter",
    "call-timeout transport bails: the connection was dropped so every "
    "other outstanding frame failed NOW instead of serially waiting "
    "out its own deadline",
    lambda l: [({"layer": l.name}, l.failfast_drops)],
    live=_LIVE_CLIENT_LAYERS)
_metrics.REGISTRY.register_objects(
    "gftpu_qos_client_backoff_total", "counter",
    "fops re-sent after a brick qos-throttle shed (the client half of "
    "the QoS plane: the caller sees a slower fop, never the EAGAIN)",
    lambda l: [({"layer": l.name}, l.qos_backoff_total)],
    live=_LIVE_CLIENT_LAYERS)


@register("protocol/client")
class ClientLayer(Layer):
    OPTIONS = (
        Option("remote-host", "str", default="127.0.0.1"),
        Option("remote-port", "int", default=0),
        Option("remote-subvolume", "str", default=""),
        Option("ping-interval", "time", default="1"),
        Option("ping-timeout", "time", default="5",
               description="declare peer dead after this (network.ping-timeout)"),
        Option("reconnect-interval", "time", default="0.5"),
        Option("call-timeout", "time", default="30"),
        Option("username", "str", default="",
               description="login credential presented at SETVOLUME "
                           "(volgen injects the volume's generated pair)"),
        Option("password", "str", default=""),
        Option("ssl", "bool", default="off",
               description="TLS to the brick (client.ssl / socket.c)"),
        Option("ssl-ca", "str", default="",
               description="CA bundle to verify the brick cert against"),
        Option("ssl-cert", "str", default="",
               description="client certificate (mutual TLS)"),
        Option("ssl-key", "str", default=""),
        Option("event-threads", "int", default=2, min=0, max=64,
               description="reply-turning workers "
                           "(client.event-threads; the client half "
                           "of the multithreaded-epoll analog): "
                           "decode of large reply frames — a 4 MiB "
                           "scatter-gather readv reply, a fat "
                           "readdirp listing — moves off the read "
                           "loop onto the process-wide event pool, "
                           "so it no longer serializes behind the "
                           "next request's encode.  The pool is "
                           "shared by every protocol/client in the "
                           "process (the reference's per-process "
                           "gf-event pool); connect grows it to the "
                           "largest configured value, reconfigure "
                           "applies the new value exactly.  0 = "
                           "decode inline (pre-9 behavior)"),
        Option("compound-fops", "bool", default="off",
               description="fuse chained fops into single wire frames "
                           "(cluster.use-compound-fops); only engages "
                           "when the brick advertised compound support "
                           "at SETVOLUME — otherwise chains decompose "
                           "into singles (mixed-version fallback)"),
        Option("sg-replies", "bool", default="on",
               description="request scatter-gather reply payloads at "
                           "SETVOLUME (network.zero-copy-reads): a "
                           "reply held brick-side as several buffers "
                           "arrives as a blob vector decoded into "
                           "segment views — no join copy on either "
                           "end.  Off = the brick joins before "
                           "framing (pre-sg wire behavior)"),
        Option("shm-transport", "bool", default="on",
               description="arm the same-host shared-memory bulk lane "
                           "at SETVOLUME when the brick advertises it "
                           "(network.shm-transport client half, "
                           "rpc/shm): request payloads (writev/xorv/"
                           "compound blobs) are written once into a "
                           "memfd arena shared with the brick and only "
                           "descriptors ride the socket; reply blobs "
                           "arrive as views into the peer's arena.  "
                           "Read per-call: off live-downgrades to "
                           "inline frames without a reconnect"),
        Option("trace-fops", "bool", default="on",
               description="ship the current trace id as a trailing "
                           "wire-frame field so brick-side spans join "
                           "the client's trace "
                           "(diagnostics.trace-propagation); only "
                           "engages when the brick advertised trace "
                           "support at SETVOLUME — a live-downgraded "
                           "peer simply never sees the field"),
        Option("circuit-breaker", "bool", default="on",
               description="per-brick circuit breaking "
                           "(client.circuit-breaker): after "
                           "circuit-failure-threshold consecutive "
                           "transport-class failures (ENOTCONN / "
                           "ETIMEDOUT) the circuit OPENS — fops fail "
                           "immediately instead of feeding a flapping "
                           "brick a retry storm; after "
                           "circuit-reset-interval it half-opens and "
                           "admits ONE probe, whose outcome closes or "
                           "re-opens it.  A successful SETVOLUME "
                           "handshake always closes the circuit"),
        Option("circuit-failure-threshold", "int", default=5, min=1,
               max=1024,
               description="consecutive transport failures that open "
                           "the circuit (client.circuit-failure-"
                           "threshold)"),
        Option("circuit-reset-interval", "time", default="2",
               description="open -> half-open probe delay "
                           "(client.circuit-reset-interval)"),
        Option("failfast", "bool", default="on",
               description="a fop round-trip hitting call-timeout "
                           "drops the transport (the frame-timeout "
                           "bail): every other outstanding frame "
                           "fails with ENOTCONN NOW instead of each "
                           "serially waiting out its own deadline "
                           "against a peer that eats requests.  Lock "
                           "fops are exempt — they park server-side "
                           "legitimately"),
        Option("idempotent-retries", "int", default=2, min=0, max=8,
               description="re-dispatch attempts for idempotent "
                           "(read-class) fops after a transport-class "
                           "failure, with capped exponential backoff; "
                           "retries stop the moment the circuit opens "
                           "(client.idempotent-retries; the georep "
                           "repce retry allowlist idea on the data "
                           "plane).  0 = fail through immediately"),
        Option("retry-backoff-max", "time", default="1",
               description="cap on the exponential retry backoff "
                           "(base 50ms, doubling per attempt)"),
        Option("qos-backoff", "bool", default="on",
               description="honor brick qos-throttle notices "
                           "(client.qos-backoff): a frame shed by the "
                           "brick's QoS admission (EAGAIN + retry-after "
                           "in the error xdata) is re-sent after the "
                           "advertised wait instead of surfacing the "
                           "errno — safe for ANY fop, idempotent or "
                           "not, because a shed frame was refused at "
                           "admission and never dispatched.  Off = the "
                           "raw EAGAIN (+ notice) reaches the caller"),
        Option("deadline-propagation", "bool", default="on",
               description="ship each fop's remaining deadline budget "
                           "in the request (network.deadline-"
                           "propagation): the brick arms it per "
                           "request so io-threads can DROP work whose "
                           "client already timed the call out instead "
                           "of burning a worker on an abandoned "
                           "answer.  Only engages when the brick "
                           "advertised the capability at SETVOLUME"),
        Option("strict-locks", "bool", default="off",
               description="fds holding posix locks must not be "
                           "reached through anonymous (gfid-addressed) "
                           "fds after a reconnect dropped their "
                           "server-side handle (client.strict-locks, "
                           "reference client.c:2438): lock-protected "
                           "I/O fails with EBADFD instead of silently "
                           "bypassing the lock's fd identity"),
        Option("compression", "bool", default="off",
               description="zlib on-wire frames (the cdc/compress "
                           "xlator analog); the brick mirrors it on "
                           "replies after the handshake"),
        Option("compression-min-size", "size", default="512",
               description="frames below this ship uncompressed"),
        Option("compression-level", "int", default=1, min=-1, max=9,
               description="zlib level for on-wire compression "
                           "(network.compression.compression-level)"),
        # socket.c transport knobs (0 = kernel default)
        Option("tcp-user-timeout", "time", default="0",
               description="TCP_USER_TIMEOUT: cap on unacked-data "
                           "linger before the kernel declares the "
                           "peer dead (client.tcp-user-timeout)"),
        Option("keepalive-time", "time", default="20",
               description="TCP_KEEPIDLE (client.keepalive-time)"),
        Option("keepalive-interval", "time", default="2",
               description="TCP_KEEPINTVL (client.keepalive-interval)"),
        Option("keepalive-count", "int", default=9, min=0,
               description="TCP_KEEPCNT (client.keepalive-count)"),
        Option("tcp-window-size", "size", default="0",
               description="SO_RCVBUF/SO_SNDBUF "
                           "(network.tcp-window-size)"),
    )

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.connected = False
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._xid = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._tasks: list[asyncio.Task] = []
        self._closing = False
        self.identity = gfid_new()
        self._last_pong = 0.0
        # did the peer advertise compound support at SETVOLUME?
        self._peer_compound = False
        # did the peer advertise trace-span re-arming at SETVOLUME?
        self._peer_trace = False
        # fop round-trips awaited on this transport (handshake/ping
        # excluded; the wire-frame-counting tests read this)
        self.rpc_roundtrips = 0
        # wire accounting (client half of the brick's per-client
        # counters): integer adds on buffers already in hand
        self.bytes_tx = 0
        self.bytes_rx = 0
        self.connects = 0
        # circuit breaker (client.circuit-breaker): closed -> open on
        # consecutive transport failures -> half-open probe -> closed
        self._cb_state = "closed"
        self._cb_failures = 0
        self._cb_opened_at = 0.0
        self._cb_probing = False
        self.retries_total = 0
        self.failfast_drops = 0
        # QoS plane (features/qos): traffic attribution carried in the
        # handshake creds ("rebalance" rides the brick's paced lane;
        # set by api.Client/mount_volume BEFORE connect so the first
        # handshake already carries it), and the shed-retry count
        self.traffic_origin = ""
        self.qos_backoff_total = 0
        # did the brick advertise deadline-budget arming at SETVOLUME?
        self._peer_deadline = False
        # did the brick advertise the xorv fop (parity-delta writes)?
        self._peer_xorv = False
        # did the brick advertise lease grants (op-version 15)?  The
        # api layer checks this before letting caches go zero-RT
        self._peer_leases = False
        # same-host shared-memory bulk lane (rpc/shm, op-version 17):
        # armed at SETVOLUME via the brick's fd side-channel.  _peer_shm
        # flips only after BOTH arenas mapped and the brick confirmed
        # (__shm_ok__); _shm_refused remembers a brick-side EOPNOTSUPP
        # downgrade (like the xorv memory — zero wasted frames after)
        self._peer_shm = False
        self._shm_tx = None
        self._shm_rx = None
        self._shm_refused = False
        _LIVE_CLIENT_LAYERS.add(self)
        # reopen bookkeeping (client-handshake.c reopen_fd_count):
        # live fds with server-side handles (value = (fd, reopen fop)),
        # and locks granted through this connection, replayed on
        # reconnect before CHILD_UP
        self._fds: dict[int, tuple[FdObj, str]] = {}
        self._held_locks: dict[tuple, tuple] = {}  # key -> (fop, args, kw)

    def reconfigure(self, options: dict) -> None:
        """client.event-threads applies live: the process-wide reply
        pool is resized to the operator's latest value exactly —
        grow AND shrink (the connect-time path only grows it)."""
        before = self.opts["event-threads"]
        super().reconfigure(options)
        after = self.opts["event-threads"]
        if after != before:
            _evt.client_pool_resize(after)

    # -- lifecycle ---------------------------------------------------------

    async def init(self):
        await super().init()
        self._closing = False
        self._tasks.append(asyncio.create_task(self._connect_loop()))

    async def fini(self):
        self._closing = True
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        await self._drop_connection(notify=False)
        await super().fini()

    async def _connect_loop(self) -> None:
        while not self._closing:
            if not self.connected:
                try:
                    await self._connect()
                except Exception as e:
                    log.debug(3, "%s: connect failed: %r", self.name, e)
            await asyncio.sleep(self.opts["reconnect-interval"])

    def _ssl_context(self):
        if not self.opts["ssl"]:
            return None
        from ..rpc import tls

        return tls.client_context(self.opts["ssl-ca"],
                                  self.opts["ssl-cert"],
                                  self.opts["ssl-key"])

    async def _connect(self) -> None:
        host = self.opts["remote-host"]
        port = self.opts["remote-port"]
        # reap finished read-loop tasks from failed attempts
        self._tasks = [t for t in self._tasks if not t.done()]
        reader, writer = await asyncio.open_connection(
            host, port, ssl=self._ssl_context())
        from ..rpc.socktune import tune_socket

        tune_socket(writer.get_extra_info("socket"),
                    keepalive_time=self.opts["keepalive-time"],
                    keepalive_interval=self.opts["keepalive-interval"],
                    keepalive_count=self.opts["keepalive-count"],
                    user_timeout=self.opts["tcp-user-timeout"],
                    window_size=self.opts["tcp-window-size"])
        self._reader, self._writer = reader, writer
        self._tasks.append(asyncio.create_task(self._read_loop(reader)))
        # handshake = SETVOLUME (client-handshake.c) with auth/login
        # credentials (client_setvolume req dict auth keys)
        creds = {}
        if self.opts["username"]:
            creds = {"username": self.opts["username"],
                     "password": self.opts["password"]}
        # advertise this build's op-version (client_setvolume sends
        # GD_OP_VERSION the same way) and the trace willingness, for
        # the brick's client accounting (client_t capability column)
        from .. import OP_VERSION

        creds["op-version"] = OP_VERSION
        if self.traffic_origin:
            # QoS traffic attribution (features/qos): re-sent on every
            # reconnect handshake, so attribution survives a bounce
            creds["origin"] = self.traffic_origin
        if self.opts["trace-fops"]:
            creds["trace-fops"] = True
        if self.opts["compression"]:
            creds["compress"] = True
        if self.opts["sg-replies"] and not self.opts["compression"]:
            # sg only pays off on the blob lane; compressed frames
            # inline everything anyway
            creds["sg-replies"] = True
        if self.opts["shm-transport"] and not self.opts["compression"] \
                and not self._shm_refused and _shm.supported():
            # ask for the shared-memory bulk lane (same
            # compression carve-out as sg: inlined frames carry no
            # blobs for the arena to hold)
            creds["shm-transport"] = True
        try:
            res = await self._call("__handshake__",
                                   (self.identity,
                                    self.opts["remote-subvolume"], creds),
                                   {})
        except BaseException:
            await self._drop_connection(notify=False)
            raise
        if not res.get("ok"):
            # close NOW: the retry loop would otherwise leak one socket
            # + read task per attempt on both ends
            await self._drop_connection(notify=False)
            raise FopError(errno.EACCES,
                           res.get("error", "handshake rejected"))
        # per-peer capability (mixed-version clusters): a brick that
        # doesn't advertise compound gets singles from this client
        self._peer_compound = bool(res.get("compound"))
        # did the peer advertise trace re-arming?  The local trace-fops
        # option is read per-call (not folded in here) so a live
        # volume-set of diagnostics.trace-propagation applies without
        # a reconnect — same pattern as compound-fops
        self._peer_trace = bool(res.get("trace"))
        # deadline-budget propagation: only to bricks that pop the
        # reserved request field before dispatch (older bricks would
        # pass it into the fop signature)
        self._peer_deadline = bool(res.get("deadline"))
        # parity-delta writes: only bricks that serve xorv (op-version
        # 12).  A missing key fails the fop EOPNOTSUPP locally — zero
        # round trips wasted per write against a live-downgraded brick
        self._peer_xorv = bool(res.get("xorv"))
        # lease plane: only bricks that grant + recall leases (op-
        # version 15).  A client stack over an older brick never enters
        # zero-RT cache mode — TTL revalidation stays the coherence
        # story there
        self._peer_leases = bool(res.get("leases"))
        # shm bulk lane: the advert carries boot-id + side-channel
        # address + one-shot token.  Arming failure of ANY kind is the
        # boring fallback — this connection simply stays inline
        ad = res.get("shm")
        if ad and creds.get("shm-transport"):
            try:
                await self._shm_arm(ad)
            except Exception as e:  # noqa: BLE001 - fallback is total
                log.warning(8, "%s: shm lane arming failed: %r",
                            self.name, e)
                _shm.count_fallback("sidechannel")
                self._shm_teardown()
        # re-open tracked fds and re-acquire held locks BEFORE CHILD_UP
        # (client_child_up_reopen_done): parents must never see an "up"
        # child whose fd handles are stale
        try:
            await self._reopen_fds()
            await self._reacquire_locks()
        except BaseException:
            await self._drop_connection(notify=False)
            raise
        self.connected = True
        self.connects += 1
        # a successful SETVOLUME is transport proof: the circuit closes
        # (the probe path for reconnect-driven recovery)
        self._cb_record(True)
        loop = asyncio.get_running_loop()
        self._last_pong = loop.time()
        self._tasks.append(asyncio.create_task(self._ping_loop()))
        log.info(4, "%s: connected to %s:%d (%s)", self.name, host, port,
                 res.get("volume"))
        # events.h EVENT_BRICK_CONNECTED — fires on every successful
        # SETVOLUME, so a reconnect storm is visible as a pulse train
        gf_event("BRICK_CONNECTED", layer=self.name,
                 brick=str(res.get("volume", "")),
                 remote=f"{host}:{port}",
                 subvol=self.opts["remote-subvolume"])
        self.notify(Event.CHILD_UP, None, None)

    async def _reopen_fds(self) -> None:
        """Re-open every tracked fd on the fresh connection
        (client_reopen_done, client-handshake.c:68-97).  A file that
        vanished while we were away drops its handle — the fd degrades
        to gfid-addressed (anonymous) access and surfaces ENOENT
        naturally on the next fop."""
        import os as _os

        for key, (fd, how) in list(self._fds.items()):
            loc = Loc(fd.path, gfid=fd.gfid)
            # never replay creation semantics: O_TRUNC would wipe the
            # file we are reconnecting to, O_CREAT|O_EXCL would EEXIST
            flags = fd.flags & ~(_os.O_CREAT | _os.O_EXCL | _os.O_TRUNC)
            fop_args = (loc,) if how == "opendir" else (loc, flags)
            try:
                ret = await self._call(how, fop_args, {})
            except FopError as e:
                log.warning(8, "%s: reopen of %s failed: %s", self.name,
                            fd.path or fd.gfid.hex(), e)
                fd.ctx_del(self)
                self._fds.pop(key, None)
                continue
            if isinstance(ret, wire.FdHandle):
                fd.ctx_set(self, ret)
            log.debug(8, "%s: reopened %s", self.name,
                      fd.path or fd.gfid.hex())

    async def _reacquire_locks(self) -> None:
        """Replay granted locks on the fresh brick (the brick restarted
        with empty lock tables).  Bounded per lock: a now-conflicting
        lock (someone else grabbed the range while we were away) is
        dropped with a warning — the reference's lk-heal gives these up
        after its grace period too."""
        for key, (fop, args, kwargs) in list(self._held_locks.items()):
            try:
                await asyncio.wait_for(
                    self._call(fop, self._wire_args(args), dict(kwargs)),
                    5)
            except (FopError, asyncio.TimeoutError) as e:
                log.warning(8, "%s: lost %s lock across reconnect: %r",
                            self.name, fop, e)
                self._held_locks.pop(key, None)

    async def _shm_arm(self, ad: dict) -> None:
        """Arm the shared-memory bulk lane from a SETVOLUME advert:
        boot-id screen, side-channel fd exchange (the real same-host
        proof — the fds either map or they don't), then __shm_ok__ so
        the brick knows replies may ride its s2c arena.  The rx arena
        is armed BEFORE __shm_ok__ goes out: no FL_SHM reply can beat
        our ability to resolve it."""
        if str(ad.get("boot-id", "")) != _shm.boot_id():
            # different machine: the side-channel cannot exist here —
            # don't even dial (cheap screen; lane never arms)
            _shm.count_fallback("cross-host")
            return
        addr = str(ad.get("addr") or "")
        token = str(ad.get("token") or "")
        if not addr or not token:
            _shm.count_fallback("sidechannel")
            return
        # blocking AF_UNIX dial + SCM_RIGHTS receive, off the loop
        fds = await asyncio.to_thread(_shm.fetch_fds, addr, token)
        try:
            self._shm_tx = _shm.ShmTx.attach(fds[0])   # c2s: we write
            self._shm_rx = _shm.ShmRx.attach(fds[1])   # s2c: we read
        finally:
            for fd in fds:
                try:
                    os.close(fd)
                except OSError:
                    pass
        res = await self._call("__shm_ok__", (), {})
        if not (isinstance(res, dict) and res.get("ok")):
            raise FopError(errno.EPROTO, "shm confirm refused")
        self._peer_shm = True
        log.info(8, "%s: shm bulk lane armed", self.name)

    def _shm_teardown(self) -> None:
        """Drop both arenas (close defers under live consumer views);
        the lane re-arms on the next successful handshake unless
        refused."""
        self._peer_shm = False
        for arena in (self._shm_tx, self._shm_rx):
            if arena is not None:
                try:
                    arena.close()
                except Exception:
                    pass
        self._shm_tx = None
        self._shm_rx = None

    def _shm_disarm(self, reason: str) -> None:
        """Peer-driven downgrade (EOPNOTSUPP + shm-unsupported xdata):
        remembered like the xorv capability — this layer never offers
        shm again, so zero further frames are wasted on it."""
        self._shm_refused = True
        _shm.count_fallback(reason)
        self._shm_teardown()
        log.warning(8, "%s: shm lane disarmed (%s)", self.name, reason)
        flight.record("shm_disarm", layer=self.name, reason=reason)

    async def _drop_connection(self, notify: bool = True) -> None:
        was = self.connected
        self.connected = False
        self._shm_teardown()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
            self._reader = None
        # unwind in-flight calls (saved_frames analog)
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(FopError(errno.ENOTCONN, "disconnected"))
        self._pending.clear()
        if was and notify:
            log.warning(5, "%s: disconnected", self.name)
            gf_event("BRICK_DISCONNECTED", layer=self.name,
                     remote=f"{self.opts['remote-host']}:"
                            f"{self.opts['remote-port']}",
                     subvol=self.opts["remote-subvolume"])
            self.notify(Event.CHILD_DOWN, None, None)

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                rec = await wire.read_frame(reader)
                self.bytes_rx += len(rec) + 4  # + the length prefix
                # reply turning (client.event-threads): large frames
                # decode on the shared event pool, keyed by this layer
                # so one connection's replies and upcalls resolve in
                # arrival order; small frames decode inline (cheaper
                # than the handoff).  A layer configured to 0 decodes
                # inline even when another graph grew the shared pool
                # (the documented escape hatch is per-volume)
                n = self.opts["event-threads"]
                pool = _evt.client_pool(n) \
                    if n > 0 and len(rec) >= _evt.TURN_MIN else None
                if pool is not None and pool.size > 0:
                    xid, mtype, payload = await pool.turn(
                        self, wire.unpack, rec, self._shm_rx)
                else:
                    xid, mtype, payload = wire.unpack(rec, self._shm_rx)
                if mtype == wire.MT_EVENT:
                    # server-pushed upcall (cache invalidation etc.):
                    # surface as a graph notification for md-cache & co
                    self.notify(Event.UPCALL, None, payload)
                    continue
                fut = self._pending.pop(xid, None)
                if fut is None or fut.done():
                    continue
                if mtype == wire.MT_ERROR:
                    fut.set_exception(payload if isinstance(payload, FopError)
                                      else FopError(errno.EIO, str(payload)))
                else:
                    fut.set_result(payload)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass
        finally:
            if reader is self._reader:
                await self._drop_connection()

    async def _ping_loop(self) -> None:
        loop = asyncio.get_running_loop()
        interval = self.opts["ping-interval"]
        timeout = self.opts["ping-timeout"]
        try:
            while self.connected:
                t0 = loop.time()
                await asyncio.sleep(interval)
                # a LOCAL event-loop stall (host overload, long compile)
                # silences our own ping clock — don't blame the peer
                # for it (rpc-clnt-ping only counts time the transport
                # was actually serviced)
                stalled = loop.time() - t0 > 3 * interval
                try:
                    await asyncio.wait_for(
                        self._call("__ping__", (), {}), interval)
                    self._last_pong = loop.time()
                except (FopError, asyncio.TimeoutError):
                    pass
                if stalled:
                    self._last_pong = max(self._last_pong,
                                          loop.time() - interval)
                    continue
                if loop.time() - self._last_pong > timeout:
                    log.warning(6, "%s: ping timeout (%.1fs)", self.name,
                                timeout)
                    await self._drop_connection()
                    return
        except asyncio.CancelledError:
            pass

    # -- circuit breaker (client.circuit-breaker) --------------------------

    #: failures that indict the TRANSPORT (not the fop): these trip the
    #: breaker and are the only errors the idempotent allowlist retries
    _TRANSPORT_ERRNOS = (errno.ENOTCONN, errno.ETIMEDOUT)

    @classmethod
    def _is_transport_err(cls, e: FopError) -> bool:
        """Did this failure indict the transport?  ENOTCONN always
        does; ETIMEDOUT only when the CLIENT's own deadline expired
        (``_local_timeout`` stamped in _call) — a server-ANSWERED
        ETIMEDOUT (a contended lock wait, an io-threads deadline drop)
        proves the wire as well as OK does, and must not open the
        circuit for a healthy brick."""
        if e.err == errno.ENOTCONN:
            return True
        return e.err == errno.ETIMEDOUT and \
            getattr(e, "_local_timeout", False)

    def _cb_admit(self) -> bool:
        """Gate one fop through the breaker: open fails fast (load
        shedding — a flapping brick must not absorb a retry storm),
        open past the reset interval half-opens and admits exactly ONE
        probe, half-open with a probe in flight fails fast.  Returns
        True when THIS call is the half-open probe (the caller must
        clear ``_cb_probing`` if it aborts without an outcome)."""
        if not self.opts["circuit-breaker"] or self._cb_state == "closed":
            return False
        if self._cb_state == "open":
            now = asyncio.get_running_loop().time()
            if now - self._cb_opened_at < \
                    self.opts["circuit-reset-interval"]:
                raise FopError(errno.ENOTCONN,
                               f"{self.name}: circuit open")
            self._cb_state = "half-open"
            self._cb_probing = False
        if self._cb_probing:
            raise FopError(errno.ENOTCONN,
                           f"{self.name}: circuit half-open "
                           "(probe in flight)")
        self._cb_probing = True
        return True

    def _cb_record(self, transport_ok: bool) -> None:
        """Account one fop outcome.  ``transport_ok`` means the wire
        answered (success or an ordinary fop error — ENOENT proves the
        transport as well as OK does)."""
        if not self.opts["circuit-breaker"]:
            return
        if transport_ok:
            self._cb_failures = 0
            self._cb_probing = False
            if self._cb_state != "closed":
                self._cb_state = "closed"
                log.info(6, "%s: circuit closed", self.name)
                gf_event("CLIENT_CIRCUIT_CLOSE", layer=self.name,
                         remote=f"{self.opts['remote-host']}:"
                                f"{self.opts['remote-port']}",
                         subvol=self.opts["remote-subvolume"])
            return
        self._cb_failures += 1
        self._cb_probing = False
        threshold = int(self.opts["circuit-failure-threshold"])
        if self._cb_state == "half-open" or \
                self._cb_failures >= threshold:
            try:
                self._cb_opened_at = asyncio.get_running_loop().time()
            except RuntimeError:
                return  # no loop: stay put rather than wedge open
            if self._cb_state != "open":
                self._cb_state = "open"
                log.warning(6, "%s: circuit OPEN after %d consecutive "
                            "transport failures", self.name,
                            self._cb_failures)
                gf_event("CLIENT_CIRCUIT_OPEN", layer=self.name,
                         failures=self._cb_failures,
                         remote=f"{self.opts['remote-host']}:"
                                f"{self.opts['remote-port']}",
                         subvol=self.opts["remote-subvolume"])

    # -- call machinery ----------------------------------------------------

    @staticmethod
    def _load_headroom() -> float:
        """Deadline multiplier for blocking lock fops, scaled to host
        load.  A blocking inodelk legitimately parks server-side for up
        to the locks layer's lock-timeout (30s default) — the same value
        as call-timeout — so on a loaded single-core host the RPC
        deadline races the server's own wait and loses by scheduling
        jitter alone (an "inodelk timed out" flake).  Floor 2x so the race can't tie even on an idle host;
        cap 8x so a genuinely dead brick still fails in bounded time."""
        try:
            import os as _os

            load = _os.getloadavg()[0] / (_os.cpu_count() or 1)
        except (OSError, AttributeError):
            load = 1.0
        return min(8.0, max(2.0, load))

    async def _call(self, fop: str, args: tuple, kwargs: dict) -> Any:
        writer = self._writer
        if writer is None:
            raise FopError(errno.ENOTCONN, f"{self.name}: not connected")
        data_fop = fop == "__compound__" or not fop.startswith("__")
        if data_fop:
            self.rpc_roundtrips += 1
        timeout = self.opts["call-timeout"]
        if fop in self._LOCK_FOPS:
            timeout *= self._load_headroom()
        elif data_fop and self._peer_deadline and \
                self.opts["deadline-propagation"]:
            # ship the remaining budget (relative seconds — clocks
            # differ across processes) so brick-side io-threads can
            # drop work this call will have abandoned by the time a
            # worker frees up (the reserved field is popped by the
            # brick before dispatch; gated on the SETVOLUME capability)
            kwargs = {**(kwargs or {}), "__deadline__": round(timeout, 3)}
        xid = next(self._xid)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[xid] = fut
        lane = None
        try:
            body = [fop, list(args), kwargs or {}]
            if self._peer_trace and tracing.ENABLED and \
                    self.opts["trace-fops"]:
                # trailing trace-id element (the wire twin of the
                # reference's frame->root): the server re-arms it so
                # brick-graph spans carry THIS request's trace id.
                # Handshake/ping frames predate _peer_trace or carry no
                # fop context worth attributing.
                tid = tracing.current_id()
                if tid is not None:
                    body.append(tid)
            if self.opts["compression"]:
                buf = wire.pack_z(
                    xid, wire.MT_CALL, body,
                    int(self.opts["compression-min-size"]),
                    self.opts["compression-level"])
                self.bytes_tx += len(buf)
                writer.write(buf)
            else:
                # payload blobs ride out-of-band and writelines hands
                # the ORIGINAL buffers to the transport — a writev
                # payload is never copied on this side (iobref submit).
                # With the shm lane armed (and the option still on —
                # read per-call, so a live volume-set downgrades
                # instantly), blobs land in the shared arena and only
                # descriptors cross the socket
                if self._peer_shm and self._shm_tx is not None \
                        and not self._shm_tx.dead \
                        and self.opts["shm-transport"]:
                    lane = self._shm_tx
                frames = wire.pack_frames(xid, wire.MT_CALL, body, lane)
                self.bytes_tx += sum(len(f) for f in frames)
                writer.writelines(frames)
            await writer.drain()
        except (ConnectionError, RuntimeError):
            self._pending.pop(xid, None)
            await self._drop_connection()
            raise FopError(errno.ENOTCONN, "send failed") from None
        try:
            return await asyncio.wait_for(fut, timeout)
        except FopError as e:
            if lane is not None \
                    and isinstance(getattr(e, "xdata", None), dict) \
                    and e.xdata.get("shm-unsupported"):
                # the brick can't serve our shm frames (live downgrade,
                # restarted peer, lost mapping): remember the refusal
                # like the xorv capability and resend THIS call inline
                # — the caller never sees the downgrade
                self._shm_disarm("downgrade")
                return await self._call(fop, args, kwargs)
            raise
        except asyncio.TimeoutError:
            self._pending.pop(xid, None)
            if data_fop and fop not in self._LOCK_FOPS and \
                    self.opts["failfast"]:
                # frame-timeout bail (disconnect failfast): a peer that
                # ate a whole call deadline is treated as dead — drop
                # the transport so every OTHER outstanding frame fails
                # ENOTCONN now instead of serially waiting out its own
                # deadline.  Lock fops are exempt (they park
                # server-side legitimately); the reconnect loop takes
                # over from here.
                self.failfast_drops += 1
                log.warning(6, "%s: %s hit call-timeout (%.0fs) — "
                            "bailing the transport", self.name, fop,
                            timeout)
                flight.record("failfast_drop", layer=self.name, fop=fop,
                              timeout_s=round(float(timeout), 3))
                await self._drop_connection()
            e = FopError(errno.ETIMEDOUT, f"{fop} timed out")
            # the CLIENT's deadline expired — the wire never answered.
            # The breaker distinguishes this from a server-returned
            # ETIMEDOUT (which proves the transport)
            e._local_timeout = True
            raise e from None

    # payloads at or above this ride the out-of-band blob lane; below
    # it the tagged codec's inline copy is cheaper than a second iovec
    BLOB_MIN = 4096

    def _fd_holds_locks(self, fd: FdObj) -> bool:
        """Does this fd hold posix locks granted through this
        connection?  (lk / fd-addressed inodelk-class grants are keyed
        by the fd's identity in the replay table.)  id() keys cannot
        alias a recycled object: every entry's value tuple holds the
        fd itself (args), so the fd outlives its keys."""
        return any(k[1] == id(fd) for k in self._held_locks)

    def _strict_lock_check(self, args: tuple) -> None:
        """client.strict-locks (client.c:2438): an fd whose server-side
        handle is gone but which holds posix locks must NOT be silently
        served via an anonymous fd — the anon route bypasses the fd
        identity the lock protects (another client could have been
        granted the range while we were away).  Lock fops themselves
        are exempt: the unlock that clears the record must always be
        able to go out."""
        if not self.opts["strict-locks"]:
            return
        for a in args:
            if isinstance(a, FdObj) and not a.anonymous and \
                    a.ctx_get(self) is None and self._fd_holds_locks(a):
                raise FopError(
                    errno.EBADFD,
                    "fd holds locks but lost its remote handle "
                    "(strict-locks)")

    def _wire_args(self, args: tuple) -> tuple:
        out = []
        for a in args:
            if isinstance(a, FdObj):
                h = a.ctx_get(self)
                if h is None:
                    # anonymous fd: address by gfid server-side
                    out.append({"__anon_fd__": a.gfid, "path": a.path})
                else:
                    out.append(h)
            elif isinstance(a, (bytes, bytearray, memoryview)) and \
                    len(a) >= self.BLOB_MIN:
                out.append(wire.Blob(a))
            else:
                out.append(a)
        return tuple(out)

    _LOCK_FOPS = ("inodelk", "finodelk", "entrylk", "fentrylk", "lk")

    #: fops safe to re-dispatch after a transport-class failure (the
    #: georep repce allowlist idea on the data plane): read-class only —
    #: a duplicated read is harmless, a duplicated write is not
    _IDEMPOTENT_FOPS = frozenset((
        "lookup", "stat", "fstat", "access", "readlink", "readv",
        "getxattr", "fgetxattr", "statfs", "readdir", "readdirp",
        "seek", "rchecksum"))

    # qos-backoff retry ceiling: with a sane brick config the advertised
    # retry-after drains the bucket debt in a few rounds; the cap only
    # guards against a pathological advert spinning the loop forever
    _QOS_RETRY_CAP = 64

    async def fop_call(self, name: str, *args, **kwargs) -> Any:
        """One fop through the breaker, with the idempotent-retry loop:
        read-class fops re-dispatch after transport-class failures with
        capped exponential backoff (base 50ms, doubling), but never
        past an OPEN circuit — load shedding beats persistence on a
        flapping brick."""
        attempt = 0
        shaped = 0
        while True:
            try:
                return await self._fop_call_once(name, *args, **kwargs)
            except FopError as e:
                note = (getattr(e, "xdata", None) or {}).get(
                    "qos-throttle")
                if note is not None and e.err == errno.EAGAIN and \
                        self.opts["qos-backoff"] and not self._closing \
                        and shaped < self._QOS_RETRY_CAP:
                    # brick QoS shed (features/qos): refused at
                    # admission, never dispatched — so retrying is safe
                    # for ANY fop, not just idempotent ones.  The wait
                    # comes from the brick's own bucket math; the
                    # backoff cap bounds a misconfigured advert.  This
                    # loop IS the client-side shaping: the caller just
                    # sees a slower fop, never the errno.
                    shaped += 1
                    self.qos_backoff_total += 1
                    delay = min(float(self.opts["retry-backoff-max"]),
                                max(float(note.get("retry-after") or 0),
                                    0.005))
                    await asyncio.sleep(delay)
                    continue
                if not self._is_transport_err(e) or \
                        name not in self._IDEMPOTENT_FOPS or \
                        self._closing or self._cb_state == "open" or \
                        attempt >= int(self.opts["idempotent-retries"]):
                    raise
                attempt += 1
                self.retries_total += 1
                delay = min(float(self.opts["retry-backoff-max"]),
                            0.05 * (1 << (attempt - 1)))
                log.debug(8, "%s: retrying %s after %r (attempt %d, "
                          "%.2fs backoff)", self.name, name, e, attempt,
                          delay)
                await asyncio.sleep(delay)

    async def _fop_call_once(self, name: str, *args, **kwargs) -> Any:
        try:
            probe = self._cb_admit()
        except FopError:
            if name in self._LOCK_FOPS:
                # same contract as the not-connected path: a shed
                # unlock must still drop its replay entry
                self._track_lock(name, args, kwargs, failed=True)
            raise
        if not self.connected:
            if name in self._LOCK_FOPS:
                # a failed UNLOCK must still drop the replay entry: the
                # server reaps this client's locks on disconnect and the
                # caller proceeds as released — replaying it on
                # reconnect would pin a lock nobody will ever drop
                self._track_lock(name, args, kwargs, failed=True)
            self._cb_record(False)
            raise FopError(errno.ENOTCONN, f"{self.name}: child down")
        try:
            if name not in self._LOCK_FOPS:
                self._strict_lock_check(args)
            ret = await self._call(name, self._wire_args(args), kwargs)
        except FopError as e:
            self._cb_record(not self._is_transport_err(e))
            if name in self._LOCK_FOPS:
                self._track_lock(name, args, kwargs, failed=True)
                note = (getattr(e, "xdata", None)
                        or {}).get("lock-revoked")
                if note:
                    # the brick revoked our lock(s): purge the replay
                    # set for that domain, or reconnect would resurrect
                    # a lock the containment plane just broke
                    self._forget_revoked(note)
            raise
        except BaseException:
            # an aborted probe (cancellation, encode error) has no
            # outcome to record — release the half-open slot or the
            # breaker wedges in "probe in flight" forever
            if probe:
                self._cb_probing = False
            raise
        self._cb_record(True)
        out = self._absorb(ret, args)
        if name in ("open", "create", "opendir"):
            self._note_fd_result(name, out, args)
        elif name in ("inodelk", "finodelk", "entrylk", "fentrylk", "lk"):
            self._track_lock(name, args, kwargs)
        elif name in ("xattrop", "fxattrop"):
            # compound post-op unlock (features/locks xdata): the brick
            # released the lock — drop it from the replay set too, or a
            # reconnect would resurrect it forever
            unlock = (kwargs.get("xdata") or {}).get("unlock-inodelk")
            if unlock:
                domain, _ltype, start, end, owner = unlock
                target = args[0]
                ident = id(target) if isinstance(target, FdObj) else \
                    (target.gfid or target.path)
                okey = owner.hex() if isinstance(owner,
                                                 (bytes, bytearray)) \
                    else str(owner)
                for lkname in ("inodelk", "finodelk"):
                    self._held_locks.pop(
                        (lkname, ident, domain, okey, start, end), None)
        return out

    def _note_fd_result(self, name: str, out: Any, args: tuple) -> None:
        """Remember a just-opened fd (+ flags and the fop that re-creates
        it) for the reconnect re-open; create returns (fd, iatt) so walk
        one level of the absorbed result."""
        flat = out if isinstance(out, (list, tuple)) else (out,)
        for fd in flat:
            if isinstance(fd, FdObj) and fd.ctx_get(self) is not None:
                if name != "opendir":
                    fd.flags = next((a for a in args[1:]
                                     if isinstance(a, int)), fd.flags)
                self._fds[id(fd)] = (
                    fd, "opendir" if name == "opendir" else "open")

    async def compound(self, links, xdata: dict | None = None) -> list:
        """Ship a whole chain as ONE wire frame (the tentpole fusion:
        create+writev+flush+release of a small file is a single round
        trip).  Decomposes into ordinary wired fops when the volume key
        is off, the peer didn't advertise compound at SETVOLUME, or the
        chain carries lock fops (their reconnect-replay bookkeeping
        lives in fop_call)."""
        from ..rpc import compound as cfop

        links = cfop.validate(links)
        if not (self.connected and self.opts["compound-fops"]
                and self._peer_compound) or \
                any(l[0] in self._LOCK_FOPS for l in links):
            return await cfop.decompose(self, links, xdata)
        wire_links = []
        for fop, args, kwargs in links:
            self._strict_lock_check(args)
            wargs = [{cfop.FD_LINK_KEY: a.index}
                     if isinstance(a, cfop.FdRef) else a
                     for a in self._wire_args(args)]
            wkw = {k: ({cfop.FD_LINK_KEY: v.index}
                       if isinstance(v, cfop.FdRef) else v)
                   for k, v in kwargs.items()}
            wire_links.append([fop, wargs, wkw])
        probe = self._cb_admit()
        try:
            replies = await self._call(
                "__compound__", (wire_links,),
                {"xdata": xdata} if xdata else {})
        except FopError as e:
            self._cb_record(not self._is_transport_err(e))
            if e.err in (errno.ENOSYS, errno.EOPNOTSUPP):
                # the brick was downgraded/reconfigured under us:
                # remember and fall back to singles for this connection
                self._peer_compound = False
                return await cfop.decompose(self, links, xdata)
            raise
        except BaseException:
            if probe:  # aborted probe: release the half-open slot
                self._cb_probing = False
            raise
        self._cb_record(True)
        out = []
        for entry, (fop, args, _kw) in zip(replies, links):
            st, val = entry[0], entry[1]
            if st == "ok":
                val = self._absorb(val, args)
                if fop in cfop.FD_PRODUCERS:
                    self._note_fd_result(fop, val, args)
            out.append([st, val])
        return out

    async def xorv(self, fd: FdObj, data, offset: int,
                   xdata: dict | None = None):
        """Parity-delta apply.  Capability-gated: a brick
        that did not advertise ``xorv`` at SETVOLUME (op-version < 12,
        or live-downgraded under us) fails EOPNOTSUPP HERE, without a
        round trip — the EC layer treats that as "peer speaks full RMW
        only" and falls back.  Write-class: deliberately NOT in the
        idempotent-retry allowlist (a replayed XOR self-cancels)."""
        if self.connected and not self._peer_xorv:
            raise FopError(errno.EOPNOTSUPP,
                           f"{self.name}: peer has no xorv "
                           "(pre-op-version-12 brick)")
        kwargs = {"xdata": xdata} if xdata is not None else {}
        try:
            return await self.fop_call("xorv", fd, data, offset,
                                       **kwargs)
        except FopError as e:
            if e.err in (errno.EOPNOTSUPP, errno.ENOSYS):
                # reconfigured/downgraded brick answered: remember so
                # later writes skip the wasted round trip
                self._peer_xorv = False
                raise FopError(errno.EOPNOTSUPP, str(e)) from None
            raise

    def _forget_revoked(self, note: dict) -> None:
        """A 'lock-revoked' notice arrived on a lock fop's EAGAIN
        (features.locks-revocation): drop every replay entry in that
        lock domain — the brick already broke them, and the strict-locks
        pairing means lock-protected I/O on those fds fails loudly
        rather than riding a lock that no longer exists.  Dropping only
        weakens reconnect replay, never correctness."""
        domain = note.get("domain")
        kind = note.get("kind")
        for key in list(self._held_locks):
            if kind == "posix":
                if key[0] == "lk":
                    self._held_locks.pop(key, None)
            elif domain is not None and len(key) > 2 and \
                    key[2] == domain:
                self._held_locks.pop(key, None)

    def _track_lock(self, name: str, args: tuple, kwargs: dict,
                    failed: bool = False) -> None:
        """Mirror granted/released locks for reconnect replay.  Keys
        lead with the lock target's identity so release() can drop a
        closing fd's record locks in one sweep.  ``failed``: the call
        errored — unlocks still forget the entry (see fop_call), grants
        are never recorded."""

        def owner_of(xd):
            o = (xd or {}).get("lk-owner")
            return o.hex() if isinstance(o, (bytes, bytearray)) else str(o)

        def ident(target):
            if isinstance(target, FdObj):
                return id(target)
            return target.gfid or target.path

        try:
            if name in ("inodelk", "finodelk"):
                domain, target, cmd = args[0], args[1], args[2]
                start = args[4] if len(args) > 4 else kwargs.get("start", 0)
                end = args[5] if len(args) > 5 else kwargs.get("end", -1)
                xd = args[6] if len(args) > 6 else kwargs.get("xdata")
                key = (name, ident(target), domain, owner_of(xd),
                       start, end)
            elif name in ("entrylk", "fentrylk"):
                domain, target, basename = args[0], args[1], args[2]
                cmd = args[3]
                xd = args[5] if len(args) > 5 else kwargs.get("xdata")
                key = (name, ident(target), domain, basename,
                       owner_of(xd))
            else:  # lk
                fd, cmd, flock = args[0], args[1], args[2]
                if cmd == "getlk":
                    return
                xd = args[3] if len(args) > 3 else kwargs.get("xdata")
                key = ("lk", id(fd), owner_of(xd),
                       flock.get("start", 0), flock.get("len", 0))
                cmd = "unlock" if flock.get("type") == "unlck" else "lock"
            if cmd in ("lock", "lock-nb") and not failed:
                self._held_locks[key] = (name, args, kwargs)
            elif cmd not in ("lock", "lock-nb"):
                self._held_locks.pop(key, None)
        except (IndexError, AttributeError, TypeError):
            pass  # unexpected call shape: tracking must never break fops

    def _absorb(self, ret: Any, args: tuple) -> Any:
        """Turn returned FdHandles into local FdObjs and scatter-gather
        vectors into SGBufs (segments are memoryviews into the reply
        frame — the payload is never joined on this side either)."""
        if isinstance(ret, wire.FdHandle):
            fd = FdObj(ret.gfid, path=ret.path)
            fd.ctx_set(self, ret)
            return fd
        if isinstance(ret, dict) and len(ret) == 1 and \
                isinstance(ret.get(wire.SG_KEY), list):
            # the segment list shape is part of the marker: a user
            # xattr dict that merely has the key must pass untouched
            return wire.SGBuf(ret[wire.SG_KEY])
        if isinstance(ret, list):
            return [self._absorb(x, args) for x in ret]
        return ret

    async def release(self, fd: FdObj) -> None:
        self._fds.pop(id(fd), None)
        # a closed fd's record locks die with it (POSIX close semantics)
        self._held_locks = {k: v for k, v in self._held_locks.items()
                            if k[1] != id(fd)}
        h = fd.ctx_del(self)
        if h is not None and self.connected and self._writer is not None:
            # fire-and-forget, but ON THE WIRE NOW: release carries no
            # status the caller can observe (close() already returned
            # flush's) and the server reaps fd tables on disconnect —
            # yet the frame must hit the transport before any later
            # fop's, or a subsequent lock request could reach the brick
            # ahead of the release that frees the range it wants.  The
            # reply (matched by xid) finds no pending future and is
            # dropped by the read loop.
            xid = next(self._xid)
            try:
                frames = wire.pack_frames(
                    xid, wire.MT_CALL, ["release", [h], {}])
                self.bytes_tx += sum(len(f) for f in frames)
                self._writer.writelines(frames)
            except (ConnectionError, RuntimeError):
                pass  # teardown race: the server reaps on disconnect

    # remote admin/heal entry points (separate RPC programs in reference)
    async def remote(self, method: str, *args, **kwargs) -> Any:
        return await self.fop_call(method, *args, **kwargs)

    async def statedump_remote(self) -> dict:
        return await self._call("__statedump__", (), {})

    def dump_private(self) -> dict:
        return {"connected": self.connected,
                "remote": f"{self.opts['remote-host']}:"
                          f"{self.opts['remote-port']}",
                "pending_calls": len(self._pending),
                "bytes_tx": self.bytes_tx,
                "bytes_rx": self.bytes_rx,
                "connects": self.connects,
                "rpc_roundtrips": self.rpc_roundtrips,
                "shm": {"armed": self._peer_shm,
                        "refused": self._shm_refused,
                        "tx_used": (self._shm_tx.used()
                                    if self._shm_tx is not None else 0),
                        "rx_held": (self._shm_rx.used()
                                    if self._shm_rx is not None else 0)}}


def _make_wire_fop(op_name: str):
    async def wired(self, *args, **kwargs):
        ret = await self.fop_call(op_name, *args, **kwargs)
        return ret
    wired.__name__ = op_name
    return wired


from ..core.layer import _timed as _layer_timed  # noqa: E402

for _fop in Fop:
    # explicit methods (compound: capability-gated fusion + fallback)
    # keep their implementation; everything else is a plain wired fop.
    # Wrapped with the layer timer: protocol/client's per-fop stats ARE
    # the wire round-trip latency (the p50/p99 the bench records), and
    # the timed bracket is what mints/joins the trace span here when
    # this layer is the graph top.
    if _fop.value not in vars(ClientLayer):
        setattr(ClientLayer, _fop.value,
                _layer_timed(_fop.value, _make_wire_fop(_fop.value)))
