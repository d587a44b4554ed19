"""protocol/server — serves a brick graph over TCP, with auth and TLS.

Reference: xlators/protocol/server (actor table server-rpc-fops_v2.c:6132,
per-client fd tables + resolver, auth).  Here: an asyncio TCP service in
front of a layer graph.  Per-connection state mirrors ``client_t``: an fd
table (wire FdHandle -> live FdObj), the client's lk-owner prefix, and
disconnect cleanup that drops fds and lock grants (the reference's lock
reaping on disconnect).

Protocol: framed records (rpc/wire.py); a CALL carries
``[fop_name, args, kwargs]``; fd arguments travel as FdHandle; replies
carry the fop return (or MT_ERROR + FopError).  The handshake
(SETVOLUME analog) is the first call: ``__handshake__`` with the client
identity, requested subvolume name, and credentials; no other fop is
dispatched before it succeeds.

Auth mirrors xlators/protocol/auth: ``auth-reject``/``auth-allow`` are
address pattern lists checked in that order (auth/addr), and
``auth-user``/``auth-password`` is the login scheme (auth/login) —
glusterd generates per-volume credentials that volgen writes into both
the brick and client volfiles, the reference's trusted-volfile model.
TLS is the socket.c SSL analog: ``ssl on`` plus cert/key/ca paths turns
the listener into a TLS endpoint (ssl stdlib), with optional mutual
auth when a CA is configured.

The ``protocol/server`` graph layer itself is a passthrough that only
carries these options (the reference's server xlator at the top of every
brick volfile); BrickServer reads them from the graph top.

Trimmed from the JAX package's server until their modules are ported:
QoS admission (``features/qos``: a ``qos`` or ``qos-*`` option on the
served top is refused when the graph activates), brick multiplexing
(``__attach__``/``__detach__``) and the ``__history__`` and
``__alerts__`` management calls (``core/history``, ``core/slo``).  Each
trimmed call answers EOPNOTSUPP.
"""

from __future__ import annotations

import asyncio
import errno
import fnmatch
import hmac
import os
import socket
import ssl as ssl_mod
import time
from typing import Any

from ..core.events import gf_event
from ..core.fops import Fop, FopError
from ..core.layer import FdObj, Layer, register
from ..core.options import Option
from ..core import gflog, tracing
from ..core import metrics as _metrics
from ..rpc import shm as _shm
from ..rpc import wire
from ..rpc.event_pool import TURN_MIN, EventPool

log = gflog.get_logger("protocol.server")


@register("protocol/server")
class ServerLayer(Layer):
    """Option-carrying top of a brick graph (server xlator analog).

    All fops pass through; BrickServer enforces the auth/TLS options
    (the reference's server_setvolume + rpc-transport/socket do the
    same outside the fop path, server.c auth via gf_authenticate)."""

    OPTIONS = (
        Option("auth-allow", "str", default="*",
               description="comma-separated address patterns allowed to "
                           "connect (auth.addr.<brick>.allow)"),
        Option("auth-reject", "str", default="",
               description="comma-separated address patterns refused "
                           "(auth.addr.<brick>.reject; wins over allow)"),
        Option("auth-user", "str", default="",
               description="login username (auth.login.<brick>.allow)"),
        Option("auth-password", "str", default="",
               description="login password (auth.login.<user>.password)"),
        Option("auth-mgmt-user", "str", default="",
               description="management credential pair: written only "
                           "into the brick volfile (never served to "
                           "clients) so glusterd's reconfigure/statedump "
                           "calls pass even when auth.allow excludes "
                           "this host"),
        Option("auth-mgmt-password", "str", default=""),
        Option("ssl", "bool", default="off",
               description="serve TLS on the brick port (socket.c SSL)"),
        Option("ssl-cert", "str", default="",
               description="PEM certificate path (ssl-cert-file)"),
        Option("ssl-key", "str", default="",
               description="PEM private-key path (ssl-private-key)"),
        Option("ssl-ca", "str", default="",
               description="PEM CA bundle; when set, client certificates "
                           "are required and verified (ssl-ca-list)"),
        Option("ssl-allow", "str", default="",
               description="comma-separated certificate CN patterns "
                           "allowed to SETVOLUME (auth.ssl-allow, "
                           "server.c:1857): per-identity TLS auth on "
                           "top of CA verification.  Empty = any "
                           "verified cert.  Requires ssl + ssl-ca "
                           "(without a verified peer cert every "
                           "handshake is refused)"),
        Option("event-threads", "int", default=2, min=0, max=64,
               description="frame-turning workers for this brick's "
                           "transport (server.event-threads; the "
                           "multithreaded-epoll analog, "
                           "event-epoll.c): decode, payload handling "
                           "and reply encode of large frames move "
                           "off the accept loop onto a keyed worker "
                           "pool — a connection's frames are turned "
                           "by one worker at a time (per-connection "
                           "ordering preserved) while distinct "
                           "connections turn in parallel.  0 = turn "
                           "inline on the event loop (the pre-9 "
                           "serial plane).  Live-reconfigurable: the "
                           "pool grows/shrinks without dropping "
                           "in-flight frames"),
        Option("compound-fops", "bool", default="on",
               description="serve compound fop chains and advertise "
                           "the capability at SETVOLUME "
                           "(cluster.use-compound-fops server half); "
                           "off = clients fall back to single fops"),
        Option("trace-fops", "bool", default="on",
               description="advertise trace-span re-arming at SETVOLUME "
                           "and adopt the client's trailing trace-id "
                           "frame field before dispatching into the "
                           "brick graph, so brick-side spans join the "
                           "client's trace "
                           "(diagnostics.trace-propagation server "
                           "half); off = the field is ignored and "
                           "clients stop sending it"),
        Option("sg-replies", "bool", default="on",
               description="serve scatter-gather reply payloads: a "
                           "readv (or chain-link) reply held as several "
                           "buffers rides the frame as a blob VECTOR "
                           "(one gathered send, no join copy) to "
                           "clients that advertised sg at SETVOLUME "
                           "(network.zero-copy-reads server half); "
                           "off = replies are joined to single blobs"),
        Option("shm-transport", "bool", default="on",
               description="advertise the same-host shared-memory bulk "
                           "lane at SETVOLUME (network.shm-transport "
                           "server half; the RDMA-transport analog, "
                           "rpc/shm): blob payloads to/from colocated "
                           "clients ride memfd arenas exchanged over "
                           "an AF_UNIX side-channel, descriptors ride "
                           "the socket.  Read per-frame: off "
                           "live-downgrades every reply to inline "
                           "blobs without a reconnect"),
        Option("shm-arena-size", "size", default="16MB", min=65536,
               description="per-direction shared-memory arena size for "
                           "the shm bulk lane (network.shm-arena-size). "
                           "A frame whose blobs don't fit the free ring "
                           "ships inline — sizing is throughput tuning, "
                           "never correctness"),
        Option("listen-backlog", "int", default=1024, min=0,
               description="accept-queue depth for the brick listener "
                           "(transport.listen-backlog; socket.c default "
                           "1024 — a connect storm at volume start must "
                           "not see ECONNREFUSED)"),
        Option("address-family", "enum", default="inet",
               values=("inet", "inet6"),
               description="listener address family "
                           "(transport.address-family)"),
        Option("allow-insecure", "bool", default="on",
               description="accept client connections from unprivileged "
                           "(>1023) source ports (server.allow-insecure; "
                           "rpcsvc auth model).  Off = classic secure-"
                           "port check"),
        Option("tcp-user-timeout", "time", default="0",
               description="TCP_USER_TIMEOUT on accepted connections "
                           "(server.tcp-user-timeout)"),
        Option("keepalive-time", "time", default="20",
               description="TCP_KEEPIDLE (server.keepalive-time)"),
        Option("keepalive-interval", "time", default="2",
               description="TCP_KEEPINTVL (server.keepalive-interval)"),
        Option("keepalive-count", "int", default=9, min=0,
               description="TCP_KEEPCNT (server.keepalive-count)"),
        Option("tcp-window-size", "size", default="0",
               description="SO_RCVBUF/SO_SNDBUF on accepted "
                           "connections (network.tcp-window-size)"),
        Option("outstanding-rpc-limit", "int", default=64, min=0,
               max=65536,
               description="per-client cap on in-flight requests: at the "
                           "limit the brick stops reading that client's "
                           "connection until replies drain, so one "
                           "misbehaving or merely fast client cannot "
                           "balloon brick memory or starve others "
                           "(rpcsvc_request_outstanding, rpcsvc.c:211-250; "
                           "default rpcsvc.h:38).  0 = unlimited.  Lock "
                           "fops are exempt from the count — a limit full "
                           "of blocked locks would otherwise never admit "
                           "the unlock that frees them (rpcsvc.c:183-208)"),
    )

    _TRANSPORT_OPTS = ("ssl", "ssl-cert", "ssl-key", "ssl-ca")

    async def init(self) -> None:
        """Refuse the QoS options: their engine (``features/qos``) is
        not in this package, and a brick must not serve unshaped
        traffic that its volfile asked to shape."""
        qos = sorted(k for k in self.opts
                     if k == "qos" or k.startswith("qos-"))
        if qos:
            raise RuntimeError(
                f"{self.name}: option(s) {', '.join(qos)} need the "
                "features/qos layer, which this package does not have")
        await super().init()

    def reconfigure(self, options: dict) -> None:
        """TLS material is bound to the live listener at start(): a
        cert/key/ca change cannot take effect in-place, so refuse the
        live path — glusterd then falls back to a respawn, which picks
        the new material up (cert rotation must not silently no-op)."""
        from ..core.options import validate_options

        new = validate_options(self.OPTIONS, options)
        if any(new[k] != self.opts[k] for k in self._TRANSPORT_OPTS):
            raise RuntimeError("TLS transport change needs a restart")
        super().reconfigure(options)


def _addr_match(addr: str, patterns: str) -> bool:
    return any(fnmatch.fnmatch(addr, p.strip())
               for p in patterns.split(",") if p.strip())


def _peer_cn(cert) -> str | None:
    """commonName from a parsed TLS peer certificate (ssl module's
    getpeercert() dict shape), or None when absent/unverified."""
    for rdn in (cert or {}).get("subject", ()):
        for key, value in rdn:
            if key == "commonName":
                return value
    return None


def _ct_eq(a, b) -> bool:
    """Constant-time credential comparison (timing side-channel)."""
    if not isinstance(a, str) or not isinstance(b, str):
        return False
    return hmac.compare_digest(a.encode("utf-8", "surrogateescape"),
                               b.encode("utf-8", "surrogateescape"))

_FOPS = {f.value for f in Fop}
# lock-class fops never count against outstanding-rpc-limit
# (rpcsvc_can_outstanding_req_be_ignored, rpcsvc.c:183-208): a limit
# full of blocked lock requests would stop the connection being read,
# and the unlock that would unblock them could then never arrive
_THROTTLE_EXEMPT = {"inodelk", "finodelk", "entrylk", "fentrylk", "lk"}
# non-wire-fop methods a client may invoke remotely (heal entry points,
# introspection — the reference exposes these via separate RPC programs)
_RPC_EXTRAS = {"heal_info", "heal_file", "heal_entry", "rebalance",
               "release", "getactivelk", "quota_usage", "top_stats",
               "metrics_dump", "changelog_history",
               "contend_held_locks", "clear_locks"}

#: management calls of the JAX package's server that this package does
#: not serve yet, each with the module it waits for (answered EOPNOTSUPP)
_TRIMMED_RPCS = {"__attach__": "brick multiplexing",
                 "__detach__": "brick multiplexing",
                 "__history__": "core/history",
                 "__alerts__": "core/slo"}

#: the deep-status op family (GF_CLI_STATUS_* brick half) — the ONE
#: definition; glusterd's fan-out and the CLI parser import it
STATUS_KINDS = ("detail", "clients", "fds", "inodes", "callpool", "mem")

#: fops whose replies are worth encoding on the event pool: bulk data
#: (readv, compound chains with readv links) or structure-heavy tagged
#: bodies (listings, status/statedump dumps).  Everything else encodes
#: inline — a stat reply is ~200 bytes and the thread handoff would
#: cost more than the encode.
_BULKY_REPLY_FOPS = {"readv", "readdir", "readdirp", "getxattr",
                     "fgetxattr", "compound", "__compound__",
                     "__status__", "__statedump__"}


class _ClientConn:
    def __init__(self, server: "BrickServer", writer: asyncio.StreamWriter):
        self.server = server
        self.writer = writer
        self.fds: dict[int, FdObj] = {}
        self.next_fd = 1
        self.identity = b""
        self.name = ""
        self.authed = False
        self.is_mgmt = False
        self.peer_addr = "?"
        self.peercert = None  # parsed TLS peer cert (CN allow-listing)
        self.compress = False  # mirror zlib frames after handshake
        self.sg = False  # peer understands scatter-gather replies
        # the brick graph this transport bound to at SETVOLUME
        self.top: Layer | None = None
        self.graph = None
        # -- per-client accounting (the client_t dump of server.c) ----
        # maintained inline in the frame read/write paths: integer
        # adds on buffers the transport already holds, zero extra
        # syscalls, no per-fop allocation
        self.connected_at = time.time()
        self.bytes_rx = 0
        self.bytes_tx = 0
        self.fop_counts: dict[str, int] = {}
        self.caps: dict = {}  # capabilities advertised at SETVOLUME
        self.opversion = 0    # peer build's op-version (0 = pre-8 peer)
        # traffic origin from the handshake creds ("rebalance" rides
        # the paced QoS lane; "" / "client" is ordinary traffic)
        self.origin = ""
        # outstanding-rpc occupancy (status callpool reads these; they
        # replace the old _serve-closure locals)
        self.inflight = 0
        self.exempt_inflight = 0
        # same-host shared-memory bulk lane (rpc/shm): armed per
        # direction by the SETVOLUME side-channel.  shm_tx stays None
        # until the client confirms its rx mapping (__shm_ok__) — an
        # FL_SHM reply must never race the peer's arming
        self.shm_rx = None
        self.shm_tx = None
        self.shm_tx_armed = False
        self.shm_token = ""

    def info(self) -> dict:
        """One ``volume status clients`` row (client_t dump shape)."""
        total = sum(self.fop_counts.values())
        return {"client": self.identity.hex(),
                "addr": self.peer_addr,
                "subvol": self.name,
                "connected_since": self.connected_at,
                "uptime": time.time() - self.connected_at,
                "op_version": self.opversion,
                "caps": sorted(self.caps),
                "bytes_rx": self.bytes_rx,
                "bytes_tx": self.bytes_tx,
                "fops": total,
                "fop_counts": dict(self.fop_counts),
                "opened_fds": len(self.fds),
                "inflight": self.inflight + self.exempt_inflight,
                "origin": self.origin,
                "shm": ("armed" if self.shm_tx_armed
                        else "rx" if self.shm_rx is not None else "off"),
                "mgmt": self.is_mgmt}

    def register_fd(self, fd: FdObj) -> wire.FdHandle:
        fdid = self.next_fd
        self.next_fd += 1
        self.fds[fdid] = fd
        return wire.FdHandle(fdid, fd.gfid, fd.path)

    def resolve(self, v: Any) -> Any:
        if isinstance(v, wire.FdHandle):
            fd = self.fds.get(v.fdid)
            if fd is None:
                raise FopError(errno.EBADFD, f"stale fd {v.fdid}")
            return fd
        if isinstance(v, dict):
            if "__anon_fd__" in v:  # anonymous fd addressed by gfid
                return FdObj(v["__anon_fd__"], path=v.get("path", ""),
                             anonymous=True)
            return {k: self.resolve(x) for k, x in v.items()}
        if isinstance(v, list):
            return [self.resolve(x) for x in v]
        return v

    # reply payloads at or above this ride the out-of-band blob lane
    # (readv data must not crawl through the tagged codec byte-wise)
    BLOB_MIN = 4096

    def wrap(self, v: Any) -> Any:
        if isinstance(v, FdObj):
            return self.register_fd(v)
        if isinstance(v, wire.SGBuf):
            # scatter-gather reply (readv served from several buffers):
            # each segment becomes its own trailing blob — writelines
            # gathers them into one send with no join copy.  A peer
            # that didn't advertise sg (or a disabled brick) gets the
            # joined single buffer it expects.
            if self.sg and len(v.segments) > 1:
                return {wire.SG_KEY: [
                    wire.Blob(s) if len(s) >= self.BLOB_MIN else bytes(s)
                    for s in v.segments]}
            one = v.segments[0] if len(v.segments) == 1 else v.tobytes()
            return wire.Blob(one) if len(one) >= self.BLOB_MIN \
                else bytes(one)
        if isinstance(v, (bytes, bytearray, memoryview)) and \
                len(v) >= self.BLOB_MIN:
            return wire.Blob(v)
        if isinstance(v, tuple):
            return [self.wrap(x) for x in v]
        if isinstance(v, list):
            return [self.wrap(x) for x in v]
        if isinstance(v, dict):
            return {k: self.wrap(x) for k, x in v.items()}
        return v


# live brick servers, scraped by the unified registry (weakref: a
# stopped server's families age out with the GC).  Per-client series
# are labeled by brick + client-uid prefix so the Prometheus endpoint
# answers "who is connected and what are they consuming" per brick.
_LIVE_SERVERS = _metrics.REGISTRY.register_objects(
    "gftpu_server_clients", "gauge",
    "authenticated client connections per served brick",
    lambda s: s._client_gauge_samples())
_metrics.REGISTRY.register_objects(
    "gftpu_server_client_bytes_total", "counter",
    "wire bytes exchanged per authenticated client connection",
    lambda s: list(s._client_byte_samples()), live=_LIVE_SERVERS)
_metrics.REGISTRY.register_objects(
    "gftpu_server_client_fops_total", "counter",
    "fops dispatched per authenticated client connection",
    lambda s: s._client_fop_samples(), live=_LIVE_SERVERS)


class BrickServer:
    """TCP service for one brick graph top (the brick process core)."""

    def __init__(self, top: Layer, host: str = "127.0.0.1", port: int = 0,
                 graph=None):
        self.top = top
        self.host = host
        self.port = port
        self.graph = graph  # enables live option reconfigure
        self._server: asyncio.AbstractServer | None = None
        self.connections: set[_ClientConn] = set()
        # the concurrent event plane (server.event-threads): keyed
        # frame-turning workers shared by every connection on this
        # transport
        self._pool: EventPool | None = None
        # shm side-channel (rpc/shm): abstract AF_UNIX listener that
        # hands arena memfds to token-bearing clients via SCM_RIGHTS;
        # tokens are one-shot and bind the dial to a SETVOLUME'd
        # transport
        self._shm_srv: asyncio.AbstractServer | None = None
        self._shm_addr = ""
        self._shm_tokens: dict[str, _ClientConn] = {}
        _LIVE_SERVERS.add(self)

    # -- per-client metrics families (scraped by core/metrics.REGISTRY) ----

    def _served_name(self, conn: _ClientConn) -> str:
        return (conn.top if conn.top is not None else self.top).name

    def _authed_conns(self, top: Layer | None = None) -> list[_ClientConn]:
        return [c for c in self.connections
                if c.authed and (top is None or
                                 (c.top if c.top is not None
                                  else self.top) is top)]

    def _metric_conns(self) -> list[_ClientConn]:
        """Real clients only: every mgmt poll shares the identity
        b"glusterd", so two concurrent fan-outs would emit duplicate
        label sets — an invalid Prometheus exposition (status rows
        still list mgmt conns, flagged)."""
        return [c for c in self._authed_conns() if not c.is_mgmt]

    def _client_gauge_samples(self):
        per_brick: dict[str, int] = {}
        for c in self._metric_conns():
            per_brick[self._served_name(c)] = \
                per_brick.get(self._served_name(c), 0) + 1
        return [({"brick": b}, n) for b, n in per_brick.items()]

    def _client_byte_samples(self):
        for c in self._metric_conns():
            labels = {"brick": self._served_name(c),
                      "client": c.identity.hex()[:8]}
            yield {**labels, "dir": "rx"}, c.bytes_rx
            yield {**labels, "dir": "tx"}, c.bytes_tx

    def _client_fop_samples(self):
        return [({"brick": self._served_name(c),
                  "client": c.identity.hex()[:8]},
                 sum(c.fop_counts.values()))
                for c in self._metric_conns()]

    def _shm_advert(self, conn: _ClientConn, creds: dict,
                    top: Layer):
        """SETVOLUME shm advert (rpc/shm): only to peers that asked,
        never under frame compression (inlined frames carry no blobs),
        and only when the lane can actually arm here — option on,
        side-channel listening, platform support.  The returned token
        is one-shot and pairs the side-channel dial with THIS
        transport."""
        if not creds.get("shm-transport") or creds.get("compress"):
            return None
        if not self._shm_on(top) or self._shm_srv is None \
                or not _shm.supported():
            return None
        token = os.urandom(16).hex()
        conn.shm_token = token
        self._shm_tokens[token] = conn
        return {"boot-id": _shm.boot_id(), "addr": self._shm_addr,
                "token": token}

    def _select_top(self, name: str) -> tuple[Layer, Any]:
        """SETVOLUME routing: the requested remote-subvolume names the
        brick graph.  Clients name the brick ('v-brick-0') or its served
        top ('v-brick-0-server') — accept either.

        A nonempty name matching nothing in the graph fails the
        handshake explicitly (the reference's server_setvolume
        "remote-subvolume not found" error) instead of silently authing
        the client against the wrong graph."""
        if not name:
            return self.top, self.graph
        if name == self.top.name or name + "-server" == self.top.name:
            return self.top, self.graph
        if self.graph is None or \
                name in getattr(self.graph, "by_name", {}):
            # bare-Layer servers (no graph) cannot enumerate their
            # subvolumes; graph-backed ones accept any layer by name
            # (the reference resolves remote-subvolume anywhere in the
            # brick volfile)
            return self.top, self.graph
        raise FopError(errno.ENOENT,
                       f"unknown remote-subvolume {name!r}")

    @staticmethod
    def _opts_of(top: Layer):
        """Live options of a protocol/server top layer, if present
        (read per-use so ``volume set`` reconfigure takes effect)."""
        return top.opts if isinstance(top, ServerLayer) else {}

    @property
    def _auth_opts(self):
        return self._opts_of(self.top)

    def _ssl_context(self) -> ssl_mod.SSLContext | None:
        # one TLS identity per transport (the brick's certificate)
        opts = self._auth_opts
        if not opts or not opts["ssl"]:
            return None
        from ..rpc import tls

        return tls.server_context(opts["ssl-cert"], opts["ssl-key"],
                                  opts["ssl-ca"])

    def _addr_ok(self, addr: str, top: Layer | None = None) -> bool:
        """auth/addr: reject list wins, then the allow list must match."""
        opts = self._opts_of(top if top is not None else self.top)
        if not opts:
            return True
        if opts["auth-reject"] and _addr_match(addr, opts["auth-reject"]):
            return False
        return _addr_match(addr, opts["auth-allow"])

    def _is_mgmt(self, creds: dict, top: Layer | None = None) -> bool:
        """The volfile-only mgmt pair: glusterd's own calls pass even
        when the address lists exclude this host."""
        opts = self._opts_of(top if top is not None else self.top)
        return bool(opts and opts["auth-mgmt-user"]
                    and _ct_eq(creds.get("username"),
                               opts["auth-mgmt-user"])
                    and _ct_eq(creds.get("password"),
                               opts["auth-mgmt-password"]))

    def _ssl_cn_ok(self, conn: "_ClientConn",
                   top: Layer | None = None) -> bool:
        """auth.ssl-allow: when the brick carries a CN allow-list, the
        peer must have presented a VERIFIED certificate whose CN
        matches one pattern (reference server.c:1857 ssl_allow — a
        valid cert with the wrong identity is still refused)."""
        opts = self._opts_of(top if top is not None else self.top)
        allow = opts.get("ssl-allow", "") if opts else ""
        if not allow:
            return True
        cn = _peer_cn(conn.peercert)
        return cn is not None and _addr_match(cn, allow)

    def _compound_on(self, top: Layer | None = None) -> bool:
        """Serve/advertise compound chains?  Read per-use so a live
        volume-set of cluster.use-compound-fops applies immediately."""
        opts = self._opts_of(top if top is not None else self.top)
        if not opts:
            return True  # bare graphs (tests): capability always on
        return bool(opts.get("compound-fops", True))

    def _sg_on(self, top: Layer | None = None) -> bool:
        """Serve scatter-gather replies?  Read per-use so a live
        volume-set of network.zero-copy-reads applies immediately."""
        opts = self._opts_of(top if top is not None else self.top)
        if not opts:
            return True  # bare graphs (tests): capability always on
        return bool(opts.get("sg-replies", True))

    def _shm_on(self, top: Layer | None = None) -> bool:
        """Serve the shared-memory bulk lane?  Read per-frame so a
        live volume-set of network.shm-transport downgrades every
        reply to inline blobs immediately, no reconnect."""
        opts = self._opts_of(top if top is not None else self.top)
        if not opts:
            return True  # bare graphs (tests): capability always on
        return bool(opts.get("shm-transport", True))

    def _shm_arena_size(self, top: Layer | None = None) -> int:
        opts = self._opts_of(top if top is not None else self.top)
        try:
            return int(opts.get("shm-arena-size", _shm.DEFAULT_ARENA))
        except (TypeError, ValueError):
            return _shm.DEFAULT_ARENA

    def _trace_on(self, top: Layer | None = None) -> bool:
        """Re-arm client trace ids?  Read per-use so a live volume-set
        of diagnostics.trace-propagation applies immediately."""
        opts = self._opts_of(top if top is not None else self.top)
        if not opts:
            return True  # bare graphs (tests): capability always on
        return bool(opts.get("trace-fops", True))

    def _login_ok(self, creds: dict, top: Layer | None = None) -> bool:
        """auth/login: when the brick carries credentials, the client
        must present the matching pair (server_setvolume
        gf_authenticate)."""
        opts = self._opts_of(top if top is not None else self.top)
        if not opts or not opts["auth-user"]:
            return True
        return (_ct_eq(creds.get("username"), opts["auth-user"])
                and _ct_eq(creds.get("password"), opts["auth-password"]))

    def _wire_upcall(self, top: Layer) -> None:
        from ..core.layer import walk

        for layer in walk(top):
            sink = getattr(layer, "set_upcall_sink", None)
            if sink is not None:
                sink(self.push_event)

    async def start(self) -> int:
        opts = self._opts_of(self.top)
        backlog = int(opts.get("listen-backlog", 1024) or 1024)
        family = {"inet": socket.AF_INET,
                  "inet6": socket.AF_INET6}.get(
                      str(opts.get("address-family", "inet")),
                      socket.AF_UNSPEC)
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port, ssl=self._ssl_context(),
            backlog=backlog, family=family)
        self.port = self._server.sockets[0].getsockname()[1]
        # shm bulk-lane side-channel (rpc/shm): an abstract-namespace
        # AF_UNIX listener (no filesystem residue, dies with the
        # process) where same-host clients trade their SETVOLUME token
        # for the two arena memfds.  Failure to bind is not an error —
        # the lane simply never advertises and every peer stays inline
        if _shm.supported():
            try:
                name = f"\0gftpu-shm-{os.getpid()}-{id(self):x}"
                self._shm_srv = await asyncio.start_unix_server(
                    self._shm_serve, path=name)
                self._shm_addr = "@" + name[1:]
            except Exception as e:  # noqa: BLE001 - lane is optional
                log.warning(9, "shm side-channel unavailable: %r", e)
                self._shm_srv = None
                self._shm_addr = ""
        # hand the event-push callback to any upcall layer in the graph
        # (the reference's upcall xlator calls back through rpcsvc the
        # same way)
        self._wire_upcall(self.top)
        # spin the event plane up with the listener so the
        # gftpu_event_threads families are scrapable from volume start
        self.event_pool()
        log.info(1, "brick %s serving on %s:%d", self.top.name, self.host,
                 self.port)
        return self.port

    async def _shm_serve(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        """Side-channel dial: one-shot token -> two arena memfds via
        SCM_RIGHTS ([c2s, s2c]; the same-host proof is that the fds
        map at all).  The c2s rx arena is armed BEFORE the fds leave
        this process, so the client's first FL_SHM call frame always
        finds a reader; the s2c tx arena stays payload-disarmed until
        the client confirms its own mapping (__shm_ok__)."""
        fd_c2s = fd_s2c = -1
        try:
            line = await asyncio.wait_for(reader.readline(), 5.0)
            token = line.decode(errors="replace").strip()
            conn = self._shm_tokens.pop(token, None) if token else None
            if conn is None or conn.shm_rx is not None:
                return
            top = conn.top if conn.top is not None else self.top
            size = max(_shm.HDR_SIZE + 4096, self._shm_arena_size(top))
            rx, fd_c2s = _shm.ShmRx.create(size)
            conn.shm_rx = rx
            tx, fd_s2c = _shm.ShmTx.create(size)
            conn.shm_tx = tx
            # sendmsg on a dup'd raw socket: the asyncio TransportSocket
            # wrapper deprecates direct sendmsg, and the transport must
            # keep owning its fd
            sock = writer.get_extra_info("socket")
            raw = socket.socket(fileno=os.dup(sock.fileno()))
            try:
                socket.send_fds(raw, [b"ok"], [fd_c2s, fd_s2c])
            finally:
                raw.close()
            log.info(8, "shm lane mapped for client %s (%d bytes/dir)",
                     conn.identity.hex()[:8], size)
        except Exception as e:  # noqa: BLE001 - peer falls back inline
            log.warning(9, "shm fd exchange failed: %r", e)
        finally:
            for fd in (fd_c2s, fd_s2c):
                if fd >= 0:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
            try:
                writer.close()
            except Exception:
                pass

    def push_event(self, targets: list[bytes], payload: dict) -> None:
        """Send an MT_EVENT frame to each connected client in targets
        (xid 0: events correlate to no call)."""
        frame = wire.pack(0, wire.MT_EVENT, payload)
        for conn in list(self.connections):
            if conn.identity in targets:
                try:
                    conn.writer.write(frame)
                except Exception:
                    pass

    def _event_threads(self) -> int:
        """Configured pool width, read per-use so a live volume-set of
        server.event-threads applies without a respawn."""
        opts = self._auth_opts
        if not opts:
            return self.DEFAULT_EVENT_THREADS
        try:
            return int(opts.get("event-threads",
                                self.DEFAULT_EVENT_THREADS))
        except (TypeError, ValueError):
            return self.DEFAULT_EVENT_THREADS

    def event_pool(self) -> EventPool:
        """The transport's frame-turning pool, reconciled to the live
        option (one int compare on the hot path).  A stopped server's
        pool stays in place, shut down — its size-0 state turns any
        straggling reply inline instead of resurrecting worker threads
        nobody would ever stop again."""
        pool = self._pool
        if pool is None:
            pool = self._pool = EventPool(self._event_threads(),
                                          name=self.top.name)
        elif not pool.closed:
            pool.ensure(self._event_threads())
        return pool

    async def stop(self) -> None:
        if self._pool is not None:
            # shut down but keep the handle: an in-flight serve_one
            # reaching send() after stop() must not construct a fresh
            # pool (leaked threads); turn() on a closed pool is inline
            self._pool.shutdown()
        if self._shm_srv is not None:
            self._shm_srv.close()
            self._shm_srv = None
            self._shm_addr = ""
        self._shm_tokens.clear()
        if self._server is not None:
            self._server.close()
            # close live connections too: since py3.12 wait_closed() also
            # waits for connection handlers, which would block forever on
            # clients that keep their sockets open
            for conn in list(self.connections):
                try:
                    conn.writer.close()
                except Exception:
                    pass
            await self._server.wait_closed()
            self._server = None

    # -- connection handling ----------------------------------------------

    # an unauthenticated peer must complete SETVOLUME within this long,
    # or the transport is dropped (no fd squatting / pre-auth probing)
    HANDSHAKE_DEADLINE = 10.0
    # rpcsvc.h:38 RPCSVC_DEFAULT_OUTSTANDING_RPC_LIMIT (used when the
    # served top carries no protocol/server options, e.g. bare graphs)
    DEFAULT_RPC_LIMIT = 64
    # server.event-threads default (the reference ships 2 since 3.8;
    # used directly when the served top carries no protocol/server
    # options, e.g. bare graphs in tests)
    DEFAULT_EVENT_THREADS = 2
    # lock-class fops are exempt from the limit (deadlock hack,
    # rpcsvc.c:183-208) but a hostile flood of them must still not OOM
    # the brick: a wide separate cap bounds parked lock tasks.  The
    # reference leaves these genuinely unbounded; we keep the exemption
    # property for any sane workload and cap the pathological one
    EXEMPT_HARD_CAP = 16384

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        """Per-frame dispatch runs CONCURRENTLY (reference rpcsvc +
        io-threads): requests are read in order but each is served in
        its own task, with replies interleaving as they finish — the
        client correlates by xid.  A blocking fop (a queued lock) must
        not starve heartbeats behind it; serial dispatch also capped
        wire throughput at one fop round-trip at a time."""
        peer = writer.get_extra_info("peername") or ("?",)
        opts = self._opts_of(self.top)
        if not opts.get("allow-insecure", True) and len(peer) > 1 and \
                isinstance(peer[1], int) and peer[1] > 1023:
            # classic secure-port check (server.allow-insecure off):
            # only root-bound source ports may talk to the brick
            log.warning(7, "refusing unprivileged port %s:%s", *peer[:2])
            writer.close()
            return
        from ..rpc.socktune import tune_socket

        tune_socket(writer.get_extra_info("socket"),
                    keepalive_time=opts.get("keepalive-time", 20),
                    keepalive_interval=opts.get("keepalive-interval", 2),
                    keepalive_count=opts.get("keepalive-count", 9),
                    user_timeout=opts.get("tcp-user-timeout", 0),
                    window_size=opts.get("tcp-window-size", 0))
        conn = _ClientConn(self, writer)
        conn.peer_addr = str(peer[0])
        # TLS identity for auth.ssl-allow: only present when the
        # listener verified a client certificate (ssl + ssl-ca)
        conn.peercert = writer.get_extra_info("peercert")
        self.connections.add(conn)
        tasks: set[asyncio.Task] = set()
        wlock = asyncio.Lock()
        # inbound backpressure (server.outstanding-rpc-limit;
        # rpcsvc_request_outstanding rpcsvc.c:211-250): when this client
        # has `limit` unanswered requests, stop reading its connection —
        # TCP flow control then bounds its queue to the socket buffers.
        # The limit is read per-admission so reconfigure applies live.
        # Occupancy lives ON the conn so `volume status callpool` can
        # read each client's outstanding count.
        gate = asyncio.Event()
        gate.set()

        def _limit() -> int:
            top = conn.top if conn.top is not None else self.top
            try:
                return int(self._opts_of(top).get(
                    "outstanding-rpc-limit", self.DEFAULT_RPC_LIMIT))
            except (TypeError, ValueError):
                return self.DEFAULT_RPC_LIMIT

        async def send(xid: int, resp_type, resp,
                       bulky: bool = False) -> None:
            # reply encode: bulky replies turn on the event pool —
            # keyed by conn, so one connection's encodes stay mutually
            # exclusive while distinct connections encode in parallel;
            # small replies encode inline (the handoff would cost more
            # than the encode).  Encoding happens OUTSIDE the write
            # lock: only the socket write serializes.
            pool = self.event_pool()
            turn = bulky and pool.size > 0
            if conn.compress:
                if turn:
                    buf = await pool.turn(conn, wire.pack_z,
                                          xid, resp_type, resp)
                else:
                    buf = wire.pack_z(xid, resp_type, resp)
                frames = [buf]
            else:
                # blob replies (readv data) go out as raw trailing
                # buffers — no payload copy between the fop return
                # and the socket.  With the shm lane armed (and the
                # option still on — read per-frame so a live
                # volume-set downgrades instantly), blob bytes ride
                # the shared arena and only descriptors hit the wire
                lane = conn.shm_tx \
                    if (conn.shm_tx_armed and not conn.shm_tx.dead
                        and self._shm_on(conn.top if conn.top is not None
                                         else self.top)) else None
                if turn:
                    frames = await pool.turn(conn, wire.pack_frames,
                                             xid, resp_type, resp, lane)
                else:
                    frames = wire.pack_frames(xid, resp_type, resp, lane)
            nbytes = sum(len(f) for f in frames)
            async with wlock:
                conn.bytes_tx += nbytes
                writer.writelines(frames)
                await writer.drain()

        async def serve_one(xid: int, payload, kind: str):
            fop = payload[0] if isinstance(payload, list) and payload \
                else None
            bulky = fop in _BULKY_REPLY_FOPS
            try:
                try:
                    resp_type, resp = await self._dispatch(conn, payload)
                    await send(xid, resp_type, resp, bulky)
                except (ConnectionError, RuntimeError):
                    pass
                except Exception as e:
                    # a reply wire.pack can't serialize must still
                    # ANSWER the xid — a silently dead task would hang
                    # the client's call forever while pings keep passing
                    log.error(2, "reply serialization failed: %r", e)
                    try:
                        await send(xid, wire.MT_ERROR,
                                   FopError(errno.EIO,
                                            f"unserializable reply: "
                                            f"{e!r}"))
                    except Exception:
                        pass
            finally:
                if kind == "throttled":
                    conn.inflight -= 1
                    gate.set()
                elif kind == "exempt":
                    conn.exempt_inflight -= 1
                    gate.set()

        try:
            while True:
                try:
                    if conn.authed:
                        rec = await wire.read_frame(reader)
                    else:
                        rec = await asyncio.wait_for(
                            wire.read_frame(reader),
                            self.HANDSHAKE_DEADLINE)
                except (asyncio.IncompleteReadError, ConnectionError,
                        asyncio.TimeoutError):
                    break
                # rx accounting: record + the 4-byte length prefix —
                # one integer add per frame already in hand
                conn.bytes_rx += len(rec) + 4
                # frame decode: large records turn on the event pool.
                # Awaiting the decode BEFORE the next read_frame is
                # what preserves per-connection dispatch order — the
                # pool's key serialization covers the encode side,
                # where several of this connection's replies can be
                # in flight at once.
                pool = self.event_pool()
                try:
                    if len(rec) >= TURN_MIN and pool.size > 0:
                        try:
                            xid, mtype, payload = await pool.turn(
                                conn, wire.unpack, rec, conn.shm_rx)
                        except (asyncio.CancelledError,
                                wire.ShmDecodeError):
                            raise
                        except Exception:
                            # undecodable frame: drop the transport
                            break
                    else:
                        xid, mtype, payload = wire.unpack(rec,
                                                          conn.shm_rx)
                except wire.ShmDecodeError as e:
                    # an FL_SHM frame this end can't serve (lane not
                    # armed / arena gone / malformed table): ANSWER it
                    # — EOPNOTSUPP + the shm-unsupported notice makes
                    # the peer disarm and resend inline, instead of
                    # its call hanging out the deadline.  Disarm OUR
                    # half too: the peer tears its arenas down on the
                    # notice, so any further FL_SHM reply from here
                    # would be undecodable over there
                    log.warning(9, "shm frame refused: %s", e)
                    conn.shm_tx_armed = False
                    try:
                        await send(wire.peek_xid(rec), wire.MT_ERROR,
                                   FopError(errno.EOPNOTSUPP, str(e),
                                            {"shm-unsupported": True}))
                    except ConnectionError:
                        break
                    continue
                if mtype != wire.MT_CALL:
                    continue
                if conn.authed and isinstance(payload, list) and payload \
                        and payload[0] == "__ping__":
                    # reserved heartbeat lane: pings bypass the
                    # outstanding-rpc gate, else a limit's worth of
                    # fops blocked on a held lock would starve the very
                    # liveness probe the concurrency exists to protect
                    try:
                        await send(xid, wire.MT_REPLY, "pong")
                    except ConnectionError:
                        break
                    continue
                if not conn.authed:
                    # SETVOLUME runs inline: everything else is gated
                    # on its outcome
                    resp_type, resp = await self._dispatch(conn, payload)
                    try:
                        buf = wire.pack(xid, resp_type, resp)
                        conn.bytes_tx += len(buf)
                        writer.write(buf)
                        await writer.drain()
                    except ConnectionError:
                        break
                    if not conn.authed:
                        break  # refused SETVOLUME: drop the transport
                    continue
                fop = payload[0] if isinstance(payload, list) and payload \
                    else None
                limit = _limit()
                if limit <= 0:
                    kind = "free"  # operator chose unlimited
                elif fop in _THROTTLE_EXEMPT:
                    while conn.exempt_inflight >= self.EXEMPT_HARD_CAP:
                        gate.clear()
                        await gate.wait()
                    conn.exempt_inflight += 1
                    kind = "exempt"
                else:
                    # re-read the limit each pass, with a bounded wait:
                    # a live volume-set raising the limit must unpark an
                    # already-throttled connection even if none of its
                    # parked requests ever completes (nothing else would
                    # set the gate)
                    while 0 < _limit() <= conn.inflight:  # stop reading
                        gate.clear()
                        try:
                            await asyncio.wait_for(gate.wait(), 1.0)
                        except asyncio.TimeoutError:
                            pass
                    conn.inflight += 1
                    kind = "throttled"
                t = asyncio.create_task(serve_one(xid, payload, kind))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        finally:
            for t in tasks:
                t.cancel()
            self.connections.discard(conn)
            await self._cleanup(conn)
            try:
                writer.close()
            except Exception:
                pass

    async def _cleanup(self, conn: _ClientConn) -> None:
        """Disconnect: release fds + this client's locks (client_t reap)."""
        top = conn.top if conn.top is not None else self.top
        if conn.authed and not conn.is_mgmt:
            # lifecycle event with the final account (events.h
            # EVENT_CLIENT_DISCONNECT); mgmt polls (glusterd status/
            # profile sweeps) are excluded on both edges — they would
            # drown the history in self-inflicted noise
            gf_event("CLIENT_DISCONNECT", client=conn.identity.hex(),
                     brick=top.name, server=self.top.name,
                     bytes_rx=conn.bytes_rx, bytes_tx=conn.bytes_tx,
                     fops=sum(conn.fop_counts.values()))
        # shm lane teardown: drop both arenas (rx close defers while
        # consumer views are alive — the last GC'd view completes it;
        # a dead CLIENT's mappings die with its process, so nothing
        # here can leak across a peer SIGKILL either way)
        if conn.shm_token:
            self._shm_tokens.pop(conn.shm_token, None)
            conn.shm_token = ""
        conn.shm_tx_armed = False
        for arena in (conn.shm_tx, conn.shm_rx):
            if arena is not None:
                try:
                    arena.close()
                except Exception:
                    pass
        conn.shm_tx = conn.shm_rx = None
        for fd in conn.fds.values():
            rel = getattr(top, "release", None)
            if rel is not None:
                try:
                    await rel(fd)
                except Exception:
                    pass
        conn.fds.clear()
        if conn.identity:
            from ..core.layer import walk

            for layer in walk(top):
                rc = getattr(layer, "release_client", None)
                if rc is not None:
                    try:
                        rc(conn.identity)
                    except Exception:
                        pass

    # -- deep volume status (GF_CLI_STATUS_{DETAIL,CLIENTS,INODE,FD,
    # CALLPOOL,MEM} brick half, glusterd-op-sm.c op family) ---------------

    STATUS_KINDS = STATUS_KINDS

    def _status_of(self, top: Layer, kind: str) -> dict:
        """One brick's share of ``volume status <kind>`` — everything
        is read from live state already in memory; ``detail`` adds one
        statvfs (cold path)."""
        from ..core.layer import walk

        if kind == "clients":
            return {"clients": [c.info() for c in self._authed_conns(top)]}
        if kind == "fds":
            out = []
            for c in self._authed_conns(top):
                out.append({"client": c.identity.hex(),
                            "count": len(c.fds),
                            "fds": [{"fd": fdid, "path": fd.path,
                                     "gfid": fd.gfid.hex(),
                                     "flags": fd.flags}
                                    for fdid, fd in c.fds.items()]})
            return {"fd_tables": out,
                    "total": sum(e["count"] for e in out)}
        if kind == "inodes":
            tables = {}
            identity = {}
            for layer in walk(top):
                it = getattr(layer, "itable", None)
                if it is not None and hasattr(it, "dump"):
                    tables[layer.name] = it.dump()
                if hasattr(layer, "_ino_cache"):
                    # storage/posix: the brick-side identity caches are
                    # its inode table analog (gfid handle store)
                    identity[layer.name] = {
                        "ino_cache": len(layer._ino_cache),
                        "xattr_cache": len(layer._xa_cache),
                        "uncompacted_bindings": len(layer._gfid_mem),
                        "dirty": len(layer._xa_dirty)}
            return {"itables": tables, "identity": identity}
        if kind == "callpool":
            pools = []
            locks = []
            leases = []
            for layer in walk(top):
                q = getattr(layer, "queued", None)
                ex = getattr(layer, "executed", None)
                if isinstance(q, list) and isinstance(ex, list):
                    pools.append({"layer": layer.name,
                                  "queued": list(q),
                                  "executed": list(ex)})
                # the lock wedge view: per-domain blocked
                # counts + oldest-holder age, so an operator sees a
                # wedge before revocation fires
                ls = getattr(layer, "lock_status", None)
                if ls is not None:
                    locks.append({"layer": layer.name, **ls()})
                # the lease wedge view: held/recalling
                # counts + oldest-holder age beside the locks table
                les = getattr(layer, "lease_status", None)
                if les is not None:
                    leases.append({"layer": layer.name, **les()})
            return {"io_threads": pools,
                    "locks": locks,
                    "leases": leases,
                    "outstanding": [
                        {"client": c.identity.hex(),
                         "inflight": c.inflight,
                         "exempt": c.exempt_inflight}
                        for c in self._authed_conns(top)]}
        if kind == "mem":
            import resource

            return {"registry": _metrics.REGISTRY.snapshot(),
                    "max_rss_kb":
                        resource.getrusage(
                            resource.RUSAGE_SELF).ru_maxrss}
        if kind == "detail":
            import os as _os

            bricks = []
            for layer in walk(top):
                root = getattr(layer, "root", None)
                if not isinstance(root, str) or \
                        not hasattr(layer, "_failed_health"):
                    continue
                row = {"layer": layer.name, "path": root,
                       "health": ("failed" if layer._failed_health
                                  else "ok"),
                       "health_error": layer._failed_health,
                       "reserve_limited":
                           bool(getattr(layer, "_reserve_full", False))}
                try:
                    sv = _os.statvfs(root)
                    row.update(block_size=sv.f_bsize,
                               blocks_total=sv.f_blocks,
                               blocks_free=sv.f_bfree,
                               blocks_avail=sv.f_bavail,
                               inodes_total=sv.f_files,
                               inodes_free=sv.f_ffree)
                except OSError as e:
                    row["statvfs_error"] = str(e)
                bricks.append(row)
            return {"backends": bricks}
        raise FopError(errno.EINVAL,
                       f"unknown status kind {kind!r} "
                       f"(one of {', '.join(self.STATUS_KINDS)})")

    async def _dispatch(self, conn: _ClientConn, payload: Any):
        try:
            # a trailing 4th element is the client's trace id (only sent
            # when this brick advertised trace at SETVOLUME; a payload
            # from an older client is the bare 3-element triple)
            fop_name, args, kwargs = payload[0], payload[1], payload[2]
            trace_id = payload[3] if len(payload) > 3 else None
            # deadline budget (network.deadline-propagation): the
            # client's remaining call budget rides a reserved request
            # field, popped HERE so fop signatures never see it, and
            # armed as an absolute local-clock deadline for this
            # request's context — io-threads drops work the client has
            # already abandoned
            budget = None
            if isinstance(kwargs, dict):
                budget = kwargs.pop("__deadline__", None)
            if isinstance(budget, (int, float)) and budget > 0:
                wire.CURRENT_DEADLINE.set(
                    asyncio.get_running_loop().time() + float(budget))
            if fop_name == "__handshake__":
                creds = args[2] if len(args) > 2 else {}
                want = args[1] if len(args) > 1 else ""
                # routing first: auth is checked against the BRICK the
                # client asked for
                try:
                    top, graph = self._select_top(want)
                except FopError as e:
                    log.warning(7, "handshake from %s: %s",
                                conn.peer_addr, e)
                    return wire.MT_REPLY, {"ok": False, "error": str(e)}
                # mgmt pair (volfile-only, never served to clients)
                # bypasses BOTH address lists — an over-broad
                # auth.reject must not cut glusterd off from its bricks
                is_mgmt = self._is_mgmt(creds or {}, top)
                ok = is_mgmt or (
                    self._addr_ok(conn.peer_addr, top)
                    and self._login_ok(creds or {}, top)
                    and self._ssl_cn_ok(conn, top))
                if not ok:
                    log.warning(7, "handshake refused from %s (%r)",
                                conn.peer_addr, args[0])
                    return wire.MT_REPLY, {"ok": False,
                                           "error": "authentication failed"}
                conn.identity = args[0]
                conn.name = want
                conn.authed = True
                conn.is_mgmt = is_mgmt
                conn.top, conn.graph = top, graph
                conn.compress = bool((creds or {}).get("compress"))
                # traffic origin (rebalance daemons ride the paced QoS
                # lane; carried in creds so the FIRST post-handshake
                # frame is already attributed — and a reconnect's fresh
                # handshake re-carries it)
                conn.origin = str((creds or {}).get("origin") or "")
                # sg replies only flow to peers that asked for them
                # (mixed-version: an old client never sees an sg dict)
                conn.sg = bool((creds or {}).get("sg-replies")) and \
                    self._sg_on(top)
                # client accounting: remember what the peer advertised
                # (the client_t dump's "capabilities" column) and stamp
                # the connect time from NOW — the pre-auth probe window
                # is not client lifetime
                conn.connected_at = time.time()
                conn.caps = {k: True for k in
                             ("compress", "sg-replies", "trace-fops",
                              "shm-transport")
                             if (creds or {}).get(k)}
                try:
                    conn.opversion = int((creds or {}).get(
                        "op-version", 0))
                except (TypeError, ValueError):
                    conn.opversion = 0
                if not is_mgmt:
                    gf_event("CLIENT_CONNECT",
                             client=conn.identity.hex(),
                             brick=top.name, server=self.top.name,
                             addr=conn.peer_addr, subvol=want,
                             op_version=conn.opversion)
                return wire.MT_REPLY, {
                    "volume": top.name, "ok": True,
                    "compound": self._compound_on(top),
                    "sg": conn.sg,
                    "trace": self._trace_on(top),
                    # deadline-budget arming: this build pops the
                    # reserved request field before dispatch
                    "deadline": True,
                    # parity-delta write plane (op-version 12):
                    # this brick serves the xorv fop — a peer
                    # that never sees this key keeps the
                    # full-RMW path
                    "xorv": True,
                    # lease plane (op-version 15): this brick
                    # grants and recalls leases — a client that
                    # never sees this key must not enter zero-RT
                    # cache mode
                    "leases": True,
                    # same-host shared-memory bulk lane (op-version
                    # 17): a dict advert (boot-id + side-channel addr
                    # + one-shot token) for peers that asked, when the
                    # side-channel can hand out arena fds here — None
                    # otherwise (falsy = no lane, old clients ignore)
                    "shm": self._shm_advert(conn, creds or {}, top)}
            if not conn.authed:
                # SETVOLUME gates everything — pings included (no
                # pre-auth liveness probing; server.c refuses requests
                # from unknown clients)
                raise FopError(errno.EACCES, "handshake required")
            top = conn.top if conn.top is not None else self.top
            graph = conn.graph if conn.top is not None else self.graph
            if trace_id and tracing.ENABLED and self._trace_on(top):
                # re-arm the client's trace for this request's context:
                # every brick-graph span below carries the client's id
                # (frame->root across the wire)
                tracing.arm(str(trace_id))
            if fop_name == "__ping__":
                return wire.MT_REPLY, "pong"
            if fop_name == "__shm_ok__":
                # the client mapped both arenas and armed its rx side:
                # replies may now ride the s2c arena.  Arming strictly
                # follows the peer's readiness — no FL_SHM frame is
                # ever sent to an end that can't resolve it
                if conn.shm_tx is not None:
                    conn.shm_tx_armed = True
                conn.caps["shm"] = True
                return wire.MT_REPLY, {"ok": conn.shm_tx is not None}
            if fop_name in _TRIMMED_RPCS:
                raise FopError(errno.EOPNOTSUPP,
                               f"{fop_name} needs {_TRIMMED_RPCS[fop_name]}, "
                               "which this package does not have")
            if fop_name == "__status__":
                # deep-status brick half: glusterd fans this out per
                # node and merges (op_volume_status_local)
                kind = args[0] if args else "clients"
                return wire.MT_REPLY, _jsonable(
                    self._status_of(top, str(kind)))
            if fop_name == "__incident__":
                # incident fan-out brick half (glusterd
                # op_volume_incident_local): this process's flight
                # bundle — record ring + span ring + metrics — plus the
                # per-client accounting the bundle contract promises
                from ..core import flight

                bundle = flight.snapshot()
                try:
                    bundle["clients"] = self._status_of(top, "clients")
                except Exception as e:  # noqa: BLE001 - best-effort extra
                    bundle["clients"] = {"error": repr(e)[:200]}
                return wire.MT_REPLY, _jsonable(bundle)
            if fop_name == "__statedump__":
                # full-graph dump (has "layers") when the daemon handed
                # us the graph; bare top-layer dump otherwise
                src = graph if graph is not None else top
                return wire.MT_REPLY, _jsonable(src.statedump())
            if fop_name == "__reconfigure__":
                # live option apply from glusterd (xlator.reconfigure
                # path, graph.c glusterfs_graph_reconfigure); topology
                # changes need a daemon respawn instead
                if graph is None:
                    return wire.MT_REPLY, {"ok": False,
                                           "reason": "no graph handle"}
                ok = graph.apply_volfile(args[0])
                return wire.MT_REPLY, {"ok": ok}
            if fop_name in ("__compound__", "compound"):
                # the compound dispatcher: the whole chain executes
                # through the brick graph inside THIS request's single
                # backpressure slot (it was admitted as one fop), and
                # the client gets one reply frame carrying the per-link
                # vector.  A brick with compound-fops off refuses with
                # EOPNOTSUPP, which the client treats as "peer speaks
                # singles only" (mixed-version fallback).
                from ..rpc import compound as cfop

                if not self._compound_on(top):
                    raise FopError(errno.EOPNOTSUPP,
                                   "compound fops disabled")
                links = cfop.validate(conn.resolve(args[0] if args
                                                   else []))
                cnt = conn.fop_counts
                cnt["compound"] = cnt.get("compound", 0) + 1
                for _lf, largs, lkw in links:
                    cnt[_lf] = cnt.get(_lf, 0) + 1
                    _scope_owner(largs, lkw, conn.identity)
                wire.CURRENT_CLIENT.set(conn.identity)
                # one handle-farm transaction per chain: batch the
                # posix sidecar journal around the WHOLE dispatch, so
                # the syscall coalescing holds even when a mid-graph
                # layer (locks, a cluster layer) decomposed the chain
                from contextlib import ExitStack

                from ..core.layer import walk

                with ExitStack() as stack:
                    for layer in walk(top):
                        jb = getattr(layer, "journal_batch", None)
                        if jb is not None:
                            stack.enter_context(jb())
                    replies = await top.compound(
                        links, (kwargs or {}).get("xdata"))
                return wire.MT_REPLY, [
                    [st, conn.wrap(val)] if st == "ok" else [st, val]
                    for st, val in replies]
            if fop_name not in _FOPS and fop_name not in _RPC_EXTRAS:
                raise FopError(errno.EOPNOTSUPP, f"unknown fop {fop_name!r}")
            conn.fop_counts[fop_name] = \
                conn.fop_counts.get(fop_name, 0) + 1
            fn = getattr(top, fop_name, None)
            if fn is None and fop_name in _RPC_EXTRAS:
                # extras (quota_usage, heal surfaces) live on a specific
                # mid-graph layer, not the passthrough top — resolve by
                # walking (the reference registers them as separate RPC
                # programs per xlator)
                from ..core.layer import walk

                for layer in walk(top):
                    fn = getattr(layer, fop_name, None)
                    if fn is not None:
                        break
            if fn is None:
                raise FopError(errno.EOPNOTSUPP, f"fop {fop_name!r} unsupported")
            # release retires the fd-table entry too (long-lived
            # connections like bitd's would otherwise grow it unboundedly)
            if fop_name == "release" and args and \
                    isinstance(args[0], wire.FdHandle):
                fd = conn.fds.pop(args[0].fdid, None)
                if fd is None:
                    return wire.MT_REPLY, {}
                await top.release(fd)
                return wire.MT_REPLY, {}
            args = conn.resolve(args)
            kwargs = {k: conn.resolve(v) for k, v in (kwargs or {}).items()}
            # scope lk-owners to this connection (cross-client isolation)
            _scope_owner(args, kwargs, conn.identity)
            # expose the peer identity to brick layers (frame->root->client)
            wire.CURRENT_CLIENT.set(conn.identity)
            ret = fn(*args, **kwargs)
            if asyncio.iscoroutine(ret):
                ret = await ret
            return wire.MT_REPLY, conn.wrap(ret)
        except FopError as e:
            return wire.MT_ERROR, e
        except Exception as e:  # internal error: surface as EIO
            log.error(2, "dispatch error: %r", e)
            return wire.MT_ERROR, FopError(errno.EIO, f"internal: {e!r}")


def _scope_owner(args, kwargs, identity: bytes) -> None:
    """Prefix lk-owner with the connection identity so two clients using
    the same owner bytes don't alias (frame lk_owner + client uid).
    The owner riding a compound ``unlock-inodelk`` payload (the
    xattrop post-op + unlock fold) must be scoped identically, or the
    brick-side unlock would target an owner that never took the lock."""
    for container in list(args) + list(kwargs.values()):
        if not isinstance(container, dict):
            continue
        if "lk-owner" in container:
            container["lk-owner"] = identity + b"/" + container["lk-owner"]
        for key in ("unlock-inodelk", "lock-inodelk"):
            compound = container.get(key)
            if isinstance(compound, (list, tuple)) and len(compound) == 5:
                container[key] = [*compound[:4],
                                  identity + b"/" + compound[4]]


def _jsonable(v):
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v
