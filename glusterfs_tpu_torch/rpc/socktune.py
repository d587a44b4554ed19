"""Transport socket tuning — the socket.c option surface
(rpc/rpc-transport/socket/src/socket.c: keepalive, user-timeout, window
size).  Shared by protocol/client (outbound) and protocol/server
(accepted connections); a 0 value leaves the kernel default alone."""

from __future__ import annotations

import socket


def tune_socket(sock, *, keepalive_time: float = 0,
                keepalive_interval: float = 0, keepalive_count: int = 0,
                user_timeout: float = 0, window_size: int = 0) -> None:
    if sock is None:
        return
    try:
        if keepalive_time > 0:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            if hasattr(socket, "TCP_KEEPIDLE"):
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPIDLE,
                                max(1, int(keepalive_time)))
        if keepalive_interval > 0 and hasattr(socket, "TCP_KEEPINTVL"):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPINTVL,
                            max(1, int(keepalive_interval)))
        if keepalive_count > 0 and hasattr(socket, "TCP_KEEPCNT"):
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPCNT,
                            int(keepalive_count))
        if user_timeout > 0 and hasattr(socket, "TCP_USER_TIMEOUT"):
            # milliseconds (tcp(7)); bounds how long sent-but-unacked
            # data may linger before the connection is declared dead
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_USER_TIMEOUT,
                            int(user_timeout * 1000))
        if window_size > 0:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                            int(window_size))
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                            int(window_size))
    except OSError:
        # tuning is advisory: an unsupported knob must never kill the
        # transport (socket.c logs and continues the same way)
        pass
