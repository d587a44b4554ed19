"""Shared TLS context construction for brick transports (the socket.c
ssl_setup_connection analog).  One policy, used by protocol/client,
glusterd's mgmt brick calls, and bitd — so a TLS change lands once."""

from __future__ import annotations

import ssl


def client_context(ca: str = "", cert: str = "",
                   key: str = "") -> ssl.SSLContext:
    """TLS toward a brick: verify against ca when given (bricks are
    addressed by IP, so hostname checks are off), present cert/key when
    the brick requires mutual auth."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    if ca:
        ctx.load_verify_locations(ca)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    if cert:
        ctx.load_cert_chain(cert, key or None)
    return ctx


def server_context(cert: str, key: str = "",
                   ca: str = "") -> ssl.SSLContext:
    """TLS listener for a brick; a ca makes client certs mandatory
    (ssl-ca-list semantics)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key or None)
    if ca:
        ctx.load_verify_locations(ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx
