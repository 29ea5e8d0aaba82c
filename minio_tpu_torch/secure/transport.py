"""The process's TLS client contexts (``minio_tpu/secure/transport.py``).

Internode clients are made from endpoint strings in many places (the
cluster's assembly, the peer notifier, the remote drives and lockers),
so the scheme is the signal: an ``https://`` endpoint takes its client
context from here.  Whoever starts TLS (a node, a TLS server, a test)
calls ``configure`` with its ``CertManager`` once; a process without one
trusts the system's roots.
"""

from __future__ import annotations

import http.client
import ssl
import threading

_mu = threading.Lock()
_manager = None
_default_ctx: dict[str, ssl.SSLContext] = {}


def configure(manager) -> None:
    """Install the process's cert manager, or clear it with None."""
    global _manager
    with _mu:
        _manager = manager


def manager():
    with _mu:
        return _manager


def client_context(plane: str = "internode") -> ssl.SSLContext:
    """The plane's client context: the manager's (CA-pinned, with the
    internode identity on that plane), else the system's trust store."""
    m = manager()
    if m is not None:
        return m.client_context(plane)
    with _mu:
        ctx = _default_ctx.get(plane)
        if ctx is None:
            ctx = _default_ctx[plane] = ssl.create_default_context()
        return ctx


def https_connection(host, port, timeout: float, plane: str = "internode",
                     context: ssl.SSLContext | None = None
                     ) -> http.client.HTTPSConnection:
    """An HTTPSConnection with the plane's context, or ``context``
    (http.client turns Nagle's algorithm off on connect)."""
    return http.client.HTTPSConnection(
        host, port, timeout=timeout,
        context=context or client_context(plane))
