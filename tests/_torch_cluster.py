"""Shared set-up of the distributed-node tests (``test_torch_rpc.py``,
``test_torch_remote.py``, ``test_torch_dsync_remote.py``,
``test_torch_cluster.py``, ``test_torch_node.py``, and the TLS, chaos and
federation files ``test_torch_tls.py``, ``test_torch_chaos.py``,
``test_torch_federation.py`` and ``test_torch_node_tls.py``).

``cluster_state_left`` is each module's guard: ``_torch_ident.
no_state_left`` (metric and kvconfig registries, socket timeout, urllib's
opener, every thread joined but the reference's lock refresher), and on
top, for both packages, the breaker registry and ``BREAKER_OPEN_COUNT``
put back, the streaming config restored, the ``secure.transport``
registry given back its manager (or none) and the cert managers'
registry (``secure.certs._MANAGERS``, read by the scrape) put back; the
port's lock refresher is stopped (its threads joined) before the threads
are counted.

``free_ports`` picks ports for nodes that bind declared endpoints.
``port_manager`` is the port's ``CertManager`` over the session's PKI
(``tests/_pki.cluster_pki``).
``served`` starts an RPC server of either package and stops it (listener
and handlers joined) however the test ends; ``client`` makes an
``RPCClient`` that is closed with it.
"""

import contextlib
import os
import random
import socket
import time
import weakref

from minio_tpu.parallel import rpc as ref_rpc
from minio_tpu.secure import certs as ref_certs
from minio_tpu.secure import transport as ref_transport
from minio_tpu_torch.parallel import dsync as port_dsync
from minio_tpu_torch.parallel import rpc as port_rpc
from minio_tpu_torch.secure import certs as port_certs
from minio_tpu_torch.secure import transport as port_transport

from ._torch_ident import no_state_left

PKGS = {"ref": ref_rpc, "port": port_rpc}
TLS = ((ref_transport, ref_certs), (port_transport, port_certs))


@contextlib.contextmanager
def cluster_state_left():
    saved = [(m, weakref.WeakSet(m._BREAKERS), m.BREAKER_OPEN_COUNT,
              dict(vars(m.STREAM))) for m in PKGS.values()]
    tls = [(t, c, t.manager(), weakref.WeakSet(c._MANAGERS))
           for t, c in TLS]
    with no_state_left():
        try:
            yield
        finally:
            port_dsync.stop_refresher()
            for m, breakers, opens, stream in saved:
                m._BREAKERS = breakers
                m.BREAKER_OPEN_COUNT = opens
                vars(m.STREAM).clear()
                vars(m.STREAM).update(stream)
            for transport, certs, manager, managers in tls:
                transport.configure(manager)
                certs._MANAGERS = managers


@contextlib.contextmanager
def served(pkg: str, secret: str, **services):
    """An RPC server of ``pkg`` with ``services`` ({name: {method: fn}})
    registered, started; stopped on exit."""
    srv = PKGS[pkg].RPCServer(secret)
    for name, methods in services.items():
        srv.register(name, methods)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


class Clients:
    """RPC clients of either package, all closed by ``close``."""

    def __init__(self):
        self.held = []

    def __call__(self, pkg: str, endpoint: str, secret: str, **kw):
        c = PKGS[pkg].RPCClient(endpoint, secret, **kw)
        self.held.append(c)
        return c

    def close(self) -> None:
        for c in self.held:
            # the reference's client has no close
            for conn in c._pool:
                conn.close()
            c._pool.clear()


def port_manager(pki, **kw) -> port_certs.CertManager:
    """The port's manager of ``pki``'s S3 pair, internode identity and
    CA (a fresh one: tests change a manager's throttle and clock)."""
    return port_certs.CertManager(
        (pki.s3_cert, pki.s3_key),
        internode=(pki.internode_cert, pki.internode_key),
        ca_file=pki.ca_cert, **kw)


def free_ports(n: int) -> list[int]:
    """``n`` free ports below the ephemeral range, so no socket another
    test binds to port 0 (nor a client connection) takes one before the
    node given it binds it."""
    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    ports: list[int] = []
    while len(ports) < n:
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        if port not in ports:
            ports.append(port)
    return ports
