"""Distributed nodes (``minio_tpu/cluster.py``, cmd/server-main.go:389
serverMain over cmd/endpoint*.go's topology).

Each node runs an RPC server that exports its drives (the ``storage``
service) and its lock table (``lock``), and an object layer whose drive
list holds its own ``XLStorage`` drives and a ``RemoteStorage`` for each
drive of every other node, in the same global order on every node, so
placement, quorum and healing agree cluster-wide.  Namespace locks are
dsync quorum locks over every node's table.  Every node serves S3
(cmd/routers.go:30-38); the node whose front takes a request encodes,
hashes, verifies and reconstructs on its own device, and ships shards to
the other nodes' drives over the RPC.

Given a ``CertManager`` (``tls``, or the ``tls`` subsystem for
``run_node``), both planes run over TLS: each RPC listener serves the
internode identity and requires a client certificate from the CA, each
internode client presents it (``secure/transport.py``), endpoints are
``https://``, and the S3 front serves the front's pair.

Not here yet (ROADMAP Queue 1 items 10 and 11): the codec service and the
observability half of the peer service.
"""

from __future__ import annotations

import os
import time
import urllib.parse
from dataclasses import dataclass

from .objectlayer.sets import ErasureSets
from .parallel.dsync import (LocalLocker, NamespaceLock, RemoteLocker,
                             register_lock_service)
from .parallel.rpc import RPCClient, RPCError, RPCServer
from .secure import transport
from .secure.certs import CertManager
from .storage import errors as serrors
from .storage import health as health_mod
from .storage.format import FORMAT_FILE, load_or_init_format
from .storage.remote import RemoteStorage, register_storage_service
from .storage.xl_storage import SYS_DIR, XLStorage
from .utils.kvconfig import Config


@dataclass
class NodeSpec:
    """One host of the layout: its id, its drives, and its RPC endpoint
    (declared, or filled when the node binds)."""
    node_id: str
    drive_dirs: list[str]
    endpoint: str = ""


class Node:
    """A cluster member: its RPC services and its view of the object
    layer.  ``set_kwargs`` go to every set (``device``, ``block_size``,
    ``parity``, ...)."""

    def __init__(self, spec: NodeSpec, all_specs: list[NodeSpec],
                 secret: str, set_drive_count: int | None = None,
                 host: str = "127.0.0.1", port: int = 0, tls=None,
                 **set_kwargs):
        self.spec = spec
        self.secret = secret
        self.tls = tls
        if tls is not None:
            # this node's internode clients take the CA and the identity
            # from the process's registry
            transport.configure(tls)
        self.drives = {f"drive{i}": XLStorage(d)
                       for i, d in enumerate(spec.drive_dirs)}
        self.locker = LocalLocker()
        self.rpc = RPCServer(secret, host=host, port=port, tls=tls)
        register_storage_service(self.rpc, self.drives)
        register_lock_service(self.rpc, self.locker)
        self.rpc.start()
        spec.endpoint = self.rpc.endpoint
        self._all_specs = all_specs
        self._set_kwargs = set_kwargs
        self._set_drive_count = set_drive_count
        self.clients: list[RPCClient] = []
        self.layer: ErasureSets | None = None
        self.monitor: health_mod.DriveMonitor | None = None

    def _client(self, endpoint: str) -> RPCClient:
        c = RPCClient(endpoint, self.secret)
        self.clients.append(c)
        return c

    def assemble(self) -> ErasureSets:
        """Build this node's object layer once every peer's endpoint is
        known (cmd/bootstrap-peer-server.go:162).  A local drive that
        boots without format.json in a formatted deployment (a wiped or
        replaced drive) is formatted with its expected identity at once
        and its set healed onto it, as a drive that returns empty is."""
        disks, lockers, fresh = [], [], []
        for spec in self._all_specs:
            local = spec.node_id == self.spec.node_id
            lockers.append(self.locker if local else
                           RemoteLocker(self._client(spec.endpoint)))
            for i in range(len(spec.drive_dirs)):
                if local:
                    d = self.drives[f"drive{i}"]
                    try:
                        d.read_all(SYS_DIR, FORMAT_FILE)
                    except (serrors.FileNotFound, serrors.VolumeNotFound):
                        fresh.append(len(disks))
                    disks.append(d)
                else:
                    disks.append(RemoteStorage(
                        self._client(spec.endpoint), f"drive{i}"))
        n = len(disks)
        sdc = self._set_drive_count or n
        if n % sdc:
            raise ValueError(f"{n} drives are not sets of {sdc}")
        fmt = load_or_init_format(disks, n // sdc, sdc)
        disks, bind = health_mod.wrap_with_heal(disks, fmt, sdc)
        self.layer = ErasureSets(
            disks, n // sdc, sdc, deployment_id=fmt.id,
            distribution_algo=fmt.distribution_algo,
            ns_lock=NamespaceLock(lockers), **self._set_kwargs)
        bind(self.layer)
        self.monitor = self.layer.start_drive_monitor()
        for i in fresh:
            try:              # formatted just now with a fresh deployment
                disks[i].read_all(SYS_DIR, FORMAT_FILE)
            except serrors.StorageError:
                disks[i]._mark_offline()
                disks[i].probe()
        return self.layer

    def stop(self) -> None:
        """Stop the drive monitor and the RPC server, close the layer
        (which a server over it may have closed already) and the RPC
        clients."""
        if self.monitor is not None:
            self.monitor.stop()
        self.rpc.stop()
        if self.layer is not None:
            self.layer.close()
            self.layer = None
        for c in self.clients:
            c.close()


def start_cluster(specs: list[NodeSpec], secret: str,
                  set_drive_count: int | None = None, tls=None,
                  **set_kwargs) -> list[Node]:
    """Every node in this process: start them all, then assemble each
    (the first formats a fresh deployment, the rest find its format).
    ``tls``: a ``CertManager`` that puts the internode plane under mutual
    TLS."""
    nodes = [Node(s, specs, secret, set_drive_count, tls=tls, **set_kwargs)
             for s in specs]
    for node in nodes:
        node.assemble()
    return nodes


def wait_for_peers(specs: list[NodeSpec], secret: str, self_id: str,
                   timeout: float = 60.0) -> None:
    """Ping every peer until the whole layout answers (nodes of separate
    processes start in any order); a wrong secret raises at once."""
    deadline = time.monotonic() + timeout
    pending = [s for s in specs if s.node_id != self_id]
    while pending:
        still = []
        for spec in pending:
            c = RPCClient(spec.endpoint, secret, timeout=2.0)
            try:
                if c.call("sys", "ping") != "pong":
                    still.append(spec)
            except RPCError as e:
                if e.error_type == "AuthError":
                    raise
                still.append(spec)
            finally:
                c.close()
        pending = still
        if pending:
            if time.monotonic() > deadline:
                raise TimeoutError("peers never came up: " +
                                   ", ".join(s.node_id for s in pending))
            time.sleep(0.25)


def _wait_for_leader_format(leader: NodeSpec, secret: str,
                            timeout: float = 60.0) -> None:
    """Poll the leader's first drive until its format.json exists."""
    client = RPCClient(leader.endpoint, secret)
    remote = RemoteStorage(client, "drive0")
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                remote.read_all(SYS_DIR, FORMAT_FILE)
                return
            except serrors.StorageError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"leader {leader.node_id} never "
                                       "wrote format.json") from None
                time.sleep(0.25)
    finally:
        client.close()


def run_node(self_id: str, specs: list[NodeSpec], secret: str,
             s3_address: str = "127.0.0.1:0",
             set_drive_count: int | None = None,
             access_key: str = "minioadmin",
             secret_key: str = "minioadmin", tls=None, **set_kwargs):
    """One member as a process of its own: the RPC services on the
    declared endpoint (so peers can dial before the rendezvous), wait for
    the layout, assemble, and serve S3 with IAM loaded, the peer service
    and fan-out, and a tracker.  Only the first node formats a fresh
    deployment, and only it runs the crawler and the heal sweep (their
    walks cover the whole layer).  ``tls``: a ``CertManager``, by default
    from the ``tls`` subsystem (``MT_TLS_ENABLE``, ``MT_TLS_CERTS_DIR``);
    with one, both planes run over TLS and every peer is dialled at
    ``https://`` (ROADMAP Queue 3 record 63).  Returns (node, started
    S3Server)."""
    from .background.crawler import Crawler
    from .background.heal import BackgroundHealer
    from .background.tracker import DataUpdateTracker
    from .objectlayer.tiering import transition_fn
    from .parallel.peer import PeerNotifier, register_peer_service
    from .s3.server import S3Server

    if tls is None:
        tls = CertManager.from_config(Config())
    spec = next(s for s in specs if s.node_id == self_id)
    if not spec.endpoint:
        raise ValueError(f"node {self_id} needs a declared endpoint")
    scheme = "https" if tls is not None else "http"
    for s in specs:                 # the scheme the plane serves
        s.endpoint = f"{scheme}://{urllib.parse.urlsplit(s.endpoint).netloc}"
    u = urllib.parse.urlsplit(spec.endpoint)
    node = Node(spec, specs, secret, set_drive_count,
                host=u.hostname or "127.0.0.1", port=u.port, tls=tls,
                **set_kwargs)
    srv = None
    try:
        wait_for_peers(specs, secret, self_id)
        # a fresh deployment is formatted by one node: formats minted on
        # several at once would name different deployments
        if specs[0].node_id != self_id:
            _wait_for_leader_format(specs[0], secret)
        layer = node.assemble()
        shost, _, sport = s3_address.rpartition(":")
        srv = S3Server(layer, access_key=access_key, secret_key=secret_key,
                       host=shost or "127.0.0.1", port=int(sport), tls=tls)
        srv.node_name = srv.api_stats.label = self_id
        srv.iam.load()
        register_peer_service(node.rpc, srv)
        srv.attach_peers(PeerNotifier(
            [node._client(s.endpoint) for s in specs
             if s.node_id != self_id]))
        srv.attach_tracker(DataUpdateTracker())
        if specs[0].node_id == self_id:
            srv.crawler = Crawler(
                layer, bucket_meta=srv.bucket_meta,
                interval_s=float(os.environ.get("MT_CRAWL_INTERVAL_S",
                                                "60")),
                transition_fn=transition_fn(srv.transition),
                tracker=srv.tracker,
                restub_fn=srv.transition.put_stub_back)
            srv.healer = BackgroundHealer(
                layer,
                interval_s=float(os.environ.get("MT_HEAL_INTERVAL_S",
                                                "3600")),
                deep_every=int(os.environ.get("MT_HEAL_DEEP_EVERY", "8")))
            srv.attach_background(srv.crawler, srv.healer)
        srv.reload_pipeline_config()
        srv.reload_commit_config()
        srv.reload_rpc_config()
        srv.start()
    except BaseException:
        if srv is not None:
            srv.stop()
        node.stop()
        raise
    return node, srv
