"""``python -m minio_tpu_torch node`` with ``MT_TLS_ENABLE=on``: three
node processes on ``--device cpu``, each owning two drives of one
six-drive set, with ``MT_TLS_CERTS_DIR`` in the ``certs_dir`` layout of
the session's PKI (``tests/_pki.py``).  The nodes dial each other at
``https://`` and form the cluster (ROADMAP Queue 3 record 63); a PUT
through one node's ``https`` front reads through every node; each RPC
listener requires a CA-signed client certificate (a client without one,
and a plain-text client, are refused, and the refusal is counted), and
answers a client that presents the internode identity; every node's
scrape carries the ``mt_tls_*`` families."""

import os
import socket
import ssl
import subprocess
import sys
import time

import pytest

from minio_tpu_torch.parallel.rpc import RPCClient
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.secure import transport

from . import _pki
from ._torch_cluster import cluster_state_left, port_manager
from ._torch_versions import body as _body
from .test_torch_metrics import parse
from .test_torch_node import IDS, ROOT, Cluster

SECRET = "node-tls-secret"


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with cluster_state_left():
        yield


class TLSCluster(Cluster):
    """``test_torch_node``'s cluster with both planes under TLS."""

    def __init__(self, tmp, pki):
        super().__init__(tmp)
        self.pki = pki
        self.certs = pki.write_certs_dir(str(tmp / "certs"))

    def start(self, nid: str) -> None:
        i = IDS.index(nid)
        env = dict(os.environ, MT_CLUSTER_SECRET=SECRET,
                   MT_TLS_ENABLE="on", MT_TLS_CERTS_DIR=self.certs,
                   OMP_NUM_THREADS="1", MT_CRAWL_INTERVAL_S="1000000",
                   PYTHONPATH=ROOT)
        with open(self.tmp / f"{nid}.log", "ab") as log:
            self.procs[nid] = subprocess.Popen(
                [sys.executable, "-m", "minio_tpu_torch", "node",
                 "--node-id", nid, "--device", "cpu",
                 "--address", f"127.0.0.1:{self.s3[i]}", *self.peers],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)

    def wait(self, nid: str, timeout: float = 90.0) -> None:
        c = self.client(nid)
        c.timeout = 2.0
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            assert self.procs[nid].poll() is None, self.logs()
            try:
                c.request("GET", "/minio/health/live", sign=False,
                          expect=(200,))
                return
            except OSError:
                time.sleep(0.2)
        raise TimeoutError(f"{nid} never served: {self.logs()}")

    def client(self, nid: str, key="minioadmin", secret="minioadmin"):
        return S3Client(f"https://127.0.0.1:{self.s3[IDS.index(nid)]}",
                        key, secret, ca_file=self.pki.ca_cert)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = TLSCluster(tmp_path_factory.mktemp("tlsnodes"),
                   _pki.cluster_pki(tmp_path_factory))
    try:
        for nid in IDS:
            c.start(nid)
        for nid in IDS:
            c.wait(nid)
        yield c
    finally:
        for nid in list(c.procs):
            c.kill(nid)


@pytest.fixture(scope="module")
def stored(cluster):
    """A bucket and an object PUT through node 1's https front."""
    c1 = cluster.client("n1")
    c1.make_bucket("tlsb")
    data = _body(300_000, 5)
    c1.put_object("tlsb", "obj", data)
    return data


def test_every_node_announces_both_planes_over_tls(cluster):
    for nid in IDS:
        log = (cluster.tmp / f"{nid}.log").read_text()
        i = IDS.index(nid)
        assert (f"rpc=https://127.0.0.1:{cluster.rpc[i]} "
                f"s3=https://127.0.0.1:{cluster.s3[i]} device cpu") in log


@pytest.mark.parametrize("nid", IDS)
def test_a_put_through_one_node_reads_through_each(cluster, stored, nid):
    c = cluster.client(nid)
    assert c.get_object("tlsb", "obj").body == stored
    assert [(o["key"], o["size"]) for o in
            c.list_objects("tlsb")["objects"]] == [("obj", len(stored))]


def _scrape(cluster, nid: str) -> dict:
    r = cluster.client(nid).request("GET", "/minio-tpu/metrics", sign=False,
                                    expect=(200,))
    return parse(r.body.decode())[0]


@pytest.mark.parametrize("nid", IDS)
def test_the_rpc_port_requires_a_client_certificate(cluster, stored, nid):
    """A client that trusts the CA but presents no certificate is refused
    at the handshake, and so is a plain-text one; the node counts them."""
    port = cluster.rpc[IDS.index(nid)]
    key = ("mt_tls_handshake_failed_total", (("plane", "internode"),))
    before = _scrape(cluster, nid).get(key, 0)
    bare = ssl.create_default_context(cafile=cluster.pki.ca_cert)
    with socket.create_connection(("127.0.0.1", port), timeout=5) as raw:
        with pytest.raises((ssl.SSLError, OSError)):
            with bare.wrap_socket(raw, server_hostname="127.0.0.1") as s:
                s.sendall(b"POST /rpc/sys/ping HTTP/1.1\r\n\r\n")
                if not s.recv(1):
                    raise ConnectionResetError("closed at the handshake")
    plain = RPCClient(f"http://127.0.0.1:{port}", SECRET, timeout=5)
    try:
        with pytest.raises(Exception):
            plain.call("sys", "ping")
    finally:
        plain.close()
    deadline = time.monotonic() + 10
    while _scrape(cluster, nid).get(key, 0) < before + 2:
        assert time.monotonic() < deadline, "the refusals were not counted"
        time.sleep(0.05)


@pytest.mark.parametrize("nid", IDS)
def test_the_internode_identity_is_answered(cluster, nid):
    prior = transport.manager()
    transport.configure(port_manager(cluster.pki))
    c = RPCClient(f"https://127.0.0.1:{cluster.rpc[IDS.index(nid)]}", SECRET,
                  timeout=5)
    try:
        assert c.call("sys", "ping") == "pong"
    finally:
        c.close()
        transport.configure(prior)


@pytest.mark.parametrize("nid", IDS)
def test_every_scrape_carries_the_tls_families(cluster, stored, nid):
    samples = _scrape(cluster, nid)
    names = {name for name, _ in samples}
    assert samples[("mt_tls_handshake_total",
                    (("plane", "internode"),))] > 0
    assert samples[("mt_tls_handshake_total", (("plane", "s3"),))] > 0
    expiries = {dict(lab)["cert"]: v for name, lab in samples
                if name == "mt_tls_cert_expiry_seconds"
                for v in [samples[(name, lab)]]}
    assert set(expiries) == {"s3", "internode"}
    assert all(0 < v <= 2 * 86400 for v in expiries.values())
    assert "mt_tls_cert_reloads_total" not in names
