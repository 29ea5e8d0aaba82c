"""The reference's network chaos drills (``tests/test_chaos_network.py``)
against the port: ``parallel/faulty.py``'s programs by connection number
(pass-through, delay, 503, reset, black hole), and ``stop()`` leaving no
socket or thread; the RPC plane's breaker opened by a 503 burst and
closed by the half-open probe; a reset mid-body, mid-handshake and
mid-frame, and a black hole, each a typed ``RPCError`` (on plain and on
TLS links) or, under a set, a PUT that commits on quorum with nothing
staged on the faulted drives; a peer killed mid-PUT (buffered and
streamed) with the object committed on quorum and healed onto the peer
when it returns; a lock refresh under a partition giving ``LockLost``,
one blip survived; and the S3 front's slowloris, slow body and Select
drills through the proxy (the pool's shedding and the drain of ``stop()``
are ``test_torch_limits.py``'s).  Every fault is programmed by connection
number; every deadline test takes a client timeout of 1 s and a bound
of 10 s."""

import http.client
import io
import os
import socket
import threading
import time

import pytest

from minio_tpu_torch.admin import metrics as port_metrics
from minio_tpu_torch.cluster import NodeSpec, start_cluster
from minio_tpu_torch.objectlayer import erasure_object as eo
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.objectlayer.healing import heal_object
from minio_tpu_torch.parallel import dsync
from minio_tpu_torch.parallel.faulty import Fault, FaultyProxy
from minio_tpu_torch.parallel.rpc import (STREAM, CircuitBreaker, RPCClient,
                                          RPCError, RPCServer)
from minio_tpu_torch.s3 import sigv4
from minio_tpu_torch.s3.client import S3Client, S3ClientError
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.s3select import message as sel_msg
from minio_tpu_torch.secure import transport
from minio_tpu_torch.storage import errors as serrors
from minio_tpu_torch.storage.remote import (RemoteStorage,
                                            register_storage_service)
from minio_tpu_torch.storage.xl_storage import XLStorage
from minio_tpu_torch.utils.memgov import GOVERNOR
from minio_tpu_torch.utils.retry import RetryPolicy

from . import _pki
from ._torch_cluster import cluster_state_left, port_manager
from ._torch_versions import body

SECRET = "chaos-secret"
LINKS = ["plain", "tls"]


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with cluster_state_left():
        yield


@pytest.fixture
def held():
    """Proxies, servers, clients and closers a test starts: all stopped,
    closed or called however it ends."""
    out: list = []
    yield out
    for x in reversed(out):
        if isinstance(x, RPCClient):
            x.close()
        elif callable(x):
            x()
        else:
            x.stop()


def _client(held, endpoint, fail_max=100, cooldown_s=60.0, timeout=5.0,
            clock=time.monotonic):
    c = RPCClient(endpoint, SECRET, timeout=timeout,
                  breaker=CircuitBreaker(fail_max=fail_max,
                                         cooldown_s=cooldown_s, clock=clock),
                  retry=RetryPolicy(attempts=1))
    c._dyn_for("t")._timeout = timeout      # the deadline pinned
    c._dyn_for("storage")._timeout = timeout
    held.append(c)
    return c


@pytest.fixture
def link(request, tmp_path_factory, held):
    """(RPC server with an ``echo`` service, scheme): over TLS, the
    session's PKI installed in the port's transport registry."""
    mgr = None
    if getattr(request, "param", "plain") == "tls":
        mgr = port_manager(_pki.cluster_pki(tmp_path_factory))
        transport.configure(mgr)
    srv = RPCServer(SECRET, tls=mgr)
    srv.register("t", {"echo": lambda x: x})
    srv.start()
    held.append(srv)
    yield srv, "https" if mgr else "http"
    transport.configure(None)


def _proxy(held, port, **kw) -> FaultyProxy:
    p = FaultyProxy("127.0.0.1", port, **kw).start()
    held.append(p)
    return p


def _at(proxy, scheme: str) -> str:
    return proxy.endpoint.replace("http://", f"{scheme}://")


# -- the proxy's programs ----------------------------------------------------


def test_the_proxy_follows_its_program_by_connection_number(link, held):
    srv, _ = link
    proxy = _proxy(held, srv.port, plan={2: Fault.http_503(),
                                         4: Fault.delay(0.3)})
    answers = []
    for x in range(4):
        c = _client(held, proxy.endpoint)     # a fresh pool: a connection
        t0 = time.monotonic()
        try:
            answers.append(c.call("t", "echo", x=x))
        except RPCError as e:
            answers.append(e.error_type)
        took = time.monotonic() - t0
    assert answers == [0, "BadResponse", 2, 3]
    assert took >= 0.3 and proxy.connections_seen() == 4


def test_stop_closes_every_socket_and_joins_every_thread(link, held):
    srv, _ = link
    proxy = FaultyProxy("127.0.0.1", srv.port, plan={2: Fault.blackhole()})
    proxy.start()
    c = _client(held, proxy.endpoint)
    assert c.call("t", "echo", x=1) == 1      # kept alive in the pool
    hole = socket.create_connection(("127.0.0.1", proxy.port), timeout=5)
    try:
        deadline = time.monotonic() + 5
        while proxy.connections_seen() < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        proxy.stop()
        assert not proxy._threads and not proxy._live
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("mt-faulty")]
        assert hole.recv(1) == b""            # the black hole was cut
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", proxy.port), timeout=1)
    finally:
        hole.close()


@pytest.mark.parametrize("link", LINKS, indirect=True)
def test_a_reset_mid_body_is_a_transport_failure(link, held):
    """Cut after 5 bytes of the answer: a typed transport error that opens
    a breaker of one failure, never a short read taken as an answer."""
    srv, scheme = link
    proxy = _proxy(held, srv.port, plan={1: Fault.reset(after_bytes=5)})
    c = _client(held, _at(proxy, scheme), fail_max=1)
    with pytest.raises(RPCError) as ei:
        c.call("t", "echo", x="Z" * 4096)
    assert ei.value.error_type == "ConnectionError"
    assert c.breaker.state == CircuitBreaker.OPEN


@pytest.mark.parametrize("link", LINKS, indirect=True)
def test_a_black_hole_meets_the_client_deadline(link, held):
    """A peer that accepts and never answers (over TLS: mid-handshake)."""
    srv, scheme = link
    proxy = _proxy(held, srv.port, default=Fault.blackhole())
    c = _client(held, _at(proxy, scheme), fail_max=1, timeout=1.0)
    t0 = time.monotonic()
    with pytest.raises(RPCError):
        c.call("t", "echo", x=1)
    assert time.monotonic() - t0 < 10.0
    assert c.breaker.state == CircuitBreaker.OPEN


@pytest.mark.parametrize("link", ["tls"], indirect=True)
def test_a_reset_mid_handshake_is_a_transport_failure(link, held):
    srv, scheme = link
    proxy = _proxy(held, srv.port, default=Fault.reset(after_bytes=64))
    c = _client(held, _at(proxy, scheme), fail_max=1)
    with pytest.raises(RPCError) as ei:
        c.call("t", "echo", x=1)
    assert ei.value.error_type == "ConnectionError"
    assert c.breaker.state == CircuitBreaker.OPEN


@pytest.mark.parametrize("link", LINKS, indirect=True)
def test_a_503_burst_opens_the_breaker_and_the_probe_closes_it(link, held):
    """Over TLS the canned answer meets a ClientHello: a failed handshake,
    a transport failure all the same."""
    srv, scheme = link
    clock = [0.0]
    proxy = _proxy(held, srv.port, default=Fault.http_503())
    c = _client(held, _at(proxy, scheme), fail_max=2, cooldown_s=5.0,
                clock=lambda: clock[0])
    for _ in range(2):
        with pytest.raises(RPCError):
            c.call("t", "echo", x=1)
    assert c.breaker.state == CircuitBreaker.OPEN
    with pytest.raises(RPCError) as ei:
        c.call("t", "echo", x=1)
    assert ei.value.error_type == "PeerOffline"
    proxy.set_default(Fault.passthrough())
    clock[0] = 6.0                              # the cooldown is over
    assert c.call("t", "echo", x=1) == 1        # the probe
    assert c.breaker.state == CircuitBreaker.CLOSED


# -- faults under a set --------------------------------------------------------


def _errors() -> float:
    return sum(v for k, v in port_metrics.GLOBAL.snapshot().items()
               if k[0] == "mt_node_rpc_errors_total")


@pytest.fixture
def frames(monkeypatch):
    """Bodies over 1 KiB stream in frames; a PUT streams in 8 KiB
    batches."""
    monkeypatch.setattr(STREAM, "enable", True)
    monkeypatch.setattr(STREAM, "chunk_bytes", 1024)
    monkeypatch.setattr(STREAM, "_loaded", True)
    monkeypatch.setattr(eo, "STREAM_BATCH_BYTES", 2 * 4096)


@pytest.mark.parametrize("link", LINKS, indirect=True)
def test_a_reset_mid_frame_commits_on_quorum(tmp_path, link, held, frames):
    """Four local drives and two behind a proxy: once the proxy resets
    every new connection, the streamed appends fail as transport errors,
    the PUT commits on the four, and nothing of it is on the two."""
    _, scheme = link
    rpc = RPCServer(SECRET, tls=transport.manager())
    for i in range(2):
        os.makedirs(tmp_path / f"r{i}")
    remote = {f"r{i}": XLStorage(str(tmp_path / f"r{i}")) for i in range(2)}
    register_storage_service(rpc, remote)
    rpc.start()
    held.append(rpc)
    proxy = _proxy(held, rpc.port)
    clients = [_client(held, _at(proxy, scheme), timeout=2.0)
               for _ in range(2)]
    disks = []
    for i in range(4):
        os.makedirs(tmp_path / f"l{i}")
        disks.append(XLStorage(str(tmp_path / f"l{i}")))
    disks += [RemoteStorage(c, f"r{i}") for i, c in enumerate(clients)]
    lay = ErasureObjects(disks, parity=2, block_size=4096, device="cpu")
    held.append(lay.close)
    lay.make_bucket("cbkt")
    data = body(10 * 4096, 1)
    lay.put_object("cbkt", "ok", io.BytesIO(data))
    assert remote["r0"].read_all("cbkt", "ok/xl.meta")
    proxy.set_default(Fault.reset(after_bytes=0))
    proxy.sever()
    for c in clients:
        c.close()
    errs = _errors()
    lay.put_object("cbkt", "cut", io.BytesIO(data))
    assert lay.get_object("cbkt", "cut")[1] == data
    assert _errors() > errs
    for i in range(2):
        assert not (tmp_path / f"r{i}" / "cbkt" / "cut").exists()


def test_a_black_hole_mid_frame_is_a_transport_failure(tmp_path, held,
                                                       frames):
    drive = XLStorage(str(tmp_path))
    drive.make_vol("vol1")
    rpc = RPCServer(SECRET)
    register_storage_service(rpc, {"bh": drive})
    rpc.start()
    held.append(rpc)
    proxy = _proxy(held, rpc.port, default=Fault.blackhole())
    c = _client(held, proxy.endpoint, timeout=1.0)
    t0 = time.monotonic()
    with pytest.raises(serrors.StorageError):
        RemoteStorage(c, "bh").append_file("vol1", "f", b"x" * 50_000)
    assert time.monotonic() - t0 < 10.0
    assert c.breaker._failures > 0
    with pytest.raises(serrors.FileNotFound):
        drive.read_file_stream("vol1", "f", 0, 1)


# -- a peer killed -------------------------------------------------------------


@pytest.fixture
def chaos_cluster(tmp_path, monkeypatch):
    """Three port nodes of two drives, one set of six, with the breaker
    opening after two failures, a 200 ms cooldown and one attempt."""
    monkeypatch.setenv("MT_RPC_BREAKER_FAILURES", "2")
    monkeypatch.setenv("MT_RPC_BREAKER_COOLDOWN", "200ms")
    monkeypatch.setenv("MT_RPC_RETRY_ATTEMPTS", "1")
    specs = []
    for n in range(3):
        dirs = [str(tmp_path / f"n{n}d{d}") for d in range(2)]
        for d in dirs:
            os.makedirs(d)
        specs.append(NodeSpec(f"node{n}", dirs))
    nodes = start_cluster(specs, SECRET, set_drive_count=6, parity=2,
                          block_size=4096, device="cpu")
    returned: list = []
    yield nodes, returned
    for srv in returned:
        srv.stop()
    for node in nodes:
        node.stop()


def _come_back(nodes, returned) -> None:
    """Node 2's RPC services back on its port, its drives and table."""
    from minio_tpu_torch.parallel.dsync import register_lock_service
    srv = RPCServer(SECRET, port=nodes[2].rpc.port)
    register_storage_service(srv, nodes[2].drives)
    register_lock_service(srv, nodes[2].locker)
    srv.start()
    returned.append(srv)


def _healed_onto_node2(nodes, key: str, data: bytes) -> None:
    """After the cooldown, heal (its traffic is the half-open probe) until
    node 2's drives hold the object again; the GET and a full-strength PUT
    follow."""
    layer = nodes[0].layer
    er = layer.get_hashed_set(key)
    deadline = time.monotonic() + 30
    while True:
        time.sleep(0.25)
        r = heal_object(er, "chaos", key)
        if r.after_ok == 6:
            break
        assert time.monotonic() < deadline, r
    for d in nodes[2].spec.drive_dirs:
        assert os.path.exists(f"{d}/chaos/{key}/xl.meta")
    assert layer.get_object("chaos", key)[1] == data
    layer.put_object("chaos", "after", body(64 * 1024, 3))
    assert nodes[1].layer.get_object("chaos", "after")[1] == \
        body(64 * 1024, 3)


def test_a_peer_killed_mid_put_commits_on_quorum_and_heals(chaos_cluster):
    nodes, returned = chaos_cluster
    layer = nodes[0].layer
    layer.make_bucket("chaos")
    before = body(128 * 1024, 1)
    layer.put_object("chaos", "before", before)
    port = nodes[2].rpc.port
    nodes[2].rpc.stop()
    during = body(256 * 1024, 2)
    layer.put_object("chaos", "during", during)
    assert layer.get_object("chaos", "during")[1] == during
    assert layer.get_object("chaos", "before")[1] == before
    victims = [d for s in layer.sets for d in s.disks
               if f":{port}/" in d.endpoint()]
    assert len(victims) == 2
    t0 = time.monotonic()
    for d in victims:
        with pytest.raises(serrors.StorageError):
            d.read_all("chaos-probe-vol", "nope")
    assert time.monotonic() - t0 < 2.0          # the breakers fail fast
    _come_back(nodes, returned)
    _healed_onto_node2(nodes, "during", during)


def test_a_peer_killed_mid_stream_with_writer_queues(chaos_cluster,
                                                     monkeypatch):
    """Node 2's services stop after two batches of a streamed PUT: the
    queued writes to its drives fail, the four others hold write quorum,
    the PUT commits, and the heal brings node 2's shards back."""
    nodes, returned = chaos_cluster
    layer = nodes[0].layer
    monkeypatch.setattr(eo, "STREAM_BATCH_BYTES", 64 * 1024)
    es = layer.sets[0]
    batch = es._batch_bytes()
    layer.make_bucket("chaos")
    data = body(4 * batch + 1234, 4)
    killed = threading.Event()

    class KillerReader(io.BytesIO):
        def read(self, n=-1):
            c = super().read(n)
            if self.tell() >= 2 * batch and not killed.is_set():
                killed.set()
                nodes[2].rpc.stop()
            return c

    layer.put_object("chaos", "queued", KillerReader(data))
    assert killed.is_set()
    assert layer.get_object("chaos", "queued")[1] == data
    fis, errs = es._fanout(
        lambda d: d.read_version("chaos", "queued", None), es.disks)
    assert sum(f is not None for f in fis) == 4
    assert sum(e is not None for e in errs) == 2
    _come_back(nodes, returned)
    _healed_onto_node2(nodes, "queued", data)


# -- locks under a partition ---------------------------------------------------


def test_a_lock_refresh_under_a_partition_is_lost(held):
    servers, lockers = [], [dsync.LocalLocker()]
    for _ in range(2):
        srv = RPCServer(SECRET)
        dsync.register_lock_service(srv, dsync.LocalLocker())
        srv.start()
        held.append(srv)
        servers.append(srv)
        lockers.append(dsync.RemoteLocker(_client(held, srv.endpoint)))
    m = dsync.DRWMutex(lockers, "chaos/partition", ttl_s=0.6)
    m.lock(write=True, timeout=5.0)
    try:
        m.ensure_valid()
        for srv in servers:
            srv.stop()
        assert m.lost.wait(timeout=10.0)
        with pytest.raises(dsync.LockLost):
            m.ensure_valid()
    finally:
        m.unlock()
        dsync.stop_refresher()


def test_a_single_refresh_blip_is_survived(held):
    srv = RPCServer(SECRET)
    dsync.register_lock_service(srv, dsync.LocalLocker())
    srv.start()
    held.append(srv)
    lockers = [dsync.LocalLocker(),
               dsync.RemoteLocker(_client(held, srv.endpoint))]
    m = dsync.DRWMutex(lockers, "chaos/blip", ttl_s=0.6)
    m.lock(write=True, timeout=5.0)
    try:
        m._refresh_fails[1] = 1
        m._do_refresh()
        assert m._refresh_fails[1] == 0 and not m.lost.is_set()
        m.ensure_valid()
    finally:
        m.unlock()
        dsync.stop_refresher()


# -- the S3 front through the proxy ---------------------------------------------


@pytest.fixture
def front(tmp_path, monkeypatch, held):
    """A port server (4 drives, 64 KiB blocks) with a 500 ms header
    deadline and a 1 s body deadline, and a pass-through proxy before
    it."""
    monkeypatch.setenv("MT_API_READ_HEADER_TIMEOUT", "500ms")
    monkeypatch.setenv("MT_API_BODY_DEADLINE", "1s")
    monkeypatch.setenv("MT_API_BODY_MIN_RATE", "0")
    dirs = [tmp_path / f"d{i}" for i in range(4)]
    for d in dirs:
        os.makedirs(d)
    srv = S3Server(ErasureObjects([XLStorage(str(d)) for d in dirs],
                                  parity=2, block_size=64 * 1024,
                                  device="cpu"), "testkey", "testsecret")
    srv.start()
    held.append(srv)
    return srv, _proxy(held, srv.port)


def test_slowloris_through_the_proxy_is_cut_at_the_header_deadline(front):
    _, proxy = front
    with socket.create_connection(("127.0.0.1", proxy.port)) as s:
        s.settimeout(10.0)
        s.sendall(b"GET / HT")
        t0 = time.monotonic()
        assert s.recv(4096) == b""
        assert time.monotonic() - t0 < 5.0


def test_a_slow_body_is_cut_with_408_while_traffic_flows(front):
    srv, proxy = front
    cli = S3Client(srv.endpoint, "testkey", "testsecret")
    cli.make_bucket("chaos")
    s = socket.create_connection(("127.0.0.1", proxy.port))
    s.settimeout(10.0)
    s.sendall(b"PUT /chaos/slow HTTP/1.1\r\nHost: h\r\n"
              b"Content-Length: 1000000\r\n\r\n")
    stop = threading.Event()

    def trickle():
        try:
            while not stop.wait(0.05):
                s.sendall(b"a")
        except OSError:
            pass
    t = threading.Thread(target=trickle)
    t.start()
    try:
        data = body(512 * 1024, 5)
        cli.put_object("chaos", "ok", data)
        assert cli.get_object("chaos", "ok").body == data
        resp = b""
        while True:
            try:
                chunk = s.recv(4096)
            except OSError:
                break
            if not chunk:
                break
            resp += chunk
        assert b"408" in resp.split(b"\r\n")[0]
        assert b"RequestTimeout" in resp
    finally:
        stop.set()
        t.join()
        s.close()
    with pytest.raises(S3ClientError):
        cli.get_object("chaos", "slow")


def test_a_reset_select_stream_releases_its_scanner(front):
    """The proxy resets the Select's event stream after 16 KiB: the
    scanner stops and its governor charge drains; the link healed, the
    same query ends with End."""
    srv, proxy = front
    c = S3Client(srv.endpoint, "testkey", "testsecret")
    c.make_bucket("chsel")
    row = b"alpha,beta,gamma-some-padding-for-size\n"
    c.put_object("chsel", "big.csv", row * ((1 << 20) // len(row)))
    query = (b'<?xml version="1.0"?><SelectObjectContentRequest '
             b'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
             b"<Expression>SELECT * FROM S3Object</Expression>"
             b"<ExpressionType>SQL</ExpressionType>"
             b"<InputSerialization><CSV/></InputSerialization>"
             b"<OutputSerialization><CSV/></OutputSerialization>"
             b"</SelectObjectContentRequest>")
    path = "/chsel/big.csv?select&select-type=2"

    def post() -> http.client.HTTPResponse:
        hdrs = sigv4.sign_request(sigv4.Credentials("testkey", "testsecret"),
                                  "POST", srv.endpoint + path, {}, query,
                                  "us-east-1")
        conn = http.client.HTTPConnection("127.0.0.1", proxy.port,
                                          timeout=30)
        conn.request("POST", path, body=query, headers=hdrs)
        return conn
    proxy.program(proxy.connections_seen() + 1,
                  Fault.reset(after_bytes=16 * 1024))
    conn = post()
    try:
        with pytest.raises((ConnectionError, http.client.HTTPException,
                            OSError)):
            resp = conn.getresponse()
            while resp.read(65536):
                pass
            raise ConnectionResetError("the stream ended short")
    finally:
        conn.close()
    deadline = time.monotonic() + 15.0
    while GOVERNOR.inuse_bytes("select"):
        assert time.monotonic() < deadline, GOVERNOR.stats()
        time.sleep(0.05)
    conn = post()
    try:
        resp = conn.getresponse()
        assert resp.status == 200
        assert sel_msg.parse_events(resp.read())[-1][0] == "End"
    finally:
        conn.close()
