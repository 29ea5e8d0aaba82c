"""TLS on both planes (``secure/pki.py``, ``certs.py``, ``transport.py``)
against ``minio_tpu``'s, on the session's PKI (``tests/_pki.py``): the
port's minted PKI has the reference's shape and each package's
``CertManager`` accepts the other's; ``from_dir`` reads the same files;
reloads on mtime, rotation and a corrupt rotation that costs one
connection, SNI; the ``mt_tls_*`` families counted and rendered alike,
and none before a manager exists; the RPC wire over mutual TLS both ways
(every ``StorageAPI`` call, the framed write, the lock service, typed
errors, a bad token answering AuthError, a client without a certificate
refused); the S3 front's clients over TLS; 3-node x 2-drive clusters
under ``start_cluster(tls=)`` leaving byte-equal drives; and the node
subcommand's scheme with TLS on (ROADMAP Queue 3 record 63: the
reference dials ``http://`` peers of a TLS plane and never forms)."""

import os
import shutil
import socket
import ssl
import threading
import time
import weakref

import pytest

from minio_tpu import cluster as ref_cluster
from minio_tpu import server_main as ref_main
from minio_tpu.admin import metrics as ref_metrics
from minio_tpu.parallel import dsync as ref_dsync
from minio_tpu.parallel import rpc as ref_rpc
from minio_tpu.secure import certs as ref_certs
from minio_tpu.secure import pki as ref_pki
from minio_tpu.secure import transport as ref_transport
from minio_tpu_torch import cluster as port_cluster
from minio_tpu_torch import server_main as port_main
from minio_tpu_torch.admin import metrics as port_metrics
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.parallel import dsync as port_dsync
from minio_tpu_torch.parallel import rpc as port_rpc
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.secure import certs as port_certs
from minio_tpu_torch.secure import pki as port_pki
from minio_tpu_torch.secure import transport as port_transport
from minio_tpu_torch.storage.xl_storage import XLStorage

from . import _pki
from ._torch_cluster import Clients, cluster_state_left
from ._torch_versions import assert_trees_equal, body, pin
from .test_torch_cluster import BATCH, BS, _specs
from .test_torch_cluster import stop as stop_nodes
from .test_torch_dsync_remote import _outcome, _wire
from .test_torch_remote import PKG as REMOTE_PKG
from .test_torch_remote import _surface
from .test_torch_rpc import _echo

CERTS = {"ref": ref_certs, "port": port_certs}
RPC = {"ref": ref_rpc, "port": port_rpc}
DSYNC = {"ref": ref_dsync, "port": port_dsync}
METRICS = {"ref": ref_metrics, "port": port_metrics}
TRANSPORT = {"ref": ref_transport, "port": port_transport}
PAIRS = [("ref", "port"), ("port", "ref"), ("port", "port")]
SECRET = "tls-secret"


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with cluster_state_left():
        yield


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    return _pki.cluster_pki(tmp_path_factory)


@pytest.fixture(scope="module")
def port_minted(tmp_path_factory, pki):
    """One PKI minted by the port, for the checks of its minting."""
    return port_pki.mint_cluster_pki(str(tmp_path_factory.mktemp("pp")))


@pytest.fixture(scope="module")
def certs_dir(tmp_path_factory, pki):
    return pki.write_certs_dir(str(tmp_path_factory.mktemp("certs")))


def manager(pkg: str, certs_dir: str, **kw):
    return CERTS[pkg].CertManager.from_dir(certs_dir) if not kw else \
        CERTS[pkg].CertManager(
            (f"{certs_dir}/public.crt", f"{certs_dir}/private.key"),
            internode=(f"{certs_dir}/internode/public.crt",
                       f"{certs_dir}/internode/private.key"),
            ca_file=f"{certs_dir}/CAs/ca.crt", **kw)


@pytest.fixture
def armed(certs_dir):
    """Each package's manager over the session PKI, installed in its own
    package's transport registry."""
    mgrs = {pkg: manager(pkg, certs_dir) for pkg in CERTS}
    for pkg, m in mgrs.items():
        TRANSPORT[pkg].configure(m)
    yield mgrs
    for t in TRANSPORT.values():
        t.configure(None)


def copied(pki, dest) -> str:
    """The session PKI's files copied to ``dest`` (a rotation edits these,
    never the session's)."""
    os.makedirs(dest)
    for name in ("ca.crt", "s3.crt", "s3.key", "internode.crt",
                 "internode.key"):
        shutil.copy(os.path.join(pki.dir, name), dest)
    return str(dest)


def shake(server_ctx, client_ctx, hostname="localhost",
          server=None) -> dict:
    """One handshake over a socket pair: the certificates each side saw,
    or its error.  ``server(sock)`` completes the server side instead of
    ``server_ctx``."""
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    out = {}

    def serve():
        try:
            s = server(a) if server else server_ctx.wrap_socket(
                a, server_side=True)
            out["client_cert"] = s.getpeercert()
            s.close()
        except Exception as e:  # noqa: BLE001 — reported to the test
            out["server_err"] = e
            a.close()
    t = threading.Thread(target=serve)
    t.start()
    try:
        c = client_ctx.wrap_socket(b, server_hostname=hostname)
        out["server_cert"] = c.getpeercert()
        try:
            c.recv(1)                   # TLS 1.3: the server's verdict
        except (ssl.SSLError, OSError) as e:
            out["client_err"] = e
        c.close()
    except (ssl.SSLError, OSError) as e:
        out["client_err"] = e
        b.close()
    t.join(10)
    return out


def cn(cert: dict) -> str:
    return dict(x[0] for x in cert["subject"])["commonName"]


def decoded(path: str) -> dict:
    info = ssl._ssl._test_decode_cert(path)
    return {k: info.get(k) for k in ("subject", "issuer", "subjectAltName",
                                     "version")}


# -- the PKI ---------------------------------------------------------------


@pytest.mark.parametrize("which", ["ca_cert", "s3_cert", "internode_cert"])
def test_minted_certificates_have_the_references_shape(pki, port_minted,
                                                       which):
    assert decoded(getattr(port_minted, which)) == \
        decoded(getattr(pki, which))


@pytest.mark.parametrize("minter", ["ref", "port"])
@pytest.mark.parametrize("server", ["ref", "port"])
def test_each_managers_pki_is_accepted_by_the_other(
        tmp_path, pki, port_minted, minter, server):
    """A certs dir of either package's minting, read by each package's
    manager: the server's internode context accepts the other package's
    internode client, mutually."""
    minted = port_minted if minter == "port" else pki
    d = minted.write_certs_dir(str(tmp_path / "certs"))
    client = "ref" if server == "port" else "port"
    got = shake(CERTS[server].CertManager.from_dir(d).server_context(
        "internode"), CERTS[client].CertManager.from_dir(d).client_context(
        "internode"))
    assert cn(got["server_cert"]) == cn(got["client_cert"]) == "internode"


def test_write_certs_dir_lays_out_the_same_files(tmp_path, pki):
    port_view = port_pki.PKI(**{k: getattr(pki, k) for k in (
        "dir", "ca_cert", "ca_key", "s3_cert", "s3_key", "internode_cert",
        "internode_key")})
    trees = {}
    for tag, p in (("ref", pki), ("port", port_view)):
        root = p.write_certs_dir(str(tmp_path / tag))
        trees[tag] = {os.path.relpath(os.path.join(d, f), root):
                      open(os.path.join(d, f), "rb").read()
                      for d, _, fs in os.walk(root) for f in fs}
    assert trees["port"] == trees["ref"]
    assert sorted(trees["ref"]) == ["CAs/ca.crt", "internode/private.key",
                                    "internode/public.crt", "private.key",
                                    "public.crt"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_no_openssl_is_a_pki_error(tmp_path, monkeypatch, pkg):
    mod = ref_pki if pkg == "ref" else port_pki
    monkeypatch.setattr(mod, "OPENSSL", str(tmp_path / "no-openssl"))
    assert not mod.available()
    with pytest.raises(mod.PKIError):
        mod.mint_cluster_pki(str(tmp_path / "out"))


# -- the manager -----------------------------------------------------------


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_a_manager_requires_its_files(tmp_path, pkg):
    with pytest.raises(CERTS[pkg].TLSConfigError):
        CERTS[pkg].CertManager((str(tmp_path / "no.crt"),
                                str(tmp_path / "no.key")))


def test_from_dir_and_from_config_find_the_same_files(tmp_path, pki,
                                                      monkeypatch):
    d = pki.write_certs_dir(str(tmp_path / "certs"))
    os.makedirs(f"{d}/sni/localhost")
    shutil.copy(pki.internode_cert, f"{d}/sni/localhost/public.crt")
    shutil.copy(pki.internode_key, f"{d}/sni/localhost/private.key")
    monkeypatch.setenv("MT_TLS_ENABLE", "on")
    monkeypatch.setenv("MT_TLS_CERTS_DIR", d)
    from minio_tpu.utils.kvconfig import Config as RefConfig
    from minio_tpu_torch.utils.kvconfig import Config
    views = []
    for mod, cfg in ((ref_certs, RefConfig()), (port_certs, Config())):
        for m in (mod.CertManager.from_dir(d),
                  mod.CertManager.from_config(cfg)):
            views.append((m._pairs(), m.ca_file, m._watched(),
                          m.cert_expiries()))
    assert all(v == views[0] for v in views)
    assert set(views[0][3]) == {"s3", "internode", "sni:localhost"}
    monkeypatch.setenv("MT_TLS_ENABLE", "off")
    assert port_certs.CertManager.from_config(Config()) is None


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_a_moved_mtime_reloads_and_a_throttle_skips(tmp_path, pki, pkg):
    d = copied(pki, tmp_path / "p")
    m = CERTS[pkg].CertManager((f"{d}/s3.crt", f"{d}/s3.key"),
                               internode=(f"{d}/internode.crt",
                                          f"{d}/internode.key"),
                               ca_file=f"{d}/ca.crt", check_interval_s=0.0)
    before = METRICS[pkg].GLOBAL.snapshot().get(
        ("mt_tls_cert_reloads_total", ()), 0)
    ctx = {plane: m.server_context(plane) for plane in ("s3", "internode")}
    client = m.client_context("internode")
    assert m.server_context("s3") is ctx["s3"]
    assert m.maybe_reload() is False
    os.utime(f"{d}/s3.crt", (time.time(), time.time() + 1))
    assert m.maybe_reload() is True and m.reloads == 1
    assert all(m.server_context(p) is not c for p, c in ctx.items())
    assert m.client_context("internode") is not client
    assert METRICS[pkg].GLOBAL.snapshot()[
        ("mt_tls_cert_reloads_total", ())] == before + 1
    m.check_interval_s = 3600.0
    os.utime(f"{d}/s3.crt", (time.time(), time.time() + 2))
    assert m.maybe_reload() is False


def _front(tmp, mgr) -> S3Server:
    dirs = [tmp / f"d{i}" for i in range(4)]
    for d in dirs:
        os.makedirs(d)
    srv = S3Server(ErasureObjects([XLStorage(str(d)) for d in dirs],
                                  parity=2, block_size=4096, device="cpu"),
                   "tk", "tls-front-secret", tls=mgr)
    srv.start()
    return srv


def _serial(port: int, ca: str, hostname: str = "localhost") -> str:
    ctx = ssl.create_default_context(cafile=ca)
    with socket.create_connection(("127.0.0.1", port), timeout=5) as raw:
        with ctx.wrap_socket(raw, server_hostname=hostname) as s:
            return s.getpeercert()["serialNumber"]


def test_a_rotation_rekeys_the_next_connection(tmp_path, pki):
    """New files on the same paths (the internode leaf over the front's):
    the next connection is served the new certificate, no restart."""
    d = copied(pki, tmp_path / "p")
    mgr = port_certs.CertManager((f"{d}/s3.crt", f"{d}/s3.key"),
                                 ca_file=f"{d}/ca.crt", check_interval_s=0.0)
    srv = _front(tmp_path, mgr)
    try:
        s0 = _serial(srv.port, pki.ca_cert)
        shutil.copy(f"{d}/internode.crt", f"{d}/s3.crt")
        shutil.copy(f"{d}/internode.key", f"{d}/s3.key")
        os.utime(f"{d}/s3.crt", (time.time(), time.time() + 5))
        assert _serial(srv.port, pki.ca_cert) != s0
        assert mgr.reloads >= 1
    finally:
        srv.stop()


@pytest.mark.parametrize("plane", ["s3", "internode"])
def test_a_corrupt_rotation_costs_one_connection_not_the_listener(
        tmp_path, pki, certs_dir, plane):
    """The server's files caught mid-rotation (its clients' are not)."""
    d = copied(pki, tmp_path / "p")
    pair = "s3" if plane == "s3" else "internode"
    mgr = port_certs.CertManager((f"{d}/s3.crt", f"{d}/s3.key"),
                                 internode=(f"{d}/internode.crt",
                                            f"{d}/internode.key"),
                                 ca_file=f"{d}/ca.crt", check_interval_s=0.0)
    port_transport.configure(manager("port", certs_dir))
    if plane == "s3":
        srv = _front(tmp_path, mgr)

        def call():
            S3Client(srv.endpoint, "tk", "tls-front-secret",
                     ca_file=pki.ca_cert, timeout=10).list_buckets()
    else:
        srv = port_rpc.RPCServer(SECRET, tls=mgr)
        srv.start()
        clients = Clients()

        def call():
            c = clients("port", srv.endpoint, SECRET, timeout=5)
            assert c.call("sys", "ping") == "pong"
    try:
        call()
        good = open(f"{d}/{pair}.crt", "rb").read()
        with open(f"{d}/{pair}.crt", "wb") as f:
            f.write(b"-----BEGIN GARBAGE-----\n")
        os.utime(f"{d}/{pair}.crt", (time.time(), time.time() + 5))
        with pytest.raises((ssl.SSLError, OSError, port_rpc.RPCError)):
            call()
        with open(f"{d}/{pair}.crt", "wb") as f:
            f.write(good)
        os.utime(f"{d}/{pair}.crt", (time.time(), time.time() + 10))
        call()                          # the same listener serves again
    finally:
        if plane == "internode":
            clients.close()
        srv.stop()
        port_transport.configure(None)


def test_sni_serves_the_hostnames_pair(tmp_path, pki):
    """``localhost`` named by SNI gets its own pair (the internode leaf);
    an address sends no SNI and gets the front's; the reference's server
    context answers alike."""
    mgrs = {pkg: CERTS[pkg].CertManager(
        (pki.s3_cert, pki.s3_key), ca_file=pki.ca_cert,
        sni={"localhost": (pki.internode_cert, pki.internode_key)})
        for pkg in CERTS}
    ctx = ssl.create_default_context(cafile=pki.ca_cert)
    srv = _front(tmp_path, mgrs["port"])
    try:
        got = {}
        for host in ("localhost", "127.0.0.1"):
            with socket.create_connection(("127.0.0.1", srv.port),
                                          timeout=5) as raw:
                with ctx.wrap_socket(raw, server_hostname=host) as s:
                    got[host] = cn(s.getpeercert())
        ref = {host: cn(shake(mgrs["ref"].server_context("s3"), ctx,
                              host)["server_cert"]) for host in got}
    finally:
        srv.stop()
    assert got == ref == {"localhost": "internode", "127.0.0.1": "s3"}


# -- the mt_tls_* families -------------------------------------------------


def tls_counters(pkg: str) -> dict:
    return {k: v for k, v in METRICS[pkg].GLOBAL.snapshot().items()
            if k[0].startswith("mt_tls_")}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_no_manager_no_tls_family(monkeypatch, pkg):
    monkeypatch.setattr(CERTS[pkg], "_MANAGERS", weakref.WeakSet())
    monkeypatch.setattr(METRICS[pkg], "GLOBAL", METRICS[pkg].Metrics())
    assert CERTS[pkg].render_metrics() == []
    assert "mt_tls" not in METRICS[pkg].render()


def test_the_same_handshakes_count_and_render_alike(monkeypatch, pki,
                                                    certs_dir):
    """On each plane, two handshakes that succeed, one from a client
    without a certificate and one in plain text, through each package's
    manager: the same counters, and the same rendered lines."""
    for pkg in CERTS:
        monkeypatch.setattr(METRICS[pkg], "GLOBAL", METRICS[pkg].Metrics())
    bare = ssl.create_default_context(cafile=pki.ca_cert)
    lines = {}
    for pkg in CERTS:
        mgr = manager(pkg, certs_dir)
        monkeypatch.setattr(CERTS[pkg], "_MANAGERS", weakref.WeakSet([mgr]))
        for plane in ("s3", "internode"):
            def server(sock, _p=plane, _m=mgr):
                s = _m.wrap_accept(sock, _p)
                _m.handshake(s, _p, 5)
                return s
            for client in (mgr.client_context("internode"),
                           mgr.client_context("internode"), bare):
                shake(None, client, server=server)
            a, b = socket.socketpair()
            b.sendall(b"GET / HTTP/1.1\r\n\r\n")
            b.close()
            with pytest.raises((ssl.SSLError, OSError)):
                server(a)
            a.close()
        text = METRICS[pkg].render()
        lines[pkg] = sorted(ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                            if "mt_tls_" in ln)
    assert tls_counters("port") == tls_counters("ref") == {
        ("mt_tls_handshake_total", (("plane", "s3"),)): 4.0,
        ("mt_tls_handshake_failed_total", (("plane", "s3"),)): 1.0,
        ("mt_tls_handshake_total", (("plane", "internode"),)): 4.0,
        ("mt_tls_handshake_failed_total", (("plane", "internode"),)): 2.0}
    assert lines["port"] == lines["ref"]
    assert 'mt_tls_cert_expiry_seconds{cert="internode"}' in lines["port"]


# -- the RPC wire over mutual TLS ------------------------------------------


def _tls_server(pkg: str, mgr, **services):
    srv = RPC[pkg].RPCServer(SECRET, tls=mgr)
    for name, methods in services.items():
        srv.register(name, methods)
    return srv


def _small_frames(mp) -> None:
    """Both packages stream bodies over 4 KiB in frames."""
    for m in (ref_rpc, port_rpc):
        mp.setattr(m.STREAM, "chunk_bytes", 4096)
        mp.setattr(m.STREAM, "enable", True)
        mp.setattr(m.STREAM, "_loaded", True)


def _surface_over_tls(cpkg: str, spkg: str, mgr, root) -> list:
    _, cremote, cxl, cdt = REMOTE_PKG[cpkg]
    _, sremote, sxl, _ = REMOTE_PKG[spkg]
    os.makedirs(root)
    local = sxl.XLStorage(str(root))
    srv = _tls_server(spkg, mgr)
    sremote.register_storage_service(srv, {"drive0": local})
    srv.start()
    clients = Clients()
    try:
        assert srv.endpoint.startswith("https://")
        remote = cremote.RemoteStorage(clients(cpkg, srv.endpoint, SECRET),
                                       "drive0")
        return _surface(remote, cdt, cxl.SYS_DIR)
    finally:
        clients.close()
        srv.stop()
        local.close()


@pytest.fixture(scope="module")
def ref_surface(tmp_path_factory, certs_dir):
    """The reference's client against its own TLS storage service."""
    mp = pytest.MonkeyPatch()
    _small_frames(mp)
    mgr = manager("ref", certs_dir)
    ref_transport.configure(mgr)
    try:
        return _surface_over_tls("ref", "ref", mgr,
                                 tmp_path_factory.mktemp("rs") / "d")
    finally:
        ref_transport.configure(None)
        mp.undo()


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_every_storage_call_answers_alike_over_mtls(tmp_path, monkeypatch,
                                                    armed, ref_surface,
                                                    cpkg, spkg):
    """``test_torch_remote``'s sequence (the framed writes and streamed
    reads with it) through a TLS listener answers as the reference's
    client does against its own."""
    _small_frames(monkeypatch)
    assert _surface_over_tls(cpkg, spkg, armed[spkg],
                             tmp_path / "d") == ref_surface
    assert ("err", "FileCorrupt") in ref_surface


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_the_lock_service_over_mtls(armed, cpkg, spkg):
    table = DSYNC[spkg].LocalLocker()
    srv = _tls_server(spkg, armed[spkg])
    DSYNC[spkg].register_lock_service(srv, table)
    srv.start()
    clients = Clients()
    try:
        got = _wire(DSYNC[cpkg].RemoteLocker,
                    clients(cpkg, srv.endpoint, SECRET))
        assert got == [True, False, False, True, False, False, True, True,
                       False, True, False, False]
        lockers = [DSYNC[cpkg].LocalLocker()] + [
            DSYNC[cpkg].RemoteLocker(clients(cpkg, srv.endpoint, SECRET))
            for _ in range(2)]
        a = DSYNC[cpkg].DRWMutex(lockers, "obj")
        b = DSYNC[cpkg].DRWMutex(lockers, "obj")
        assert _outcome(a, True, 1.0) == "granted" and table.is_locked("obj")
        assert _outcome(b, False, 0.05) == "LockTimeout"
        a.unlock()
        assert not table.is_locked("obj")
    finally:
        clients.close()
        srv.stop()


@pytest.mark.parametrize("cpkg,spkg", PAIRS)
def test_calls_errors_and_a_bad_token_over_mtls(armed, cpkg, spkg):
    srv = _tls_server(spkg, armed[spkg], echo=_echo())
    srv.start()
    clients = Clients()
    try:
        c = clients(cpkg, srv.endpoint, SECRET)
        assert c.call("echo", "hi", x=21) == 42
        errs = []
        for cl, method in ((c, "boom"), (c, "missing"),
                           (clients(cpkg, srv.endpoint, "wrong"), "hi")):
            with pytest.raises(RPC[cpkg].RPCError) as ei:
                cl.call("echo", method, **({"x": 1} if method == "hi"
                                           else {}))
            errs.append((ei.value.error_type, ei.value.message))
        assert errs == [("ValueError", "nope"),
                        ("NoSuchMethod", "/rpc/echo/missing"),
                        ("AuthError", "bad token")]
        assert len(c._pool) == 1        # one kept-alive TLS connection
    finally:
        clients.close()
        srv.stop()


@pytest.mark.parametrize("spkg", ["ref", "port"])
def test_a_client_without_a_certificate_is_refused(armed, pki, spkg):
    """Refused at the handshake, before the token check, and counted in
    the server's ``mt_tls_handshake_failed_total{plane="internode"}``; a
    plain-text client is refused too."""
    import http.client
    srv = _tls_server(spkg, armed[spkg])
    srv.start()
    key = ("mt_tls_handshake_failed_total", (("plane", "internode"),))
    before = METRICS[spkg].GLOBAL.snapshot().get(key, 0)
    clients = Clients()
    try:
        conn = http.client.HTTPSConnection(
            "127.0.0.1", srv.port, timeout=5,
            context=ssl.create_default_context(cafile=pki.ca_cert))
        with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
            conn.request("POST", "/rpc/sys/ping", body=b"")
            conn.getresponse()
        conn.close()
        plain = clients("port", srv.endpoint.replace("https", "http"),
                        SECRET, timeout=5)
        with pytest.raises(port_rpc.RPCError):
            plain.call("sys", "ping")
        deadline = time.monotonic() + 5
        while METRICS[spkg].GLOBAL.snapshot().get(key, 0) < before + 2:
            assert time.monotonic() < deadline, "refusals not counted"
            time.sleep(0.01)
    finally:
        clients.close()
        srv.stop()


# -- the S3 front's clients ------------------------------------------------


def test_the_front_over_tls_with_a_ca_file_or_the_registry(tmp_path, pki,
                                                           port_minted):
    srv = _front(tmp_path, port_certs.CertManager((pki.s3_cert, pki.s3_key),
                                                  ca_file=pki.ca_cert))
    try:
        assert srv.endpoint.startswith("https://")
        c = S3Client(srv.endpoint, "tk", "tls-front-secret",
                     ca_file=pki.ca_cert)
        c.make_bucket("tlsbkt")
        data = body(70_000, 3)
        c.put_object("tlsbkt", "obj", data)
        assert c.get_object("tlsbkt", "obj").body == data
        adm = AdminClient(srv.endpoint, "tk", "tls-front-secret",
                          ca_file=pki.ca_cert)
        assert adm.server_info()["region"] == srv.region
        # no CA given: the server configured the registry with its own
        assert S3Client(srv.endpoint, "tk", "tls-front-secret").get_object(
            "tlsbkt", "obj").body == data
        with pytest.raises(ssl.SSLError):
            S3Client(srv.endpoint, "tk", "tls-front-secret",
                     ca_file=port_minted.ca_cert).list_buckets()
    finally:
        srv.stop()
        port_transport.configure(None)


# -- clusters over TLS -----------------------------------------------------


def test_tls_clusters_leave_the_same_drives(tmp_path, monkeypatch,
                                            certs_dir):
    """A 3-node x 2-drive cluster of each package under
    ``start_cluster(tls=)``, the same pinned calls through its nodes."""
    pin(monkeypatch, batch=BATCH)
    answers = {}
    for pkg in ("ref", "port"):
        mgr = manager(pkg, certs_dir)
        mod = port_cluster if pkg == "port" else ref_cluster
        kw = {"device": "cpu"} if pkg == "port" else {"backend": "numpy"}
        nodes = mod.start_cluster(_specs(pkg, tmp_path / pkg), SECRET,
                                  set_drive_count=6, tls=mgr, parity=2,
                                  block_size=BS,
                                  enforce_min_part_size=False, **kw)
        try:
            assert all(n.rpc.endpoint.startswith("https://") for n in nodes)
            n0, n1, n2 = nodes
            n0.layer.make_bucket("bkt")
            for j, size in enumerate((1000, 300_000, 1_200_000)):
                nodes[j].layer.put_object("bkt", f"o{j}", body(size, j))
            n1.layer.put_object("bkt", "o0", body(2000, 9))
            n2.layer.delete_object("bkt", "o1")
            answers[pkg] = [nodes[(j + 1) % 3].layer.get_object(
                "bkt", k)[1] == body(size, s) for j, (k, size, s) in
                enumerate((("o0", 2000, 9), ("o2", 1_200_000, 2)))]
            answers[pkg].append(sorted(
                o.name for o in n2.layer.list_objects("bkt").objects))
        finally:
            stop_nodes(nodes)
            TRANSPORT[pkg].configure(None)
    assert answers["port"] == answers["ref"] == [True, True, ["o0", "o2"]]
    assert_trees_equal(tmp_path / "port", tmp_path / "ref", 6)


# -- the node subcommand's scheme (Queue 3 record 63) ----------------------


class Captured(Exception):
    pass


def _capture(monkeypatch, mod, seen: dict) -> None:
    def run_node(self_id, specs, secret, *a, **kw):
        seen["specs"], seen["tls"] = specs, kw.get("tls")
        raise Captured
    monkeypatch.setattr(mod, "run_node", run_node)


def _node_argv(tmp_path, rpc_port: int) -> list:
    return ["node", "--node-id", "n1", "--secret", SECRET,
            f"n1=127.0.0.1:{rpc_port}={tmp_path}/a0",
            f"n2=127.0.0.1:1={tmp_path}/b0"]


def test_ref_node_dials_http_peers_of_a_tls_plane(tmp_path, monkeypatch,
                                                  certs_dir):
    """``[ref]``: with ``MT_TLS_ENABLE=on`` the reference's node command
    declares every peer ``http://``, and its rendezvous never reaches a
    TLS peer: a node process of it cannot form a cluster."""
    monkeypatch.setenv("MT_TLS_ENABLE", "on")
    monkeypatch.setenv("MT_TLS_CERTS_DIR", certs_dir)
    peer = _tls_server("ref", manager("ref", certs_dir))
    peer.start()
    seen = {}
    _capture(monkeypatch, ref_cluster, seen)
    try:
        with pytest.raises(Captured):
            ref_main.main(_node_argv(tmp_path, peer.port))
        assert [s.endpoint.split(":")[0] for s in seen["specs"]] == \
            ["http", "http"]
        with pytest.raises(TimeoutError):
            ref_cluster.wait_for_peers(seen["specs"], SECRET, "n2",
                                       timeout=1.0)
    finally:
        peer.stop()


def test_port_node_dials_https_peers_with_tls_on(tmp_path, monkeypatch,
                                                 certs_dir):
    """The port's node command reads the ``tls`` subsystem and its
    ``run_node`` gives every peer the plane's scheme before the node
    binds: the rendezvous reaches a TLS peer."""
    monkeypatch.setenv("MT_TLS_ENABLE", "on")
    monkeypatch.setenv("MT_TLS_CERTS_DIR", certs_dir)
    peer = _tls_server("port", manager("port", certs_dir))
    peer.start()
    seen = {}

    def node(spec, all_specs, secret, *a, tls=None, **kw):
        seen["specs"], seen["tls"] = all_specs, tls
        raise Captured
    monkeypatch.setattr(port_cluster, "Node", node)
    try:
        with pytest.raises(Captured):
            port_main.main(_node_argv(tmp_path, peer.port) + ["--device",
                                                             "cpu"])
        assert [s.endpoint.split(":")[0] for s in seen["specs"]] == \
            ["https", "https"]
        assert seen["tls"] is not None
        port_transport.configure(seen["tls"])
        port_cluster.wait_for_peers(seen["specs"], SECRET, "n2",
                                    timeout=5.0)
    finally:
        peer.stop()
        port_transport.configure(None)
