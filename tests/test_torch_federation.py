"""Bucket DNS federation (``utils/fed_dns.py`` and the server's hooks)
against ``minio_tpu``'s.

The same calls on each package's ``FileDNSStore`` leave the same JSON
file, and on its ``EtcdDNSStore`` the same skydns keys and values (each
on its own ``tests/etcd_stub.py``); each package reads the other's
records.  ``FederationSys.from_config`` reads the ``federation``
subsystem alike.  Over HTTP, a reference server and a port server share
one DNS file: a bucket made on one is refused on the other with
BucketAlreadyExists, a request through the other answers 307 to its
owner and the redirect serves the body, DELETE bucket frees the name,
and a make that fails locally takes its fresh record back.  Behind TLS
fronts, the port's redirect keeps the front's scheme; ``[ref]`` the
reference's names ``http://`` (ROADMAP Queue 3 record 64)."""

import json
import socket
import urllib.parse

import pytest

from minio_tpu.secure import transport as ref_transport
from minio_tpu.utils import fed_dns as ref_fed
from minio_tpu.utils import kvconfig as ref_kv
from minio_tpu_torch.s3.client import S3Client, S3ClientError
from minio_tpu_torch.secure import transport as port_transport
from minio_tpu_torch.utils import fed_dns as port_fed
from minio_tpu_torch.utils import kvconfig as port_kv

from . import _pki
from .etcd_stub import StubEtcd
from ._torch_cluster import cluster_state_left, free_ports
from ._torch_control import AK, SK, client, servers
from ._torch_ident import stub_running
from ._torch_versions import body

FED = {"ref": ref_fed, "port": port_fed}
KV = {"ref": ref_kv, "port": port_kv}
DOMAIN = "fed.example.test"


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with cluster_state_left():
        yield


# -- the stores ----------------------------------------------------------------


def _store_calls(fed, store) -> list:
    """Every store call, with fixed creation times: (answer or error)."""
    rec = fed.DNSRecord
    out = []
    for call in (lambda: store.put(rec("alpha", "h1", 9000, 11)),
                 lambda: store.put(rec("alpha", "h1", 9000, 12)),
                 lambda: store.put(rec("alpha", "h2", 9000, 13)),
                 lambda: store.put(rec("beta", "h2", 9001, 21)),
                 lambda: store.put(rec("gamma", "h3", 9002, 31)),
                 lambda: store.put(rec("gamma", "h1", 9000, 32),
                                   replace=True),
                 lambda: store.get("alpha"), lambda: store.get("nope"),
                 lambda: sorted((r.bucket, r.host, r.port, r.created_ns)
                                for r in store.list()),
                 lambda: store.delete("beta"), lambda: store.delete("beta"),
                 lambda: store.get("beta"),
                 lambda: sorted(r.bucket for r in store.list())):
        try:
            got = call()
            out.append(got.to_dict() if isinstance(got, fed.DNSRecord)
                       else got)
        except fed.DNSError as e:
            out.append(type(e).__name__)
    return out


def test_file_stores_leave_the_same_file(tmp_path):
    answers, files = {}, {}
    for pkg, fed in FED.items():
        path = str(tmp_path / pkg / "dns.json")
        answers[pkg] = _store_calls(fed, fed.FileDNSStore(path))
        with open(path, "rb") as f:
            files[pkg] = f.read()
    assert answers["port"] == answers["ref"]
    assert "BucketTaken" in answers["port"]
    assert files["port"] == files["ref"]
    assert sorted(json.loads(files["port"])) == ["alpha", "gamma"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    path = str(tmp_path / "dns.json")
    _store_calls(FED[writer], FED[writer].FileDNSStore(path))
    reader = "port" if writer == "ref" else "ref"
    fed = FED[reader]
    store = fed.FileDNSStore(path)
    assert store.get("gamma").to_dict() == {
        "bucket": "gamma", "host": "h1", "port": 9000, "created_ns": 32}
    with pytest.raises(fed.BucketTaken):
        store.put(fed.DNSRecord("alpha", "h9", 1))


@pytest.fixture(scope="module")
def _etcds():
    r, p = StubEtcd(), StubEtcd()
    with stub_running(r) as r_ep, stub_running(p) as p_ep:
        yield {"ref": (r, r_ep), "port": (p, p_ep)}


@pytest.fixture
def etcds(_etcds):
    """{package: (stub, endpoint)}, both stubs empty."""
    for stub, _ in _etcds.values():
        stub.kv.clear()
    return _etcds


def test_etcd_stores_leave_the_same_keys(etcds):
    answers = {pkg: _store_calls(fed, fed.EtcdDNSStore([etcds[pkg][1]],
                                                       DOMAIN))
               for pkg, fed in FED.items()}
    kv = {pkg: dict(etcds[pkg][0].kv) for pkg in FED}
    assert answers["port"] == answers["ref"]
    assert kv["port"] == kv["ref"]
    assert sorted(kv["port"]) == [b"/skydns/test/example/fed/alpha",
                                  b"/skydns/test/example/fed/gamma"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_etcd_records_cross_over_and_a_race_has_one_winner(etcds, writer):
    """Two servers of the two packages register one name on one etcd:
    the second is refused, the first reads as the owner on both."""
    _, ep = etcds[writer]
    other = "port" if writer == "ref" else "ref"
    first = FED[writer].FederationSys(
        FED[writer].EtcdDNSStore([ep], DOMAIN), DOMAIN, "h1", 9000)
    second = FED[other].FederationSys(
        FED[other].EtcdDNSStore([ep], DOMAIN), DOMAIN, "h2", 9000)
    assert first.register("race") is True
    assert first.register("race") is False      # ours already
    with pytest.raises(FED[other].BucketTaken):
        second.register("race")
    assert second.lookup_other("race").host == "h1"
    assert first.lookup_other("race") is None
    second.unregister("race")                    # not its record
    assert [r.bucket for r in first.federated_buckets()] == ["race"]
    first.unregister("race")
    assert second.register("race") is True


# -- the federation subsystem --------------------------------------------------


def _view(fed, pkg: str, host: str):
    """What ``from_config`` built, or its error's name."""
    try:
        f = fed.FederationSys.from_config(KV[pkg].Config(), host, 9100)
    except fed.DNSError as e:
        return type(e).__name__, str(e)
    if f is None:
        return None
    return (type(f.store).__name__, f.domain, f.self_host, f.self_port)


@pytest.mark.parametrize("env,host,want", [
    ({}, "127.0.0.1", None),
    ({"ENABLE": "on", "DNS_FILE": "{tmp}/d.json"}, "127.0.0.1",
     ("FileDNSStore", "", "127.0.0.1", 9100)),
    ({"ENABLE": "on", "DNS_FILE": "{tmp}/d.json", "DOMAIN": DOMAIN,
      "ADVERTISE": "fed-a.example.test:9443"}, "0.0.0.0",
     ("FileDNSStore", DOMAIN, "fed-a.example.test", 9443)),
    ({"ENABLE": "on", "DNS_FILE": "{tmp}/d.json"}, "0.0.0.0", "DNSError"),
    ({"ENABLE": "on"}, "127.0.0.1", "DNSError"),
    ({"ENABLE": "on", "DOMAIN": DOMAIN, "ETCD": "http://127.0.0.1:1"},
     "127.0.0.1", ("EtcdDNSStore", DOMAIN, "127.0.0.1", 9100)),
], ids=["off", "file", "advertise", "wildcard", "no-store", "etcd"])
def test_from_config_reads_the_subsystem_alike(tmp_path, monkeypatch, env,
                                               host, want):
    for k, v in env.items():
        name = "MT_ETCD_ENDPOINTS" if k == "ETCD" else f"MT_FEDERATION_{k}"
        monkeypatch.setenv(name, v.format(tmp=tmp_path))
    views = [_view(FED[pkg], pkg, host) for pkg in ("ref", "port")]
    assert views[0] == views[1]
    assert (views[1] if not isinstance(want, str) else views[1][0]) == want


def test_a_server_that_cannot_federate_frees_its_port(tmp_path,
                                                      monkeypatch):
    """``federation`` on without a store: the port's server refuses to be
    built and closes the listener it bound."""
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.storage.xl_storage import XLStorage
    monkeypatch.setenv("MT_FEDERATION_ENABLE", "on")
    dirs = [tmp_path / f"d{i}" for i in range(4)]
    for d in dirs:
        d.mkdir()
    layer = ErasureObjects([XLStorage(str(d)) for d in dirs], parity=2,
                           block_size=4096, device="cpu")
    port = free_ports(1)[0]
    try:
        with pytest.raises(port_fed.DNSError):
            S3Server(layer, AK, SK, port=port)
    finally:
        layer.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


# -- two federated servers ----------------------------------------------------


def _federate(mp, tmp) -> str:
    dns = str(tmp / "shared-dns.json")
    mp.setenv("MT_FEDERATION_ENABLE", "on")
    mp.setenv("MT_FEDERATION_DOMAIN", DOMAIN)
    mp.setenv("MT_FEDERATION_DNS_FILE", dns)
    return dns


@pytest.fixture
def fed_pair(tmp_path, monkeypatch):
    """(reference server, port server) on one DNS file."""
    _federate(monkeypatch, tmp_path)
    with servers(tmp_path, monkeypatch) as pair:
        yield pair


SERVERS = {"ref": 0, "port": 1}


def drop(c: S3Client, bucket: str) -> None:
    c.request("DELETE", f"/{bucket}", expect=(204,))


@pytest.mark.parametrize("owner", ["ref", "port"])
def test_a_name_belongs_to_one_server_and_redirects_to_it(fed_pair, owner):
    own = fed_pair[SERVERS[owner]]
    other = fed_pair[1 - SERVERS[owner]]
    co, cx = client(own), client(other)
    co.make_bucket("fedbkt")
    data = body(50_000, 7)
    co.put_object("fedbkt", "dir/obj", data)
    with pytest.raises(S3ClientError) as ei:
        cx.make_bucket("fedbkt")
    assert (ei.value.status, ei.value.code) == (409, "BucketAlreadyExists")
    for path, query in (("/fedbkt/dir/obj", ""),
                        ("/fedbkt", "list-type=2&prefix=dir%2F")):
        r = cx.request("GET", path, query, expect=(307,))
        loc = urllib.parse.urlsplit(r.headers["Location"])
        assert (loc.scheme, loc.hostname, loc.port, loc.path, loc.query) \
            == ("http", "127.0.0.1", own.port, path, query)
    # the redirect, followed, serves the owner's body
    loc = cx.request("GET", "/fedbkt/dir/obj", expect=(307,)).headers[
        "Location"]
    assert S3Client(loc.rsplit("/fedbkt/", 1)[0], AK, SK).get_object(
        "fedbkt", "dir/obj").body == data
    # the owner's duplicate make keeps its record
    with pytest.raises(S3ClientError) as ei:
        co.make_bucket("fedbkt")
    assert (ei.value.status, ei.value.code) == (409,
                                                "BucketAlreadyOwnedByYou")
    assert own.federation.store.get("fedbkt").port == own.port
    # DELETE bucket frees the name for the other server
    co.delete_object("fedbkt", "dir/obj")
    drop(co, "fedbkt")
    assert own.federation.store.get("fedbkt") is None
    cx.make_bucket("fedbkt")
    assert other.federation.store.get("fedbkt").port == other.port
    drop(cx, "fedbkt")


def test_both_answer_a_redirect_and_a_missing_bucket_alike(fed_pair):
    ref, port = fed_pair
    client(ref).make_bucket("on-ref")
    client(port).make_bucket("on-port")
    redirects = [client(x).request("GET", f"/{b}/k", "versionId=null",
                                   expect=())
                 for x, b in ((port, "on-ref"), (ref, "on-port"))]
    assert [(r.status, r.body, r.headers["Location"]) for r in redirects] \
        == [(307, b"", f"http://127.0.0.1:{ref.port}/on-ref/k?"
             "versionId=null"),
            (307, b"", f"http://127.0.0.1:{port.port}/on-port/k?"
             "versionId=null")]
    missing = [client(x).request("GET", "/nowhere/k", expect=())
               for x in (ref, port)]
    assert [(r.status, b"NoSuchBucket" in r.body) for r in missing] == \
        [(404, True)] * 2
    for x, b in ((ref, "on-ref"), (port, "on-port")):
        drop(client(x), b)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_a_failed_make_takes_its_record_back(fed_pair, monkeypatch, pkg):
    srv = fed_pair[SERVERS[pkg]]

    def broken(bucket, *a, **kw):
        raise OSError("drive gone")
    with monkeypatch.context() as mp:
        mp.setattr(srv.layer, "make_bucket", broken)
        r = client(srv).request("PUT", "/rollback", expect=())
    assert r.status == 500
    assert srv.federation.store.get("rollback") is None
    other = fed_pair[1 - SERVERS[pkg]]
    client(other).make_bucket("rollback")     # the name is free
    drop(client(other), "rollback")


# -- behind TLS fronts ---------------------------------------------------------


@pytest.fixture
def tls_pair(tmp_path, tmp_path_factory, monkeypatch):
    """(reference server, port server) with TLS fronts on one DNS file;
    both transport registries given back on exit."""
    pki = _pki.cluster_pki(tmp_path_factory)
    certs = pki.write_certs_dir(str(tmp_path / "certs"))
    monkeypatch.setenv("MT_TLS_ENABLE", "on")
    monkeypatch.setenv("MT_TLS_CERTS_DIR", certs)
    _federate(monkeypatch, tmp_path)
    prior = [(t, t.manager()) for t in (ref_transport, port_transport)]
    try:
        with servers(tmp_path, monkeypatch) as (ref, port):
            for srv in (ref, port):
                srv.test_ca = pki.ca_cert
            yield ref, port
    finally:
        for t, m in prior:
            t.configure(m)


def test_ref_redirect_from_a_tls_front_names_http(tls_pair):
    """``[ref]``: the reference's 307 names ``http://`` whatever its front
    serves, so the redirect from a TLS federation cannot be followed."""
    ref, port = tls_pair
    client(port).make_bucket("on-port")
    loc = client(ref).request("GET", "/on-port/k", expect=(307,)).headers[
        "Location"]
    assert loc == f"http://127.0.0.1:{port.port}/on-port/k"
    with pytest.raises((ConnectionError, OSError, S3ClientError)):
        S3Client(f"http://127.0.0.1:{port.port}", AK, SK,
                 timeout=5).get_object("on-port", "k")
    drop(client(port), "on-port")


def test_port_redirect_from_a_tls_front_keeps_https(tls_pair):
    ref, port = tls_pair
    c = client(ref)
    c.make_bucket("on-ref")
    data = body(30_000, 8)
    c.put_object("on-ref", "k", data)
    loc = client(port).request("GET", "/on-ref/k", expect=(307,)).headers[
        "Location"]
    assert loc == f"https://127.0.0.1:{ref.port}/on-ref/k"
    assert S3Client(loc.rsplit("/on-ref/", 1)[0], AK, SK,
                    ca_file=ref.test_ca).get_object("on-ref", "k").body \
        == data
    c.delete_object("on-ref", "k")
    drop(c, "on-ref")
