"""The pools' control plane on the two servers: ``minio_tpu``'s and the
port's S3 servers each over its own package's server pools (built as
``minio_tpu/soak/chaos.py`` builds them: pool 0, a crawler and a
rebalancer attached), with clocks, uuid draws and free space pinned
(``_torch_pools``).  The five pool routes, ``storageinfo``'s pools rows,
``background-status``'s rebalance, the ``rebalance`` kvconfig and the
``mt_rebalance_*`` and ``mt_pool_usage_*`` families answer alike; a
decommission over HTTP drains alike; on a sets layer the pool routes
answer 400 alike."""

import contextlib
import json
import os
import time

import pytest

from minio_tpu.background import crawler as ref_cr
from minio_tpu.background import rebalance as ref_rb
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.background import crawler as port_cr
from minio_tpu_torch.background import rebalance as port_rb
from minio_tpu_torch.s3.server import S3Server

from ._torch_control import AK, SK, both, client, servers
from ._torch_pools import GIB, PER, Deployment, pin_all, pool_dirs
from ._torch_versions import T0, body

ADMIN = "/minio-tpu/admin/v1"
FREES = [2 * GIB, 5 * GIB, 3 * GIB]
VOLATILE = {"node", "elapsedSeconds", "objectsPerSecond", "bytesPerSecond",
            "durationNs", "etaSeconds", "lastCycle"}
# the reference's layout arguments; the port reads the same and records
# ``backend`` without reading it
POOL_KW = {"backend": "numpy", "parity": 2, "block_size": 4096,
           "enforce_min_part_size": False}


@contextlib.contextmanager
def pool_servers(root, mp: pytest.MonkeyPatch):
    """(reference server, port server) over pools, started; stopped on
    exit with every pool they held closed."""
    mp.setenv("MT_CACHE_ENABLE", "off")
    pin_all(mp)
    for mod in (ref_cr, port_cr):
        mp.setattr(mod, "now_ns", lambda: T0 + 7)
    deps, srvs = [], []
    try:
        for tag, port, srv_cls, cr, rb in (
                ("ref", False, RefServer, ref_cr, ref_rb),
                ("port", True, S3Server, port_cr, port_rb)):
            dep = Deployment(root / tag, port, FREES, mp)
            deps.append(dep)
            srv = srv_cls(dep.layer, access_key=AK, secret_key=SK,
                          host="127.0.0.1", port=0)
            srvs.append(srv)
            srv.iam.load()
            srv.crawler = cr.Crawler(dep.layer, bucket_meta=srv.bucket_meta,
                                     interval_s=1e6)
            rebalancer = rb.Rebalancer(dep.layer, interval_s=3600.0)
            if port:
                srv.attach_background(srv.crawler, rebalancer=rebalancer)
            else:               # the reference's chaos harness
                srv.rebalancer = rebalancer
                srv.attach_background(rebalancer, srv.crawler)
            srv.start()
        yield tuple(srvs)
    finally:
        for srv in reversed(srvs):
            srv.stop()
        for dep in deps:
            dep.close()


@pytest.fixture
def pair(tmp_path, monkeypatch):
    with pool_servers(tmp_path, monkeypatch) as srvs:
        yield srvs


def _json(resp):
    return json.loads(resp.body)


def _mask(doc, root=None):
    """Volatile fields starred, drive paths relative to their root."""
    if isinstance(doc, dict):
        return {k: "*" if k in VOLATILE else
                [os.path.relpath(d, root) for d in v] if k == "dirs" else
                _mask(v, root) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask(v, root) for v in doc]
    return doc


def _adm(srv) -> AdminClient:
    return AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK)


def _alike(ref, port, method, route, query="", payload=b"", status=200,
           tmp=None):
    r, p = both(ref, port, method, f"{ADMIN}/{route}", query, payload)
    assert r.status == p.status == status, (route, r.status, p.status,
                                            p.body[:200])
    if status != 200:
        return None
    roots = (tmp / "ref", tmp / "port") if tmp is not None else (None, None)
    want, got = (_mask(_json(x), str(rt)) if rt else _mask(_json(x))
                 for x, rt in ((r, roots[0]), (p, roots[1])))
    assert got == want, route
    return got


def _add_pool(srv, root, j) -> dict:
    return _adm(srv).pool_add(pool_dirs(root, j), 1, PER, **POOL_KW)


def test_pool_routes_answer_alike(pair, tmp_path, monkeypatch):
    ref, port = pair
    st = _alike(ref, port, "GET", "pool-status", tmp=tmp_path)
    assert [p["status"] for p in st["pools"]] == ["active"]
    for srv, tag in ((ref, "ref"), (port, "port")):
        c = client(srv)
        c.make_bucket("bkt")
        for i in range(4):
            c.put_object("bkt", f"a{i}", body(500 + i, i))
        assert _add_pool(srv, tmp_path / tag, 1) == {"status": "ok",
                                                     "pool": 1}
        for i in range(8):
            c.put_object("bkt", f"b{i}", body(700 + i, i))
    st = _alike(ref, port, "GET", "pool-status", tmp=tmp_path)
    assert len(st["pools"]) == 2
    r, p = both(ref, port, "GET", f"{ADMIN}/storageinfo")
    want, got = _json(r), _json(p)
    assert _mask(got["pools"], str(tmp_path / "port")) == \
        _mask(want["pools"], str(tmp_path / "ref"))
    assert len(got["disks"]) == len(want["disks"]) == 2 * PER
    _alike(ref, port, "GET", "rebalance-status")
    got = _alike(ref, port, "GET", "background-status")
    assert got["rebalance"]["stats"]["movedObjects"] == 0
    # refusals
    for query in ("pool=0", "pool=7", "pool=nosuch"):
        _alike(ref, port, "POST", "pool-decommission", query, status=400)
    _alike(ref, port, "POST", "pool-decommission-abort", "pool=1",
           status=400)
    _alike(ref, port, "POST", "pool-decommission", "", status=400)
    # a decommission started and aborted, the loop not woken
    for mod in (ref_rb, port_rb):
        monkeypatch.setattr(mod.Rebalancer, "kick", lambda self: None)
    assert _alike(ref, port, "POST", "pool-decommission", "pool=1") == \
        {"status": "draining", "pool": 1}
    st = _alike(ref, port, "GET", "pool-status", tmp=tmp_path)
    assert st["pools"][1]["status"] == "draining"
    assert _alike(ref, port, "GET", "rebalance-status")["draining"] == \
        [st["pools"][1]["id"]]
    pid = st["pools"][1]["id"]
    assert _alike(ref, port, "POST", "pool-decommission-abort",
                  f"pool={pid}") == {"status": "active", "pool": 1}
    # a crawler cycle: per-pool usage in pool-status and the scrape
    for srv in pair:
        srv.crawler.run_cycle()
    st = _alike(ref, port, "GET", "pool-status", tmp=tmp_path)
    assert sum(p["objects"] for p in st["pools"]) == 12
    assert sum(p["usedBytes"] for p in st["pools"]) == \
        sum(500 + i for i in range(4)) + sum(700 + i for i in range(8))
    _alike(ref, port, "GET", "datausageinfo")


def _families(text: str, prefixes: tuple) -> dict:
    out = {}
    for ln in text.splitlines():
        if ln.startswith(prefixes) and "_per_second" not in ln:
            name, _, value = ln.rpartition(" ")
            out[name] = float(value)
    return out


def test_a_decommission_over_http_drains_alike(pair, tmp_path):
    """``rebalance enable`` on through the admin API; pool 1 drained by
    the woken loop and retired; the moved counts, the scrape's families
    and every body alike."""
    ref, port = pair
    bodies = {}
    for srv, tag in ((ref, "ref"), (port, "port")):
        c = client(srv)
        c.make_bucket("bkt")
        _add_pool(srv, tmp_path / tag, 1)
        _add_pool(srv, tmp_path / tag, 2)
        c.set_bucket_versioning("bkt", True)
        for i in range(10):
            bodies[f"k{i}"] = body(900 + i, i)
            c.put_object("bkt", f"k{i}", bodies[f"k{i}"])
        c.delete_object("bkt", "k3")
        _adm(srv).set_config_kv("rebalance", "enable", "on")
        assert srv.rebalancer.enabled
    held = [o.name for o in port.layer.pools[1].list_objects("bkt").objects]
    assert len(held) >= 4
    _alike(ref, port, "POST", "pool-decommission", "pool=1")
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and \
            (len(ref.layer.pools) == 3 or len(port.layer.pools) == 3):
        time.sleep(0.05)
    assert len(ref.layer.pools) == len(port.layer.pools) == 2
    st = _alike(ref, port, "GET", "rebalance-status")
    assert st["stats"]["movedObjects"] >= len(held) - 1
    assert st["draining"] == []
    for srv in pair:
        c = client(srv)
        for name, data in bodies.items():
            if name != "k3":
                assert c.get_object("bkt", name).body == data
        srv.crawler.run_cycle()
    fams = ("mt_rebalance_", "mt_pool_usage_")
    r, p = both(ref, port, "GET", "/minio-tpu/metrics")
    got, want = _families(p.body.decode(), fams), \
        _families(r.body.decode(), fams)
    assert got == want
    assert got["mt_rebalance_moved_objects_total"] == \
        st["stats"]["movedObjects"]
    assert len([k for k in got if k.startswith("mt_pool_usage_bytes")]) == 2


def test_the_rebalance_config_alike_and_live(pair, tmp_path):
    ref, port = pair
    got = _alike(ref, port, "GET", "config/rebalance")
    assert got == {"enable": "off", "max_workers": "1", "bandwidth": "0"}
    r, p = both(ref, port, "PUT", f"{ADMIN}/config/rebalance/nosuch",
                body=b"1")
    assert r.status == p.status != 200
    for srv in pair:
        adm = _adm(srv)
        adm.set_config_kv("rebalance", "max_workers", "3")
        adm.set_config_kv("rebalance", "bandwidth", "1048576")
        adm.set_config_kv("heal", "max_sleep", "250ms")
        rb = srv.rebalancer
        assert (rb.max_workers, rb.bandwidth_bps, rb.pace_s,
                rb.enabled) == (3, 1 << 20, 0.25, False)
    got = _alike(ref, port, "GET", "rebalance-status")
    assert got["bandwidth"] == {"limitInBytesPerSecond": 1 << 20,
                                "totalBytesMoved": 0}
    # the pipeline knobs reach every set of every pool
    _add_pool(port, tmp_path / "port", 1)
    adm = _adm(port)
    adm.set_config_kv("pipeline", "depth", "0")
    assert [s._pipe_depth for p in port.layer.pools for s in p.sets] == \
        [0, 0]
    adm.set_config_kv("pipeline", "depth", "2")


def test_on_a_sets_layer_the_pool_routes_answer_400(tmp_path, monkeypatch):
    with servers(tmp_path, monkeypatch) as (ref, port):
        for method, route, query in (
                ("GET", "pool-status", ""), ("POST", "pool-add", ""),
                ("POST", "pool-decommission", "pool=1"),
                ("POST", "pool-decommission-abort", "pool=1")):
            r, p = both(ref, port, method, f"{ADMIN}/{route}", query,
                        b'{"dirs": [], "setCount": 1, "setDriveCount": 4}')
            assert r.status == p.status == 400
            assert _json(p) == _json(r) == \
                {"error": "not a pooled deployment"}
        r, p = both(ref, port, "GET", f"{ADMIN}/rebalance-status")
        assert r.status == p.status == 200 and _json(p) is _json(r) is None
        r, p = both(ref, port, "GET", f"{ADMIN}/storageinfo")
        assert "pools" not in _json(p) and "pools" not in _json(r)
