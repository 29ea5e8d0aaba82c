"""The usage plane of the two servers, each built by its own package's
``build_server`` (``_torch_control``): the crawler and the data-update
tracker started with the server, ``datausageinfo``, ``data-usage`` and
``background-status`` answered alike after the same writes and one
crawler cycle each, the ``scanner`` and ``quota`` kvconfig subsystems
(defaults, live changes, refusals), S3 ``?lifecycle`` and the new metric
families (``mt_cluster_usage_*``, ``mt_bucket_usage_*``,
``mt_bucket_objects_size_distribution``, ``mt_scanner_*``)."""

import json

import pytest

from minio_tpu.background import crawler as ref_cr
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.background import crawler as port_cr

from ._torch_control import AK, SK, both, client, servers
from ._torch_versions import T0, body

ADMIN = "/minio-tpu/admin/v1"
# what depends on the wall clock or the listener's port
VOLATILE = {"node", "elapsedSeconds", "objectsPerSecond", "bytesPerSecond",
            "durationNs", "etaSeconds"}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for mod in (ref_cr, port_cr):
        mp.setattr(mod, "now_ns", lambda: T0 + 7)
    with servers(tmp_path_factory.mktemp("usage"), mp) as (ref, port):
        yield ref, port
    mp.undo()


def _json(resp):
    return json.loads(resp.body)


def _mask(doc):
    if isinstance(doc, dict):
        return {k: "*" if k in VOLATILE else _mask(v)
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask(v) for v in doc]
    return doc


def _adm(srv) -> AdminClient:
    return AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK)


def test_server_starts_the_crawler_and_tracker(pair):
    _, port = pair
    assert port.crawler is not None and port.crawler._thread.is_alive()
    assert port.crawler.tracker is port.tracker
    assert port.crawler.usage_cache is port.usage
    assert all(s.metacache.tracker is port.tracker
               for s in port.layer.sets)
    assert port.crawler.interval_s == 1_000_000   # MT_CRAWL_INTERVAL_S


def test_usage_routes_alike(pair):
    ref, port = pair
    r, p = both(ref, port, "GET", f"{ADMIN}/datausageinfo")
    assert r.status == p.status == 404
    for srv in pair:
        c = client(srv)
        for b in ("usea", "useb"):
            c.make_bucket(b)
        for i in range(5):
            c.put_object("usea", f"k{i}", body(300 * i + 1, i))
        c.put_object("useb", "big", body(1_100_000, 9))
        c.set_bucket_versioning("useb", True)
        c.put_object("useb", "big", body(2000, 8))
        srv.crawler.run_cycle()
    r, p = both(ref, port, "GET", f"{ADMIN}/datausageinfo")
    assert r.status == p.status == 200
    assert _json(p) == _json(r)
    doc = _json(p)
    assert doc["bucketsUsageInfo"]["useb"]["versionsCount"] == 2
    assert doc["objectsTotalSize"] == sum(300 * i + 1 for i in range(5)) \
        + 1_100_000 + 2000
    for srv in pair:
        client(srv).put_object("usea", "late", b"x" * 77)
    r, p = both(ref, port, "GET", f"{ADMIN}/data-usage")
    assert r.status == p.status == 200
    assert _json(p) == _json(r)
    assert _json(p)["cache"]["pendingBytes"] == {"usea": 77}


def test_background_status_alike(pair):
    ref, port = pair
    r, p = both(ref, port, "GET", f"{ADMIN}/background-status")
    assert r.status == p.status == 200
    got, want = _json(p), _json(r)
    assert _mask(got) == _mask(want)
    assert got["scanner"]["cycles"] >= 1
    assert got["replication"] is got["mrf"] is got["rebalance"] is None


@pytest.mark.parametrize("subsys", ["scanner", "quota"])
def test_config_subsystems_alike(pair, subsys):
    ref, port = pair
    r, p = both(ref, port, "GET", f"{ADMIN}/config/{subsys}")
    assert r.status == p.status == 200
    assert _json(p) == _json(r)
    r, p = both(ref, port, "PUT", f"{ADMIN}/config/{subsys}/nosuch",
                body=b"1")
    assert r.status == p.status != 200


def test_scanner_knobs_are_live(pair):
    for srv in pair:
        adm = _adm(srv)
        adm.set_config_kv("scanner", "delay", "2.5")
        adm.set_config_kv("scanner", "max_wait", "3s")
    try:
        for srv in pair:
            assert (srv.crawler.delay_mult, srv.crawler.max_wait_s) == \
                (2.5, 3.0)
    finally:
        for srv in pair:
            adm = _adm(srv)
            adm.set_config_kv("scanner", "delay", "10")
            adm.set_config_kv("scanner", "max_wait", "15s")


FAMILIES = ("mt_cluster_usage_object_total", "mt_cluster_usage_total_bytes",
            "mt_cluster_usage_last_update_timestamp_seconds",
            "mt_bucket_usage_total_bytes", "mt_bucket_usage_object_total",
            "mt_bucket_usage_version_total",
            "mt_bucket_objects_size_distribution", "mt_scanner_cycles_total",
            "mt_scanner_cycle_objects", "mt_scanner_cycle_active")


def test_metric_families_alike(pair):
    ref, port = pair
    r, p = both(ref, port, "GET", "/minio-tpu/metrics", sign=False)
    assert r.status == p.status == 200

    def fam(text: bytes, name: str) -> list[str]:
        return [ln for ln in text.decode().splitlines()
                if ln.split("{")[0].split(" ")[0] == name
                or ln == f"# TYPE {name} gauge"
                or ln == f"# TYPE {name} counter"]

    for name in FAMILIES:
        got, want = fam(p.body, name), fam(r.body, name)
        assert got == want and len(got) >= 2, name
    assert 'mt_bucket_usage_total_bytes{bucket="usea"}' in p.body.decode()


def test_lifecycle_config_alike(pair):
    ref, port = pair
    doc = (b'<LifecycleConfiguration><Rule><ID>x</ID><Status>Enabled'
           b'</Status><Filter><Prefix>exp/</Prefix></Filter><Expiration>'
           b'<Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>'
           b'</LifecycleConfiguration>')
    r, p = both(ref, port, "GET", "/usea", "lifecycle")
    assert r.status == p.status == 404
    assert p.xml().findtext("Code") == r.xml().findtext("Code")
    r, p = both(ref, port, "PUT", "/usea", "lifecycle", doc)
    assert r.status == p.status == 200
    r, p = both(ref, port, "GET", "/usea", "lifecycle")
    assert r.status == p.status == 200 and p.body == r.body
    r, p = both(ref, port, "PUT", "/usea", "lifecycle", b"<bad")
    assert r.status == p.status == 400
    assert p.xml().findtext("Code") == r.xml().findtext("Code")
    r, p = both(ref, port, "DELETE", "/usea", "lifecycle")
    assert r.status == p.status == 204
    r, p = both(ref, port, "GET", "/usea", "lifecycle")
    assert r.status == p.status == 404
