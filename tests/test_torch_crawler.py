"""The port's crawler (``minio_tpu_torch/background/crawler.py``)
against ``minio_tpu``'s: the same seeded buckets through both packages
with their clocks and ids pinned (``_torch_versions.pin``), then one
scan each with the same lifecycle configurations: the same usage,
byte-equal ``usage.json`` on every drive, the same expiries (current
versions, noncurrent versions dated from their successor, delete
markers left alone) and the same drives afterwards.  A Transition rule
takes no action in either.  Then a reference fault the port does not
carry: the reference's version listing counts no versions, so its
ExpiredObjectDeleteMarker rule removes a delete marker that still hides
an older version, and that version becomes the object again.  Then the
crawler's cycles, its tracker skip and pacing, and the hard quota's
``UsageCache``."""

import json

import pytest

from minio_tpu.background import crawler as ref_cr
from minio_tpu.background import tracker as ref_tr
from minio_tpu.objectlayer.bucket_meta import BucketMetadataSys as RefMeta
from minio_tpu_torch.background import crawler as port_cr
from minio_tpu_torch.background import tracker as port_tr
from minio_tpu_torch.objectlayer.bucket_meta import BucketMetadataSys

from ._torch_versions import (N, T0, assert_trees_equal, body, close,
                              is_port, obj_opts, pin, port_layer, put_opts,
                              ref_layer)

LIFECYCLE = (
    '<LifecycleConfiguration><Rule><ID>cur</ID><Status>Enabled</Status>'
    '<Filter><Prefix>cur/</Prefix></Filter><Expiration><Days>1</Days>'
    '</Expiration></Rule><Rule><ID>nc</ID><Status>Enabled</Status>'
    '<Filter><Prefix>nc/</Prefix></Filter><NoncurrentVersionExpiration>'
    '<NoncurrentDays>1</NoncurrentDays></NoncurrentVersionExpiration>'
    '</Rule><Rule><ID>dm</ID><Status>Enabled</Status><Filter><Prefix>dm/'
    '</Prefix></Filter><Expiration><ExpiredObjectDeleteMarker>true'
    '</ExpiredObjectDeleteMarker></Expiration></Rule><Rule><ID>tr</ID>'
    '<Status>Enabled</Status><Filter><Prefix>tr/</Prefix></Filter>'
    '<Transition><Days>1</Days><StorageClass>WARM</StorageClass>'
    '</Transition></Rule></LifecycleConfiguration>')


def _meta(er):
    return BucketMetadataSys(er) if is_port(er) else RefMeta(er)


def _fill(er, meta) -> None:
    """An unversioned bucket with current versions to expire and some to
    transition, a versioned one with noncurrent versions and delete
    markers, and a bucket without a configuration."""
    er.make_bucket("plain")
    er.make_bucket("vers")
    er.make_bucket("keep")
    for i in range(3):
        er.put_object("plain", f"cur/{i}", body(500 + i, i))
        er.put_object("plain", f"tr/{i}", body(300, i))
        er.put_object("plain", f"other/{i}", body(2000 + i, i))
        er.put_object("keep", f"cur/{i}", body(70_000, i))
    meta.set_config("plain", "lifecycle", LIFECYCLE)
    meta.set_versioning("vers", True)
    vopt = put_opts(er, versioned=True)
    for i in range(2):
        for v in range(3):
            er.put_object("vers", f"nc/{i}", body(100 * (v + 1), i), vopt)
    v1 = er.put_object("vers", "dm/alone", b"x", vopt)
    er.delete_object("vers", "dm/alone", obj_opts(er, versioned=True))
    er.delete_object("vers", "dm/alone",
                     obj_opts(er, version_id=v1.version_id))
    er.put_object("vers", "cur/v", b"z" * 10, vopt)
    meta.set_config("vers", "lifecycle", LIFECYCLE)


def _usage_files(root) -> list[bytes]:
    out = []
    for i in range(N):
        with open(f"{root}/d{i}/.mt.sys/datausage/usage.json", "rb") as f:
            out.append(f.read())
    return out


@pytest.fixture
def pinned(monkeypatch):
    pin(monkeypatch)
    for mod in (ref_cr, port_cr):
        monkeypatch.setattr(mod, "now_ns", lambda: T0 + 1)


def test_scan_expires_and_accounts_alike(tmp_path, pinned):
    """The same expiries, usage and drives but for ``vers/cur/v``: a
    current version expired in a versioned bucket gets a delete marker
    on the port, while the reference deletes the null version it does
    not hold and leaves the object (ROADMAP Queue 3 item 31); the bodies
    and the version list are the oracle there."""
    ref, port = ref_layer(tmp_path / "ref"), port_layer(tmp_path / "port")
    try:
        results = []
        for er, cr in ((ref, ref_cr), (port, port_cr)):
            meta = _meta(er)
            _fill(er, meta)
            res = cr.scan_usage(er, meta)
            cr.persist_usage(er, res.usage)
            results.append(res)
        want, got = results
        assert got.expired == want.expired
        assert sorted(got.expired) == sorted(
            [("plain", f"cur/{i}", "") for i in range(3)]
            + [e for e in want.expired if e[0] == "vers"])
        assert {e[1] for e in want.expired if e[0] == "vers"} == \
            {"nc/0", "nc/1", "dm/alone", "cur/v"}
        _assert_cur_v_marked(port)
        assert "cur/v" in [o.name for o in ref.list_objects("vers").objects]
        assert got.usage.to_json() == want.usage.to_json()
        assert _usage_files(tmp_path / "port") == \
            _usage_files(tmp_path / "ref")
        assert_trees_equal(tmp_path / "port", tmp_path / "ref",
                           skip={i: ["vers/cur/v"] for i in range(N)})
        u = got.usage.bucket_usage
        assert (u["keep"].objects_count, u["keep"].size) == (3, 3 * 70_000)
        # a rescan after the expiries: the port expires nothing new (the
        # reference expires "cur/v" again), and counts what is left as
        # the reference does, "cur/v" now noncurrent
        again = [cr.scan_usage(er, _meta(er))
                 for er, cr in ((ref, ref_cr), (port, port_cr))]
        assert again[0].expired == \
            [e for e in want.expired if e[1] == "cur/v"]
        assert again[1].expired == []
        _assert_cur_v_marked(port)
        r, p = (json.loads(a.usage.to_json()) for a in again)
        assert p["bucketsUsageInfo"]["vers"]["objectsCount"] == \
            r["bucketsUsageInfo"]["vers"]["objectsCount"] - 1
        assert p["objectsCount"] == r["objectsCount"] - 1
        for doc in (r, p):
            doc["bucketsUsageInfo"]["vers"].pop("objectsCount")
            doc.pop("objectsCount")
        assert p == r
        assert [o.name for o in port.list_objects("plain").objects] == \
            [f"other/{i}" for i in range(3)] + [f"tr/{i}" for i in range(3)]
    finally:
        close(ref, port)


def _assert_cur_v_marked(port) -> None:
    """``vers/cur/v``: a delete marker over its one version, whose body
    still reads by its version id."""
    assert "cur/v" not in [o.name for o in port.list_objects("vers").objects]
    vs = [o for o in port.list_object_versions("vers", "cur/v").objects
          if o.name == "cur/v"]
    assert [(o.delete_marker, o.is_latest) for o in vs] == \
        [(True, True), (False, False)]
    _, data = port.get_object("vers", "cur/v",
                              opts=obj_opts(port, version_id=vs[1].version_id))
    assert data == b"z" * 10


@pytest.mark.parametrize("name", ["ref", "port"])
def test_versioned_expiry_writes_a_delete_marker(tmp_path, pinned, name):
    """Queue 3 item 31: an Expiration rule on a current version in a
    versioned bucket writes a delete marker (S3's expiry); the older
    body stays readable by its version id and a second cycle expires
    nothing.  The reference deletes the null version, which the bucket
    does not hold: no marker, the version stays current, and the expiry
    recurs every cycle."""
    make, cr = (ref_layer, ref_cr) if name == "ref" else (port_layer,
                                                           port_cr)
    er = make(tmp_path / name)
    try:
        meta = _meta(er)
        er.make_bucket("vers")
        meta.set_versioning("vers", True)
        vopt = put_opts(er, versioned=True)
        old = er.put_object("vers", "cur/x", body(3000, 1), vopt)
        new = er.put_object("vers", "cur/x", body(5000, 2), vopt)
        meta.set_config("vers", "lifecycle", LIFECYCLE)
        cycles = [cr.scan_usage(er, meta).expired for _ in range(2)]
        listed = [o.name for o in er.list_objects("vers").objects]
        out = er.list_object_versions("vers")
        rows = [(o.version_id, o.delete_marker, o.is_latest)
                for o in getattr(out, "objects", out)]
        for oi, size, seed in ((old, 3000, 1), (new, 5000, 2)):
            _, data = er.get_object(
                "vers", "cur/x",
                opts=obj_opts(er, version_id=oi.version_id))
            assert data == body(size, seed)
    finally:
        close(er)
    first = [("vers", "cur/x", new.version_id)]
    if name == "ref":
        assert cycles == [first, first], "reference fault gone"
        assert listed == ["cur/x"]
        return
    assert cycles == [first, []]
    assert listed == []
    assert [r[1:] for r in rows] == [(True, True), (False, False),
                                     (False, False)]
    assert [r[0] for r in rows[1:]] == [new.version_id, old.version_id]


def test_a_marker_over_an_older_version_is_kept(tmp_path, pinned):
    """A delete marker with an older version behind it is not an expired
    marker: the port keeps it, and the object stays deleted; the
    reference removes it (its listing says the marker is the only
    version), and the older version is served again."""
    got = {}
    for name, make, cr in (("ref", ref_layer, ref_cr),
                           ("port", port_layer, port_cr)):
        er = make(tmp_path / name)
        try:
            meta = _meta(er)
            er.make_bucket("vers")
            meta.set_versioning("vers", True)
            er.put_object("vers", "dm/kept", b"y", put_opts(er,
                                                            versioned=True))
            er.delete_object("vers", "dm/kept",
                             obj_opts(er, versioned=True))
            meta.set_config("vers", "lifecycle", LIFECYCLE)
            res = cr.scan_usage(er, meta)
            got[name] = ([e[1] for e in res.expired],
                         [o.name for o in er.list_objects("vers").objects])
        finally:
            close(er)
    assert got["ref"] == (["dm/kept"], ["dm/kept"]), "reference fault gone"
    assert got["port"] == ([], [])


def test_usage_json_reads_across(tmp_path, pinned):
    ref, port = ref_layer(tmp_path / "ref"), port_layer(tmp_path / "port")
    try:
        for er, cr in ((ref, ref_cr), (port, port_cr)):
            _fill(er, _meta(er))
            cr.persist_usage(er, cr.scan_usage(er, None).usage)
        a = port_cr.load_usage(port)
        b = ref_cr.load_usage(ref)
        assert a.to_json() == b.to_json()
        assert port_cr.DataUsageInfo.from_json(b.to_json()).to_json() == \
            b.to_json()
        assert a.bucket_usage["vers"].versions_count == \
            b.bucket_usage["vers"].versions_count > 0
    finally:
        close(ref, port)


def test_crawler_cycles_skip_unchanged_buckets(tmp_path, pinned):
    """The reference's second cycle skips the lifecycle pass of a bucket
    the tracker saw no change in, though ``cur/a`` (written at the
    pinned 2025 clock) is due under the real one; the port evaluates the
    rules of every bucket and expires it there (ROADMAP Queue 3 item
    49).  A marked bucket is scanned in both, and the cycle and tracker
    counts agree."""
    ref, port = ref_layer(tmp_path / "ref"), port_layer(tmp_path / "port")
    try:
        out = []
        for er, cr, tr in ((ref, ref_cr, ref_tr), (port, port_cr, port_tr)):
            meta = _meta(er)
            er.make_bucket("cyc")
            crawler = cr.Crawler(er, bucket_meta=meta, interval_s=3600,
                                 tracker=tr.DataUpdateTracker(bits=1 << 12))
            crawler.run_cycle()
            er.put_object("cyc", "cur/a", b"a")
            meta.set_config("cyc", "lifecycle", LIFECYCLE)
            skipped = crawler.run_cycle()
            crawler.tracker.mark("cyc", "cur/a")
            crawler.run_cycle()      # changed since: the old cycle is kept
            done = crawler.run_cycle()
            out.append((skipped.expired, done.expired, crawler.cycles,
                        crawler.tracker.cycle,
                        crawler.progress.snapshot()["lastCycle"]["objects"]))
        assert out[0][0] == []                      # [ref] item 49
        assert out[1][0] == [("cyc", "cur/a", "")]
        assert out[1][1:] == out[0][1:]
        assert out[1][2] == 4
    finally:
        close(ref, port)


def test_crawler_thread_and_pacing(tmp_path):
    port = port_layer(tmp_path)
    try:
        port.make_bucket("thr")
        c = port_cr.Crawler(port, interval_s=0.01)
        c.delay_mult, c.max_wait_s, c._last_cycle_s = 10.0, 0.05, 1.0
        assert c._wait_s() == pytest.approx(0.06)
        c.delay_mult = 0.0
        cache = port_cr.UsageCache()
        c.usage_cache = cache
        c.start()
        try:
            import time
            deadline = time.monotonic() + 10
            while c.cycles == 0 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            c.stop()
        assert c.cycles >= 1 and not c._thread.is_alive()
        assert cache.info is not None and "thr" in cache.info.bucket_usage
    finally:
        close(port)


def test_usage_cache_alike(tmp_path, pinned, monkeypatch):
    ref, port = ref_layer(tmp_path / "ref"), port_layer(tmp_path / "port")
    try:
        caches = []
        for er, cr in ((ref, ref_cr), (port, port_cr)):
            er.make_bucket("qua")
            er.put_object("qua", "a", b"a" * 1000)
            cache = cr.UsageCache(er, reload_ttl_s=3600)
            assert cache.bucket_size("qua") == 0      # no snapshot yet
            cr.persist_usage(er, cr.scan_usage(er, None).usage)
            cache.add_pending("qua", 10)
            cache.add_pending("qua", 0)
            before = cache.bucket_size("qua")          # not reloaded yet
            cache._loaded_at = float("-inf")
            caches.append((before, cache.bucket_size("qua"),
                           cache.snapshot_doc()))
        assert caches[1] == caches[0]
        assert caches[1][:2] == (10, 1000)
    finally:
        close(ref, port)


def test_a_reread_of_the_same_usage_keeps_the_writes_since(tmp_path,
                                                           pinned):
    """The quota view re-reads usage.json when no cycle refreshed it: the
    port keeps the writes charged since that snapshot; the reference
    forgets them, so a bucket can pass its hard quota between cycles."""
    got = {}
    for name, make, cr in (("ref", ref_layer, ref_cr),
                           ("port", port_layer, port_cr)):
        er = make(tmp_path / name)
        try:
            er.make_bucket("qua")
            cr.persist_usage(er, cr.scan_usage(er, None).usage)
            cache = cr.UsageCache(er, reload_ttl_s=3600)
            cache.add_pending("qua", 500)
            cache._loaded_at = float("-inf")     # the re-read is due
            got[name] = cache.bucket_size("qua")
            cr.persist_usage(er, cr.DataUsageInfo(last_update_ns=T0 + 9))
            cache._loaded_at = float("-inf")     # a newer snapshot lands
            got[name] = (got[name], cache.bucket_size("qua"))
        finally:
            close(er)
    assert got["ref"] == (0, 0), "reference fault gone"
    assert got["port"] == (500, 0)
