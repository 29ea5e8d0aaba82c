"""The port's listing metacache (``minio_tpu_torch/objectlayer/
metacache.py``) against ``minio_tpu``'s: ``tests/test_metacache.py``'s
cases run through both packages (pages, delimiters, invalidation, TTL,
persisted blocks reused by a new layer, ``SnapshotGone`` and its
re-walk), then the same seeded sequence through both with their clocks
and ids pinned (``_torch_versions.pin``): equal pages and equal
``.mt.sys/metacache/`` trees, each package reading the blocks and
manifest the other wrote, the generation guard, the ``listing`` memory
shed (503 from both servers), and the reference fault the port does not
carry: ``delete_bucket`` leaves the reference's cached listing behind."""

import os
import shutil

import pytest

from minio_tpu.objectlayer import interface as ref_ol
from minio_tpu.objectlayer import metacache as ref_mc
from minio_tpu.utils import memgov as ref_mg
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.objectlayer import metacache as port_mc
from minio_tpu_torch.utils import memgov as port_mg

from ._torch_control import both, client, servers
from ._torch_versions import (N, body, close, is_port, pin, port_layer,
                              ref_layer)

PKGS = ["ref", "port"]


@pytest.fixture(params=PKGS)
def lay(request, tmp_path):
    er = (port_layer if request.param == "port" else ref_layer)(tmp_path)
    er.make_bucket("bkt")
    yield er
    close(er)


def _names(res) -> list[str]:
    return [o.name for o in res.objects]


def _mc(er):
    return port_mc if is_port(er) else ref_mc


# -- tests/test_metacache.py, through both packages ----------------------------

def test_listing_cached_and_invalidated(lay):
    for k in ["a/1", "a/2", "b/1"]:
        lay.put_object("bkt", k, b"x")
    base = lay.metacache.misses
    assert _names(lay.list_objects("bkt")) == ["a/1", "a/2", "b/1"]
    assert lay.metacache.misses == base + 1
    lay.list_objects("bkt", max_keys=2)
    assert lay.metacache.hits >= 1 and lay.metacache.misses == base + 1
    lay.put_object("bkt", "c/9", b"y")
    assert _names(lay.list_objects("bkt")) == ["a/1", "a/2", "b/1", "c/9"]
    assert lay.metacache.misses == base + 2
    lay.delete_object("bkt", "a/1")
    assert _names(lay.list_objects("bkt")) == ["a/2", "b/1", "c/9"]


def test_pagination_served_from_one_snapshot(lay):
    for i in range(10):
        lay.put_object("bkt", f"k{i:02d}", b"d")
    base = lay.metacache.misses
    marker, got, pages = "", [], 0
    while True:
        res = lay.list_objects("bkt", marker=marker, max_keys=3)
        got += _names(res)
        pages += 1
        if not res.is_truncated:
            break
        marker = res.next_marker
    assert got == [f"k{i:02d}" for i in range(10)] and pages == 4
    assert lay.metacache.misses == base + 1


def test_delimiter_pagination_no_duplicate_prefixes(lay):
    for k in ["a/1", "a/2", "a/3", "b/1", "c", "d/9"]:
        lay.put_object("bkt", k, b"d")
    prefixes, keys, marker, pages = [], [], "", 0
    while True:
        res = lay.list_objects("bkt", delimiter="/", marker=marker,
                               max_keys=1)
        prefixes += res.prefixes
        keys += _names(res)
        pages += 1
        assert pages < 20
        if not res.is_truncated:
            break
        marker = res.next_marker
    assert prefixes == ["a/", "b/", "d/"] and keys == ["c"]


@pytest.mark.parametrize("pkg", PKGS)
def test_cache_ttl_expiry(pkg):
    mc = port_mc if pkg == "port" else ref_mc
    ol = port_ol if pkg == "port" else ref_ol
    calls = {"n": 0}

    def loader():
        calls["n"] += 1
        return iter([ol.ObjectInfo(name="k")])

    mgr = mc.MetacacheManager()
    mgr.list_path_stream("bkt", "", loader)
    mgr.list_path_stream("bkt", "", loader)
    assert calls["n"] == 1
    mgr._caches[("bkt", "")].created -= mc.DEFAULT_TTL + 1
    mgr.list_path_stream("bkt", "", loader)
    assert calls["n"] == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_blocked_pagination_loads_one_block_per_page(tmp_path, pkg):
    mc = port_mc if pkg == "port" else ref_mc
    ol = port_ol if pkg == "port" else ref_ol
    from minio_tpu.storage.xl_storage import XLStorage as RefStorage
    from minio_tpu_torch.storage.xl_storage import XLStorage
    os.makedirs(tmp_path / "d0")
    disk = (XLStorage if pkg == "port" else RefStorage)(str(tmp_path / "d0"))
    mgr = mc.MetacacheManager(disks=[disk], sys_volume=".mt.sys",
                              block_entries=10, cache_blocks=2)
    names = [f"k{i:04d}" for i in range(95)]
    snap = mgr.list_path_stream(
        "bkt", "", lambda: iter([ol.ObjectInfo(name=n) for n in names]))
    assert len(snap.block_keys) == 10 and snap.block_keys[0] == "k0009"
    got, marker, pages = [], "", 0
    while True:
        res = mc.paginate(snap.iter_from(marker), "", marker, "", 7)
        got += _names(res)
        pages += 1
        assert pages < 30
        if not res.is_truncated:
            break
        marker = res.next_marker
    assert got == names and len(snap._blocks) <= mgr.cache_blocks


def test_snapshot_gone_recovers_with_rewalk(lay):
    lay.metacache.block_entries = 4
    lay.metacache.cache_blocks = 1
    for i in range(20):
        lay.put_object("bkt", f"o{i:03d}", b"x")
    assert _names(lay.list_objects("bkt", max_keys=4)) == \
        [f"o{i:03d}" for i in range(4)]
    for d in lay.disks:
        shutil.rmtree(os.path.join(d.root, ".mt.sys", "metacache"),
                      ignore_errors=True)
    with pytest.raises(_mc(lay).SnapshotGone):
        list(lay.metacache.list_path_stream("bkt", "", iter).iter_from("o009"))
    res = lay.list_objects("bkt", marker="o009", max_keys=100)
    assert _names(res) == [f"o{i:03d}" for i in range(10, 20)]


def test_cache_persisted_across_instances(tmp_path, monkeypatch):
    pin(monkeypatch, shared=True)
    for make in (ref_layer, port_layer):
        root = tmp_path / make.__name__
        er1 = make(root)
        er1.make_bucket("pbkt")
        er1.put_object("pbkt", "x/1", b"1")
        er1.list_objects("pbkt")
        close(er1)
        er2 = make(root)
        try:
            assert _names(er2.list_objects("pbkt")) == ["x/1"]
            assert (er2.metacache.misses, er2.metacache.hits) == (0, 1)
        finally:
            close(er2)


# -- the two packages on the same sequence -------------------------------------

KEYS = [f"{p}/{i:03d}" for p in ("a", "b/c", "d") for i in range(9)] + \
    ["top", "z-1", "z/1"]


def _fill(er) -> None:
    er.make_bucket("eqb")
    for i, k in enumerate(KEYS):
        er.put_object("eqb", k, body(100 + 37 * i, i))
    er.delete_object("eqb", "a/004")


def _pages(er, prefix="", delimiter="", max_keys=4) -> list:
    out, marker = [], ""
    while True:
        res = er.list_objects("eqb", prefix, marker, delimiter, max_keys)
        out.append(([(o.name, o.size, o.etag, o.mod_time, o.user_defined,
                      o.parts) for o in res.objects], res.prefixes,
                    res.is_truncated, res.next_marker))
        if not res.is_truncated:
            return out
        marker = res.next_marker


def _cache_tree(root) -> dict:
    out = {}
    for i in range(N):
        base = f"{root}/d{i}/.mt.sys/metacache"
        for dirpath, _, files in os.walk(base):
            for f in files:
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[(i, os.path.relpath(os.path.join(dirpath, f),
                                            base))] = fh.read()
    return out


@pytest.mark.parametrize("prefix,delimiter", [("", ""), ("", "/"),
                                              ("b/", ""), ("b/c/", "/")])
def test_pages_and_blocks_equal(tmp_path, monkeypatch, prefix, delimiter):
    pin(monkeypatch)
    ref, port = ref_layer(tmp_path / "ref"), port_layer(tmp_path / "port")
    try:
        for er in (ref, port):
            er.metacache.block_entries = 5
            _fill(er)
        assert _pages(port, prefix, delimiter) == \
            _pages(ref, prefix, delimiter)
        got, want = _cache_tree(tmp_path / "port"), \
            _cache_tree(tmp_path / "ref")
        assert want and sorted(got) == sorted(want)
        for path in want:
            assert got[path] == want[path], path
    finally:
        close(ref, port)


@pytest.mark.parametrize("writer", PKGS)
def test_each_reads_the_others_blocks(tmp_path, monkeypatch, writer):
    pin(monkeypatch, shared=True)
    make_w, make_r = (ref_layer, port_layer) if writer == "ref" \
        else (port_layer, ref_layer)
    w = make_w(tmp_path)
    w.metacache.block_entries = 5
    _fill(w)
    want = _pages(w)
    close(w)
    r = make_r(tmp_path)
    r.metacache.block_entries = 5
    try:
        assert _pages(r) == want
        assert (r.metacache.misses, r.metacache.hits) == (0, len(want))
    finally:
        close(r)


def test_generation_guard(lay):
    """A walk that a mutation overlaps serves its caller, and is neither
    cached nor left on the drives: the next listing walks again."""
    lay.put_object("bkt", "g1", b"1")
    inner = lay._gather_listing_iter

    def racing(bucket, prefix, after=""):
        for oi in inner(bucket, prefix):
            yield oi
        lay.put_object("bkt", "g2", b"2")        # lands mid-walk

    lay._gather_listing_iter = racing
    try:
        assert _names(lay.list_objects("bkt")) == ["g1"]
    finally:
        lay._gather_listing_iter = inner
    assert lay.metacache.stats()["caches"] == 0
    assert lay.metacache._load_manifest("bkt", "") is None
    misses = lay.metacache.misses
    assert _names(lay.list_objects("bkt")) == ["g1", "g2"]
    assert lay.metacache.misses == misses + 1


def test_clean_buckets_skip_the_drop(lay):
    """Only the first write after a persisted snapshot pays the drop."""
    lay.put_object("bkt", "c0", b"0")
    lay.list_objects("bkt")
    assert "bkt" not in lay.metacache._clean_buckets
    drops = []
    real = lay.metacache._drop_persisted
    lay.metacache._drop_persisted = lambda b: (drops.append(b), real(b))
    for i in range(3):
        lay.put_object("bkt", f"c{i + 1}", b"x")
    assert drops == ["bkt"] and "bkt" in lay.metacache._clean_buckets


def test_listing_memory_shed(lay, monkeypatch):
    lay.put_object("bkt", "m", b"m")
    mg = port_mg if is_port(lay) else ref_mg
    gov = mg.MemoryGovernor(limit_bytes=1 << 20)
    monkeypatch.setattr(mg, "GOVERNOR", gov)
    if is_port(lay):
        monkeypatch.setattr(port_mc, "GOVERNOR", gov)
    with pytest.raises(mg.MemoryPressure) as e:
        lay.list_objects("bkt")
    assert e.value.kind == "listing"
    assert gov.inuse_bytes("listing") == 0


def test_listing_shed_answers_503_alike(tmp_path, monkeypatch):
    with servers(tmp_path, monkeypatch) as (ref, port):
        for srv in (ref, port):
            c = client(srv)
            c.make_bucket("shed")
            c.put_object("shed", "k", b"k")
        for mg in (ref_mg, port_mg):
            monkeypatch.setattr(mg.GOVERNOR, "limit_bytes", 1 << 20)
        r, p = both(ref, port, "GET", "/shed", "list-type=2")
        assert r.status == p.status == 503
        assert p.xml().findtext("Code") == r.xml().findtext("Code")
        assert p.headers.get("Retry-After") == r.headers.get("Retry-After")


def test_delete_bucket_drops_the_cached_listing(tmp_path, monkeypatch):
    """A force delete, a re-create and a listing within the TTL: the
    reference lists the deleted keys from its snapshot; the port lists
    none."""
    pin(monkeypatch)
    ref, port = ref_layer(tmp_path / "ref"), port_layer(tmp_path / "port")
    try:
        got = {}
        for name, er in (("ref", ref), ("port", port)):
            er.make_bucket("gone")
            er.put_object("gone", "a", b"a")
            er.put_object("gone", "b", b"b")
            assert _names(er.list_objects("gone")) == ["a", "b"]
            er.delete_bucket("gone", force=True)
            er.make_bucket("gone")
            got[name] = _names(er.list_objects("gone"))
        assert got["ref"] == ["a", "b"], "reference fault gone"
        assert got["port"] == []
    finally:
        close(ref, port)


def test_tokens_equal():
    for args in (("k",), ("a/b", "snap", 3), ("x", "", 0), ("", "s")):
        assert port_mc.encode_list_token(*args) == \
            ref_mc.encode_list_token(*args)
        tok = port_mc.encode_list_token(*args)
        assert port_mc.decode_list_token(tok) == \
            ref_mc.decode_list_token(tok) == args[0]
    with pytest.raises(ValueError):
        port_mc.decode_list_token("mt1-!!!")
