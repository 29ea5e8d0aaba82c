"""The port's object versions, delete markers and heal options against
minio_tpu's, on the CPU.

Six drives, parity 2, 4 KiB blocks and 1040 KiB stream batches, so every
layout is reached: inline (up to 128 KiB), packed (up to 1 MiB),
part files, and multipart.  The same numpy-seeded sequence of versioned
and unversioned PUTs, delete markers and deletes of single versions runs
through ``minio_tpu``'s ``ErasureObjects(backend="numpy")`` and the port
on ``device="cpu"`` and on a 1 x 1 CPU mesh, clocks and uuid draws
pinned to counters in both: after every step the drives hold the same
bytes, and reads, listings, errors and ``HealResult`` agree.  Heal runs
per version, ``deep`` (a flipped byte only a bitrot check finds),
``dry_run`` (no drive byte changes) and ``remove_dangling``.  Two faults
of the port before versioning have a test each: a delete marker's GET
and HEAD (MethodNotAllowed, over HTTP 405 with ``x-amz-delete-marker``),
and ``GET ?versioning``, which reads the ``bucket-meta.json`` that
minio_tpu writes.
"""

import glob
import re
import shutil

import pytest

from minio_tpu.objectlayer import hotread as ref_hotread
from minio_tpu.objectlayer import interface as ref_ol
from minio_tpu.objectlayer.bucket_meta import \
    BucketMetadataSys as RefBucketMeta
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu.storage.xl_meta import XLMeta as RefXLMeta
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.objectlayer.bucket_meta import BucketMetadataSys
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage.xl_meta import XLMeta

from ._torch_versions import (BS, ENGINES, M, N, assert_trees_equal, body,
                              close, drive_numbers, is_port, obj_opts, pin,
                              port_layer, put_opts, ref_layer, tree,
                              version_rows)

BKT = "vbkt"
BATCH = 260 * BS
KIB = 1024
AK, SK = "ver-key", "ver-secret"


def _outcome(fn):
    try:
        return ("ok", fn())
    except (port_ol.ObjectLayerError, ref_ol.ObjectLayerError) as e:
        return (type(e).__name__, None)


@pytest.fixture
def pair(tmp_path, monkeypatch, request):
    pin(monkeypatch, batch=BATCH)
    port = port_layer(tmp_path / "port", request.param)
    ref = ref_layer(tmp_path / "ref")
    for lay in (port, ref):
        lay.make_bucket(BKT)
    yield tmp_path, port, ref
    close(port, ref)


def _both(pair, fn):
    """fn(layer) on the port and on the reference; their results."""
    _, port, ref = pair
    return fn(port), fn(ref)


def _versioned_upload(lay, key: str, sizes) -> object:
    uid = lay.new_multipart_upload(BKT, key, put_opts(lay, versioned=True))
    parts = [(n, lay.put_object_part(BKT, key, uid, n, body(size, n)).etag)
             for n, size in enumerate(sizes, 1)]
    return lay.complete_multipart_upload(BKT, key, uid, parts)


MP_SIZES = (3 * BS + 1, 2 * BS)
BODIES = {"inline": body(5000, 1), "packed": body(300 * KIB, 2),
          "part": body(BATCH + 11, 3),
          "multipart": body(MP_SIZES[0], 1) + body(MP_SIZES[1], 2),
          "null": body(7000, 5), "null2": body(200 * KIB, 6)}


@pytest.mark.parametrize("pair", ENGINES, indirect=True)
def test_versions_and_delete_markers_match_reference(pair):
    root = pair[0]
    vids = {}

    def step(name, fn):
        got, want = _both(pair, fn)
        assert_trees_equal(root / "port", root / "ref")
        return got, want

    for name in ("inline", "packed", "part"):
        got, want = step(name, lambda lay, n=name: lay.put_object(
            BKT, "k", BODIES[n], put_opts(lay, versioned=True)))
        assert got.version_id == want.version_id != ""
        assert got.etag == want.etag
        vids[name] = got.version_id
    got, want = step("multipart",
                     lambda lay: _versioned_upload(lay, "k", MP_SIZES))
    assert got.version_id == want.version_id and got.etag == want.etag
    vids["multipart"] = got.version_id
    # an unversioned PUT writes the null version beside them, twice
    for name in ("null", "null2"):
        got, want = step(name, lambda lay, n=name: lay.put_object(
            BKT, "k", BODIES[n]))
        assert got.version_id == want.version_id == ""
    vids["null2"] = ""
    got, want = step("marker", lambda lay: lay.delete_object(
        BKT, "k", obj_opts(lay, versioned=True)))
    assert got.delete_marker and want.delete_marker
    assert got.version_id == want.version_id
    marker = got.version_id

    def reads(lay):
        out = {"latest": _outcome(lambda: lay.get_object(BKT, "k")),
               "head": _outcome(lambda: lay.get_object_info(
                   BKT, "k").delete_marker),
               "unknown": _outcome(lambda: lay.get_object(
                   BKT, "k", opts=obj_opts(lay, version_id="nope"))),
               "marker": _outcome(lambda: lay.get_object(
                   BKT, "k", opts=obj_opts(lay, version_id=marker))),
               "missing": _outcome(lambda: lay.get_object(BKT, "zz"))}
        for name, vid in vids.items():
            out[name] = _outcome(lambda v=vid: lay.get_object(
                BKT, "k", opts=obj_opts(lay, version_id=v))[1])
        return out

    got, want = _both(pair, reads)
    assert got == want
    assert got["latest"][0] == "MethodNotAllowed"
    assert got["head"] == ("ok", True)
    assert got["unknown"][0] == "VersionNotFound"
    assert got["missing"][0] == "ObjectNotFound"
    for name, vid in vids.items():
        assert got[name] == ("ok", BODIES[name]), name

    def listing(lay):
        res = lay.list_object_versions(BKT)
        return version_rows(res.objects if is_port(lay) else res)

    got, want = _both(pair, listing)
    assert got == want and len(got) == 6
    assert [r[3] for r in got] == [True] + [False] * 5
    # single versions go: a packed one, a part file, then the marker,
    # which makes the null version the latest again, then the null one
    for vid in (vids["packed"], vids["part"], marker, ""):
        step(vid, lambda lay, v=vid: lay.delete_object(
            BKT, "k", obj_opts(lay, version_id=v)))
        if vid == marker:
            got, want = _both(pair, lambda lay: lay.get_object(BKT, "k")[1])
            assert got == want == BODIES["null2"]
    got, want = _both(pair, listing)
    assert got == want
    assert [r[1] for r in got] == [vids["multipart"], vids["inline"]]
    step("gone", lambda lay: lay.delete_object(
        BKT, "k", obj_opts(lay, version_id="nope")))


def _add_sharing_version(root, new_vid: str, load, n: int = N) -> None:
    """On every drive, a second version of ``k`` that shares the first
    one's data dir (as a metadata-only change of a version would)."""
    for i in range(n):
        path = f"{root}/d{i}/{BKT}/k/xl.meta"
        with open(path, "rb") as f:
            meta = load(f.read())
        v = dict(meta.versions[0], vid=new_vid, mt=meta.versions[0]["mt"] + 1)
        meta.add_version_dict(v)
        with open(path, "wb") as f:
            f.write(meta.dump())


@pytest.mark.parametrize("pair", ["device"], indirect=True)
def test_a_shared_data_dir_goes_with_its_last_version(pair):
    root, port, ref = pair
    got, want = _both(pair, lambda lay: lay.put_object(
        BKT, "k", BODIES["part"], put_opts(lay, versioned=True)))
    first = got.version_id
    _add_sharing_version(root / "port", "v-2", XLMeta.load)
    _add_sharing_version(root / "ref", "v-2", RefXLMeta.load)
    assert_trees_equal(root / "port", root / "ref")
    _both(pair, lambda lay: lay.delete_object(
        BKT, "k", obj_opts(lay, version_id=first)))
    assert_trees_equal(root / "port", root / "ref")
    assert len(glob.glob(f"{root}/port/d0/{BKT}/k/*/part.1")) == 1
    got, want = _both(pair, lambda lay: lay.get_object(BKT, "k")[1])
    assert got == want == BODIES["part"]
    _both(pair, lambda lay: lay.delete_object(
        BKT, "k", obj_opts(lay, version_id="v-2")))
    assert_trees_equal(root / "port", root / "ref")
    assert not glob.glob(f"{root}/port/d*/{BKT}/k")


def _heal_rows(res) -> tuple:
    return (res.version_id, res.before_ok, res.after_ok,
            drive_numbers(res.healed_disks), res.dangling_purged)


def _wipe_drive(root, d: int, key: str = "k") -> None:
    shutil.rmtree(f"{root}/d{d}/{BKT}/{key}")


def _flip_payload_byte(root, d: int) -> None:
    """One byte of drive d's part file, past its first digest: the size
    stays, so only a bitrot check sees it."""
    (part,) = glob.glob(f"{root}/d{d}/{BKT}/k/*/part.1")
    with open(part, "r+b") as f:
        f.seek(40)
        b = f.read(1)
        f.seek(40)
        f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("pair", ENGINES, indirect=True)
def test_heal_options_match_reference(pair):
    root = pair[0]

    def both_heal(**kw):
        got, want = _both(pair, lambda lay: lay.heal_object(BKT, "k", **kw))
        assert _heal_rows(got) == _heal_rows(want), kw
        assert_trees_equal(root / "port", root / "ref")
        return got

    old, _ = _both(pair, lambda lay: lay.put_object(
        BKT, "k", BODIES["part"], put_opts(lay, versioned=True)))
    _both(pair, lambda lay: lay.put_object(
        BKT, "k", BODIES["inline"], put_opts(lay, versioned=True)))
    for side in ("port", "ref"):
        _wipe_drive(root / side, 1)
    # dry run: classified, nothing written
    before = {s: [tree(f"{root}/{s}/d{i}") for i in range(N)]
              for s in ("port", "ref")}
    res = both_heal(version_id=old.version_id, dry_run=True)
    assert (res.before_ok, res.healed_disks) == (N - 1, [])
    for s in ("port", "ref"):
        assert [tree(f"{root}/{s}/d{i}") for i in range(N)] == before[s]
    # the old version alone, then the latest
    res = both_heal(version_id=old.version_id)
    assert drive_numbers(res.healed_disks) == [1]
    res = both_heal()
    assert drive_numbers(res.healed_disks) == [1]
    # a flipped byte: only deep finds it
    for side in ("port", "ref"):
        _flip_payload_byte(root / side, 3)
    assert both_heal(version_id=old.version_id).healed_disks == []
    res = both_heal(version_id=old.version_id, deep=True)
    assert drive_numbers(res.healed_disks) == [3]
    got, want = _both(pair, lambda lay: lay.get_object(
        BKT, "k", opts=obj_opts(lay, version_id=old.version_id))[1])
    assert got == want == BODIES["part"]
    # fewer than k drives hold it: dangling, purged only when asked
    _both(pair, lambda lay: lay.put_object(BKT, "d", BODIES["packed"]))
    for side in ("port", "ref"):
        for d in range(N - M - 1):
            _wipe_drive(root / side, d, "d")
    got, want = _both(pair, lambda lay: lay.heal_object(BKT, "d"))
    assert _heal_rows(got) == _heal_rows(want)
    assert not got.dangling_purged and got.before_ok == M + 1
    got, want = _both(pair, lambda lay: lay.heal_object(
        BKT, "d", remove_dangling=True, dry_run=True))
    assert _heal_rows(got) == _heal_rows(want) and not got.dangling_purged
    got, want = _both(pair, lambda lay: lay.heal_object(
        BKT, "d", remove_dangling=True))
    assert _heal_rows(got) == _heal_rows(want) and got.dangling_purged
    assert_trees_equal(root / "port", root / "ref")
    assert not glob.glob(f"{root}/port/d*/{BKT}/d")


@pytest.mark.parametrize("pair", ["device"], indirect=True)
def test_heal_of_a_delete_marker_and_a_wiped_version(pair):
    root = pair[0]
    _both(pair, lambda lay: lay.put_object(
        BKT, "k", BODIES["packed"], put_opts(lay, versioned=True)))
    _both(pair, lambda lay: lay.delete_object(
        BKT, "k", obj_opts(lay, versioned=True)))
    for side in ("port", "ref"):
        _wipe_drive(root / side, 4)
    got, want = _both(pair, lambda lay: lay.heal_object(BKT, "k"))
    assert _heal_rows(got) == _heal_rows(want)
    assert drive_numbers(got.healed_disks) == [4]
    assert_trees_equal(root / "port", root / "ref")


# -- the two faults of the port before versioning ---------------------------

def _ref_writes_marker(root):
    """minio_tpu on six drives: two versioned PUTs of one key (5000 B
    and 3000 B), then a versioned DELETE."""
    ref = ref_layer(root)
    ref.make_bucket(BKT)
    vids = [ref.put_object(BKT, "k", body(n, 9), ref_ol.PutObjectOptions(
        versioned=True)).version_id for n in (5000, 3000)]
    dm = ref.delete_object(BKT, "k", ref_ol.ObjectOptions(versioned=True))
    close(ref)
    return vids, dm.version_id


def test_get_of_a_delete_marker_is_method_not_allowed(tmp_path):
    vids, dm = _ref_writes_marker(tmp_path)
    port = port_layer(tmp_path)
    try:
        with pytest.raises(port_ol.MethodNotAllowed):
            port.get_object(BKT, "k")
        info = port.get_object_info(BKT, "k")
        assert info.delete_marker and info.version_id == dm
        with pytest.raises(port_ol.VersionNotFound):
            port.get_object(BKT, "k", opts=port_ol.ObjectOptions(
                version_id="0000"))
        assert port.get_object(BKT, "k", opts=port_ol.ObjectOptions(
            version_id=vids[1]))[1] == body(3000, 9)
    finally:
        close(port)


def _request(srv, method, path, query="", body=b""):
    client = S3Client(f"http://127.0.0.1:{srv.port}", AK, SK)
    return client.request(method, path, query, body, expect=None)


def _wire(r) -> tuple:
    hdrs = [(k, v) for k, v in r.headers.items()
            if k.lower() not in ("date", "server", "x-amz-request-id")]
    return r.status, hdrs, re.sub(rb"<RequestId>[^<]*</RequestId>", b"",
                                  r.body)


def test_delete_marker_over_http_answers_as_the_reference(tmp_path,
                                                          monkeypatch):
    """Both fronts over the drives minio_tpu wrote: GET and HEAD of the
    delete marker answer 405 with ``x-amz-delete-marker``, each version
    reads by id, an unknown one is NoSuchVersion.  The reference's
    hot-read cache is off (it adds a header)."""
    monkeypatch.setenv("MT_CACHE_ENABLE", "off")
    for k, v in dict(ref_hotread.CONFIG.__dict__).items():
        monkeypatch.setattr(ref_hotread.CONFIG, k, v)
    vids, dm = _ref_writes_marker(tmp_path)
    from ._torch_versions import drives
    from minio_tpu.storage.xl_storage import XLStorage as RefStorage
    from minio_tpu.objectlayer.erasure_object import ErasureObjects as RefEO
    from minio_tpu_torch.storage.xl_storage import XLStorage
    from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
    ref = RefServer(RefEO(drives(tmp_path, RefStorage), parity=M,
                          block_size=BS, backend="numpy"),
                    access_key=AK, secret_key=SK)
    port = S3Server(ErasureObjects(drives(tmp_path, XLStorage), parity=M,
                                   block_size=BS, device="cpu"),
                    access_key=AK, secret_key=SK)
    ref.start()
    port.start()
    try:
        for method, query in (("GET", ""), ("HEAD", ""),
                              ("GET", f"versionId={dm}"),
                              ("HEAD", f"versionId={dm}"),
                              ("GET", f"versionId={vids[0]}"),
                              ("HEAD", f"versionId={vids[1]}"),
                              ("GET", "versionId=0000")):
            want = _request(ref, method, f"/{BKT}/k", query)
            got = _request(port, method, f"/{BKT}/k", query)
            assert _wire(got) == _wire(want), (method, query)
        assert _request(port, "GET", f"/{BKT}/k").status == 405
        assert _request(port, "GET", f"/{BKT}/k").headers[
            "x-amz-delete-marker"] == "true"
    finally:
        port.stop()
        ref.stop()


def test_get_versioning_reads_the_references_bucket_meta(tmp_path):
    """A bucket minio_tpu made versioned is versioned through the port:
    GET ?versioning says so and a PUT gets a version id."""
    ref = ref_layer(tmp_path)
    ref.make_bucket(BKT)
    RefBucketMeta(ref).set_versioning(BKT, True)
    close(ref)
    port = S3Server(port_layer(tmp_path), access_key=AK, secret_key=SK)
    port.start()
    try:
        r = _request(port, "GET", f"/{BKT}", "versioning")
        assert r.status == 200
        assert b"<Status>Enabled</Status>" in r.body
        assert BucketMetadataSys(port.layer).versioning_enabled(BKT)
        r = _request(port, "PUT", f"/{BKT}/obj", body=b"x" * 100)
        assert r.status == 200 and r.headers.get("x-amz-version-id")
        # suspended through the port, read back by the reference
        _request(port, "PUT", f"/{BKT}", "versioning",
                 b"<VersioningConfiguration><Status>Suspended</Status>"
                 b"</VersioningConfiguration>")
    finally:
        port.stop()
    ref = ref_layer(tmp_path)
    try:
        assert RefBucketMeta(ref).get(BKT)["versioning"] == {
            "status": "Suspended"}
        assert RefBucketMeta(ref).get(BKT)["_rev"] == 2
    finally:
        close(ref)


def test_version_pages(tmp_path, monkeypatch):
    """ListObjectVersions pages by key and version-id marker."""
    pin(monkeypatch, batch=BATCH)
    lay = port_layer(tmp_path)
    try:
        lay.make_bucket(BKT)
        for key in ("a", "b", "c"):
            for i in range(3):
                lay.put_object(BKT, key, body(100, i),
                               port_ol.PutObjectOptions(versioned=True))
        every = [(o.name, o.version_id)
                 for o in lay.list_object_versions(BKT).objects]
        assert len(every) == 9
        for size in (1, 2, 4, 9):
            got, km, vm = [], "", ""
            while True:
                page = lay.list_object_versions(BKT, "", km, vm, size)
                got += [(o.name, o.version_id) for o in page.objects]
                if not page.is_truncated:
                    break
                km, vm = page.next_key_marker, page.next_version_id_marker
            assert got == every, size
        page = lay.list_object_versions(BKT, "", "b")
        assert [o.name for o in page.objects] == ["c"] * 3
    finally:
        close(lay)

