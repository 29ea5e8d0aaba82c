"""CopyObject and UploadPartCopy on the port's S3 server against
``minio_tpu``'s: both built by their own package's ``build_server`` over
two sets of four drives (``_torch_control``: 4 KiB blocks, parity 2,
clocks and uuid draws pinned), every request sent to both and the
answers compared whole (``_torch_objfeat.Pair``).  Copies of every size
band (inline, packed, a part file, a body past the HTTP stream
threshold), within a set and across the two, with the COPY and REPLACE
metadata and tagging directives, of a version by id and of the null
version, of a multipart source (whose copy has a plain MD5 ETag), under
the ``x-amz-copy-source-if-*`` conditions, onto its own name, from a
source with a lost shard, and the refusals; UploadPartCopy with ranges.
After the sequence both servers' drives hold the same bytes.  The port
streams a copy's source version into its PUT, one batch at a time and
without the source's read lock, where the reference reads it whole: a
copy onto its own name completes within its timeout, and two copies in
opposite directions do not wait on each other.  Last, the same on two
server pools."""

import hashlib
import os
import threading
import urllib.parse

import pytest

from minio_tpu.s3 import server as ref_server
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.objectlayer.pools import MANIFEST_PATH
from minio_tpu_torch.s3 import server as port_server
from minio_tpu_torch.s3.client import multipart_etag

from ._torch_control import AK, BATCH, SK, client, servers
from ._torch_objfeat import S3NS, Pair, assert_drives_equal, code
from ._torch_pools import PER, pool_dirs, set_kwargs
from ._torch_versions import body
from .test_torch_pools_admin import pool_servers

# inline in xl.meta, packed into the segment files, one part file (two
# stream batches), and past the HTTP stream threshold
BANDS = {"inline": 1000, "packed": 300_000, "part": 1_200_000,
         "streamed": 2_000_000}
META = {"Content-Type": "text/plain", "x-amz-meta-color": "blue",
        "x-amz-tagging": "k1=v1&k2=v2"}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("copy")
    with servers(root, mp) as (ref, port):
        p = Pair(ref, port, root)
        for b in ("src", "dst"):
            p.same("PUT", f"/{b}", status=200)
        for band, size in BANDS.items():
            p.same("PUT", f"/src/{band}", body=body(size, 1), headers=META,
                   status=200)
        yield p
    mp.undo()


def _src(bucket: str, key: str, vid: str | None = None) -> dict:
    src = "/" + urllib.parse.quote(f"{bucket}/{key}")
    if vid is not None:
        src += f"?versionId={vid}"
    return {"x-amz-copy-source": src}


def _etag(resp) -> str:
    return resp.xml().findtext(f"{S3NS}ETag").strip('"')


@pytest.mark.parametrize("band", list(BANDS))
def test_copy_keeps_metadata_and_tags(pair, band):
    """COPY directives: the source's Content-Type, x-amz-meta-* and tags;
    a body of every band, the ETag its MD5."""
    r = pair.same("PUT", f"/dst/{band}", headers=_src("src", band),
                  status=200)
    assert _etag(r) == hashlib.md5(body(BANDS[band], 1)).hexdigest()
    got = pair.same("GET", f"/dst/{band}", status=200)
    assert got.body == body(BANDS[band], 1)
    assert got.headers["Content-Type"] == "text/plain"
    assert got.headers["x-amz-meta-color"] == "blue"
    assert got.headers["x-amz-tagging-count"] == "2"
    tags = pair.same("GET", f"/dst/{band}", "tagging", status=200)
    assert b"<Key>k1</Key><Value>v1</Value>" in tags.body


@pytest.mark.parametrize("band", ["inline", "part"])
def test_replace_directives(pair, band):
    """REPLACE: the request's metadata and tags, none of the source's."""
    pair.same("PUT", f"/dst/r-{band}", headers={
        **_src("src", band), "x-amz-metadata-directive": "REPLACE",
        "x-amz-tagging-directive": "REPLACE",
        "x-amz-meta-shape": "round", "x-amz-tagging": "only=one"},
        status=200)
    h = pair.same("HEAD", f"/dst/r-{band}", status=200).headers
    assert h.get("x-amz-meta-shape") == "round"
    assert "x-amz-meta-color" not in h
    assert h["Content-Type"] == "binary/octet-stream"
    assert h["x-amz-tagging-count"] == "1"
    # metadata copied, tags replaced; then the reverse
    pair.same("PUT", f"/dst/m-{band}", headers={
        **_src("src", band), "x-amz-tagging-directive": "REPLACE"},
        status=200)
    h = pair.same("HEAD", f"/dst/m-{band}", status=200).headers
    assert h["x-amz-meta-color"] == "blue"
    assert "x-amz-tagging-count" not in h
    pair.same("PUT", f"/dst/t-{band}", headers={
        **_src("src", band), "x-amz-metadata-directive": "REPLACE"},
        status=200)
    h = pair.same("HEAD", f"/dst/t-{band}", status=200).headers
    assert "x-amz-meta-color" not in h and h["x-amz-tagging-count"] == "2"


def test_copies_cross_the_sets(pair):
    """Copies whose source and destination names hash to different sets,
    and to the same set."""
    lay = pair.port.layer
    src_set = lay.get_hashed_set_index("part")
    names = [f"x/{i}" for i in range(12)]
    sets = {lay.get_hashed_set_index(n) for n in names}
    assert sets == {0, 1} and src_set in sets
    assert [pair.ref.layer.get_hashed_set_index(n) for n in names] == \
        [lay.get_hashed_set_index(n) for n in names]
    for name in names:
        pair.same("PUT", f"/src/{name}", headers=_src("src", "part"),
                  status=200)
        assert pair.same("GET", f"/src/{name}").body == body(BANDS["part"], 1)


def test_multipart_source_copies_as_a_plain_object(pair):
    r = pair.same("POST", "/src/mp", "uploads", status=200)
    uid = r.xml().findtext(f"{S3NS}UploadId")
    parts = []
    for n, size in ((1, 70_000), (2, 30_000)):
        r = pair.same("PUT", "/src/mp", f"partNumber={n}&uploadId={uid}",
                      body=body(size, n), status=200)
        parts.append((n, r.headers["ETag"].strip('"')))
    doc = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in parts) + "</CompleteMultipartUpload>"
    r = pair.same("POST", "/src/mp", f"uploadId={uid}", doc.encode(),
                  status=200)
    assert _etag(r) == multipart_etag([e for _, e in parts])
    whole = body(70_000, 1) + body(30_000, 2)
    r = pair.same("PUT", "/dst/mp", headers=_src("src", "mp"), status=200)
    assert _etag(r) == hashlib.md5(whole).hexdigest()
    assert pair.same("GET", "/dst/mp").body == whole


def test_version_copies(pair):
    """``?versionId=`` names the source version (``null`` the null
    version); the answer carries ``x-amz-copy-source-version-id``."""
    pair.same("PUT", "/nul", status=200)
    pair.same("PUT", "/nul/k", body=body(500, 7), status=200)     # null
    pair.same("PUT", "/nul", "versioning", status=200,
              body=b"<VersioningConfiguration><Status>Enabled</Status>"
                   b"</VersioningConfiguration>")
    vids = [pair.same("PUT", "/nul/k", body=body(600 + i, i),
                      status=200).headers["x-amz-version-id"]
            for i in range(2)]
    for vid, want in ((vids[0], body(600, 0)), ("null", body(500, 7))):
        r = pair.same("PUT", "/dst/v", headers=_src("nul", "k", vid),
                      status=200)
        assert r.headers["x-amz-copy-source-version-id"] == vid
        assert pair.same("GET", "/dst/v").body == want
    # a version copied onto its own name becomes the latest
    r = pair.same("PUT", "/nul/k", headers=_src("nul", "k", vids[0]),
                  status=200)
    assert r.headers["x-amz-version-id"] not in vids
    assert pair.same("GET", "/nul/k").body == body(600, 0)
    pair.same("DELETE", "/nul/k", status=204)
    pair.same("PUT", "/dst/dm", headers=_src("nul", "k"), status=405)
    pair.same("PUT", "/dst/v", headers=_src("nul", "k", "nosuch"),
              err="NoSuchVersion")


@pytest.mark.parametrize("headers,err", [
    ({"x-amz-copy-source": "/src"}, "InvalidArgument"),
    ({"x-amz-copy-source": "/src/"}, "InvalidArgument"),
    ({**_src("src", "nothere")}, "NoSuchKey"),
    ({**_src("nobucket", "k")}, "NoSuchBucket"),
    ({**_src("src", "inline"), "x-amz-copy-source-if-match": '"0"'},
     "PreconditionFailed"),
    ({**_src("src", "inline"), "x-amz-copy-source-if-none-match":
      hashlib.md5(body(1000, 1)).hexdigest()}, "PreconditionFailed"),
    ({**_src("src", "inline"), "x-amz-tagging-directive": "REPLACE",
      "x-amz-tagging": "a=1&a=2"}, "InvalidTag"),
    ({**_src("src", "inline"), "x-amz-object-lock-mode": "GOVERNANCE"},
     "InvalidRequest"),
], ids=["no-key", "empty-key", "no-source", "no-bucket", "if-match",
        "if-none-match", "bad-tag", "lock-on-plain-bucket"])
def test_copy_refusals(pair, headers, err):
    pair.same("PUT", "/dst/refused", headers=headers, err=err)
    pair.same("HEAD", "/dst/refused", status=404)


def test_conditions_that_hold_and_the_self_copy(pair):
    etag = hashlib.md5(body(1000, 1)).hexdigest()
    pair.same("PUT", "/dst/cond", headers={
        **_src("src", "inline"), "x-amz-copy-source-if-match": f'"{etag}"',
        "x-amz-copy-source-if-none-match": '"other"'}, status=200)
    # onto its own name, changing nothing
    pair.same("PUT", "/src/inline", headers=_src("src", "inline"),
              err="InvalidRequest")


@pytest.mark.parametrize("band", ["packed", "streamed"])
def test_a_copy_onto_its_own_name_completes(pair, band):
    """REPLACE onto its own name: the name's write lock and the source's
    read must not wait on each other."""
    out = {}

    def go():
        out["r"] = pair.same("PUT", f"/src/{band}", headers={
            **_src("src", band), "x-amz-metadata-directive": "REPLACE",
            "x-amz-meta-again": "yes"}, status=200)

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "a copy onto its own name hung"
    assert "r" in out
    got = pair.same("GET", f"/src/{band}", status=200)
    assert got.body == body(BANDS[band], 1)
    assert got.headers["x-amz-meta-again"] == "yes"


@pytest.mark.parametrize("dst", ["/src/big", "/dst/big"])
def test_a_copy_streams_its_source_a_batch_at_a_time(pair, monkeypatch,
                                                     dst):
    """A source of several stream batches copied onto its own name
    (REPLACE) and onto another: the port never reads it whole, reads
    no chunk larger than a batch, and holds no read lock on it."""
    size = 5 * BATCH // 2
    pair.same("PUT", "/src/big", body=body(size, 4), status=200)
    layer = pair.port.layer
    reads = []

    def whole(*a, **kw):
        raise AssertionError("a copy read its source whole")

    def reader(bucket, key, offset=0, length=-1, opts=None, **kw):
        info, chunks = type(layer).get_object_reader(
            layer, bucket, key, offset, length, opts, **kw)
        reads.append(opts.no_lock)

        def sizes():
            for c in chunks:
                reads.append(len(c))
                yield c
        return info, sizes()

    monkeypatch.setattr(layer, "get_object", whole)
    monkeypatch.setattr(layer, "get_object_reader", reader)
    pair.same("PUT", dst, headers={
        **_src("src", "big"), "x-amz-metadata-directive": "REPLACE",
        "x-amz-meta-n": "1"}, status=200)
    monkeypatch.undo()
    assert reads[0] is True
    assert sum(reads[1:]) == size and max(reads[1:]) <= BATCH
    assert pair.same("GET", dst, status=200).body == body(size, 4)


def test_copies_in_opposite_directions_do_not_wait(tmp_path, monkeypatch):
    """a -> b and b -> a at once, each copy's source open before either
    PUT starts: neither waits on the other's name lock (the port's
    server alone: concurrent calls draw the pinned ids in any order)."""
    with servers(tmp_path, monkeypatch) as (_, port):
        c = client(port)
        c.request("PUT", "/opp")
        for k in ("a", "b"):
            c.request("PUT", f"/opp/{k}", body=body(6 * BATCH, 5))
        layer = port.layer
        both_open = threading.Barrier(2, timeout=30)

        def reader(*a, **kw):
            got = type(layer).get_object_reader(layer, *a, **kw)
            both_open.wait()
            return got

        out = {}

        def copy(src, dst):
            out[dst] = c.request("PUT", f"/opp/{dst}", headers=_src(
                "opp", src), expect=())

        threads = [threading.Thread(target=copy, args=names, daemon=True)
                   for names in (("a", "b"), ("b", "a"))]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layer, "get_object_reader", reader)
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "the copies hung"
        assert [out[k].status for k in ("a", "b")] == [200, 200], \
            [out[k].body for k in ("a", "b")]
        for k in ("a", "b"):
            assert c.request("GET", f"/opp/{k}").body == body(6 * BATCH, 5)


def test_upload_part_copy_with_ranges(pair):
    src = body(BANDS["streamed"], 1)
    r = pair.same("POST", "/dst/parts", "uploads", status=200)
    uid = r.xml().findtext(f"{S3NS}UploadId")
    ranges = [(0, 799_999), (800_000, 1_599_999), (1_600_000, None)]
    parts = []
    for n, (a, b) in enumerate(ranges, 1):
        rng = f"bytes={a}-" + ("" if b is None else str(b))
        r = pair.same("PUT", "/dst/parts", f"partNumber={n}&uploadId={uid}",
                      headers={**_src("src", "streamed"),
                               "x-amz-copy-source-range": rng}, status=200)
        assert r.xml().tag == f"{S3NS}CopyPartResult"
        want = src[a:] if b is None else src[a:b + 1]
        assert _etag(r) == hashlib.md5(want).hexdigest()
        parts.append((n, _etag(r)))
    # a part copied from a whole source, then replaced
    pair.same("PUT", "/dst/parts", f"partNumber=4&uploadId={uid}",
              headers=_src("src", "inline"), status=200)
    for rng, err in (("bytes=2000000-", "InvalidRange"),
                     ("bytes=-5", "InvalidRange"), ("bytes=9-1",
                                                    "InvalidRange")):
        pair.same("PUT", "/dst/parts", f"partNumber=5&uploadId={uid}",
                  headers={**_src("src", "streamed"),
                           "x-amz-copy-source-range": rng}, err=err)
    pair.same("PUT", "/dst/parts", "partNumber=5&uploadId=nosuch",
              headers=_src("src", "inline"), err="NoSuchUpload")
    pair.same("PUT", "/dst/parts", f"partNumber=x&uploadId={uid}",
              headers=_src("src", "inline"), err="InvalidArgument")
    pair.same("GET", "/dst/parts", f"uploadId={uid}", status=200)
    doc = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in parts) + "</CompleteMultipartUpload>"
    pair.same("POST", "/dst/parts", f"uploadId={uid}", doc.encode(),
              status=200)
    assert pair.same("GET", "/dst/parts", status=200).body == src


def test_a_copy_of_a_source_with_a_lost_shard(pair):
    """A part file of the source gone from one drive: the copy reads the
    rest and rebuilds it, in both."""
    for tag in ("ref", "port"):
        parts = sorted(
            f"{dp}/part.1" for i in range(8)
            for dp, _, fs in os.walk(f"{pair.root}/{tag}/d{i}/src/part")
            if "part.1" in fs)
        assert len(parts) == 4
        os.remove(parts[0])
    pair.same("PUT", "/dst/degraded", headers=_src("src", "part"),
              status=200)
    assert pair.same("GET", "/dst/degraded").body == body(BANDS["part"], 1)


def test_a_copy_past_the_quota_is_refused_before_it_reads(pair):
    admins = [AdminClient(f"http://127.0.0.1:{s.port}", AK, SK)
              for s in (pair.ref, pair.port)]
    pair.same("PUT", "/quo", status=200)
    for adm in admins:
        adm.set_bucket_quota("quo", 1_500_000)
    pair.same("PUT", "/quo/a", headers=_src("src", "part"), status=200)
    before = _codec_ops(admins[1])
    r = pair.same("PUT", "/quo/b", headers=_src("src", "part"), status=403)
    assert code(r) == "XMinioAdminBucketQuotaExceeded"
    r = pair.same("POST", "/quo/mp", "uploads", status=200)
    uid = r.xml().findtext(f"{S3NS}UploadId")
    pair.same("PUT", "/quo/mp", f"partNumber=1&uploadId={uid}",
              headers=_src("src", "part"), status=403)
    assert _codec_ops(admins[1]) == before, "a refused copy reached the codec"
    pair.same("DELETE", "/quo/mp", f"uploadId={uid}", status=204)
    for adm in admins:
        adm.clear_bucket_quota("quo")


def _codec_ops(adm) -> float:
    return sum(float(line.rsplit(" ", 1)[1])
               for line in adm.metrics().splitlines()
               if line.startswith("mt_tpu_ops_total"))


@pytest.mark.parametrize("query", [{}, {"partNumber": "1", "uploadId": "u"}])
def test_a_copy_is_named_as_the_reference_names_it(query):
    assert port_server._api_name("PUT", "b", "k", query) == \
        ref_server._api_name("PUT", "b", "k", query)


def test_drives_match_reference(pair):
    """Last: every drive of both servers holds the same bytes."""
    assert_drives_equal(pair.root, 8)


def test_copies_across_pools(tmp_path, monkeypatch):
    """Two pools on each server: copies whose source and destination
    lie in different pools, then both pools' drives byte-equal."""
    with pool_servers(tmp_path, monkeypatch) as (ref, port):
        for tag, srv in (("ref", ref), ("port", port)):
            srv.layer.attach_pool(pool_dirs(tmp_path / tag, 1), 1, PER,
                                  **set_kwargs(tag == "port"))
        p = Pair(ref, port, tmp_path)
        p.same("PUT", "/pbk", status=200)
        for band, size in BANDS.items():
            p.same("PUT", f"/pbk/{band}", body=body(size, 3), headers=META,
                   status=200)
        moved = set()
        for band in BANDS:
            for i in range(3):
                dst = f"c/{band}/{i}"
                p.same("PUT", f"/pbk/{dst}", headers=_src("pbk", band),
                       status=200)
                assert p.same("GET", f"/pbk/{dst}").body == \
                    body(BANDS[band], 3)
                moved.add((port.layer.get_pool_idx("pbk", band),
                           port.layer.get_pool_idx("pbk", dst)))
        assert {(0, 1), (1, 0)} & moved, moved
        p.same("PUT", "/pbk/streamed", headers={
            **_src("pbk", "streamed"), "x-amz-metadata-directive": "REPLACE"},
            status=200)
        p.same("GET", "/pbk", "list-type=2", status=200)
    for j in range(2):
        # the sealed manifest has a random salt and nonce
        assert_drives_equal(tmp_path, PER, pool=f"p{j}/",
                            skip=[f".mt.sys/{MANIFEST_PATH}"])
