"""Object and bucket tagging on the port against ``minio_tpu``: the two
servers (``_torch_control``) answer every ``?tagging`` call alike, on
objects of every size band and on versions, and the ``x-amz-tagging``
header on a PUT, a streamed PUT, a multipart upload and a POST-policy
form's ``tagging`` field, with ``x-amz-tagging-count`` on GET and HEAD;
then their drives are byte-equal.  In the layer, ``put_object_metadata``
updates a version in place in every band (inline, packed, part files,
multipart) and leaves the reference's drives, every body still read
back.  A tag update that parity drives missed (offline): the port reads
the tags most drives of the version hold and its heal writes them to the
drives that missed them; the reference reads the first drive's, no tag,
and its heal leaves them (ROADMAP Queue 3).  A drive that missed one
still counts for the version's read quorum: a 2+2 set that then loses
two drives reads every body."""

import hashlib

import pytest

from minio_tpu_torch.bucket import tags as port_tags

from ._torch_control import client, servers
from ._torch_objfeat import S3NS, Pair, assert_drives_equal, wire
from ._torch_versions import (BS, RefStorage, XLStorage, assert_trees_equal,
                              body, close, drives, obj_opts, port_eo, ref_eo,
                              pin, port_layer, put_opts, ref_layer)

BANDS = {"inline": 1000, "packed": 300_000, "part": 1_200_000,
         "streamed": 2_000_000}
V = b"<VersioningConfiguration><Status>Enabled</Status>" \
    b"</VersioningConfiguration>"


def tagging_xml(tags: dict) -> bytes:
    return ('<Tagging xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            "<TagSet>" + "".join(
                f"<Tag><Key>{k}</Key><Value>{v}</Value></Tag>"
                for k, v in tags.items()) + "</TagSet></Tagging>").encode()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("tagging")
    with servers(root, mp) as (ref, port):
        p = Pair(ref, port, root)
        for b in ("tag", "tagv"):
            p.same("PUT", f"/{b}", status=200)
        p.same("PUT", "/tagv", "versioning", body=V, status=200)
        yield p
    mp.undo()


def _tags(resp) -> dict:
    return {t.findtext(f"{S3NS}Key"): t.findtext(f"{S3NS}Value") or ""
            for t in resp.xml().iter(f"{S3NS}Tag")}


@pytest.mark.parametrize("band", list(BANDS))
def test_object_tagging_in_every_band(pair, band):
    data = body(BANDS[band], 2)
    pair.same("PUT", f"/tag/{band}", body=data, status=200)
    assert _tags(pair.same("GET", f"/tag/{band}", "tagging",
                           status=200)) == {}
    want = {"team": "blue", "stage": "", "Name With Space": "v=1&2"}
    pair.same("PUT", f"/tag/{band}", "tagging",
              tagging_xml({k.replace("&", "&amp;"): v.replace("&", "&amp;")
                           for k, v in want.items()}), status=200)
    assert _tags(pair.same("GET", f"/tag/{band}", "tagging",
                           status=200)) == want
    h = pair.same("HEAD", f"/tag/{band}", status=200).headers
    assert h["x-amz-tagging-count"] == "3"
    got = pair.same("GET", f"/tag/{band}", status=200)
    assert got.body == data and got.headers["x-amz-tagging-count"] == "3"
    pair.same("DELETE", f"/tag/{band}", "tagging", status=204)
    assert _tags(pair.same("GET", f"/tag/{band}", "tagging")) == {}
    assert "x-amz-tagging-count" not in \
        pair.same("HEAD", f"/tag/{band}").headers
    pair.same("PUT", f"/tag/{band}", "tagging", tagging_xml({"kept": "1"}),
              status=200)
    assert pair.same("GET", f"/tag/{band}").body == data


def test_tagging_a_version(pair):
    vids = [pair.same("PUT", "/tagv/k", body=body(700 + i, i),
                      status=200).headers["x-amz-version-id"]
            for i in range(2)]
    pair.same("PUT", "/tagv/k", f"tagging&versionId={vids[0]}",
              tagging_xml({"old": "yes"}), status=200)
    assert _tags(pair.same("GET", "/tagv/k", f"tagging&versionId="
                           f"{vids[0]}")) == {"old": "yes"}
    assert _tags(pair.same("GET", "/tagv/k", "tagging")) == {}
    pair.same("DELETE", "/tagv/k", status=204)          # a delete marker
    pair.same("PUT", "/tagv/k", "tagging", tagging_xml({"a": "b"}),
              status=405)
    pair.same("GET", "/tagv/k", "tagging", status=200)
    pair.same("PUT", "/tagv/k", "tagging&versionId=nosuch",
              tagging_xml({"a": "b"}), err="NoSuchVersion")
    assert pair.same("GET", "/tagv/k", f"versionId={vids[0]}").body == \
        body(700, 0)


@pytest.mark.parametrize("doc,err", [
    (b"<Tagging><TagSet>", "MalformedXML"),
    (b"<Other/>", "MalformedXML"),
    (b"<Tagging/>", "MalformedXML"),
    (tagging_xml({"": "x"}), "InvalidTag"),
    (tagging_xml({"k" * 129: "x"}), "InvalidTag"),
    (tagging_xml({"k": "v" * 257}), "InvalidTag"),
    (tagging_xml({f"k{i}": "v" for i in range(11)}), "InvalidTag"),
    (b"<Tagging><TagSet><Tag><Key>a</Key><Value>1</Value></Tag><Tag><Key>"
     b"a</Key><Value>2</Value></Tag></TagSet></Tagging>", "InvalidTag"),
], ids=["truncated", "root", "no-tagset", "empty-key", "long-key",
        "long-value", "eleven", "duplicate"])
def test_object_tagging_refusals(pair, doc, err):
    pair.same("PUT", "/tag/refusals", body=b"r", status=200)
    pair.same("PUT", "/tag/refusals", "tagging", doc, err=err)
    pair.same("PUT", "/tag/absent", "tagging", tagging_xml({"a": "b"}),
              err="NoSuchKey")


@pytest.mark.parametrize("band", ["inline", "streamed"])
def test_the_tagging_header_on_put(pair, band):
    """``x-amz-tagging`` on a buffered and on a streamed PUT."""
    pair.same("PUT", f"/tag/h-{band}", body=body(BANDS[band], 3),
              headers={"x-amz-tagging": "a=1&b=2&c="}, status=200)
    assert _tags(pair.same("GET", f"/tag/h-{band}", "tagging")) == \
        {"a": "1", "b": "2", "c": ""}
    assert pair.same("HEAD", f"/tag/h-{band}").headers[
        "x-amz-tagging-count"] == "3"
    pair.same("PUT", f"/tag/bad-{band}", body=body(BANDS[band], 3),
              headers={"x-amz-tagging": "a=1&a=2"}, err="InvalidTag")
    pair.same("HEAD", f"/tag/bad-{band}", status=404)


def test_the_tagging_header_on_a_multipart_upload(pair):
    r = pair.same("POST", "/tag/mp", "uploads",
                  headers={"x-amz-tagging": "mp=yes"}, status=200)
    uid = r.xml().findtext(f"{S3NS}UploadId")
    parts = []
    for n, size in ((1, 70_000), (2, 20_000)):
        r = pair.same("PUT", "/tag/mp", f"partNumber={n}&uploadId={uid}",
                      body=body(size, n), status=200)
        parts.append((n, r.headers["ETag"]))
    doc = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in parts) + "</CompleteMultipartUpload>"
    pair.same("POST", "/tag/mp", f"uploadId={uid}", doc.encode(),
              status=200)
    assert _tags(pair.same("GET", "/tag/mp", "tagging")) == {"mp": "yes"}
    pair.same("POST", "/tag/mp2", "uploads",
              headers={"x-amz-tagging": "x=1&x=2"}, err="InvalidTag")


@pytest.mark.parametrize("field,status", [
    (tagging_xml({"post": "ed", "n": "2"}).decode(), 204),
    (tagging_xml({"a": "1", "b": "2"}).decode().replace("<Key>b",
                                                        "<Key>a"), 400),
], ids=["tags", "duplicate"])
def test_post_policy_tagging_field(pair, field, status):
    """The form's ``tagging`` field (a Tagging document) is stored as the
    object's tags; a bad one answers InvalidTag."""
    data = body(5000, 4)
    answers = []
    for srv in (pair.ref, pair.port):
        answers.append(client(srv).post_object(
            "tag", "posted", data, fields={"tagging": field},
            conditions=[["starts-with", "$tagging", ""]], expect=()))
    r, p = answers
    assert wire(p) == wire(r)
    assert p.status == status
    if status == 204:
        assert p.headers["ETag"] == r.headers["ETag"] == \
            f'"{hashlib.md5(data).hexdigest()}"'
        assert _tags(pair.same("GET", "/tag/posted", "tagging")) == \
            {"post": "ed", "n": "2"}
    else:
        assert b"<Code>InvalidTag</Code>" in p.body


def test_bucket_tagging(pair):
    pair.same("GET", "/tag", "tagging", err="NoSuchTagSet")
    pair.same("PUT", "/tag", "tagging", tagging_xml(
        {f"k{i}": str(i) for i in range(50)}), status=200)
    assert len(_tags(pair.same("GET", "/tag", "tagging", status=200))) == 50
    pair.same("PUT", "/tag", "tagging", tagging_xml(
        {f"k{i}": str(i) for i in range(51)}), err="BadRequest")
    pair.same("PUT", "/tag", "tagging", b"<x", err="MalformedXML")
    pair.same("PUT", "/nobkt", "tagging", tagging_xml({"a": "b"}),
              err="NoSuchBucket")
    pair.same("DELETE", "/tag", "tagging", status=204)
    pair.same("GET", "/tag", "tagging", err="NoSuchTagSet")
    pair.same("POST", "/tag", "tagging", status=405)
    pair.same("PUT", "/tag", "tagging", tagging_xml({"env": "prod"}),
              status=200)


def test_drives_match_reference(pair):
    """Last: every drive of both servers holds the same bytes."""
    assert_drives_equal(pair.root, 8)


# -- the layer ----------------------------------------------------------------

def _fill(er) -> dict:
    """An object of each band, two versions of a key and a multipart
    object; {(name, version id): body}."""
    er.make_bucket("bkt")
    out = {}
    for band, size in (("inline", 1000), ("packed", 300_000),
                       ("part", 1_050_000)):
        out[(band, None)] = body(size, 5)
        er.put_object("bkt", band, out[(band, None)])
    vopt = put_opts(er, versioned=True)
    for i in range(2):
        oi = er.put_object("bkt", "ver", body(200_000 + i, i), vopt)
        out[("ver", oi.version_id)] = body(200_000 + i, i)
    uid = er.new_multipart_upload("bkt", "mp")
    parts = [(n, er.put_object_part("bkt", "mp", uid, n, body(s, n)).etag)
             for n, s in ((1, 40_000), (2, 9_000))]
    er.complete_multipart_upload("bkt", "mp", uid, parts)
    out[("mp", None)] = body(40_000, 1) + body(9_000, 2)
    return out


def _read_all(er, bodies: dict) -> None:
    for (name, vid), data in bodies.items():
        _, got = er.get_object("bkt", name,
                               opts=obj_opts(er, version_id=vid))
        assert got == data, (name, vid)


def test_metadata_updates_in_place_in_every_band(tmp_path, monkeypatch):
    """Tags set, replaced and removed on every band, a noncurrent
    version included: the bodies read back, and the drives equal the
    reference's (data dirs, packed extents and inline data kept)."""
    pin(monkeypatch)
    ref, port = ref_layer(tmp_path / "ref"), port_layer(tmp_path / "port")
    try:
        for er in (ref, port):
            bodies = _fill(er)
            for (name, vid) in bodies:
                oi = er.put_object_metadata("bkt", name, vid,
                                            {"x-amz-tagging": "a=1"})
                assert oi.user_defined["x-amz-tagging"] == "a=1"
                er.put_object_metadata("bkt", name, vid,
                                       {"x-amz-tagging": "b=2",
                                        "x-amz-meta-x": "y"})
            er.put_object_metadata("bkt", "inline", None, {},
                                   removes=("x-amz-tagging",))
            _read_all(er, bodies)
            got = {name: er.get_object_info(
                "bkt", name, obj_opts(er, version_id=vid)).user_defined
                for (name, vid) in bodies}
            assert "x-amz-tagging" not in got["inline"]
            assert got["packed"]["x-amz-tagging"] == "b=2"
        assert_trees_equal(tmp_path / "port", tmp_path / "ref")
    finally:
        close(ref, port)


def test_a_tag_update_parity_drives_missed_is_healed(tmp_path, monkeypatch):
    """Two drives (the parity count) offline during a tag update: the
    port reads the tags the four others agree on, and its heal writes
    them onto the two, their data untouched; the reference reads the
    first drive's (no tag) and its heal leaves the two as they were."""
    pin(monkeypatch)
    got = {}
    for name, make in (("ref", ref_layer), ("port", port_layer)):
        er = make(tmp_path / name)
        try:
            bodies = _fill(er)
            keys = list(bodies)
            saved = er.disks[:2]
            er.disks[:2] = [None, None]
            for (key, vid) in keys:
                er.put_object_metadata("bkt", key, vid,
                                       {"x-amz-tagging": "held=1"})
            er.disks[:2] = saved
            read = [er.get_object_info("bkt", key, obj_opts(
                er, version_id=vid)).user_defined.get("x-amz-tagging")
                for (key, vid) in keys]
            healed = [len(er.heal_object("bkt", key, vid).healed_disks)
                      for (key, vid) in keys]
            _read_all(er, bodies)
            on_drives = [[_drive_tag(er, i, key, vid) for i in range(2)]
                         for (key, vid) in keys]
            got[name] = (read, healed, on_drives)
        finally:
            close(er)
    n = len(got["port"][0])
    assert got["ref"] == ([None] * n, [0] * n, [[None, None]] * n), \
        "reference fault gone"
    assert got["port"] == (["held=1"] * n, [2] * n, [["held=1"] * 2] * n)


def test_a_tag_update_one_drive_missed_survives_parity_losses(tmp_path,
                                                             monkeypatch):
    """A 2+2 set: a tag update that one drive missed (offline), the drive
    back, then two of the three updated drives lost (within parity): one
    drive holds the old tags and one the new, and every version still
    reads whole in both packages, since the drives agree on its data; a
    heal that would remove dangling objects keeps them all, and once the
    lost drives return every body still reads back."""
    pin(monkeypatch)
    for name, make in (("ref", _layer_2_2(ref_eo, RefStorage, "numpy")),
                       ("port", _layer_2_2(port_eo, XLStorage, None))):
        er = make(tmp_path / name)
        try:
            bodies = _fill(er)
            saved = list(er.disks)
            er.disks[3] = None
            for (key, vid) in bodies:
                er.put_object_metadata("bkt", key, vid,
                                       {"x-amz-tagging": "held=1"})
            er.disks[:] = [None, None] + saved[2:]
            _read_all(er, bodies)
            for (key, vid) in bodies:
                er.get_object_info("bkt", key, obj_opts(er, version_id=vid))
                er.heal_object("bkt", key, vid, remove_dangling=True)
            _read_all(er, bodies)
            er.disks[:] = saved
            _read_all(er, bodies)
        finally:
            close(er)


def _layer_2_2(eo, storage, backend):
    """A maker of a layer of four drives, two data and two parity."""
    kw = {"backend": backend} if backend else {"device": "cpu"}
    return lambda root: eo.ErasureObjects(
        drives(root, storage, 4), parity=2, block_size=BS,
        enforce_min_part_size=False, **kw)


def _drive_tag(er, i: int, key: str, vid) -> str | None:
    return er.disks[i].read_version("bkt", key, vid).metadata.get(
        "x-amz-tagging")


@pytest.mark.parametrize("value", [
    "a=1&b=2", "a=1&a=2", "=x", "k=" + "v" * 257,
    "&".join(f"k{i}=v" for i in range(11)), ""])
def test_the_crawler_reads_tags_with_the_fronts_parser(value):
    """The crawler's lifecycle filter reads an object's tags through
    ``bucket/tags.py``: an invalid tag set is no tags."""
    from types import SimpleNamespace

    from minio_tpu_torch.background.crawler import _tags_of
    try:
        want = port_tags.parse_header(value)
    except port_tags.TagError:
        want = {}
    assert _tags_of(SimpleNamespace(
        user_defined={"x-amz-tagging": value})) == want
