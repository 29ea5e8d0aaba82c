"""Object lock on the port against ``minio_tpu``: the two servers
(``_torch_control``, both object-lock modules on one pinned wall clock,
``_torch_objfeat.pin_lock_clock``) answer alike as a bucket is created
lock-enabled (and versioned), given a default retention, written to by
every write path, and asked to delete: a GOVERNANCE version yields only
to a caller allowed ``s3:BypassGovernanceRetention`` who asks, a
COMPLIANCE one and one under legal hold to no one, also in the
multi-object DELETE; retention may be tightened, not loosened; a lock
bucket cannot be suspended (InvalidBucketState).  The refusals launch no
codec op, and the drives end byte-equal.  Then the background: the
crawler's lifecycle expiry passes a locked version (the reference's
deletes it, ROADMAP Queue 3), also one locked after the crawler listed
it, the layer judging the lock under the name's write lock; and a drain
of two pools moves locked and tagged versions with their metadata, a
metadata update sent mid-move waiting for the move rather than being
undone by it."""

import datetime
import threading

import pytest

from minio_tpu.background import crawler as ref_cr
from minio_tpu.objectlayer.bucket_meta import BucketMetadataSys as RefMeta
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.background import crawler as port_cr
from minio_tpu_torch.bucket import objectlock as olock
from minio_tpu_torch.objectlayer.bucket_meta import BucketMetadataSys

from ._torch_control import AK, SK, client, servers
from ._torch_objfeat import (S3NS, Pair, assert_drives_equal, code,
                             pin_lock_clock)
from ._torch_pools import Deployment, assert_pools_equal, ol, pin_all
from ._torch_versions import (body, close, is_port, obj_opts, pin,
                              port_layer, put_opts, ref_layer)

V_ON = b"<VersioningConfiguration><Status>Enabled</Status>" \
    b"</VersioningConfiguration>"
V_OFF = V_ON.replace(b"Enabled", b"Suspended")
BYPASS = {"x-amz-bypass-governance-retention": "true"}
NS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'


def lock_doc(mode: str = "", days: int = 0) -> bytes:
    rule = (f"<Rule><DefaultRetention><Mode>{mode}</Mode><Days>{days}"
            "</Days></DefaultRetention></Rule>") if mode else ""
    return (f"<ObjectLockConfiguration {NS}><ObjectLockEnabled>Enabled"
            f"</ObjectLockEnabled>{rule}</ObjectLockConfiguration>").encode()


def retention_doc(mode: str, until: datetime.datetime) -> bytes:
    return (f"<Retention {NS}><Mode>{mode}</Mode><RetainUntilDate>"
            f"{until.strftime('%Y-%m-%dT%H:%M:%SZ')}</RetainUntilDate>"
            "</Retention>").encode()


def hold_doc(status: str) -> bytes:
    return f"<LegalHold {NS}><Status>{status}</Status></LegalHold>".encode()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("objectlock")
    now = pin_lock_clock(mp)
    with servers(root, mp) as (ref, port):
        p = Pair(ref, port, root)
        p.now = now
        p.same("PUT", "/lck", headers={
            "x-amz-bucket-object-lock-enabled": "true"}, status=200)
        p.same("PUT", "/hld", headers={
            "x-amz-bucket-object-lock-enabled": "True"}, status=200)
        p.same("PUT", "/pln", status=200)
        yield p
    mp.undo()


def _vid(resp) -> str:
    return resp.headers["x-amz-version-id"]


def test_a_bucket_created_lock_enabled(pair):
    assert b"<Status>Enabled</Status>" in pair.same(
        "GET", "/lck", "versioning", status=200).body
    r = pair.same("GET", "/lck", "object-lock", status=200)
    assert b"<ObjectLockEnabled>Enabled</ObjectLockEnabled>" in r.body
    pair.same("PUT", "/lck", "object-lock", lock_doc("GOVERNANCE", 1),
              status=200)
    assert b"<Mode>GOVERNANCE</Mode><Days>1</Days>" in pair.same(
        "GET", "/lck", "object-lock", status=200).body
    pair.same("PUT", "/lck", "versioning", V_OFF, err="InvalidBucketState")
    pair.same("PUT", "/lck", "versioning", V_ON, status=200)
    pair.same("GET", "/pln", "object-lock",
              err="ObjectLockConfigurationNotFoundError")
    pair.same("PUT", "/pln", "object-lock", lock_doc("GOVERNANCE", 1),
              err="InvalidBucketObjectLockConfiguration")
    pair.same("PUT", "/pln", "versioning", V_OFF, status=200)
    pair.same("DELETE", "/lck", "object-lock", status=405)
    pair.same("GET", "/nobkt", "object-lock", err="NoSuchBucket")


@pytest.mark.parametrize("doc", [
    b"<ObjectLockConfiguration", b"<Other/>",
    lock_doc("GOVERNANCE", 1).replace(b"<Mode>GOVERNANCE</Mode>", b""),
    lock_doc("WORM", 1), lock_doc("GOVERNANCE", 0),
    lock_doc("GOVERNANCE", 1).replace(b"<Days>1</Days>", b""),
    lock_doc("GOVERNANCE", 1).replace(b"<Days>1</Days>",
                                      b"<Days>1</Days><Years>1</Years>"),
    lock_doc("GOVERNANCE", 1).replace(b"<DefaultRetention>",
                                      b"<X>").replace(b"</DefaultRetention>",
                                                      b"</X>"),
], ids=["truncated", "root", "no-mode", "bad-mode", "zero-days",
        "no-period", "two-periods", "no-default"])
def test_lock_configuration_refusals(pair, doc):
    pair.same("PUT", "/lck", "object-lock", doc, err="MalformedXML")


@pytest.mark.parametrize("route", ["put", "streamed", "multipart", "copy",
                                   "post"])
def test_every_write_takes_the_default_retention(pair, route):
    key = f"def/{route}"
    if route in ("put", "streamed"):
        pair.same("PUT", f"/lck/{key}", body=body(
            1000 if route == "put" else 2_000_000, 1), status=200)
    elif route == "multipart":
        r = pair.same("POST", f"/lck/{key}", "uploads", status=200)
        uid = r.xml().findtext(f"{S3NS}UploadId")
        r = pair.same("PUT", f"/lck/{key}", f"partNumber=1&uploadId={uid}",
                      body=body(9000, 2), status=200)
        pair.same("POST", f"/lck/{key}", f"uploadId={uid}", (
            "<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
            f"<ETag>{r.headers['ETag']}</ETag></Part>"
            "</CompleteMultipartUpload>").encode(), status=200)
    elif route == "copy":
        pair.same("PUT", "/pln/src", body=body(3000, 3), status=200)
        pair.same("PUT", f"/lck/{key}",
                  headers={"x-amz-copy-source": "/pln/src"}, status=200)
    else:
        answers = [client(s).post_object("lck", key, body(4000, 4),
                                         expect=())
                   for s in (pair.ref, pair.port)]
        assert answers[1].status == answers[0].status == 204
    r = pair.same("GET", f"/lck/{key}", "retention", status=200)
    until = (pair.now + datetime.timedelta(days=1)).strftime(
        "%Y-%m-%dT%H:%M:%SZ")
    assert r.xml().findtext(f"{S3NS}Mode") == "GOVERNANCE"
    assert r.xml().findtext(f"{S3NS}RetainUntilDate") == until


def test_governance_yields_only_to_the_bypass(pair):
    vid = _vid(pair.same("PUT", "/lck/gov", body=b"g" * 500, status=200))
    pair.same("DELETE", "/lck/gov", f"versionId={vid}", err="ObjectLocked")
    # a delete marker keeps the data: allowed
    dm = pair.same("DELETE", "/lck/gov", status=204)
    assert dm.headers["x-amz-delete-marker"] == "true"
    pair.same("DELETE", "/lck/gov", f"versionId={_vid(dm)}", status=204)
    # a caller without s3:BypassGovernanceRetention: the header is ignored
    admins = [AdminClient(f"http://127.0.0.1:{s.port}", AK, SK)
              for s in (pair.ref, pair.port)]
    for adm in admins:
        adm.add_policy("lckrw", {"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Action": ["s3:GetObject*", "s3:PutObject",
                                          "s3:DeleteObject*"],
            "Resource": ["arn:aws:s3:::lck/*"]}]})
        adm.add_user("lckuser", "lckuser-secret", ["lckrw"])
    answers = [client(s, "lckuser", "lckuser-secret").request(
        "DELETE", "/lck/gov", f"versionId={vid}", headers=BYPASS,
        expect=()) for s in (pair.ref, pair.port)]
    assert [code(a) for a in answers] == ["ObjectLocked"] * 2
    pair.same("DELETE", "/lck/gov", f"versionId={vid}", headers=BYPASS,
              status=204)
    pair.same("GET", "/lck/gov", f"versionId={vid}", err="NoSuchKey")


def test_compliance_yields_to_no_one(pair):
    until = pair.now + datetime.timedelta(days=3)
    r = pair.same("PUT", "/lck/cmp", body=b"c" * 500, headers={
        "x-amz-object-lock-mode": "COMPLIANCE",
        "x-amz-object-lock-retain-until-date":
            until.strftime("%Y-%m-%dT%H:%M:%SZ")}, status=200)
    vid = _vid(r)
    q = f"versionId={vid}"
    pair.same("DELETE", "/lck/cmp", q, headers=BYPASS, err="ObjectLocked")
    # loosened: an earlier date or the GOVERNANCE mode, even with bypass
    for mode, days in (("COMPLIANCE", 2), ("GOVERNANCE", 5)):
        pair.same("PUT", "/lck/cmp", f"retention&{q}", retention_doc(
            mode, pair.now + datetime.timedelta(days=days)),
            headers=BYPASS, err="ObjectLocked")
    # tightened
    pair.same("PUT", "/lck/cmp", f"retention&{q}", retention_doc(
        "COMPLIANCE", pair.now + datetime.timedelta(days=4)), status=200)
    r = pair.same("GET", "/lck/cmp", f"retention&{q}", status=200)
    assert r.xml().findtext(f"{S3NS}Mode") == "COMPLIANCE"
    pair.same("POST", "/lck", "delete", (
        f"<Delete><Object><Key>cmp</Key><VersionId>{vid}</VersionId>"
        "</Object></Delete>").encode(), headers=BYPASS, status=200)
    assert pair.same("GET", "/lck/cmp", q).body == b"c" * 500


def test_governance_retention_changes(pair):
    vid = _vid(pair.same("PUT", "/lck/gch", body=b"h" * 10, status=200))
    q = f"retention&versionId={vid}"
    shorter = retention_doc("GOVERNANCE",
                            pair.now + datetime.timedelta(hours=2))
    pair.same("PUT", "/lck/gch", q, shorter, err="ObjectLocked")
    pair.same("PUT", "/lck/gch", q, shorter, headers=BYPASS, status=200)
    # a change of mode counts as a loosening, even to COMPLIANCE
    stricter = retention_doc("COMPLIANCE",
                             pair.now + datetime.timedelta(hours=3))
    pair.same("PUT", "/lck/gch", q, stricter, err="ObjectLocked")
    pair.same("PUT", "/lck/gch", q, stricter, headers=BYPASS, status=200)
    pair.same("PUT", "/lck/gch", q, retention_doc(
        "GOVERNANCE", pair.now + datetime.timedelta(hours=4)),
        headers=BYPASS, err="ObjectLocked")


def test_a_legal_hold_blocks_every_delete(pair):
    vid = _vid(pair.same("PUT", "/hld/k", body=b"x" * 100, headers={
        "x-amz-object-lock-legal-hold": "ON"}, status=200))
    q = f"versionId={vid}"
    assert b"<Status>ON</Status>" in pair.same(
        "GET", "/hld/k", f"legal-hold&{q}", status=200).body
    pair.same("DELETE", "/hld/k", q, headers=BYPASS, err="ObjectLocked")
    pair.same("GET", "/hld/k", f"retention&{q}",
              err="NoSuchObjectLockConfiguration")
    pair.same("PUT", "/hld/k", f"legal-hold&{q}", hold_doc("OFF"),
              status=200)
    pair.same("PUT", "/hld/k", f"legal-hold&{q}", hold_doc("MAYBE"),
              err="MalformedXML")
    vid2 = _vid(pair.same("PUT", "/hld/k", body=b"y" * 100, status=200))
    assert b"<Status>OFF</Status>" in pair.same(
        "GET", "/hld/k", f"legal-hold&versionId={vid2}", status=200).body
    pair.same("PUT", "/hld/k", "legal-hold", hold_doc("ON"), status=200)
    pair.same("DELETE", "/hld/k", f"versionId={vid2}", err="ObjectLocked")
    pair.same("DELETE", "/hld/k", q, status=204)


def test_the_multi_object_delete_keeps_locked_versions(pair):
    locked = _vid(pair.same("PUT", "/lck/m1", body=b"1", status=200))
    held = _vid(pair.same("PUT", "/hld/m2", body=b"2", headers={
        "x-amz-object-lock-legal-hold": "ON"}, status=200))
    free = _vid(pair.same("PUT", "/hld/m3", body=b"3", status=200))
    r = pair.same("POST", "/lck", "delete", (
        f"<Delete><Object><Key>m1</Key><VersionId>{locked}</VersionId>"
        "</Object><Object><Key>m1</Key></Object></Delete>").encode(),
        status=200)
    assert r.body.count(b"<Code>ObjectLocked</Code>") == 1
    assert b"<DeleteMarker>true</DeleteMarker>" in r.body
    r = pair.same("POST", "/hld", "delete", (
        f"<Delete><Object><Key>m2</Key><VersionId>{held}</VersionId>"
        f"</Object><Object><Key>m3</Key><VersionId>{free}</VersionId>"
        "</Object></Delete>").encode(), headers=BYPASS, status=200)
    assert r.body.count(b"<Code>ObjectLocked</Code>") == 1
    assert pair.same("GET", "/hld/m2", f"versionId={held}").body == b"2"
    pair.same("GET", "/hld/m3", f"versionId={free}", err="NoSuchKey")


def _iso(dt: datetime.datetime) -> str:
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


FUTURE = _iso(datetime.datetime.now(datetime.timezone.utc)
              + datetime.timedelta(days=30))


@pytest.mark.parametrize("bucket,headers", [
    ("lck", {"x-amz-object-lock-mode": "GOVERNANCE"}),
    ("lck", {"x-amz-object-lock-retain-until-date": FUTURE}),
    ("lck", {"x-amz-object-lock-mode": "WORM",
             "x-amz-object-lock-retain-until-date": FUTURE}),
    ("lck", {"x-amz-object-lock-mode": "COMPLIANCE",
             "x-amz-object-lock-retain-until-date": "2001-01-01T00:00:00Z"}),
    ("lck", {"x-amz-object-lock-mode": "COMPLIANCE",
             "x-amz-object-lock-retain-until-date": "tomorrow"}),
    ("lck", {"x-amz-object-lock-legal-hold": "on"}),
    ("pln", {"x-amz-object-lock-legal-hold": "ON"}),
], ids=["mode-alone", "date-alone", "bad-mode", "past", "bad-date",
        "bad-hold", "plain-bucket"])
def test_lock_header_refusals(pair, bucket, headers):
    pair.same("PUT", f"/{bucket}/refused", body=b"r", headers=headers,
              err="InvalidRequest")
    pair.same("POST", f"/{bucket}/refused", "uploads", headers=headers,
              err="InvalidRequest")


def test_retention_and_hold_refusals(pair):
    pair.same("PUT", "/pln/plain", body=b"p", status=200)
    later = pair.now + datetime.timedelta(days=1)
    pair.same("PUT", "/pln/plain", "retention",
              retention_doc("GOVERNANCE", later), err="InvalidRequest")
    pair.same("PUT", "/pln/plain", "legal-hold", hold_doc("ON"),
              err="InvalidRequest")
    pair.same("GET", "/pln/plain", "retention",
              err="NoSuchObjectLockConfiguration")
    assert b"<Status>OFF</Status>" in pair.same(
        "GET", "/pln/plain", "legal-hold", status=200).body
    pair.same("PUT", "/lck/rr", body=b"r", status=200)
    for doc in (b"<Retention", retention_doc("WORM", later),
                retention_doc("GOVERNANCE", pair.now
                              - datetime.timedelta(days=1)),
                retention_doc("GOVERNANCE", later).replace(
                    _iso(later).encode(), b"soon")):
        pair.same("PUT", "/lck/rr", "retention", doc, err="MalformedXML")
    pair.same("PUT", "/lck/none", "retention",
              retention_doc("GOVERNANCE", later), err="NoSuchKey")
    pair.same("POST", "/lck/rr", "retention", status=405)


def test_the_refusals_launch_nothing(pair):
    adm = AdminClient(f"http://127.0.0.1:{pair.port.port}", AK, SK)

    def ops() -> float:
        return sum(float(line.rsplit(" ", 1)[1])
                   for line in adm.metrics().splitlines()
                   if line.startswith("mt_tpu_ops_total"))

    vid = _vid(pair.same("PUT", "/lck/quiet", body=b"q" * 300_000,
                         status=200))
    before = ops()
    pair.same("DELETE", "/lck/quiet", f"versionId={vid}",
              err="ObjectLocked")
    pair.same("PUT", "/lck/quiet", f"legal-hold&versionId={vid}",
              hold_doc("ON"), status=200)
    pair.same("DELETE", "/lck/quiet", f"versionId={vid}", headers=BYPASS,
              err="ObjectLocked")
    pair.same("PUT", "/lck/quiet", "tagging", (
        f"<Tagging {NS}><TagSet><Tag><Key>a</Key><Value>b</Value></Tag>"
        "</TagSet></Tagging>").encode(), status=200)
    assert ops() == before


def test_drives_match_reference(pair):
    """Last: every drive of both servers holds the same bytes."""
    assert_drives_equal(pair.root, 8)


# -- the background ------------------------------------------------------------

EXPIRE_NONCURRENT = (
    "<LifecycleConfiguration><Rule><ID>nc</ID><Status>Enabled</Status>"
    "<Filter><Prefix></Prefix></Filter><NoncurrentVersionExpiration>"
    "<NoncurrentDays>1</NoncurrentDays></NoncurrentVersionExpiration>"
    "</Rule></LifecycleConfiguration>")


UNTIL = _iso(datetime.datetime.now(datetime.timezone.utc)
             + datetime.timedelta(days=2))


def _lock_meta(kind: str) -> dict:
    until = UNTIL
    return {"compliance": {olock.AMZ_OBJECT_LOCK_MODE: "COMPLIANCE",
                           olock.AMZ_OBJECT_LOCK_RETAIN_UNTIL: until},
            "governance": {olock.AMZ_OBJECT_LOCK_MODE: "GOVERNANCE",
                           olock.AMZ_OBJECT_LOCK_RETAIN_UNTIL: until},
            "hold": {olock.AMZ_OBJECT_LOCK_LEGAL_HOLD: "ON"},
            "plain": {}}[kind]


KINDS = ("compliance", "governance", "hold", "plain")


@pytest.mark.parametrize("name", ["ref", "port"])
def test_lifecycle_expiry_passes_a_locked_version(tmp_path, monkeypatch,
                                                   name):
    """A NoncurrentVersionExpiration rule over a lock bucket: the port
    expires the version no lock protects and passes the COMPLIANCE, the
    GOVERNANCE (no bypass) and the held one; the reference's crawler
    deletes all four (ROADMAP Queue 3)."""
    pin(monkeypatch)
    make, cr = (ref_layer, ref_cr) if name == "ref" else (port_layer,
                                                           port_cr)
    er = make(tmp_path / name)
    try:
        meta = BucketMetadataSys(er) if is_port(er) else RefMeta(er)
        er.make_bucket("lck")
        meta.set_versioning("lck", True)
        meta.set_config("lck", "object-lock",
                        olock.LockConfig(enabled=True).to_xml().decode())
        vids = {}
        for i, kind in enumerate(KINDS):
            vids[kind] = er.put_object(
                "lck", "k", body(100 + i, i), put_opts(
                    er, versioned=True, user_defined=_lock_meta(kind))
            ).version_id
        er.put_object("lck", "k", b"latest", put_opts(er, versioned=True))
        meta.set_config("lck", "lifecycle", EXPIRE_NONCURRENT)
        expired = [e[2] for e in cr.scan_usage(er, meta).expired]
        left = []
        for kind in KINDS:
            try:
                _, data = er.get_object("lck", "k", opts=obj_opts(
                    er, version_id=vids[kind]))
                assert data == body(100 + KINDS.index(kind),
                                    KINDS.index(kind))
                left.append(kind)
            except Exception:  # noqa: BLE001 — deleted
                pass
    finally:
        close(er)
    if name == "ref":
        assert sorted(expired) == sorted(vids.values()) and left == [], \
            "reference fault gone"
        return
    assert expired == [vids["plain"]]
    assert left == ["compliance", "governance", "hold"]


@pytest.mark.parametrize("hold", ["legal-hold", "compliance"])
def test_a_lock_set_after_the_listing_stops_the_expiry(tmp_path,
                                                       monkeypatch, hold):
    """A legal hold or a COMPLIANCE retention set on a noncurrent version
    after the crawler listed the bucket and before it expires the
    version: the layer judges the lock on the version as it stands,
    under the name's write lock, so the version stays and is not
    counted as expired."""
    pin(monkeypatch)
    er = port_layer(tmp_path / "port")
    try:
        meta = BucketMetadataSys(er)
        er.make_bucket("lck")
        meta.set_versioning("lck", True)
        meta.set_config("lck", "object-lock",
                        olock.LockConfig(enabled=True).to_xml().decode())
        old = er.put_object("lck", "k", body(300, 1),
                            put_opts(er, versioned=True)).version_id
        er.put_object("lck", "k", b"latest", put_opts(er, versioned=True))
        meta.set_config("lck", "lifecycle", EXPIRE_NONCURRENT)
        listed = port_cr._list_versions_with_pools

        def list_then_lock(layer, bucket):
            out = listed(layer, bucket)
            er.put_object_metadata("lck", "k", old, _lock_meta(
                "hold" if hold == "legal-hold" else "compliance"))
            return out

        monkeypatch.setattr(port_cr, "_list_versions_with_pools",
                            list_then_lock)
        assert port_cr.scan_usage(er, meta).expired == []
        _, data = er.get_object("lck", "k",
                                opts=obj_opts(er, version_id=old))
        assert data == body(300, 1)
    finally:
        close(er)


def test_a_locked_version_delete_is_refused_in_the_layer(tmp_path,
                                                         monkeypatch):
    """``ObjectOptions.check_lock``: the layer refuses (ObjectLocked) a
    version delete that the version's lock forbids, GOVERNANCE yields to
    ``bypass_governance``, a delete marker and an absent version pass,
    and a delete without ``check_lock`` (the rebalancer's) is not
    judged."""
    from minio_tpu_torch.objectlayer.interface import ObjectLocked
    pin(monkeypatch)
    er = port_layer(tmp_path / "port")
    try:
        er.make_bucket("lck")
        vids = {kind: er.put_object("lck", kind, body(100, 1), put_opts(
            er, versioned=True, user_defined=_lock_meta(kind))).version_id
            for kind in KINDS}
        for kind, vid in vids.items():
            opts = obj_opts(er, version_id=vid, check_lock=True)
            if kind == "plain":
                er.delete_object("lck", kind, opts)
                continue
            with pytest.raises(ObjectLocked):
                er.delete_object("lck", kind, opts)
            er.delete_object("lck", kind, obj_opts(er, versioned=True,
                                                   check_lock=True))
        er.delete_object("lck", "governance", obj_opts(
            er, version_id=vids["governance"], check_lock=True,
            bypass_governance=True))
        er.delete_object("lck", "plain", obj_opts(
            er, version_id=vids["plain"], check_lock=True))
        er.delete_object("lck", "hold", obj_opts(er,
                                                 version_id=vids["hold"]))
        left = {o.name for o in er.list_object_versions("lck").objects
                if not o.delete_marker}
        assert left == {"compliance"}
    finally:
        close(er)


def _fill_locked(dep) -> dict:
    """Pool 1 of pools 0 and 1: versions under COMPLIANCE retention,
    under legal hold and tagged, and a plain one; bodies by id."""
    lay, o = dep.layer, ol(dep.layer)
    lay.make_bucket("bkt")
    dep.attach(1)
    p1 = lay.pools[1]
    out = {}
    for i, kind in enumerate(KINDS):
        ud = dict(_lock_meta(kind), **{"x-amz-tagging": f"kind={kind}"})
        oi = p1.put_object("bkt", f"k{i % 2}", body(2000 + i, i),
                           o.PutObjectOptions(versioned=True,
                                              user_defined=ud))
        out[(f"k{i % 2}", oi.version_id)] = body(2000 + i, i)
    p1.put_object_metadata("bkt", "k0", None, {"x-amz-meta-late": "1"})
    return out


def test_a_drain_moves_locked_and_tagged_versions(tmp_path, monkeypatch):
    """A decommission drains pool 1's locked, held and tagged versions
    (the mover's source delete is internal, no S3 DELETE), each with its
    metadata, as the reference does: the same drives after."""
    pin_all(monkeypatch)
    got = []
    deps = [Deployment(tmp_path / "ref", False, [2 << 30, 6 << 30],
                       monkeypatch),
            Deployment(tmp_path / "port", True, [2 << 30, 6 << 30],
                       monkeypatch)]
    try:
        for dep in deps:
            bodies = _fill_locked(dep)
            before = _metas(dep.layer, bodies)
            dep.layer.start_decommission(1)
            assert dep.rebalancer().run_once()
            assert len(dep.layer.pools) == 1
            assert _metas(dep.layer, bodies) == before
            for (key, vid), data in bodies.items():
                assert dep.layer.get_object("bkt", key, opts=ol(
                    dep.layer).ObjectOptions(version_id=vid))[1] == data
            got.append(before)
        assert got[1] == got[0]
        assert any(olock.AMZ_OBJECT_LOCK_MODE in m for m in got[1])
    finally:
        for dep in deps:
            dep.close()
    assert_pools_equal(tmp_path / "port", tmp_path / "ref", 1)


def _metas(lay, bodies: dict) -> list[dict]:
    return [lay.get_object_info("bkt", key, ol(lay).ObjectOptions(
        version_id=vid)).user_defined for (key, vid) in bodies]


def test_a_metadata_update_during_a_move_is_not_undone(tmp_path,
                                                       monkeypatch):
    """A retention and tag update of the version the mover is copying,
    sent between its read of the source and its commit: the update waits
    on the pools' name lock and lands on the moved copy."""
    dep = Deployment(tmp_path, True, [2 << 30, 6 << 30], monkeypatch)
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        dep.attach(1)
        src = lay.pools[1]
        src.put_object("bkt", "k", body(5000, 1))
        lay.start_decommission(1)
        real_get = src.get_object
        fore: list[threading.Thread] = []
        update = {"x-amz-tagging": "during=move",
                  olock.AMZ_OBJECT_LOCK_LEGAL_HOLD: "ON"}

        def get_then_update(*a, **kw):
            got = real_get(*a, **kw)
            t = threading.Thread(target=lambda: lay.put_object_metadata(
                "bkt", "k", None, update))
            t.start()
            t.join(timeout=1.0)     # done here unless the move holds it off
            fore.append(t)
            return got

        monkeypatch.setattr(src, "get_object", get_then_update)
        assert dep.rebalancer().run_once()
        fore[0].join()
        monkeypatch.setattr(src, "get_object", real_get)
        assert len(lay.pools) == 1
        oi = lay.get_object_info("bkt", "k")
        assert {k: oi.user_defined.get(k) for k in update} == update
        assert lay.get_object("bkt", "k")[1] == body(5000, 1)
    finally:
        dep.close()
