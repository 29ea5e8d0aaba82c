"""Bucket replication between two servers on the port
(``minio_tpu_torch/background/replication.py``, ``S3Server.replicate``,
the replication PUT's ARN check, the remote-target admin routes and
``mt_replication_*``) against ``minio_tpu``'s.

``_torch_control.replication_pairs`` builds a source and a destination
server in each package, clocks and ids pinned.  The same pinned request
sequence on both sources (a PUT with metadata, a streamed PUT, a
POST-policy upload, a multipart upload, a copy, two PUTs of one key, a
DELETE that writes a marker, a key outside the rule), with one worker and
each task finished before the next request, leaves both sources' drives
(their PENDING and COMPLETED stamps) and both destinations' drives byte
for byte equal, and the admin routes and ``mt_replication_*`` answer
alike.  That test runs first: the fault cases after it make the two
packages' drives and counters differ on purpose (ROADMAP Queue 3).

The reference faults the port does not carry, each with its [ref] case:
``arn_exists`` is missing, so a replication PUT after a target is set
answers 500; the worker reads and stamps the latest version, not the
queued one; persisted targets are not loaded at boot; an SSE or
compressed object is sent as its stored bytes and a stub as an empty
body.  Then the reference's own replication tests
(``tests/test_background.py``) on the port's layers and servers, each
package loading the other's ``targets.json``, and a port source
replicating to a reference destination."""

import base64
import json
import os
import re
import threading
import time
import types

import pytest

import minio_tpu.s3.handlers_object as ref_ho
from minio_tpu import server_main as ref_main
from minio_tpu.background import replication as ref_repl
from minio_tpu.objectlayer import interface as ref_ol
from minio_tpu_torch import server_main as port_main
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.background import replication as port_repl
from minio_tpu_torch.crypto import sse as csse
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.objectlayer.bucket_meta import BucketMetadataSys
from minio_tpu_torch.s3 import handlers_object as port_ho
from minio_tpu_torch.s3.server import S3Server

from ._torch_control import (AK, SK, both, client, replication_pairs,
                             start_replication)
from ._torch_objfeat import (Pair, assert_drives_equal,
                             assert_no_event_threads,
                             assert_no_replication_threads)
from ._torch_versions import (Draws, body, close, is_port, port_layer,
                              ref_layer)

ADMIN = "/minio-tpu/admin/v1"
N = 8                                   # drives per server (2 sets of 4)
V = b"<VersioningConfiguration><Status>Enabled</Status>" \
    b"</VersioningConfiguration>"
MASTER = "repl-test-key:" + base64.b64encode(bytes(range(32))).decode()
SSE = {"x-amz-server-side-encryption": "AES256"}
TEXT = b"".join(b"line %06d: a log the front stores compressed\n" % i
                for i in range(400))
STREAM_AT = 20_000                      # a larger PUT body streams
# what a fault test touches: left out of the equality of the drives
FAULT_PATHS = ("f", ".mt.sys/buckets/f", ".mt.sys/replication/")


def arn_of(bucket: str) -> str:
    return f"arn:minio:replication::1:{bucket}"


def repl_cfg(arn: str, prefix: str = "in/") -> bytes:
    return (f'<ReplicationConfiguration><Rule><ID>r1</ID><Status>Enabled'
            f'</Status><Priority>1</Priority><DeleteMarkerReplication>'
            f'<Status>Enabled</Status></DeleteMarkerReplication><Filter>'
            f'<Prefix>{prefix}</Prefix></Filter><Destination><Bucket>{arn}'
            f'</Bucket></Destination></Rule></ReplicationConfiguration>'
            ).encode()


def target(dst, bucket: str) -> dict:
    return {"arn": arn_of(bucket), "endpoint": dst.endpoint,
            "target_bucket": bucket, "access_key": AK, "secret_key": SK}


def settle(srv, timeout: float = 30.0) -> None:
    """Wait until every task queued on ``srv`` has finished (either
    package: a finished task counts once in replicated, failed or
    deletes)."""
    st = srv.replication.stats
    deadline = time.monotonic() + timeout
    while st.replicated + st.failed + st.deletes_replicated < st.queued:
        assert time.monotonic() < deadline, st.to_dict()
        time.sleep(0.01)


def admin_json(resp) -> dict:
    return json.loads(resp.body)


def status_of(srv, bucket: str, key: str, vid: str) -> str:
    """The replication stamp of one version."""
    ol = port_ol if isinstance(srv, S3Server) else ref_ol
    oi = srv.layer.get_object_info(bucket, key,
                                   ol.ObjectOptions(version_id=vid))
    return oi.user_defined.get(port_repl.STATUS_KEY, "")


def versions(srv, bucket: str, key: str) -> list[tuple[str, bytes]]:
    """(version id, body) of ``key``'s versions on ``srv``, newest
    first."""
    c = client(srv)
    return [(v["version_id"], c.get_object(bucket, key,
                                           version_id=v["version_id"]).body)
            for v in c.list_object_versions(bucket, key)
            if v["key"] == key and not v["delete_marker"]]


def setup_buckets(src: Pair, dst: Pair, sb: str, db: str,
                  prefix: str = "in/") -> None:
    """Versioned ``sb`` and ``db``, the rule on ``sb`` (set before any
    plane exists, so the reference's missing ``arn_exists`` is not
    reached), and each source's target for ``sb``."""
    for pair, b in ((src, sb), (dst, db)):
        pair.same("PUT", f"/{b}", status=200)
        pair.same("PUT", f"/{b}", "versioning", V, status=200)
    for s in (src.ref, src.port):
        s.bucket_meta.set_config(sb, "replication",
                                 repl_cfg(arn_of(db), prefix).decode())
    for s, d in ((src.ref, dst.ref), (src.port, dst.port)):
        AdminClient(s.endpoint, AK, SK).set_remote_target(sb, target(d, db))


@pytest.fixture(scope="module")
def repl(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("MT_COMPRESSION_ENABLE", "on")
    mp.setenv("MINIO_TPU_KMS_SECRET_KEY", MASTER)
    root = tmp_path_factory.mktemp("repl")
    before = set(threading.enumerate())
    try:
        with replication_pairs(root, mp) as (rsrc, psrc, rdst, pdst):
            mp.setattr(port_ho, "STREAM_PUT_THRESHOLD", STREAM_AT)
            mp.setattr(ref_ho, "STREAM_PUT_THRESHOLD", STREAM_AT)
            mp.setattr(os, "urandom", Draws(29))
            yield types.SimpleNamespace(src=Pair(rsrc, psrc, root / "src"),
                                        dst=Pair(rdst, pdst, root / "dst"),
                                        root=root)
    finally:
        mp.undo()
    assert_no_event_threads(before=before)
    assert_no_replication_threads(before)


# -- the same sequence, the same drives -----------------------------------------

def _multipart(c, bucket: str, key: str, parts: list[bytes]):
    uid = c.create_multipart_upload(bucket, key)
    etags = [(i + 1, c.upload_part(bucket, key, uid, i + 1, p,
                                   chunked=False))
             for i, p in enumerate(parts)]
    return c.complete_multipart_upload(bucket, key, uid, etags)


def test_the_same_sequence_leaves_equal_drives(repl):
    """One worker, each task finished before the next request: both
    sources' and both destinations' drives equal, every replicated
    version COMPLETED, the replicas' bodies and metadata the sources',
    and the admin routes and ``mt_replication_*`` alike."""
    src, dst = repl.src, repl.dst
    for s in (src.ref, src.port):
        start_replication(s, workers=1)
    setup_buckets(src, dst, "rsrc", "rdst")
    small, big = body(3000, 1), body(30_000, 2)
    meta = {"x-amz-meta-color": "teal", "Content-Type": "text/plain"}

    def each(fn):
        out = [fn(s) for s in (src.ref, src.port)]
        for s in (src.ref, src.port):
            settle(s)
        return out

    src.same("PUT", "/rsrc/in/one", body=small, headers=meta, status=200)
    each(lambda s: None)
    src.same("PUT", "/rsrc/in/big", body=big, status=200)      # streamed
    each(lambda s: None)
    got = each(lambda s: client(s).post_object("rsrc", "in/post", small,
                                               fields={"x-amz-meta-via":
                                                       "form"}).status)
    assert got[0] == got[1] == 204
    got = each(lambda s: _multipart(client(s), "rsrc", "in/mp",
                                    [body(5000, 3), body(2000, 4)]).status)
    assert got == [200, 200]
    src.same("PUT", "/rsrc/in/copy", headers={
        "x-amz-copy-source": "/rsrc/in/one"}, status=200)
    each(lambda s: None)
    for i in range(2):
        src.same("PUT", "/rsrc/in/twice", body=body(1000 + i, 5 + i),
                 status=200)
        each(lambda s: None)
    src.same("DELETE", "/rsrc/in/copy", status=204)
    each(lambda s: None)
    src.same("PUT", "/rsrc/out/skip", body=small, status=200)
    each(lambda s: None)
    # the replicas: bodies and metadata as the source's GET gives them
    for key in ("in/one", "in/big", "in/post", "in/mp", "in/twice"):
        r, p = (client(s).get_object("rsrc", key) for s in (src.ref,
                                                             src.port))
        d = client(dst.port).get_object("rdst", key)
        assert d.body == p.body == r.body, key
        assert d.headers["Content-Type"] == p.headers["Content-Type"], key
        for h, v in p.headers.items():
            if h.lower().startswith("x-amz-meta-"):
                assert d.headers.get(h) == v, (key, h)
    assert client(dst.port).get_object("rdst", "in/one").headers[
        "x-amz-meta-color"] == "teal"
    assert [b for _, b in versions(dst.port, "rdst", "in/twice")] == \
        [body(1001, 6), body(1000, 5)]
    dv = client(dst.port).list_object_versions("rdst", "in/copy")
    assert [v["delete_marker"] for v in dv] == [True, False]
    assert client(dst.port).list_objects("rdst", "out/")["objects"] == []
    for v in client(src.port).list_object_versions("rsrc", "in/"):
        if not v["delete_marker"]:
            assert status_of(src.port, "rsrc", v["key"], v["version_id"]) \
                == "COMPLETED", v
    # the drives, the stamps among them
    assert_drives_equal(repl.root / "src", N, skip=FAULT_PATHS)
    assert_drives_equal(repl.root / "dst", N, skip=FAULT_PATHS)
    # the targets' file: each package's bytes but the endpoint
    files = {}
    for tag, d in (("ref", dst.ref), ("port", dst.port)):
        with open(repl.root / "src" / tag / "d0" / ".mt.sys" /
                  port_repl.TARGETS_PATH, "rb") as f:
            files[tag] = f.read().replace(d.endpoint.encode(), b"*")
    assert files["ref"] == files["port"]
    # the admin routes
    for route in ("replication-stats", "bandwidth"):
        r, p = both(src.ref, src.port, "GET", f"{ADMIN}/{route}")
        assert p.status == r.status == 200
        assert admin_json(p) == admin_json(r), route
    stats = admin_json(both(src.ref, src.port, "GET",
                            f"{ADMIN}/replication-stats")[1])
    assert stats == {"queued": 8, "replicated": 7, "replicaBytes":
                     3 * 3000 + 30_000 + 7000 + 1000 + 1001,
                     "failed": 0, "deletesReplicated": 1}
    r, p = both(src.ref, src.port, "GET", f"{ADMIN}/list-remote-targets")
    masked = [json.dumps(admin_json(x)).replace(d.endpoint, "*")
              for x, d in ((r, dst.ref), (p, dst.port))]
    assert masked[0] == masked[1]
    r, p = both(src.ref, src.port, "GET", f"{ADMIN}/background-status")
    rb, pb = admin_json(r)["replication"], admin_json(p)["replication"]
    assert (pb["stats"], pb["bandwidth"]) == (rb["stats"], rb["bandwidth"])
    assert pb["progress"].keys() == rb["progress"].keys()
    # the scrape: every family alike but the pending gauge and the rates
    scrapes = [_replication_lines(client(s).request(
        "GET", "/minio-tpu/metrics", sign=False).body.decode())
        for s in (src.ref, src.port)]
    timing = re.compile(r"^mt_replication_(pending|objects_per_second|"
                        r"bytes_per_second|cycle_active) ")
    exact = [[ln for ln in sc if not timing.match(ln)] for sc in scrapes]
    assert exact[0] == exact[1] and len(exact[1]) == 18
    for sc in scrapes:
        vals = {ln.split()[0]: float(ln.split()[1]) for ln in sc
                if timing.match(ln)}
        assert vals["mt_replication_pending"] == 0
        assert vals["mt_replication_cycle_active"] == 1
        assert vals["mt_replication_objects_per_second"] > 0
        assert vals["mt_replication_bytes_per_second"] > 0


def _replication_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines()
            if "mt_replication_" in ln or "mt_bucket_bandwidth_" in ln]


def test_admin_routes_answer_alike(repl):
    """Without a replication plane (the destinations) the routes answer
    empty, 400 "replication not enabled", and null in
    ``background-status``; with one, a bucket without a target is 404, a
    bandwidth limit is set and reported; an identity without ``admin:*``
    is refused; the scrape of a server without a plane has no
    ``mt_replication_*``."""
    src, dst = repl.src, repl.dst
    for method, route, query in (
            ("GET", "replication-stats", ""),
            ("GET", "list-remote-targets", ""),
            ("GET", "bandwidth", ""),
            ("POST", "remove-remote-target", "bucket=rdst"),
            ("POST", "set-bandwidth-limit", "bucket=rdst&limit=5"),
            ("POST", "remove-remote-target", ""),
            ("GET", "background-status", "")):
        r, p = both(dst.ref, dst.port, method, f"{ADMIN}/{route}", query)
        assert p.status == r.status, route
        if route == "background-status":
            assert admin_json(p)["replication"] is \
                admin_json(r)["replication"] is None
        else:
            assert admin_json(p) == admin_json(r), route
    r, p = both(dst.ref, dst.port, "GET", "/minio-tpu/metrics", sign=False)
    assert not _replication_lines(p.body.decode())
    assert not _replication_lines(r.body.decode())
    r, p = both(src.ref, src.port, "POST", f"{ADMIN}/remove-remote-target",
                "bucket=nosuch")
    assert p.status == r.status == 404
    assert admin_json(p) == admin_json(r)
    for limit in ("1000000", "0"):
        r, p = both(src.ref, src.port, "POST", f"{ADMIN}/set-bandwidth-limit",
                    f"bucket=rsrc&limit={limit}")
        assert p.status == r.status == 200 and p.body == r.body
        r, p = both(src.ref, src.port, "GET", f"{ADMIN}/bandwidth")
        assert admin_json(p) == admin_json(r)
        assert admin_json(p)["rsrc"]["limitInBytesPerSecond"] == int(limit)
    r, p = both(src.ref, src.port, "GET", f"{ADMIN}/replication-stats",
                sign=False)
    assert p.status == r.status == 403
    for s in (src.ref, src.port):
        AdminClient(s.endpoint, AK, SK).add_user("viewer", "viewer-secret",
                                                 ["readwrite"])
        out = client(s, "viewer", "viewer-secret").request(
            "POST", f"{ADMIN}/set-remote-target", body=b"{}", expect=())
        assert (out.status, out.xml().findtext("Code")) == \
            (403, "AccessDenied")


# -- reference faults the port does not carry -----------------------------------

def test_a_replication_config_is_checked_against_the_targets(repl):
    """Once a target is set, a replication PUT naming it answers 200 on
    the port and one naming no target ReplicationDestinationNotFoundError.
    [ref]: the reference calls an ``arn_exists`` it lacks, so both answer
    500."""
    src = repl.src
    src.same("PUT", "/farn", status=200)
    src.same("PUT", "/farn", "versioning", V, status=200)
    for arn, want in ((arn_of("rdst"), (200, None)),
                      (arn_of("nosuch"),
                       (404, "ReplicationDestinationNotFoundError"))):
        r, p = src.both("PUT", "/farn", "replication", repl_cfg(arn))
        assert (p.status, p.xml().findtext("Code") if p.body else None) \
            == want
        assert (r.status, r.xml().findtext("Code")) == (500, "InternalError")


def _deferred(srv):
    """The source's plane swapped for one not started yet: tasks queue
    and wait; returns it (start it, then ``settle``)."""
    srv.replication.stop()
    return start_replication(srv, workers=1, start=False)


def test_the_queued_version_is_replicated(repl):
    """Two PUTs of one key queued before the worker runs: the port sends
    each version and stamps each COMPLETED, so the destination's latest
    body is the newer.  [ref]: the reference reads and stamps the latest
    version for both tasks, so the older stays PENDING and the
    destination holds the newer body twice."""
    src, dst = repl.src, repl.dst
    setup_buckets(src, dst, "fver", "fverd", prefix="")
    seen = {}
    for s, d in ((src.ref, dst.ref), (src.port, dst.port)):
        plane = _deferred(s)
        vids = [client(s).put_object("fver", "k", body(500 + i, 20 + i))
                .headers["x-amz-version-id"] for i in range(2)]
        plane.start()
        settle(s)
        seen["port" if s is src.port else "ref"] = (
            [status_of(s, "fver", "k", v) for v in vids],
            [b for _, b in versions(d, "fverd", "k")])
    new, old = body(501, 21), body(500, 20)
    assert seen["port"] == (["COMPLETED", "COMPLETED"], [new, old])
    assert seen["ref"] == (["PENDING", "COMPLETED"], [new, new])


def test_transformed_objects_and_stubs(repl, tmp_path):
    """An SSE-S3 and a compressed object reach the destination as the
    source's GET gives them, and a version transitioned to a tier before
    its task ran fails its task (FAILED, counted), where the reference
    sends the stored ciphertext, the compressed stream and the stub's
    empty body ([ref])."""
    src, dst = repl.src, repl.dst
    setup_buckets(src, dst, "ftx", "ftxd", prefix="")
    data = {"sse.dat": (body(3000, 30), SSE), "log.txt": (TEXT, None)}
    out = {}
    for s, d in ((src.ref, dst.ref), (src.port, dst.port)):
        tag = "port" if s is src.port else "ref"
        c = client(s)
        for key, (payload, hdrs) in data.items():
            c.put_object("ftx", key, payload, hdrs)
        settle(s)
        AdminClient(s.endpoint, AK, SK).add_tier(
            {"type": "dir", "name": "COLD", "path": str(tmp_path / tag)})
        plane = _deferred(s)
        vid = c.put_object("ftx", "stub.dat", body(2000, 31)).headers[
            "x-amz-version-id"]
        oi = s.layer.get_object_info("ftx", "stub.dat")
        oi.transition_tier = "COLD"
        s.transition.transition("ftx", oi)
        plane.start()
        settle(s)
        cd = client(d)
        out[tag] = ({k: cd.get_object("ftxd", k).body for k in data},
                    {k: s.layer.get_object("ftx", k)[1] for k in data},
                    status_of(s, "ftx", "stub.dat", vid),
                    plane.stats.failed,
                    sorted(v["key"] for v in cd.list_object_versions("ftxd")))
    got, stored, stub_status, failed, listed = out["port"]
    assert got == {k: v[0] for k, v in data.items()}
    assert stub_status == "FAILED" and failed == 1
    assert listed == ["log.txt", "sse.dat"]
    got, stored, stub_status, failed, listed = out["ref"]
    assert got == stored and got["sse.dat"] != data["sse.dat"][0] and \
        got["log.txt"] != TEXT
    assert stub_status == "COMPLETED" and failed == 0
    assert client(dst.ref).get_object("ftxd", "stub.dat").body == b""


def test_an_ssec_version_fails_its_task(repl):
    """An SSE-C version can be opened with its client's key only, which
    the server does not keep: the port's task fails (FAILED, counted) and
    sends nothing, where the reference would send the ciphertext, as it
    does for SSE-S3 above."""
    src, dst = repl.src, repl.dst
    setup_buckets(src, dst, "fssec", "fssecd", prefix="")
    s = src.port
    sealed = {csse.META_SEALED_KEY: base64.b64encode(bytes(64)).decode()}
    assert csse.ObjectEncryption.kind_of(sealed) == "SSE-C"
    oi = s.layer.put_object("fssec", "k", body(100, 50),
                            port_ol.PutObjectOptions(user_defined=sealed,
                                                     versioned=True))
    failed = s.replication.stats.failed
    assert s.replication.queue("fssec", oi) is True
    settle(s)
    assert status_of(s, "fssec", "k", oi.version_id) == "FAILED"
    assert s.replication.stats.failed == failed + 1
    assert client(dst.port).list_object_versions("fssecd") == []


def test_targets_are_loaded_at_boot(tmp_path, monkeypatch, repl):
    """A server built over drives that hold a target replicates at once;
    ``stop()`` joins its workers.  [ref]: the reference's
    ``build_server`` leaves ``replication`` None over the same file."""
    monkeypatch.setenv("MT_CRAWL_INTERVAL_S", "1000000")
    dst = repl.dst
    for pair in (dst,):
        pair.same("PUT", "/fboot", status=200)
    kw = {"ref": dict(set_drive_count=4, backend="numpy", block_size=4096),
          "port": dict(set_drive_count=4, device="cpu", block_size=4096)}
    mains = {"ref": ref_main, "port": port_main}
    got = {}
    for tag in ("ref", "port"):
        dirs = [str(tmp_path / tag / f"d{i}") for i in range(4)]
        first = mains[tag].build_server(dirs, "127.0.0.1:0", AK, SK,
                                        **kw[tag])
        first.start()
        d = dst.ref if tag == "ref" else dst.port
        try:
            c = client(first)
            c.make_bucket("boot")
            c.set_bucket_versioning("boot", True)
            first.bucket_meta.set_config("boot", "replication", repl_cfg(
                arn_of("fboot"), "").decode())
            AdminClient(first.endpoint, AK, SK).set_remote_target(
                "boot", target(d, "fboot"))
        finally:
            first.replication.stop()
            first.stop()
        again = mains[tag].build_server(dirs, "127.0.0.1:0", AK, SK,
                                        **kw[tag])
        again.start()
        try:
            got[tag] = again.replication
            if again.replication is not None:
                client(again).put_object("boot", "k", b"after a restart")
                settle(again)
                threads = list(again.replication._threads)
        finally:
            again.stop()
    assert got["ref"] is None
    assert got["port"].get_target("boot").endpoint == dst.port.endpoint
    assert client(dst.port).get_object("fboot", "k").body == \
        b"after a restart"
    assert threads and not any(t.is_alive() for t in threads)


# -- interop --------------------------------------------------------------------

def test_each_package_loads_the_others_targets(tmp_path):
    """The same target written by either package is the same
    ``targets.json``, and each loads the other's."""
    tgt = {"arn": arn_of("dst"), "endpoint": "http://127.0.0.1:9",
           "target_bucket": "dst", "access_key": "a", "secret_key": "s",
           "region": "us-east-1"}
    blobs = {}
    for tag, mk, mod in (("port", port_layer, port_repl),
                         ("ref", ref_layer, ref_repl)):
        lay = mk(tmp_path / tag)
        try:
            meta = BucketMetadataSys(lay) if is_port(lay) else None
            sys_ = mod.ReplicationSys(lay, meta, None) if is_port(lay) \
                else mod.ReplicationSys(lay, meta)
            sys_.set_target("src", mod.ReplicationTarget(**tgt))
        finally:
            close(lay)
        with open(tmp_path / tag / "d0" / ".mt.sys" / port_repl.TARGETS_PATH,
                  "rb") as f:
            blobs[tag] = f.read()
    assert blobs["port"] == blobs["ref"]
    port_on_ref = port_layer(tmp_path / "ref")
    ref_on_port = ref_layer(tmp_path / "port")
    try:
        assert port_repl.load_targets(port_on_ref)["src"].to_dict() == tgt
        assert ref_repl.ReplicationSys(ref_on_port, None).get_target(
            "src").to_dict() == tgt
    finally:
        close(port_on_ref, ref_on_port)


def test_a_port_source_replicates_to_a_reference_destination(repl):
    src, dst = repl.src, repl.dst
    for pair, b in ((src, "fxs"), (dst, "fxd")):
        pair.same("PUT", f"/{b}", status=200)
    src.port.bucket_meta.set_versioning("fxs", True)
    src.port.bucket_meta.set_config("fxs", "replication",
                                    repl_cfg(arn_of("fxd"), "").decode())
    AdminClient(src.port.endpoint, AK, SK).set_remote_target(
        "fxs", target(dst.ref, "fxd"))
    client(src.port).put_object("fxs", "k", body(4000, 40),
                                {"x-amz-meta-from": "port"})
    settle(src.port)
    info, data = dst.ref.layer.get_object("fxd", "k")
    assert data == body(4000, 40)
    assert info.user_defined["x-amz-meta-from"] == "port"


# -- the reference's own tests (tests/test_background.py), on the port ----------

def _server(root) -> tuple:
    lay = port_layer(root)
    srv = S3Server(lay, port=0)
    srv.start()
    return srv, lay


def test_replication_end_to_end(tmp_path):
    src_srv, src_layer = _server(tmp_path / "src")
    dst_srv, dst_layer = _server(tmp_path / "dst")
    try:
        src_layer.make_bucket("srcb")
        dst_layer.make_bucket("dstb")
        bm = BucketMetadataSys(src_layer)
        bm.set_config("srcb", "replication", (
            '<ReplicationConfiguration>'
            '<Role>arn:minio:replication::1:dstb</Role>'
            '<Rule><ID>r1</ID><Status>Enabled</Status><Priority>1</Priority>'
            '<DeleteReplication><Status>Enabled</Status></DeleteReplication>'
            '<Destination><Bucket>arn:aws:s3:::dstb</Bucket></Destination>'
            '</Rule></ReplicationConfiguration>'))
        repl = port_repl.ReplicationSys(
            src_layer, bm,
            lambda b, k, v: port_ho.read_version(src_srv, b, k, v),
            workers=1)
        repl.set_target("srcb", port_repl.ReplicationTarget(
            arn="arn:minio:replication::1:dstb",
            endpoint=dst_srv.endpoint, target_bucket="dstb",
            access_key="minioadmin", secret_key="minioadmin"))
        repl.start()
        try:
            oi = src_layer.put_object(
                "srcb", "doc.txt", b"replicate me",
                port_ol.PutObjectOptions(user_defined={
                    "x-amz-meta-who": "tester",
                    "content-type": "text/plain"}))
            assert repl.queue("srcb", oi) is True
            assert repl.drain()
            doi, data = dst_layer.get_object("dstb", "doc.txt")
            assert data == b"replicate me"
            assert doi.user_defined.get("x-amz-meta-who") == "tester"
            soi = src_layer.get_object_info("srcb", "doc.txt")
            assert soi.user_defined.get(
                "x-amz-replication-status") == "COMPLETED"
            assert repl.stats.replicated == 1
            # delete replication (the rule opts in)
            doomed = src_layer.get_object_info("srcb", "doc.txt")
            src_layer.delete_object("srcb", "doc.txt")
            assert repl.queue("srcb", doomed, delete=True) is True
            assert repl.drain()
            with pytest.raises(port_ol.ObjectNotFound):
                dst_layer.get_object_info("dstb", "doc.txt")
            assert repl.stats.deletes_replicated == 1
            # the target registry persisted
            assert port_repl.load_targets(src_layer)["srcb"].endpoint == \
                dst_srv.endpoint
        finally:
            repl.stop()
    finally:
        src_srv.stop()
        dst_srv.stop()


def test_replication_no_rule_no_queue(tmp_path):
    src_srv, src_layer = _server(tmp_path / "nr")
    try:
        src_layer.make_bucket("plain")
        repl = port_repl.ReplicationSys(
            src_layer, BucketMetadataSys(src_layer),
            lambda b, k, v: port_ho.read_version(src_srv, b, k, v))
        oi = src_layer.put_object("plain", "x", b"1")
        assert repl.queue("plain", oi) is False
    finally:
        src_srv.stop()
