"""The port's S3 front against minio_tpu's, on the CPU, request for request.

One ``minio_tpu`` ``S3Server`` over ``ErasureObjects(backend="numpy")`` and
one port ``S3Server`` over ``ErasureObjects(device="cpu")``: four drives
each, parity 2, 4 KiB blocks, 1040 KiB stream batches, the same root
credential, and the same fixed clock for object mod times.  The
reference's hot-read cache is off (the port has none; it adds a header).
Every request below goes to both, signed the same way with the same
timestamp, and the two answers must carry the same status, body and
headers, in order, with only ``Date``, ``Server``, ``x-amz-request-id``,
``RequestId``, ``CreationDate`` and ``Location`` (it names the server's
port) masked.  After the whole sequence
the drives must hold the same bytes (bucket volumes, segment files and
journal; data-dir uuids masked) and no staging dir.

The streamed route is reached by lowering ``STREAM_PUT_THRESHOLD`` on
both sides, at the name each handler reads.  A streamed PUT whose
Content-MD5 or last chunk signature fails must leave no object, no
staging dir and no pooled buffer checked out on the port.  Multipart uploads and versioned buckets go to both with both packages'
clocks and uuid draws pinned to counters (``_torch_versions.pin``), so
upload ids, version ids and mod times agree.  Port-only tests cover what
the reference serves and the port does not (``NotImplemented``) and a
GET that loses quorum after its status line.  Last, both servers over
two sets of four drives each (``ErasureSets``), pinned so that formats
and placement agree: the same answers, the same drive bytes (format.json
included), and ``/minio/health/cluster`` with a set below quorum.
"""

import base64
import datetime
import email.utils
import hashlib
import http.client
import io
import os
import re
import shutil
import sys
import threading
import urllib.parse
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import minio_tpu.objectlayer.erasure_object as ref_eo
import minio_tpu.s3.handlers_object as ref_ho
from minio_tpu.objectlayer import hotread as ref_hotread
from minio_tpu.s3.server import S3Server as RefServer
from minio_tpu.storage.xl_storage import XLStorage as RefStorage
from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.ops import _build
from minio_tpu_torch.s3 import handlers_object as port_ho
from minio_tpu_torch.s3 import sigv4
from minio_tpu_torch.s3.server import S3Server
from minio_tpu_torch.storage.xl_storage import XLStorage
from minio_tpu_torch.utils import bufpool

from ._torch_versions import pin

N, PARITY, BS = 4, 2, 4096
BATCH = 260 * BS                    # a 1 MiB body fits one stream batch
THRESHOLD = 1_500_000               # larger HTTP bodies take the stream route
AK, SK = "s3-test-key", "s3-test-secret"
MOD_TIME = 1_760_000_000_123_456_789
B = "main"
NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"
UUID = re.compile(rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  rb"[0-9a-f]{12}")
VOLATILE_HEADERS = ("date", "server", "x-amz-request-id")
VOLATILE_XML = re.compile(rb"<(RequestId|CreationDate|Location)>[^<]*</\1>")
# inline in xl.meta, packed into segment files, one part file committed
# beside the MD5, a part file streamed in two batches, and the HTTP
# stream route (four batches)
SIZES = {"inline": 1000, "inline-max": 100 * 1024, "packed": 300_000,
         "part-single": 1_050_000, "part": 1_200_000,
         "streamed": 4 * 1024 * 1024 - 4321}


def _body(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed + size).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _md5_b64(data: bytes) -> str:
    return base64.b64encode(hashlib.md5(data).digest()).decode()


def _http_date(seconds: float) -> str:
    return email.utils.formatdate(seconds, usegmt=True)


class Resp:
    def __init__(self, status, headers, body):
        self.status, self.headers, self.body = status, headers, body

    def header(self, name: str) -> str | None:
        return next((v for k, v in self.headers
                     if k.lower() == name.lower()), None)

    def wire(self) -> tuple:
        """What must match: status, headers in order (volatile values
        masked), body (volatile XML values masked)."""
        return (self.status,
                [(k, "*" if k.lower() in VOLATILE_HEADERS else v)
                 for k, v in self.headers],
                VOLATILE_XML.sub(rb"<\1>*</\1>", self.body))


def raw_send(method, url, body=b"", headers=None) -> Resp:
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    try:
        conn.request(method, u.path + (f"?{u.query}" if u.query else ""),
                     body=body, headers=headers or {})
        r = conn.getresponse()
        return Resp(r.status, r.getheaders(), r.read())
    finally:
        conn.close()


def signed(auth, method, url, body, headers, ts):
    """(url, headers, body) of a request signed as ``auth`` says."""
    creds = sigv4.Credentials(AK, SK)
    if auth == "anon":
        return url, dict(headers), body
    if auth == "presign":
        return sigv4.presign_url(creds, method, url, 600,
                                 timestamp=ts), dict(headers), body
    if auth == "chunked":
        hdrs, framed = sigv4.sign_request_streaming(
            creds, method, url, headers, body, 64 * 1024, timestamp=ts)
        return url, hdrs, framed
    if auth == "badsig":
        creds = sigv4.Credentials(AK, SK + "x")
    elif auth == "unknown":
        creds = sigv4.Credentials("nobody", SK)
    elif auth == "skewed":
        ts -= datetime.timedelta(minutes=20)
    return url, sigv4.sign_request(creds, method, url, headers, body,
                                   timestamp=ts), body


class Pair:
    """The reference and the port behind one request interface."""

    def __init__(self, ref, port, ref_root, port_root):
        self.ref, self.port = ref, port
        self.ref_root, self.port_root = ref_root, port_root

    def both(self, method, path, query="", body=b"", headers=None,
             auth="v4", tamper=None) -> tuple[Resp, Resp]:
        ts = datetime.datetime.now(datetime.timezone.utc)
        out = []
        for srv in (self.ref, self.port):
            url = f"http://127.0.0.1:{srv.port}" + \
                urllib.parse.quote(path, safe="/~-._") + \
                (f"?{query}" if query else "")
            u, h, b = signed(auth, method, url, body, headers or {}, ts)
            if tamper is not None:
                b = tamper(b)
            out.append(raw_send(method, u, b, h))
        return out[0], out[1]

    def same(self, method, path, query="", body=b"", headers=None,
             auth="v4", status=None, tamper=None) -> Resp:
        ref, port = self.both(method, path, query, body, headers, auth,
                              tamper)
        assert port.wire() == ref.wire(), (method, path, query)
        if status is not None:
            assert port.status == status, port.body
        return port

    def error(self, method, path, code, status, **kw) -> Resp:
        r = self.same(method, path, status=status, **kw)
        assert f"<Code>{code}</Code>".encode() in r.body
        return r


def _drives(root, cls):
    out = []
    for i in range(N):
        os.makedirs(f"{root}/d{i}")
        out.append(cls(f"{root}/d{i}"))
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    saved = dict(ref_hotread.CONFIG.__dict__)
    mp.setenv("MT_CACHE_ENABLE", "off")
    for mod in (ref_eo, port_eo):
        mp.setattr(mod, "STREAM_BATCH_BYTES", BATCH)
        mp.setattr(mod, "now_ns", lambda: MOD_TIME)
    for mod in (ref_ho, port_ho):
        mp.setattr(mod, "STREAM_PUT_THRESHOLD", THRESHOLD)
    root = tmp_path_factory.mktemp("s3pair")
    ref = RefServer(ref_eo.ErasureObjects(_drives(root / "ref", RefStorage),
                                          parity=PARITY, block_size=BS,
                                          backend="numpy"),
                    access_key=AK, secret_key=SK)
    port = S3Server(port_eo.ErasureObjects(_drives(root / "port", XLStorage),
                                           parity=PARITY, block_size=BS,
                                           device="cpu"),
                    access_key=AK, secret_key=SK)
    ref.start()
    port.start()
    try:
        p = Pair(ref, port, root / "ref", root / "port")
        p.same("PUT", f"/{B}", status=200)
        yield p
    finally:
        port.stop()
        ref.stop()
        mp.undo()
        ref_hotread.CONFIG.__dict__.update(saved)


# -- the shared sequence (module order matters: the drives are compared
# -- at the end) -----------------------------------------------------------

def test_health_probes(pair):
    for path in ("/minio/health/live", "/minio/health/ready"):
        pair.same("GET", path, auth="anon", status=200)
        pair.same("HEAD", path, auth="anon", status=200)
    pair.error("POST", "/minio/health/live", "MethodNotAllowed", 405,
               auth="anon")


def test_health_cluster(pair):
    """One set of four local drives: ready for traffic, and not safe to
    take down for maintenance (412), as the reference answers."""
    for method in ("GET", "HEAD"):
        r = pair.same(method, "/minio/health/cluster", auth="anon",
                      status=200)
        assert r.header("X-Minio-Write-Quorum") == "3"
        pair.same(method, "/minio/health/cluster", "maintenance=true",
                  auth="anon", status=412)
    pair.same("GET", "/minio/health/cluster", "maintenance=false",
              auth="anon", status=200)
    pair.error("PUT", "/minio/health/cluster", "MethodNotAllowed", 405,
               auth="anon")
    pair.error("GET", "/minio/health/nope", "NoSuchKey", 404, auth="anon")


def test_bucket_lifecycle(pair):
    pair.same("PUT", "/life", status=200)
    pair.error("PUT", "/life", "BucketAlreadyOwnedByYou", 409)
    pair.same("HEAD", "/life", status=200)
    pair.same("GET", "/life", "location", status=200)
    pair.same("GET", "/life", "versioning", status=200)
    pair.same("GET", "/", status=200)
    # a bucket holding only a packed object is not empty
    pair.same("PUT", "/life/only-packed", body=_body(SIZES["packed"]),
              status=200)
    pair.error("DELETE", "/life", "BucketNotEmpty", 409)
    pair.same("DELETE", "/life/only-packed", status=204)
    pair.same("DELETE", "/life", status=204)
    pair.same("HEAD", "/life", status=404)
    pair.error("GET", "/life", "NoSuchBucket", 404, query="list-type=2")
    pair.error("DELETE", "/life", "NoSuchBucket", 404)
    pair.error("PUT", "/Bad_Name", "InvalidBucketName", 400)
    pair.error("GET", "/minio/x", "AccessDenied", 403)
    pair.same("GET", "/", status=200)


def test_object_round_trip(pair):
    for name, size in SIZES.items():
        if name == "streamed":
            continue
        body = _body(size)
        r = pair.same("PUT", f"/{B}/rt/{name}", body=body, status=200,
                      headers={"Content-Type": "application/x-test",
                               "x-amz-meta-color": "blue",
                               "X-Amz-Meta-Mixed-Case": "Yes"})
        assert r.header("ETag") == f'"{hashlib.md5(body).hexdigest()}"'
        got = pair.same("GET", f"/{B}/rt/{name}", status=200)
        assert got.body == body
        assert got.header("x-amz-meta-color") == "blue"
        pair.same("HEAD", f"/{B}/rt/{name}", status=200)
    pair.same("PUT", f"/{B}/rt/empty", status=200)
    assert pair.same("GET", f"/{B}/rt/empty", status=200).body == b""
    # an overwrite with another layout
    pair.same("PUT", f"/{B}/rt/inline", body=_body(SIZES["packed"], 1),
              status=200)
    assert pair.same("GET", f"/{B}/rt/inline").body == \
        _body(SIZES["packed"], 1)
    pair.error("GET", f"/{B}/rt/missing", "NoSuchKey", 404)
    pair.error("GET", "/nobucket/x", "NoSuchBucket", 404)


@pytest.mark.parametrize("spec,status", [
    ("bytes=0-0", 206), ("bytes=100-199", 206), ("bytes=1000-", 206),
    ("bytes=-500", 206), ("bytes=70000-200000", 206),
    ("bytes=5-100000000", 206), ("bytes=99999999-", 416),
    ("bytes=-0", 416), ("bytes=9-3", 416), ("items=1-2", 416)])
@pytest.mark.parametrize("name", ["inline-max", "packed", "part"])
def test_ranges(pair, name, spec, status):
    r = pair.same("GET", f"/{B}/rt/{name}", headers={"Range": spec},
                  status=status)
    if status == 206:
        first, _, rest = r.header("Content-Range")[6:].partition("-")
        last = int(rest.split("/")[0])
        assert r.body == _body(SIZES[name])[int(first):last + 1]


def test_preconditions(pair):
    path = f"/{B}/rt/packed"
    etag = hashlib.md5(_body(SIZES["packed"])).hexdigest()
    t = MOD_TIME / 1e9
    for hdrs, status in (
            ({"If-Match": f'"{etag}"'}, 200),
            ({"If-Match": '"0123"'}, 412),
            ({"If-Match": "*"}, 200),
            ({"If-None-Match": f'"{etag}"'}, 304),
            ({"If-None-Match": '"0123"'}, 200),
            ({"If-Modified-Since": _http_date(t + 3600)}, 304),
            ({"If-Modified-Since": _http_date(t - 3600)}, 200),
            ({"If-Modified-Since": "not a date"}, 200),
            ({"If-Unmodified-Since": _http_date(t - 3600)}, 412),
            ({"If-Unmodified-Since": _http_date(t + 3600)}, 200),
            ({"If-Match": f'"{etag}"',
              "If-Unmodified-Since": _http_date(t - 3600)}, 200),
            ({"If-None-Match": f'"{etag}"', "Range": "bytes=0-9"}, 304)):
        for method in ("GET", "HEAD"):
            pair.same(method, path, headers=hdrs, status=status)
    pair.same("HEAD", f"/{B}/rt/missing", status=404)
    pair.same("HEAD", f"/{B}/rt/missing", headers={"If-Match": "*"},
              status=404)


def test_deletes(pair):
    pair.same("DELETE", f"/{B}/never-there", status=204)
    for i in range(3):
        pair.same("PUT", f"/{B}/del/{i}", body=_body(200 * i + 1), status=200)
    doc = ('<Delete xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
           + "".join(f"<Object><Key>del/{k}</Key></Object>"
                     for k in ("0", "1", "nope")) + "</Delete>").encode()
    pair.same("POST", f"/{B}", "delete", body=doc, status=200)
    quiet = (b"<Delete><Quiet>true</Quiet><Object><Key>del/2</Key>"
             b"</Object></Delete>")
    pair.same("POST", f"/{B}", "delete", body=quiet, status=200)
    pair.error("POST", f"/{B}", "MalformedXML", 400, query="delete",
               body=b"<Delete><Object>")
    pair.error("GET", f"/{B}/del/1", "NoSuchKey", 404)


LIST_KEYS = ["a b/ü.txt", "a b/z", "dir/sub/one", "dir/sub/two", "dir/zz",
             "x-1", "x/y", "x/y-2/z", "日本/語", "top", "zz top", "%pct"]


def test_listing(pair):
    sizes = [10, SIZES["packed"], SIZES["part"], 0, 150_000]
    pair.same("PUT", "/lst", status=200)
    for i, key in enumerate(LIST_KEYS):
        pair.same("PUT", f"/lst/{key}",
                  body=_body(sizes[i] if i < len(sizes) else i, i),
                  status=200)
    q = urllib.parse.quote
    queries = ["", "list-type=2", "delimiter=/", "list-type=2&delimiter=/",
               "prefix=dir/", "list-type=2&prefix=dir/&delimiter=/",
               f"prefix={q('a b/')}&encoding-type=url",
               f"list-type=2&prefix={q('日')}&encoding-type=url",
               "list-type=2&delimiter=/&encoding-type=url",
               "list-type=2&start-after=dir/sub/one",
               "list-type=2&fetch-owner=true&max-keys=4",
               "marker=x-1", "max-keys=0", "prefix=zzz"]
    for query in queries:
        pair.same("GET", "/lst", query, status=200)
    for v2 in (False, True):
        for delim in ("", "/"):
            marker, pages = "", 0
            while True:
                query = ("list-type=2&" if v2 else "") + "max-keys=2" + \
                    (f"&delimiter={q(delim)}" if delim else "") + \
                    (f"&{'continuation-token' if v2 else 'marker'}="
                     f"{q(marker)}" if marker else "")
                doc = ET.fromstring(
                    pair.same("GET", "/lst", query, status=200).body)
                pages += 1
                if doc.findtext(f"{NS}IsTruncated") != "true":
                    break
                marker = doc.findtext(f"{NS}NextContinuationToken") or \
                    doc.findtext(f"{NS}NextMarker")
            assert 2 <= pages <= len(LIST_KEYS)
    pair.error("GET", "/lst", "InvalidArgument", 400,
               query="list-type=2&continuation-token=mt1-%21%21")
    pair.error("GET", "/lst", "InvalidArgument", 400,
               query="encoding-type=base64")


def test_auth_failures(pair):
    path = f"/{B}/auth/obj"
    pair.error("PUT", path, "SignatureDoesNotMatch", 403, body=b"abc",
               auth="badsig")
    pair.error("GET", f"/{B}/rt/packed", "InvalidAccessKeyId", 403,
               auth="unknown")
    pair.error("GET", f"/{B}/rt/packed", "RequestTimeTooSkewed", 403,
               auth="skewed")
    pair.error("GET", f"/{B}/rt/packed", "AccessDenied", 403, auth="anon")
    pair.error("PUT", path, "AccessDenied", 403, body=b"abc", auth="anon")
    pair.error("GET", "/", "AccessDenied", 403, auth="anon")
    pair.error("PUT", "/anon-bucket", "AccessDenied", 403, auth="anon")
    pair.same("POST", f"/{B}", "delete", auth="anon", status=200,
              body=b"<Delete><Object><Key>rt/packed</Key></Object></Delete>")
    pair.error("PUT", path, "BadDigest", 400, body=b"abc",
               tamper=lambda b: b"abd")
    pair.error("GET", f"/{B}/auth/obj", "NoSuchKey", 404)


def test_presigned_get_and_put(pair):
    body = _body(SIZES["packed"], 7)
    pair.same("PUT", f"/{B}/pre/put", body=body, auth="presign", status=200)
    assert pair.same("GET", f"/{B}/pre/put", auth="presign",
                     status=200).body == body
    big = _body(SIZES["streamed"], 7)
    pair.same("PUT", f"/{B}/pre/big", body=big, auth="presign", status=200)
    assert pair.same("GET", f"/{B}/pre/big").body == big


def test_aws_chunked_upload(pair):
    body = _body(200_000, 9)
    pair.same("PUT", f"/{B}/chunked/small", body=body, auth="chunked",
              headers={"Content-MD5": _md5_b64(body)}, status=200)
    assert pair.same("GET", f"/{B}/chunked/small").body == body


def test_content_md5(pair):
    body = _body(5000, 3)
    pair.same("PUT", f"/{B}/md5/ok", body=body,
              headers={"Content-MD5": _md5_b64(body)}, status=200)
    pair.error("PUT", f"/{B}/md5/bad", "BadDigest", 400, body=body,
               headers={"Content-MD5": _md5_b64(body + b"x")})
    pair.error("PUT", f"/{B}/md5/bad", "InvalidDigest", 400, body=body,
               headers={"Content-MD5": "abcde"})
    pair.error("GET", f"/{B}/md5/bad", "NoSuchKey", 404)


def test_streamed_put(pair):
    body = _body(SIZES["streamed"], 11)
    r = pair.same("PUT", f"/{B}/stream/signed", body=body, status=200,
                  headers={"Content-MD5": _md5_b64(body),
                           "Content-Type": "video/x-test"})
    assert r.header("ETag") == f'"{hashlib.md5(body).hexdigest()}"'
    pair.same("PUT", f"/{B}/stream/chunked", body=body, auth="chunked",
              headers={"Content-MD5": _md5_b64(body)}, status=200)
    for key in ("signed", "chunked"):
        assert pair.same("GET", f"/{B}/stream/{key}").body == body
        pair.same("GET", f"/{B}/stream/{key}",
                  headers={"Range": "bytes=65000-1300000"}, status=206)


def _staging(root) -> list:
    return [p for i in range(N)
            for p in os.listdir(f"{root}/d{i}/.mt.sys/tmp")]


def _last_chunk_signature_broken(framed: bytes) -> bytes:
    at = framed.rindex(b"0;chunk-signature=") + len(b"0;chunk-signature=")
    flip = b"1" if framed[at:at + 1] == b"0" else b"0"
    return framed[:at] + flip + framed[at + 1:]


@pytest.mark.parametrize("fault", ["content-md5", "chunk-signature"])
def test_failed_streamed_put_leaves_nothing(pair, fault):
    """The digest that fails at the end of a streamed body is read inside
    the port's PUT pipeline, with batches already in the drives' writer
    queues: no object, no staging dir, no pooled buffer checked out."""
    body = _body(SIZES["streamed"], 13)
    key = f"/{B}/stream/fail-{fault}"
    out_before = bufpool.GLOBAL.checked_out
    if fault == "content-md5":
        r = pair.error("PUT", key, "BadDigest", 400, body=body,
                       headers={"Content-MD5": _md5_b64(body[1:])})
    else:
        r = pair.error("PUT", key, "SignatureDoesNotMatch", 403, body=body,
                       auth="chunked", tamper=_last_chunk_signature_broken,
                       headers={"Content-MD5": _md5_b64(body)})
    assert r.body
    pair.error("GET", key, "NoSuchKey", 404)
    assert _staging(pair.port_root) == []
    assert bufpool.GLOBAL.checked_out == out_before
    # nothing stays locked: the key takes a PUT at once
    pair.same("PUT", key, body=b"after", status=200)


def _complete_doc(parts) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag></Part>"
        for n, e in parts) + "</CompleteMultipartUpload>").encode()


def _upload_id(resp) -> str:
    return ET.fromstring(resp.body).findtext(f"{NS}UploadId")


def test_multipart_upload(pair, monkeypatch):
    """CreateMultipartUpload, UploadPart buffered and streamed
    (aws-chunked, Content-MD5), ListParts, ListMultipartUploads,
    CompleteMultipartUpload and its errors, GET and ranges across parts,
    AbortMultipartUpload."""
    pin(monkeypatch, batch=BATCH)
    for srv in (pair.ref, pair.port):
        monkeypatch.setattr(srv.layer, "enforce_min_part_size", False)
    key = f"/{B}/mp/obj"
    uid = _upload_id(pair.same(
        "POST", key, "uploads", status=200,
        headers={"Content-Type": "text/x-mp", "x-amz-meta-a": "1"}))
    bodies = {1: _body(3 * BS + 5, 31), 2: _body(2 * 1024 * 1024, 32),
              3: _body(5000, 33), 4: b""}
    etags = {}
    for num, data in bodies.items():
        kw = {"auth": "chunked", "headers": {"Content-MD5": _md5_b64(data)}} \
            if num == 2 else {}
        r = pair.same("PUT", key, f"partNumber={num}&uploadId={uid}",
                      body=data, status=200, **kw)
        etags[num] = hashlib.md5(data).hexdigest()
        assert r.header("ETag") == f'"{etags[num]}"'
    pair.error("PUT", key, "BadDigest", 400, auth="chunked",
               query=f"partNumber=5&uploadId={uid}", body=bodies[2],
               headers={"Content-MD5": _md5_b64(b"x")})
    pair.error("PUT", key, "NoSuchUpload", 404,
               query="partNumber=1&uploadId=nope", body=b"x")
    pair.error("PUT", key, "InvalidArgument", 400,
               query=f"partNumber=x&uploadId={uid}", body=b"x")
    pair.error("PUT", key, "InvalidPart", 400,
               query=f"partNumber=0&uploadId={uid}", body=b"x")
    pair.same("GET", key, f"uploadId={uid}", status=200)
    other = _upload_id(pair.same("POST", f"/{B}/mp/other", "uploads",
                                 status=200))
    pair.same("GET", f"/{B}", "uploads", status=200)
    pair.same("GET", f"/{B}", "uploads&prefix=mp/o", status=200)
    parts = sorted(etags.items())
    pair.error("POST", key, "InvalidPartOrder", 400, query=f"uploadId={uid}",
               body=_complete_doc(parts[::-1]))
    pair.error("POST", key, "InvalidPart", 400, query=f"uploadId={uid}",
               body=_complete_doc([(1, etags[2])] + parts[1:]))
    pair.error("POST", key, "MalformedXML", 400, query=f"uploadId={uid}",
               body=b"<CompleteMultipartUpload><Part>")
    pair.error("POST", key, "NoSuchUpload", 404, query="uploadId=nope",
               body=_complete_doc(parts))
    r = pair.same("POST", key, f"uploadId={uid}", body=_complete_doc(parts),
                  status=200)
    md5s = b"".join(bytes.fromhex(e) for _, e in parts)
    assert f"{hashlib.md5(md5s).hexdigest()}-4".encode() in r.body
    want = b"".join(bodies.values())
    assert pair.same("GET", key, status=200).body == want
    pair.same("HEAD", key, status=200)
    b1 = len(bodies[1])
    for spec in (f"bytes={b1 - 10}-{b1 + 9}", f"bytes={b1 - 1}-{b1 + 4 * BS}",
                 "bytes=-7", f"bytes={len(want) - 3}-"):
        r = pair.same("GET", key, headers={"Range": spec}, status=206)
        first, _, rest = r.header("Content-Range")[6:].partition("-")
        assert r.body == want[int(first):int(rest.split("/")[0]) + 1]
    pair.error("GET", key, "NoSuchUpload", 404, query=f"uploadId={uid}")
    pair.same("DELETE", f"/{B}/mp/other", f"uploadId={other}", status=204)
    pair.error("DELETE", f"/{B}/mp/other", "NoSuchUpload", 404,
               query=f"uploadId={other}")
    pair.same("GET", f"/{B}", "uploads", status=200)
    assert not list(pair.port_root.glob("d*/.mt.sys/multipart"))
    assert not list(pair.ref_root.glob("d*/.mt.sys/multipart"))


def test_versioned_bucket(pair, monkeypatch):
    """PUT and GET ?versioning, versioned PUTs (inline, part file,
    streamed, multipart), a delete marker (405 on GET and HEAD), GET and
    HEAD by versionId, ListObjectVersions, DeleteObjects and DELETE with
    version ids, then versioning suspended."""
    pin(monkeypatch, batch=BATCH)
    for srv in (pair.ref, pair.port):
        monkeypatch.setattr(srv.layer, "enforce_min_part_size", False)
    enabled = (b'<VersioningConfiguration xmlns="http://s3.amazonaws.com/'
               b'doc/2006-03-01/"><Status>Enabled</Status>'
               b'</VersioningConfiguration>')
    pair.error("PUT", "/nover", "NoSuchBucket", 404, query="versioning",
               body=enabled)
    pair.same("PUT", "/verb", status=200)
    pair.same("GET", "/verb", "versioning", status=200)
    pair.same("PUT", "/verb", "versioning", body=enabled, status=200)
    assert b"<Status>Enabled</Status>" in pair.same(
        "GET", "/verb", "versioning", status=200).body
    vids, bodies = [], []
    for i, (size, auth) in enumerate(((5000, "v4"), (SIZES["part"], "v4"),
                                      (SIZES["streamed"], "chunked"))):
        data = _body(size, 40 + i)
        r = pair.same("PUT", "/verb/k", body=data, auth=auth, status=200)
        vids.append(r.header("x-amz-version-id"))
        bodies.append(data)
    uid = _upload_id(pair.same("POST", "/verb/k", "uploads", status=200))
    parts = []
    for num, size in ((1, 3 * BS), (2, 777)):
        data = _body(size, 50 + num)
        pair.same("PUT", "/verb/k", f"partNumber={num}&uploadId={uid}",
                  body=data, status=200)
        parts.append((num, hashlib.md5(data).hexdigest()))
    r = pair.same("POST", "/verb/k", f"uploadId={uid}",
                  body=_complete_doc(parts), status=200)
    vids.append(r.header("x-amz-version-id"))
    bodies.append(_body(3 * BS, 51) + _body(777, 52))
    assert all(vids) and len(set(vids)) == 4
    r = pair.same("DELETE", "/verb/k", status=204)
    assert r.header("x-amz-delete-marker") == "true"
    marker = r.header("x-amz-version-id")
    for method in ("GET", "HEAD"):
        pair.same(method, "/verb/k", status=405)
        pair.same(method, "/verb/k", f"versionId={marker}", status=405)
        pair.same(method, "/verb/k", headers={"Range": "bytes=0-9"},
                  status=405)
        pair.same(method, "/verb/k", headers={"If-Match": "*"}, status=405)
    for vid, data in zip(vids, bodies):
        assert pair.same("GET", "/verb/k", f"versionId={vid}",
                         status=200).body == data
        pair.same("HEAD", "/verb/k", f"versionId={vid}", status=200)
        pair.same("GET", "/verb/k", f"versionId={vid}",
                  headers={"Range": "bytes=100-4200"}, status=206)
    pair.error("GET", "/verb/k", "NoSuchVersion", 404, query="versionId=nope")
    pair.error("GET", "/verb/k", "NoSuchVersion", 404, query="versionId=null")
    pair.same("PUT", "/verb/other", body=b"o" * 300, status=200)
    for query in ("versions", "versions&prefix=k", "versions&prefix=zz"):
        pair.same("GET", "/verb", query, status=200)
    doc = ("<Delete>" + f"<Object><Key>k</Key><VersionId>{vids[0]}"
           "</VersionId></Object><Object><Key>other</Key></Object>"
           "</Delete>").encode()
    pair.same("POST", "/verb", "delete", body=doc, status=200)
    r = pair.same("DELETE", "/verb/k", f"versionId={vids[1]}", status=204)
    assert r.header("x-amz-version-id") == vids[1]
    pair.same("DELETE", "/verb/k", f"versionId={marker}", status=204)
    assert pair.same("GET", "/verb/k", status=200).body == bodies[3]
    pair.same("GET", "/verb", "versions", status=200)
    pair.same("PUT", "/verb", "versioning", status=200, body=(
        b"<VersioningConfiguration><Status>Suspended</Status>"
        b"</VersioningConfiguration>"))
    pair.same("GET", "/verb", "versioning", status=200)
    r = pair.same("PUT", "/verb/k", body=b"null version", status=200)
    assert r.header("x-amz-version-id") is None
    assert pair.same("GET", "/verb/k", "versionId=null",
                     status=200).body == b"null version"
    pair.same("GET", "/verb", "versions", status=200)


def test_drives_match_reference(pair):
    """Last in the sequence: every bucket volume and the segment store
    hold the same bytes on every drive; no staging dir is left."""
    assert _staging(pair.port_root) == [] == _staging(pair.ref_root)
    for i in range(N):
        got = _tree(f"{pair.port_root}/d{i}")
        want = _tree(f"{pair.ref_root}/d{i}")
        assert sorted(got) == sorted(want), f"drive {i} files differ"
        for path in want:
            assert got[path] == want[path], f"drive {i}: {path} differs"
        assert any(p.startswith(".mt.sys/seg/seg.") for p in got)


def _tree(root) -> dict:
    """{path: bytes} of the bucket volumes and the segment store, uuids
    replaced by zeros in paths and bytes alike."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith(".mt.sys") and not rel.startswith(".mt.sys/seg"):
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                data = UUID.sub(b"0" * 36, fh.read())
            out[UUID.sub(b"0" * 36, os.path.join(rel, f).encode())
                .decode()] = data
    return out


# -- the port alone ----------------------------------------------------------

@pytest.mark.parametrize("method,path,query,headers", [
    ("GET", f"/{B}", "tagging", {}),
    ("PUT", f"/{B}", "encryption", {}),
    ("GET", f"/{B}", "cors", {}),
    ("GET", f"/{B}", "object-lock", {}),
    ("GET", f"/{B}/rt/packed", "retention", {}),
    ("POST", f"/{B}/k", "restore", {}),
    ("PUT", f"/{B}/k", "partNumber=1&uploadId=x",
     {"x-amz-copy-source": f"/{B}/rt/packed"}),
    ("GET", f"/{B}/rt/packed", "tagging", {}),
    ("GET", f"/{B}/rt/packed", "acl", {}),
    ("PUT", f"/{B}/k", "", {"x-amz-copy-source": f"/{B}/rt/packed"}),
    ("PUT", f"/{B}/k", "", {"x-amz-tagging": "a=b"}),
    ("PUT", f"/{B}/k", "", {"x-amz-server-side-encryption": "AES256"}),
    ("PUT", f"/{B}/k", "", {"x-amz-storage-class": "REDUCED_REDUNDANCY"}),
    ("PUT", "/locked", "", {"x-amz-bucket-object-lock-enabled": "true"}),
    ("GET", f"/{B}", "replication", {}),
    ("GET", "/minio-tpu/admin/v3/info", "", {}),
    ("GET", f"/{B}", "notification", {}),
])
def test_unserved_answers_not_implemented(pair, method, path, query,
                                          headers):
    """What the port does not serve answers NotImplemented.  Tagging,
    object lock, copy, SSE, the bucket's default encryption, storage
    classes, restore, ACLs, CORS and the replication and notification
    configs are served now: those requests answer as ``NOW_SERVED`` says
    (each is compared with the reference in ``test_torch_copy.py``,
    ``test_torch_tagging.py``, ``test_torch_objectlock.py``,
    ``test_torch_sse.py``, ``test_torch_storage_class.py``,
    ``test_torch_tiering.py`` and ``test_torch_bucket_configs.py``)."""
    url = f"http://127.0.0.1:{pair.port.port}{path}" + \
        (f"?{query}" if query else "")
    _, hdrs, body = signed("v4", method, url, b"", headers,
                           datetime.datetime.now(datetime.timezone.utc))
    r = raw_send(method, url, body, hdrs)
    status, code = NOW_SERVED.get((method, path, query, *headers),
                                  (501, "NotImplemented"))
    assert r.status == status
    if code:
        assert f"<Code>{code}</Code>".encode() in r.body


# (method, path, query, header names) -> (status, error code or None)
NOW_SERVED = {
    ("GET", f"/{B}", "tagging"): (404, "NoSuchTagSet"),
    ("GET", f"/{B}", "object-lock"):
        (404, "ObjectLockConfigurationNotFoundError"),
    ("GET", f"/{B}/rt/packed", "retention"):
        (404, "NoSuchObjectLockConfiguration"),
    ("PUT", f"/{B}/k", "partNumber=1&uploadId=x", "x-amz-copy-source"):
        (404, "NoSuchUpload"),
    ("GET", f"/{B}/rt/packed", "tagging"): (200, None),
    ("PUT", f"/{B}/k", "", "x-amz-copy-source"): (200, None),
    ("PUT", f"/{B}/k", "", "x-amz-tagging"): (200, None),
    ("PUT", "/locked", "", "x-amz-bucket-object-lock-enabled"): (200, None),
    ("PUT", f"/{B}", "encryption"): (400, "MalformedXML"),
    ("PUT", f"/{B}/k", "", "x-amz-server-side-encryption"): (200, None),
    ("PUT", f"/{B}/k", "", "x-amz-storage-class"): (200, None),
    ("POST", f"/{B}/k", "restore"): (404, "NoSuchKey"),
    ("GET", f"/{B}", "cors"): (404, "NoSuchCORSConfiguration"),
    ("GET", f"/{B}/rt/packed", "acl"): (200, None),
    ("GET", f"/{B}", "replication"):
        (404, "ReplicationConfigurationNotFoundError"),
    ("GET", f"/{B}", "notification"): (200, None),
}


def test_sigv2_and_unknown_methods(pair):
    url = f"http://127.0.0.1:{pair.port.port}/{B}/rt/packed"
    r = raw_send("GET", url, headers={"Authorization": "AWS k:sig",
                                      "Date": "Sat, 17 Oct 2026 10:00:00 GMT"})
    assert r.status == 403 and b"<Code>InvalidAccessKeyId</Code>" in r.body
    _, hdrs, _ = signed("v4", "PATCH", url, b"", {},
                        datetime.datetime.now(datetime.timezone.utc))
    r = raw_send("PATCH", url, b"", hdrs)
    assert r.status == 405 and b"<Code>MethodNotAllowed</Code>" in r.body


@pytest.mark.parametrize("name", ["inline", "packed", "part-single",
                                  "part", "streamed"])
def test_layer_refuses_a_wrong_content_md5(tmp_path, monkeypatch, name):
    """The stream route hands Content-MD5 to the layer, which checks it
    against its own MD5 before anything commits, for every layout."""
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    er = port_eo.ErasureObjects(_drives(tmp_path, XLStorage), parity=PARITY,
                                block_size=BS, device="cpu")
    try:
        er.make_bucket("cmd5")
        body = _body(SIZES[name], 19)
        bad = hashlib.md5(body + b"x").hexdigest()
        for data in (body, io.BytesIO(body)):
            with pytest.raises(port_ol.BadDigest):
                er.put_object("cmd5", "k", data, port_ol.PutObjectOptions(
                    content_md5=bad))
            with pytest.raises(port_ol.ObjectNotFound):
                er.get_object_info("cmd5", "k")
            assert _staging(tmp_path) == []
            assert not any(tmp_path.glob("d*/cmd5/k"))
        good = hashlib.md5(body).hexdigest().upper()
        assert er.put_object("cmd5", "k", io.BytesIO(body),
                             port_ol.PutObjectOptions(content_md5=good)
                             ).etag == good.lower()
    finally:
        er.close()


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("advance", [0, 1, 2])
def test_dropped_reader_releases_its_lock(tmp_path, monkeypatch, depth,
                                          advance):
    """A GET's reader holds the object's read lock while it streams and
    lets go when it is dropped, advanced or not (a client that hangs up
    mid-body), with or without readahead."""
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", 16 * BS)
    er = port_eo.ErasureObjects(_drives(tmp_path, XLStorage), parity=PARITY,
                                block_size=BS, device="cpu")
    try:
        er.make_bucket("lock")
        body = _body(SIZES["packed"], 23)
        er.put_object("lock", "k", body)
        _, chunks = er.get_object_reader("lock", "k",
                                         readahead_depth=depth)
        got = b"".join(next(chunks) for _ in range(advance))
        assert got == body[:len(got)]
        assert er.ns_lock.locker._map
        del chunks
        assert not er.ns_lock.locker._map
    finally:
        er.close()


def test_launch_counts_hold_under_request_threads():
    """Request threads launch kernels concurrently; the counts that
    chip_smoke.py reads lose no update."""
    counts = _build.Counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            (counts.add_launch(), counts.add_plain())
            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert (counts.launches, counts.plain) == (32000, 32000)


def test_get_that_loses_quorum_mid_body_ends_short(tmp_path):
    """A GET whose second batch loses read quorum has already sent its
    status line: the connection drops after a short body, no second
    response follows, and the object's read lock is released."""
    mp = pytest.MonkeyPatch()
    batch_blocks = 16
    mp.setattr(port_eo, "STREAM_BATCH_BYTES", batch_blocks * BS)
    srv = S3Server(port_eo.ErasureObjects(_drives(tmp_path, XLStorage),
                                          parity=PARITY, block_size=BS,
                                          device="cpu"),
                   access_key=AK, secret_key=SK)
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        now = datetime.datetime.now(datetime.timezone.utc)
        body = _body(SIZES["part"], 17)
        for method, u, b in (("PUT", f"{url}/qrm", b""),
                             ("PUT", f"{url}/qrm/obj", body)):
            _, h, b = signed("v4", method, u, b, {}, now)
            assert raw_send(method, u, b, h).status == 200
        # corrupt every drive's shard past the first batch: the first
        # batch verifies, the second cannot reach quorum
        for part in tmp_path.glob("d*/qrm/obj/*/part.1"):
            with open(part, "r+b") as f:
                f.seek(2 * batch_blocks * (32 + BS // (N - PARITY)))
                f.write(b"\xff" * 4096)
        _, h, _ = signed("v4", "GET", f"{url}/qrm/obj", b"", {}, now)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/qrm/obj", headers=h)
        r = conn.getresponse()
        assert r.status == 200
        assert int(r.getheader("Content-Length")) == len(body)
        with pytest.raises(http.client.IncompleteRead) as ei:
            r.read()
        assert 0 < len(ei.value.partial) < len(body)
        assert ei.value.partial == body[:len(ei.value.partial)]
        conn.close()
        _, h, _ = signed("v4", "DELETE", f"{url}/qrm/obj", b"", {}, now)
        assert raw_send("DELETE", f"{url}/qrm/obj", b"", h).status == 204
    finally:
        srv.stop()
        mp.undo()
        shutil.rmtree(tmp_path, ignore_errors=True)


# -- two sets each -----------------------------------------------------------

SET_DRIVES = 4


@pytest.fixture(scope="module")
def sets_pair(tmp_path_factory):
    """Both servers over two sets of four drives (``ErasureSets.from_dirs``
    with health proxies), both packages' clocks and uuid draws pinned, so
    formats, placement, version ids and data dirs agree."""
    from minio_tpu.objectlayer.sets import ErasureSets as RefSets
    from minio_tpu_torch.objectlayer.sets import ErasureSets
    mp = pytest.MonkeyPatch()
    saved = dict(ref_hotread.CONFIG.__dict__)
    mp.setenv("MT_CACHE_ENABLE", "off")
    pin(mp, batch=BATCH)
    for mod in (ref_ho, port_ho):
        mp.setattr(mod, "STREAM_PUT_THRESHOLD", THRESHOLD)
    root = tmp_path_factory.mktemp("s3sets")
    layers = []
    for cls, tag, kw in ((RefSets, "ref", {"backend": "numpy"}),
                         (ErasureSets, "port", {"device": "cpu"})):
        dirs = [str(root / tag / f"d{i}") for i in range(2 * SET_DRIVES)]
        for d in dirs:
            os.makedirs(d)
        layers.append(cls.from_dirs(dirs, 2, SET_DRIVES, parity=PARITY,
                                    block_size=BS,
                                    enforce_min_part_size=False, **kw))
    ref = RefServer(layers[0], access_key=AK, secret_key=SK)
    port = S3Server(layers[1], access_key=AK, secret_key=SK)
    ref.start()
    port.start()
    try:
        yield Pair(ref, port, root / "ref", root / "port")
    finally:
        port.stop()
        ref.stop()
        mp.undo()
        ref_hotread.CONFIG.__dict__.update(saved)


def test_sets_answer_as_the_reference(sets_pair):
    p = sets_pair
    assert p.port.layer.deployment_id == p.ref.layer.deployment_id
    p.same("PUT", "/sets", status=200)
    p.same("PUT", "/sets", "versioning", status=200,
           body=b"<VersioningConfiguration><Status>Enabled</Status>"
                b"</VersioningConfiguration>")
    keys = []
    for name, size in SIZES.items():
        for i in range(2):
            key = f"{name}/{i}"
            keys.append(key)
            p.same("PUT", f"/sets/{key}", body=_body(size, i), status=200)
    assert {p.port.layer.get_hashed_set_index(k) for k in keys} == {0, 1}
    for key in keys:
        got = p.same("GET", f"/sets/{key}", status=200)
        assert got.body == _body(SIZES[key.split("/")[0]], int(key[-1]))
    p.same("DELETE", "/sets/inline/0", status=204)
    token, pages = "", 0
    while True:
        query = "list-type=2&max-keys=3" + \
            (f"&continuation-token={urllib.parse.quote(token)}"
             if token else "")
        doc = ET.fromstring(p.same("GET", "/sets", query, status=200).body)
        pages += 1
        if doc.findtext(f"{NS}IsTruncated") != "true":
            break
        token = doc.findtext(f"{NS}NextContinuationToken")
    assert pages >= 4
    p.same("GET", "/sets", "versions", status=200)
    r = p.same("POST", "/sets/mp/obj", "uploads", status=200)
    uid = _upload_id(r)
    parts = []
    for n, size in ((1, 70_000), (2, 30_000)):
        r = p.same("PUT", "/sets/mp/obj", f"partNumber={n}&uploadId={uid}",
                   body=_body(size, n), status=200)
        parts.append((n, r.header("ETag").strip('"')))
    p.same("GET", "/sets", "uploads", status=200)
    p.same("POST", "/sets/mp/obj", f"uploadId={uid}",
           body=_complete_doc(parts), status=200)
    p.same("GET", "/sets/mp/obj", status=200)
    p.same("GET", "/minio/health/cluster", auth="anon", status=200)


def test_sets_drives_match_reference(sets_pair):
    """After the sequence every drive holds the same bytes, format.json,
    the bucket metadata on set 0 and the segment store included."""
    for i in range(2 * SET_DRIVES):
        got = _sets_tree(f"{sets_pair.port_root}/d{i}")
        want = _sets_tree(f"{sets_pair.ref_root}/d{i}")
        assert sorted(got) == sorted(want), f"drive {i} files differ"
        for path in want:
            assert got[path] == want[path], f"drive {i}: {path} differs"
        assert ".mt.sys/format.json" in got
        assert (".mt.sys/buckets/sets/bucket-meta.json" in got) == \
            (i < SET_DRIVES)


def _sets_tree(root) -> dict:
    """{path: bytes} of a drive but its staging dir, the reference's
    listing caches and its config (a KMS key the port has no use for)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith((".mt.sys/tmp", ".mt.sys/metacache",
                           ".mt.sys/buckets/.metacache", ".mt.sys/config")):
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def test_sets_health_below_quorum(sets_pair):
    """Last: two drives of set 0 gone leave it two of four online, below
    its write quorum of three: 503, and 412 under maintenance."""
    p = sets_pair
    key = next(k for k in (f"{n}/{i}" for n in SIZES for i in range(2))
               if p.port.layer.get_hashed_set_index(k) == 0
               and k != "inline/0")
    for srv, root in ((p.ref, p.ref_root), (p.port, p.port_root)):
        for d in (1, 2):
            shutil.rmtree(root / f"d{d}")
        for d in srv.layer.sets[0].disks[1:3]:
            with pytest.raises(OSError):
                d.stat_vol("sets")
    p.same("GET", f"/sets/{key}", status=200)
    for method in ("GET", "HEAD"):
        r = p.same(method, "/minio/health/cluster", auth="anon", status=503)
        assert r.header("X-Minio-Write-Quorum") == "3"
        p.same(method, "/minio/health/cluster", "maintenance=true",
               auth="anon", status=412)
