"""S3 object handlers (``minio_tpu/s3/handlers_object.py``,
cmd/object-handlers.go): PUT (read whole, or streamed straight into the
object layer above ``STREAM_PUT_THRESHOLD``), GET and HEAD with ranges
and preconditions, and DELETE.  ``_make_handler`` (server.py) attaches
them to the request handler; ``self`` is the handler and ``self.srv``
its server.
"""

from __future__ import annotations

import base64
import email.utils
import hashlib

from ..objectlayer.interface import PutObjectOptions
from . import sigv4
from .server import (MAX_PUT_SIZE, RESERVED_BUCKETS, STREAM_PUT_THRESHOLD,
                     S3Error, _BUCKET_RE, _BodyReader, _http_date,
                     _parse_range)

# object subresources and headers the port does not serve: tagging,
# retention and legal hold, ACLs, select, multipart, restore, versions,
# copy, object lock
UNSERVED = frozenset((
    "tagging", "retention", "legal-hold", "acl", "select", "uploads",
    "uploadId", "restore", "versionId"))
UNSERVED_HEADERS = (
    "x-amz-copy-source", "x-amz-tagging", "x-amz-object-lock-mode",
    "x-amz-object-lock-retain-until-date", "x-amz-object-lock-legal-hold")
PRECONDITIONS = ("If-Match", "If-None-Match", "If-Modified-Since",
                 "If-Unmodified-Since")


def _object_api(self, bucket, key, query, payload):
    cmd = self.command
    if UNSERVED & set(query) or cmd == "POST" or \
            any(h in self.headers for h in UNSERVED_HEADERS):
        raise S3Error("NotImplemented")
    if cmd == "PUT":
        self._allow()
        return self._put_object(bucket, key, payload)
    if cmd in ("GET", "HEAD"):
        self._allow()
        return self._get_object(bucket, key, head=(cmd == "HEAD"))
    if cmd == "DELETE":
        self._allow()
        self.srv.layer.delete_object(bucket, key)
        return self._send(204)
    raise S3Error("MethodNotAllowed")


def _user_defined(self) -> dict[str, str]:
    """Content-Type and x-amz-meta-* headers, as stored with the object.
    A storage class other than STANDARD is not served."""
    if self.headers.get("x-amz-storage-class", "STANDARD").upper() \
            != "STANDARD":
        raise S3Error("NotImplemented")
    user_defined = {}
    ct = self.headers.get("Content-Type")
    if ct:
        user_defined["content-type"] = ct
    for h, v in self.headers.items():
        if h.lower().startswith("x-amz-meta-"):
            user_defined[h.lower()] = v
    return user_defined


def _content_md5(self) -> bytes | None:
    md5_hdr = self.headers.get("Content-MD5")
    if not md5_hdr:
        return None
    try:
        return base64.b64decode(md5_hdr)
    except Exception as e:  # noqa: BLE001 — any malformed header
        raise S3Error("InvalidDigest") from e


def _put_object(self, bucket, key, payload):
    """PutObject with the body in hand (cmd/object-handlers.go:1488)."""
    if "Content-Length" not in self.headers:
        raise S3Error("MissingContentLength")
    want = self._content_md5()
    if want is not None and hashlib.md5(payload).digest() != want:
        raise S3Error("BadDigest")
    oi = self.srv.layer.put_object(
        bucket, key, payload,
        PutObjectOptions(user_defined=self._user_defined()))
    self._send(200, headers={"ETag": f'"{oi.etag}"'})


def _try_stream_put(self, path, bucket, key, query) -> bool:
    """Take a plain object PUT above ``STREAM_PUT_THRESHOLD`` down the
    streaming route.  True when the request was answered (success or
    error); False, with no body byte read, sends it down the buffered
    route."""
    if self.command != "PUT" or not bucket or not key:
        return False
    if bucket in RESERVED_BUCKETS or not _BUCKET_RE.match(bucket):
        return False
    if UNSERVED & set(query) or \
            any(h in self.headers for h in UNSERVED_HEADERS):
        return False
    try:
        cl = int(self.headers["Content-Length"])
    except (KeyError, ValueError):
        return False
    if cl <= STREAM_PUT_THRESHOLD:
        return False
    # committed to streaming: any failure is answered here and the
    # half-read connection dropped
    try:
        if cl > MAX_PUT_SIZE:
            raise S3Error("EntityTooLarge")
        want_md5 = self._content_md5()
        reader = self._auth_stream(path, query, cl)
        self._allow()
        # the layer checks Content-MD5 against the MD5 it takes for the
        # ETag, before it commits: one pass over the body, not two
        oi = self.srv.layer.put_object(
            bucket, key, reader, PutObjectOptions(
                user_defined=self._user_defined(),
                content_md5=want_md5.hex() if want_md5 is not None
                else None))
        self._send(200, headers={"ETag": f'"{oi.etag}"'})
    except Exception as e:  # noqa: BLE001 — XML, as in dispatch
        self._fail(e, path)
        self.close_connection = True
    return True


def _auth_stream(self, path, query, cl: int):
    """Authenticate a PUT without reading its body; returns the verified
    body reader.  The signature is checked now; the SHA-256 and every
    aws-chunked chunk signature as the body is read, the last of them at
    its end, before the object layer commits."""
    hdrs = dict(self.headers.items())
    sha = self.headers.get("x-amz-content-sha256")
    lookup = self.srv.lookup_secret
    try:
        if "Authorization" not in hdrs and \
                "X-Amz-Signature" not in query and \
                not ("Signature" in query and "AWSAccessKeyId" in query):
            self.access_key = ""
            return _BodyReader(
                self.rfile, cl,
                sha256_hex=(sha if sha and sha != sigv4.UNSIGNED_PAYLOAD
                            else None))
        if hdrs.get("Authorization", "").startswith("AWS ") or \
                "AWSAccessKeyId" in query:
            raise S3Error("NotImplemented")                # SigV2
        if "X-Amz-Signature" in query:
            self.access_key = sigv4.verify_presigned(
                lookup, self.command, path, query, hdrs,
                region=self.srv.region)
            return _BodyReader(self.rfile, cl)
        if sha == sigv4.STREAMING_PAYLOAD:
            self.access_key, key, seed, amz_date, scope = \
                sigv4.verify_request_streaming(
                    lookup, self.command, path, query, hdrs,
                    region=self.srv.region)
            return sigv4.ChunkedStreamReader(
                _BodyReader(self.rfile, cl), key, seed, amz_date, scope)
        sha = sha or sigv4.UNSIGNED_PAYLOAD
        self.access_key = sigv4.verify_request(
            lookup, self.command, path, query, hdrs, sha,
            region=self.srv.region)
        return _BodyReader(
            self.rfile, cl,
            sha256_hex=sha if sha != sigv4.UNSIGNED_PAYLOAD else None)
    except sigv4.SigV4Error as e:
        raise S3Error(e.code) from e


def _get_object(self, bucket, key, head: bool):
    """GetObject and HeadObject (cmd/object-handlers.go:360): the
    preconditions are answered from metadata before any data is read,
    and a GET's body streams from the layer's reader."""
    layer = self.srv.layer
    oi = None
    if any(h in self.headers for h in PRECONDITIONS):
        oi = layer.get_object_info(bucket, key)
        if self._preconditions_304(oi):
            return self._send(304, b"", headers={
                "ETag": f'"{oi.etag}"',
                "Last-Modified": _http_date(oi.mod_time)},
                content_length=0)
    rng = self.headers.get("Range")
    offset, length = _parse_range(rng) if rng else (0, -1)
    body = None
    if head:
        oi = oi if oi is not None else layer.get_object_info(bucket, key)
    else:
        oi, body = layer.get_object_reader(bucket, key, offset, length)
    hdrs = {"ETag": f'"{oi.etag}"', "Last-Modified": _http_date(oi.mod_time),
            "Accept-Ranges": "bytes"}
    for k, v in oi.user_defined.items():
        if k.startswith("x-amz-meta-"):
            hdrs[k] = v
    ct = oi.content_type or "binary/octet-stream"
    if head:
        return self._send(200, b"", content_type=ct, headers=hdrs,
                          content_length=oi.size)
    if rng:
        start = max(0, oi.size + offset) if offset < 0 else offset
        sent = oi.size - start if length < 0 \
            else min(length, oi.size - start)
        hdrs["Content-Range"] = f"bytes {start}-{start + sent - 1}/{oi.size}"
        return self._send_stream(206, body, sent, ct, hdrs)
    return self._send_stream(200, body, oi.size, ct, hdrs)


def _preconditions_304(self, oi) -> bool:
    """GET/HEAD preconditions (checkPreconditions,
    cmd/object-handlers-common.go): PreconditionFailed for a failed
    If-Match or If-Unmodified-Since; True when the answer is 304."""
    if_match = self.headers.get("If-Match")
    if_none = self.headers.get("If-None-Match")
    if_mod = self.headers.get("If-Modified-Since")
    if_unmod = self.headers.get("If-Unmodified-Since")
    # Last-Modified has whole seconds: compare truncated seconds, or an
    # echoed header would fail
    mod_s = oi.mod_time // 10 ** 9

    def etag_in(header: str) -> bool:
        tags = [t.strip().strip('"') for t in header.split(",")]
        return "*" in tags or oi.etag in tags

    def parse_date(v: str) -> float | None:
        try:
            return email.utils.parsedate_to_datetime(v).timestamp()
        except (TypeError, ValueError):
            return None                 # an invalid date is ignored

    if if_match is not None and not etag_in(if_match):
        raise S3Error("PreconditionFailed")
    if if_match is None and if_unmod is not None:
        t = parse_date(if_unmod)
        if t is not None and mod_s > t:
            raise S3Error("PreconditionFailed")
    if if_none is not None and etag_in(if_none):
        return True
    if if_none is None and if_mod is not None:
        t = parse_date(if_mod)
        if t is not None and mod_s <= t:
            return True
    return False


# the methods _make_handler attaches to the request handler
HANDLERS = ["_object_api", "_user_defined", "_content_md5", "_put_object",
            "_try_stream_put", "_auth_stream", "_get_object",
            "_preconditions_304"]
