"""S3 object handlers (``minio_tpu/s3/handlers_object.py``,
cmd/object-handlers.go, cmd/object-multipart-handlers.go): PUT and
UploadPart (read whole, or streamed straight into the object layer above
``STREAM_PUT_THRESHOLD``), GET and HEAD with ranges, preconditions and
version ids, DELETE of the latest version (a delete marker in a
versioned bucket) or of one version, and the multipart calls:
CreateMultipartUpload, ListParts, CompleteMultipartUpload and
AbortMultipartUpload.  A bucket's versioning state comes from
``self.srv.bucket_meta``.  ``_make_handler`` (server.py) attaches them to
the request handler; ``self`` is the handler and ``self.srv`` its
server.
"""

from __future__ import annotations

import base64
import email.utils
import hashlib
import xml.etree.ElementTree as ET

from ..admin import metrics as _metrics
from ..objectlayer import interface as ol
from ..objectlayer.interface import ObjectOptions, PutObjectOptions
from . import errors as s3err
from . import sigv4
from .server import (MAX_PUT_SIZE, RESERVED_BUCKETS, S3_NS,
                     STREAM_PUT_THRESHOLD, S3Error, _BUCKET_RE, _BodyReader,
                     _http_date, _parse_range, _xml)

# object subresources and headers the port does not serve: tagging,
# retention and legal hold, ACLs, select, restore, copy (CopyObject and
# UploadPartCopy), object lock
UNSERVED = frozenset((
    "tagging", "retention", "legal-hold", "acl", "select", "restore"))
UNSERVED_HEADERS = (
    "x-amz-copy-source", "x-amz-tagging", "x-amz-object-lock-mode",
    "x-amz-object-lock-retain-until-date", "x-amz-object-lock-legal-hold")
PRECONDITIONS = ("If-Match", "If-None-Match", "If-Modified-Since",
                 "If-Unmodified-Since")


def _object_api(self, bucket, key, query, payload):
    cmd = self.command
    if UNSERVED & set(query) or \
            any(h in self.headers for h in UNSERVED_HEADERS):
        raise S3Error("NotImplemented")
    if cmd == "POST" and "uploads" in query:
        self._allow()
        return self._create_multipart(bucket, key)
    if cmd == "POST" and "uploadId" in query:
        self._allow()
        return self._complete_multipart(bucket, key, query, payload)
    if cmd == "POST":
        raise S3Error("NotImplemented")     # select, restore, POST policy
    if cmd == "PUT" and "uploadId" in query:
        self._allow()
        return self._upload_part(bucket, key, query, payload)
    if cmd == "DELETE" and "uploadId" in query:
        self._allow()
        self.srv.layer.abort_multipart_upload(bucket, key,
                                              query["uploadId"][0])
        return self._send(204)
    if cmd == "GET" and "uploadId" in query:
        self._allow()
        return self._list_parts(bucket, key, query)
    if cmd == "PUT":
        self._allow()
        return self._put_object(bucket, key, payload)
    if cmd in ("GET", "HEAD"):
        self._allow()
        return self._get_object(bucket, key, query, head=(cmd == "HEAD"))
    if cmd == "DELETE":
        self._allow()
        return self._delete_object(bucket, key, query)
    raise S3Error("MethodNotAllowed")


def _version_id(query) -> str | None:
    """The ``versionId`` query value; "null" names the null version."""
    vid = query.get("versionId", [None])[0]
    return "" if vid == "null" else vid


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
        PutObjectOptions(user_defined=self._user_defined(),
                         versioned=self.srv.bucket_meta.versioning_enabled(
                             bucket)))
    self._send(200, headers=_put_headers(oi))


def _put_headers(oi) -> dict:
    hdrs = {"ETag": f'"{oi.etag}"'}
    if oi.version_id:
        hdrs["x-amz-version-id"] = oi.version_id
    return hdrs


def _create_multipart(self, bucket, key):
    """CreateMultipartUpload (cmd/object-multipart-handlers.go)."""
    user_defined = self._user_defined()
    uid = self.srv.layer.new_multipart_upload(
        bucket, key, PutObjectOptions(
            user_defined=user_defined,
            versioned=self.srv.bucket_meta.versioning_enabled(bucket)))
    root = ET.Element("InitiateMultipartUploadResult", xmlns=S3_NS)
    ET.SubElement(root, "Bucket").text = bucket
    ET.SubElement(root, "Key").text = key
    ET.SubElement(root, "UploadId").text = uid
    self._send(200, _xml(root))


def _part_number(query) -> int:
    try:
        return int(query["partNumber"][0])
    except (KeyError, ValueError) as e:
        raise S3Error("InvalidArgument") from e


def _upload_part(self, bucket, key, query, payload):
    """UploadPart with the body in hand."""
    uid = query["uploadId"][0]
    part_num = _part_number(query)
    want = self._content_md5()
    pi = self.srv.layer.put_object_part(
        bucket, key, uid, part_num, payload,
        content_md5=want.hex() if want is not None else None)
    self._send(200, headers={"ETag": f'"{pi.etag}"'})


def _complete_multipart(self, bucket, key, query, payload):
    """CompleteMultipartUpload: the client's part list, as XML."""
    uid = query["uploadId"][0]
    try:
        root = ET.fromstring(payload)
    except ET.ParseError as e:
        raise S3Error("MalformedXML") from e
    ns = f"{{{S3_NS}}}"
    parts = []
    for p in root.findall(f"{ns}Part") + root.findall("Part"):
        num = p.findtext(f"{ns}PartNumber") or p.findtext("PartNumber")
        etag = p.findtext(f"{ns}ETag") or p.findtext("ETag") or ""
        if num is None or not num.isdigit():
            raise S3Error("MalformedXML")
        parts.append((int(num), etag.strip('"')))
    oi = self.srv.layer.complete_multipart_upload(bucket, key, uid, parts)
    out = ET.Element("CompleteMultipartUploadResult", xmlns=S3_NS)
    ET.SubElement(out, "Location").text = \
        f"{self.srv.endpoint}/{bucket}/{key}"
    ET.SubElement(out, "Bucket").text = bucket
    ET.SubElement(out, "Key").text = key
    ET.SubElement(out, "ETag").text = f'"{oi.etag}"'
    hdrs = {}
    if oi.version_id:
        hdrs["x-amz-version-id"] = oi.version_id
    self._send(200, _xml(out), headers=hdrs)


def _list_parts(self, bucket, key, query):
    uid = query["uploadId"][0]
    parts = self.srv.layer.list_object_parts(bucket, key, uid)
    root = ET.Element("ListPartsResult", xmlns=S3_NS)
    ET.SubElement(root, "Bucket").text = bucket
    ET.SubElement(root, "Key").text = key
    ET.SubElement(root, "UploadId").text = uid
    ET.SubElement(root, "IsTruncated").text = "false"
    for p in parts:
        pe = ET.SubElement(root, "Part")
        ET.SubElement(pe, "PartNumber").text = str(p.part_number)
        ET.SubElement(pe, "ETag").text = f'"{p.etag}"'
        ET.SubElement(pe, "Size").text = str(p.size)
    self._send(200, _xml(root))


def _delete_object(self, bucket, key, query):
    """DeleteObject: in a versioned bucket and without a version id, a
    delete marker."""
    res = self.srv.layer.delete_object(
        bucket, key, ObjectOptions(
            version_id=_version_id(query),
            versioned=self.srv.bucket_meta.versioning_enabled(bucket)))
    hdrs = {}
    if res.delete_marker:
        hdrs["x-amz-delete-marker"] = "true"
    if res.version_id:
        hdrs["x-amz-version-id"] = res.version_id
    self._send(204, headers=hdrs)


def _try_stream_put(self, path, bucket, key, query) -> bool:
    """Take a plain object PUT or an UploadPart above
    ``STREAM_PUT_THRESHOLD`` down the streaming route.  True when the
    request was answered (success or error); False, with no body byte
    read, sends it down the buffered route (also a part of an unknown
    upload, which the buffered route refuses)."""
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
    if "uploadId" in query:
        try:
            self.srv.layer.get_multipart_info(bucket, key,
                                              query["uploadId"][0])
        except Exception:  # noqa: BLE001 — answered on the buffered route
            return False
    # committed to streaming: any failure is answered here and the
    # half-read connection dropped
    try:
        if cl > MAX_PUT_SIZE:
            raise S3Error("EntityTooLarge")
        want_md5 = self._content_md5()
        reader = self._auth_stream(path, query, cl)
        self._rx_bytes = cl
        _metrics.GLOBAL.inc("mt_s3_rx_bytes_total", value=cl)
        self._allow()
        # the layer checks Content-MD5 against the MD5 it takes for the
        # ETag, before it commits: one pass over the body, not two
        md5_hex = want_md5.hex() if want_md5 is not None else None
        if "uploadId" in query:
            pi = self.srv.layer.put_object_part(
                bucket, key, query["uploadId"][0], _part_number(query),
                reader, content_md5=md5_hex)
            self._send(200, headers={"ETag": f'"{pi.etag}"'})
        else:
            oi = self.srv.layer.put_object(
                bucket, key, reader, PutObjectOptions(
                    user_defined=self._user_defined(),
                    versioned=self.srv.bucket_meta.versioning_enabled(
                        bucket),
                    content_md5=md5_hex))
            self._send(200, headers=_put_headers(oi))
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


def _get_object(self, bucket, key, query, head: bool):
    """GetObject and HeadObject (cmd/object-handlers.go:360), of the latest
    version or of ``versionId``: the preconditions are answered from
    metadata before any data is read, and a GET's body streams from the
    layer's reader.  A delete marker answers 405 with
    ``x-amz-delete-marker``."""
    layer = self.srv.layer
    opts = ObjectOptions(version_id=_version_id(query))
    oi = None
    rng = self.headers.get("Range")
    body = None
    try:
        if any(h in self.headers for h in PRECONDITIONS):
            oi = layer.get_object_info(bucket, key, opts)
            if not oi.delete_marker and self._preconditions_304(oi):
                return self._send(304, b"", headers={
                    "ETag": f'"{oi.etag}"',
                    "Last-Modified": _http_date(oi.mod_time)},
                    content_length=0)
        offset, length = _parse_range(rng) if rng else (0, -1)
        if head or rng:
            # metadata first: a delete marker's range is never read, and
            # a HEAD's range is checked (InvalidRange) as the reference
            # checks it
            oi = oi if oi is not None else \
                layer.get_object_info(bucket, key, opts)
            if rng and not oi.delete_marker:
                oi, body = layer.get_object_reader(bucket, key, offset,
                                                   length, opts)
        else:
            oi, body = layer.get_object_reader(bucket, key, offset, length,
                                               opts)
        if not head and oi.delete_marker:
            raise ol.MethodNotAllowed(key)
    except ol.MethodNotAllowed:
        return self._send(
            405, s3err.to_xml(s3err.get("MethodNotAllowed")),
            headers={"x-amz-delete-marker": "true"})
    hdrs = {"ETag": f'"{oi.etag}"', "Last-Modified": _http_date(oi.mod_time),
            "Accept-Ranges": "bytes"}
    if oi.version_id:
        hdrs["x-amz-version-id"] = oi.version_id
    for k, v in oi.user_defined.items():
        if k.startswith("x-amz-meta-"):
            hdrs[k] = v
    ct = oi.content_type or "binary/octet-stream"
    if head:
        if body is not None:
            body.close()
        if oi.delete_marker:
            dm_hdrs = {"x-amz-delete-marker": "true"}
            if oi.version_id:
                dm_hdrs["x-amz-version-id"] = oi.version_id
            return self._send(405, b"", headers=dm_hdrs, content_length=0)
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
            "_create_multipart", "_upload_part", "_complete_multipart",
            "_list_parts", "_delete_object", "_try_stream_put",
            "_auth_stream", "_get_object", "_preconditions_304"]
