"""S3 object handlers (``minio_tpu/s3/handlers_object.py``,
cmd/object-handlers.go, cmd/object-multipart-handlers.go): PUT and
UploadPart (read whole, or streamed straight into the object layer above
``STREAM_PUT_THRESHOLD``), GET and HEAD with ranges, preconditions and
version ids, DELETE of the latest version (a delete marker in a
versioned bucket) or of one version, and the multipart calls:
CreateMultipartUpload, ListParts, CompleteMultipartUpload and
AbortMultipartUpload.  CopyObject and UploadPartCopy stream the source
version through the GET path into the PUT path, one batch at a time and
without the source's read lock; their ``x-amz-copy-source-if-*``
conditions and the quota are judged on the source's metadata before a
byte is read.
An object's tags (``?tagging``, ``x-amz-tagging``), retention and legal
hold (``?retention``, ``?legal-hold``, the ``x-amz-object-lock-*``
headers, else the bucket's default retention) are metadata, updated in
place by ``put_object_metadata``; a DELETE of a version its lock
protects answers ``ObjectLocked`` (``_delete_opts``).  Each handler
authorises the reference's S3 action on ``bucket/key`` (``_allow``)
before it reads a body or reaches the layer; CompleteMultipartUpload
charges its largest part to the memory governor (``multipart``).  A
write to a bucket with a hard quota is refused (403
``XMinioAdminBucketQuotaExceeded``) before its body is read when it
would take the bucket past the limit, and a committed write is charged
to the server's usage view (``_check_quota``, ``_charge_quota_usage``);
every call that changes an object marks the data-update tracker.  A
bucket's versioning and lock configuration come from
``self.srv.bucket_meta``.  ``_make_handler`` (server.py) attaches these
functions to the request handler; ``self`` is the handler and
``self.srv`` its server.
"""

from __future__ import annotations

import base64
import datetime
import email.utils
import hashlib
import urllib.parse
import xml.etree.ElementTree as ET

from ..admin import metrics as _metrics
from ..bucket import objectlock as olock
from ..bucket import tags as btags
from ..bucket.quota import Quota
from ..iam import policy as iampol
from ..objectlayer import interface as ol
from ..objectlayer.interface import ObjectOptions, PutObjectOptions
from ..utils.memgov import GOVERNOR
from . import errors as s3err
from . import sigv2, sigv4
from .server import (MAX_PUT_SIZE, RESERVED_BUCKETS, S3_NS,
                     STREAM_PUT_THRESHOLD, S3Error, _BUCKET_RE, _BodyReader,
                     _http_date, _iso_date, _parse_range, _try, _xml)

# object subresources the port does not serve: ACLs, select (ROADMAP
# Queue 1 item 16.9) and restore (item 16.6)
UNSERVED = frozenset(("acl", "select", "restore"))
# subresources answered on the buffered route only
SUBRESOURCES = UNSERVED | {"tagging", "retention", "legal-hold"}
# what a source stored by another transform carries: SSE's sealed key,
# compression, a transition to a tier (ROADMAP Queue 1 items 16.3, 16.6)
TRANSFORMED = ("x-minio-internal-server-side-encryption-sealed-key",
               "x-minio-internal-compression")
TRANSITION_STATUS = "x-minio-internal-transition-status"
PRECONDITIONS = ("If-Match", "If-None-Match", "If-Modified-Since",
                 "If-Unmodified-Since")


def _object_api(self, bucket, key, query, payload):
    cmd = self.command
    resource = f"{bucket}/{key}"
    if UNSERVED & set(query):
        raise S3Error("NotImplemented")
    if "tagging" in query:
        return self._object_tagging(bucket, key, query, payload)
    if "retention" in query:
        return self._object_retention(bucket, key, query, payload)
    if "legal-hold" in query:
        return self._object_legal_hold(bucket, key, query, payload)
    if cmd == "POST" and "uploads" in query:
        self._allow(iampol.PUT_OBJECT, resource)
        return self._create_multipart(bucket, key)
    if cmd == "POST" and "uploadId" in query:
        self._allow(iampol.PUT_OBJECT, resource)
        return self._complete_multipart(bucket, key, query, payload)
    if cmd == "POST":
        raise S3Error("NotImplemented")     # select, restore
    if cmd == "PUT" and "uploadId" in query:
        self._allow(iampol.PUT_OBJECT, resource)
        if "x-amz-copy-source" in self.headers:
            return self._upload_part_copy(bucket, key, query)
        return self._upload_part(bucket, key, query, payload)
    if cmd == "DELETE" and "uploadId" in query:
        self._allow(iampol.ABORT_MULTIPART, resource)
        self.srv.layer.abort_multipart_upload(bucket, key,
                                              query["uploadId"][0])
        return self._send(204)
    if cmd == "GET" and "uploadId" in query:
        self._allow(iampol.LIST_PARTS, resource)
        return self._list_parts(bucket, key, query)
    if cmd == "PUT":
        self._allow(iampol.PUT_OBJECT, resource)
        if "x-amz-copy-source" in self.headers:
            return self._copy_object(bucket, key)
        return self._put_object(bucket, key, payload)
    if cmd in ("GET", "HEAD"):
        self._allow(iampol.GET_OBJECT_VERSION if query.get("versionId")
                    else iampol.GET_OBJECT, resource)
        return self._get_object(bucket, key, query, head=(cmd == "HEAD"))
    if cmd == "DELETE":
        self._allow(iampol.DELETE_OBJECT_VERSION if query.get("versionId")
                    else iampol.DELETE_OBJECT, resource)
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


def _new_object_meta(self, bucket: str, key: str) -> dict[str, str]:
    """What a new object stores from its request, in the reference's
    order: Content-Type and x-amz-meta-*, the validated
    ``x-amz-tagging``, then the lock headers or the bucket's default
    retention (a multipart upload must not dodge WORM)."""
    user_defined = self._user_defined()
    user_defined.update(self._tagging_header_meta())
    user_defined.update(self._lock_headers(bucket, key))
    return user_defined


def _tagging_header_meta(self) -> dict[str, str]:
    """The ``x-amz-tagging`` header, validated, as metadata."""
    tag_hdr = self.headers.get("x-amz-tagging")
    if not tag_hdr:
        return {}
    _try(lambda: btags.parse_header(tag_hdr))
    return {btags.TAG_KEY: tag_hdr}


def _lock_headers(self, bucket: str, key: str) -> dict[str, str]:
    """The ``x-amz-object-lock-*`` headers, or else the bucket's default
    retention (cmd/bucket-object-lock.go).  Either needs a lock-enabled
    bucket, a mode needs its date, and the date must lie ahead: stored
    otherwise it would mint a version its client believes locked and no
    delete would ever find locked."""
    raw = self.srv.bucket_meta.get_config(bucket, "object-lock")
    mode = self.headers.get(olock.AMZ_OBJECT_LOCK_MODE)
    until = self.headers.get(olock.AMZ_OBJECT_LOCK_RETAIN_UNTIL)
    hold = self.headers.get(olock.AMZ_OBJECT_LOCK_LEGAL_HOLD)
    if not (mode or until or hold):
        if raw is None:
            return {}
        cfg = _try(lambda: self.srv.bucket_meta.get_parsed(
            bucket, "object-lock", olock.LockConfig.parse))
        return cfg.default_retention_headers()
    if raw is None or (mode is None) != (until is None):
        raise S3Error("InvalidRequest")
    out: dict[str, str] = {}
    if mode:
        if mode not in (olock.GOVERNANCE, olock.COMPLIANCE):
            raise S3Error("InvalidRequest")
        try:
            dt = datetime.datetime.fromisoformat(until.replace("Z",
                                                               "+00:00"))
        except ValueError as e:
            raise S3Error("InvalidRequest") from e
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=datetime.timezone.utc)
        if dt <= datetime.datetime.now(datetime.timezone.utc):
            raise S3Error("InvalidRequest")
        out[olock.AMZ_OBJECT_LOCK_MODE] = mode
        out[olock.AMZ_OBJECT_LOCK_RETAIN_UNTIL] = _lock_date(dt)
    if hold:
        if hold not in ("ON", "OFF"):
            raise S3Error("InvalidRequest")
        out[olock.AMZ_OBJECT_LOCK_LEGAL_HOLD] = hold
    return out


def _lock_date(dt: datetime.datetime) -> str:
    return dt.astimezone(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


# -- tagging, retention and legal hold (cmd/object-handlers.go
# -- PutObjectTaggingHandler, PutObjectRetentionHandler,
# -- PutObjectLegalHoldHandler): metadata updated in place -----------------

def _update_meta(self, bucket, key, vid, updates, removes=()) -> None:
    oi = self.srv.layer.put_object_metadata(bucket, key, vid, updates,
                                            removes)
    self.srv.mark_changed(bucket, oi)


def _object_tagging(self, bucket, key, query, payload):
    resource = f"{bucket}/{key}"
    vid = _version_id(query)
    if self.command == "PUT":
        self._allow(iampol.PUT_OBJECT_TAGGING, resource)
        tags = _try(lambda: btags.parse_xml(payload))
        self._update_meta(bucket, key, vid,
                          {btags.TAG_KEY: btags.to_header(tags)})
        return self._send(200)
    if self.command == "GET":
        self._allow(iampol.GET_OBJECT_TAGGING, resource)
        oi = self.srv.layer.get_object_info(bucket, key,
                                            ObjectOptions(version_id=vid))
        return self._send(200, btags.to_xml(btags.parse_header(
            oi.user_defined.get(btags.TAG_KEY, ""))))
    if self.command == "DELETE":
        self._allow(iampol.DELETE_OBJECT_TAGGING, resource)
        self._update_meta(bucket, key, vid, {}, removes=(btags.TAG_KEY,))
        return self._send(204)
    raise S3Error("MethodNotAllowed")


def _object_retention(self, bucket, key, query, payload):
    """A retention may always be tightened; a COMPLIANCE one never
    loosened, a GOVERNANCE one only with the governance bypass."""
    resource = f"{bucket}/{key}"
    vid = _version_id(query)
    opts = ObjectOptions(version_id=vid)
    if self.command == "PUT":
        self._allow(iampol.PUT_OBJECT_RETENTION, resource)
        if self.srv.bucket_meta.get_config(bucket, "object-lock") is None:
            raise S3Error("InvalidRequest")
        ret = _try(lambda: olock.Retention.parse(payload))
        cur = olock.Retention.from_metadata(
            self.srv.layer.get_object_info(bucket, key, opts).user_defined)
        if cur.active() and (ret.retain_until < cur.retain_until
                             or ret.mode != cur.mode) and (
                cur.mode == olock.COMPLIANCE
                or cur.mode == olock.GOVERNANCE
                and not self._governance_bypass(resource)):
            raise S3Error("ObjectLocked")
        self._update_meta(bucket, key, vid, {
            olock.AMZ_OBJECT_LOCK_MODE: ret.mode,
            olock.AMZ_OBJECT_LOCK_RETAIN_UNTIL: _lock_date(ret.retain_until)})
        return self._send(200)
    if self.command == "GET":
        self._allow(iampol.GET_OBJECT_RETENTION, resource)
        ret = olock.Retention.from_metadata(
            self.srv.layer.get_object_info(bucket, key, opts).user_defined)
        if not ret.mode:
            raise S3Error("NoSuchObjectLockConfiguration")
        return self._send(200, ret.to_xml())
    raise S3Error("MethodNotAllowed")


def _object_legal_hold(self, bucket, key, query, payload):
    resource = f"{bucket}/{key}"
    vid = _version_id(query)
    if self.command == "PUT":
        self._allow(iampol.PUT_OBJECT_LEGAL_HOLD, resource)
        if self.srv.bucket_meta.get_config(bucket, "object-lock") is None:
            raise S3Error("InvalidRequest")
        status = _try(lambda: olock.legal_hold_from_xml(payload))
        self._update_meta(bucket, key, vid,
                          {olock.AMZ_OBJECT_LOCK_LEGAL_HOLD: status})
        return self._send(200)
    if self.command == "GET":
        self._allow(iampol.GET_OBJECT_LEGAL_HOLD, resource)
        oi = self.srv.layer.get_object_info(bucket, key,
                                            ObjectOptions(version_id=vid))
        return self._send(200, olock.legal_hold_to_xml(
            oi.user_defined.get(olock.AMZ_OBJECT_LOCK_LEGAL_HOLD, "OFF")))
    raise S3Error("MethodNotAllowed")


def _governance_bypass(self, resource: str) -> bool:
    """``x-amz-bypass-governance-retention: true`` from a caller allowed
    ``s3:BypassGovernanceRetention`` on the object."""
    if self.headers.get("x-amz-bypass-governance-retention",
                        "").lower() != "true":
        return False
    try:
        self._allow(iampol.BYPASS_GOVERNANCE, resource)
        return True
    except S3Error:
        return False


def _delete_opts(self, bucket, key, vid, versioned) -> ObjectOptions:
    """The layer's options of a DELETE of ``key`` (``vid`` None: the
    latest).  In a bucket with an object-lock configuration the layer
    refuses, ObjectLocked, to remove a version that a legal hold or an
    unexpired retention protects (enforceRetentionForDeletion), judged
    under the name's write lock; GOVERNANCE yields to
    ``_governance_bypass``.  A delete that only writes a delete marker
    keeps the data and always passes."""
    locked = self.srv.bucket_meta.get_config(bucket, "object-lock") \
        is not None
    return ObjectOptions(
        version_id=vid, versioned=versioned, check_lock=locked,
        bypass_governance=locked
        and self._governance_bypass(f"{bucket}/{key}"))


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
    user_defined = self._new_object_meta(bucket, key)
    self._check_quota(bucket, len(payload))
    oi = self.srv.layer.put_object(
        bucket, key, payload,
        PutObjectOptions(user_defined=user_defined,
                         versioned=self.srv.bucket_meta.versioning_enabled(
                             bucket)))
    self._charge_quota_usage(bucket, oi.size)
    self.srv.mark_changed(bucket, oi)
    self._send(200, headers=_put_headers(oi))


def _check_quota(self, bucket: str, nbytes: int) -> None:
    """Hard-quota admission (cmd/bucket-quota.go enforceBucketQuotaHard):
    the crawler's usage plus the writes since, before any drive is
    written.  The quota document is read first, so a bucket without one
    pays nothing; ``quota.enable=off`` stops the enforcement."""
    quota = self.srv.bucket_meta.get_parsed(bucket, "quota", Quota.parse)
    if quota is None or self.srv.config.get("quota", "enable") != "on":
        return
    if not quota.allows(self.srv.usage.bucket_size(bucket), nbytes):
        raise S3Error("AdminBucketQuotaExceeded")


def _charge_quota_usage(self, bucket: str, nbytes: int) -> None:
    """A committed write's bytes, seen by the next quota check until a
    crawler cycle counts them."""
    self.srv.usage.add_pending(bucket, nbytes)


def _put_headers(oi) -> dict:
    hdrs = {"ETag": f'"{oi.etag}"'}
    if oi.version_id:
        hdrs["x-amz-version-id"] = oi.version_id
    return hdrs


def _create_multipart(self, bucket, key):
    """CreateMultipartUpload (cmd/object-multipart-handlers.go)."""
    user_defined = self._new_object_meta(bucket, key)
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
    self._check_quota(bucket, len(payload))
    pi = self.srv.layer.put_object_part(
        bucket, key, uid, part_num, payload,
        content_md5=want.hex() if want is not None else None)
    self._charge_quota_usage(bucket, pi.size)
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
    # the assembly holds one part at a time: charge the largest, never
    # the object's size, or an object above the watermark could never
    # complete
    try:
        staged = max((p.size for p in self.srv.layer.list_object_parts(
            bucket, key, uid)), default=0)
    except Exception:  # noqa: BLE001 — an unknown upload: the layer call
        staged = 0     # below raises its S3 error
    # the parts were charged as they came: this refuses only the seal of
    # a bucket already past its quota
    self._check_quota(bucket, 0)
    with GOVERNOR.charge(staged, "multipart"):
        oi = self.srv.layer.complete_multipart_upload(bucket, key, uid,
                                                      parts)
    self.srv.mark_changed(bucket, oi)
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
    delete marker; a version under a lock is refused."""
    res = self.srv.layer.delete_object(bucket, key, self._delete_opts(
        bucket, key, _version_id(query),
        self.srv.bucket_meta.versioning_enabled(bucket)))
    self.srv.mark_changed(bucket, res)
    hdrs = {}
    if res.delete_marker:
        hdrs["x-amz-delete-marker"] = "true"
    if res.version_id:
        hdrs["x-amz-version-id"] = res.version_id
    self._send(204, headers=hdrs)


# -- CopyObject and UploadPartCopy (cmd/object-handlers.go:886,
# -- cmd/object-multipart-handlers.go CopyObjectPartHandler) --------------

def _parse_copy_source(self) -> tuple[str, str, str | None]:
    """``x-amz-copy-source`` as (bucket, key, version id).  The
    ``?versionId=`` qualifier is split off the raw header before it is
    unquoted, so a percent-encoded "?" stays part of the key; "null"
    names the null version."""
    raw = self.headers.get("x-amz-copy-source", "")
    vid = None
    if "?versionId=" in raw:
        raw, vid = raw.split("?versionId=", 1)
        if vid == "null":
            vid = ""
    src = urllib.parse.unquote(raw).lstrip("/")
    sbucket, _, skey = src.partition("/")
    if not sbucket or not skey:
        raise S3Error("InvalidCopySource")
    return sbucket, skey, vid


def _copy_source(self):
    """(bucket, key, version id, info) of the copy source, authorised
    for GetObject, its ``x-amz-copy-source-if-match`` and
    ``-if-none-match`` judged on its metadata before any data is read.
    A source another transform stored (SSE, compression, a tier) is
    NotImplemented: the port cannot read it; a delete marker is
    MethodNotAllowed."""
    sbucket, skey, svid = self._parse_copy_source()
    self._allow(iampol.GET_OBJECT, f"{sbucket}/{skey}")
    soi = self.srv.layer.get_object_info(sbucket, skey,
                                         ObjectOptions(version_id=svid))
    ud = soi.user_defined
    if any(k in ud for k in TRANSFORMED) or \
            ud.get(TRANSITION_STATUS) == "complete":
        raise S3Error("NotImplemented")
    if_match = self.headers.get("x-amz-copy-source-if-match")
    if_none = self.headers.get("x-amz-copy-source-if-none-match")
    if if_match and if_match.strip('"') != soi.etag:
        raise S3Error("PreconditionFailed")
    if if_none and if_none.strip('"') == soi.etag:
        raise S3Error("PreconditionFailed")
    if soi.delete_marker:
        raise ol.MethodNotAllowed(f"{sbucket}/{skey} is a delete marker")
    return sbucket, skey, svid, soi


class _ChunkReader:
    """``read(n)`` over a layer reader's chunks: a copy's source streamed
    into the destination's PUT, one batch at a time."""

    def __init__(self, chunks):
        self._it = iter(chunks)
        self._chunks = chunks
        self._buf = memoryview(b"")

    def read(self, n: int = -1) -> bytes:
        while not self._buf:
            try:
                self._buf = memoryview(next(self._it))
            except StopIteration:
                return b""
        n = len(self._buf) if n < 0 else n
        out, self._buf = self._buf[:n], self._buf[n:]
        return out.tobytes()

    def close(self) -> None:
        close = getattr(self._chunks, "close", None)
        if close is not None:
            close()


def _source_body(self, sbucket, skey, soi, offset, length) -> _ChunkReader:
    """The bytes [offset, offset + length) of the source version ``soi``
    (the one whose conditions were judged), streamed one batch at a time
    without the source's read lock (``no_lock``), so a copy onto its own
    name, or two copies in opposite directions, never wait on the PUT's
    write lock."""
    _, chunks = self.srv.layer.get_object_reader(
        sbucket, skey, offset, length,
        ObjectOptions(version_id=soi.version_id or "", no_lock=True))
    return _ChunkReader(chunks)


def _copy_object(self, bucket, key):
    """CopyObject: the source's metadata (Content-Type, x-amz-meta-*) and
    tags, or with the ``REPLACE`` directives the request's, then the
    destination's lock headers or default retention.  A copy onto its
    own name that changes nothing is InvalidCopyDest.  The quota is
    checked against the source's size before any data is read."""
    sbucket, skey, svid, soi = self._copy_source()
    replace = self.headers.get("x-amz-metadata-directive", "COPY") \
        == "REPLACE"
    request_meta = self._user_defined()
    user_defined = request_meta if replace else {
        k: v for k, v in soi.user_defined.items()
        if k.startswith("x-amz-meta-") or k == "content-type"}
    if self.headers.get("x-amz-tagging-directive", "COPY") == "REPLACE":
        user_defined.update(self._tagging_header_meta())
    elif soi.user_defined.get(btags.TAG_KEY):
        user_defined[btags.TAG_KEY] = soi.user_defined[btags.TAG_KEY]
    user_defined.update(self._lock_headers(bucket, key))
    same_name = (sbucket, skey) == (bucket, key)
    if same_name and svid is None and not replace:
        raise S3Error("InvalidCopyDest")
    self._check_quota(bucket, soi.size)
    body = self._source_body(sbucket, skey, soi, 0, -1)
    try:
        oi = self.srv.layer.put_object(bucket, key, body, PutObjectOptions(
            user_defined=user_defined,
            versioned=self.srv.bucket_meta.versioning_enabled(bucket)))
    finally:
        body.close()
    self._charge_quota_usage(bucket, oi.size)
    self.srv.mark_changed(bucket, oi)
    root = ET.Element("CopyObjectResult", xmlns=S3_NS)
    ET.SubElement(root, "ETag").text = f'"{oi.etag}"'
    ET.SubElement(root, "LastModified").text = _iso_date(oi.mod_time)
    hdrs = {}
    if oi.version_id:
        hdrs["x-amz-version-id"] = oi.version_id
    if svid is not None:
        hdrs["x-amz-copy-source-version-id"] = svid or "null"
    self._send(200, _xml(root), headers=hdrs)


def _upload_part_copy(self, bucket, key, query):
    """UploadPartCopy: the source's bytes, or the
    ``x-amz-copy-source-range`` of them, as one part.  The range is
    judged against the source's size, and the quota and the upload
    checked, before any data is read."""
    uid = query["uploadId"][0]
    part_num = _part_number(query)
    offset, length = 0, -1
    crng = self.headers.get("x-amz-copy-source-range")
    if crng:
        offset, length = _parse_range(crng)
        if offset < 0:
            raise S3Error("InvalidRange")
    sbucket, skey, svid, soi = self._copy_source()
    size = soi.size
    if offset > size or (size > 0 and offset == size):
        raise S3Error("InvalidRange")
    n = size - offset if length < 0 else min(length, size - offset)
    self._check_quota(bucket, n)
    self.srv.layer.get_multipart_info(bucket, key, uid)
    body = self._source_body(sbucket, skey, soi, offset, n)
    try:
        pi = self.srv.layer.put_object_part(bucket, key, uid, part_num,
                                            body)
    finally:
        body.close()
    self._charge_quota_usage(bucket, pi.size)
    root = ET.Element("CopyPartResult", xmlns=S3_NS)
    ET.SubElement(root, "ETag").text = f'"{pi.etag}"'
    ET.SubElement(root, "LastModified").text = _iso_date(pi.mod_time or 0)
    self._send(200, _xml(root))


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
    if SUBRESOURCES & set(query) or "x-amz-copy-source" in self.headers:
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
        # before a byte of the body is read or encoded
        self._allow(iampol.PUT_OBJECT, f"{bucket}/{key}")
        user_defined = None if "uploadId" in query \
            else self._new_object_meta(bucket, key)
        self._check_quota(bucket, cl)
        # the layer checks Content-MD5 against the MD5 it takes for the
        # ETag, before it commits: one pass over the body, not two
        md5_hex = want_md5.hex() if want_md5 is not None else None
        if "uploadId" in query:
            pi = self.srv.layer.put_object_part(
                bucket, key, query["uploadId"][0], _part_number(query),
                reader, content_md5=md5_hex)
            self._charge_quota_usage(bucket, pi.size)
            self._send(200, headers={"ETag": f'"{pi.etag}"'})
        else:
            oi = self.srv.layer.put_object(
                bucket, key, reader, PutObjectOptions(
                    user_defined=user_defined,
                    versioned=self.srv.bucket_meta.versioning_enabled(
                        bucket),
                    content_md5=md5_hex))
            self._charge_quota_usage(bucket, oi.size)
            self.srv.mark_changed(bucket, oi)
            self._send(200, headers=_put_headers(oi))
    except Exception as e:  # noqa: BLE001 — XML, as in dispatch
        self._fail(e, path)
        self.close_connection = True
    return True


def _auth_stream(self, path, query, cl: int):
    """Authenticate a PUT without reading its body; returns the verified
    body reader.  The signature (and an STS session's token) is checked
    now; the SHA-256 and every aws-chunked chunk signature as the body is
    read, the last of them at its end, before the object layer
    commits."""
    self._query_token = query.get("X-Amz-Security-Token", [""])[0]
    hdrs = dict(self.headers.items())
    sha = self.headers.get("x-amz-content-sha256")
    lookup = self.srv.iam.lookup_secret
    try:
        if "Authorization" not in hdrs and \
                "X-Amz-Signature" not in query and \
                not ("Signature" in query and "AWSAccessKeyId" in query):
            self.access_key = ""
            body = _BodyReader(
                self.rfile, cl,
                sha256_hex=(sha if sha and sha != sigv4.UNSIGNED_PAYLOAD
                            else None))
        elif hdrs.get("Authorization", "").startswith("AWS "):
            self.access_key = sigv2.verify_request(
                lookup, self.command, path, query, hdrs)
            body = _BodyReader(self.rfile, cl)
        elif "Signature" in query and "AWSAccessKeyId" in query:
            self.access_key = sigv2.verify_presigned(
                lookup, self.command, path, query, hdrs)
            body = _BodyReader(self.rfile, cl)
        elif "X-Amz-Signature" in query:
            self.access_key = sigv4.verify_presigned(
                lookup, self.command, path, query, hdrs,
                region=self.srv.region)
            body = _BodyReader(self.rfile, cl)
        elif sha == sigv4.STREAMING_PAYLOAD:
            self.access_key, key, seed, amz_date, scope = \
                sigv4.verify_request_streaming(
                    lookup, self.command, path, query, hdrs,
                    region=self.srv.region)
            body = sigv4.ChunkedStreamReader(
                _BodyReader(self.rfile, cl), key, seed, amz_date, scope)
        else:
            sha = sha or sigv4.UNSIGNED_PAYLOAD
            self.access_key = sigv4.verify_request(
                lookup, self.command, path, query, hdrs, sha,
                region=self.srv.region)
            body = _BodyReader(
                self.rfile, cl,
                sha256_hex=sha if sha != sigv4.UNSIGNED_PAYLOAD else None)
    except sigv4.SigV4Error as e:
        raise S3Error(e.code) from e
    self._check_session_token()
    return body


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
    tag_hdr = oi.user_defined.get(btags.TAG_KEY)
    if tag_hdr:
        hdrs["x-amz-tagging-count"] = str(len(urllib.parse.parse_qsl(
            tag_hdr, keep_blank_values=True)))
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
HANDLERS = ["_object_api", "_user_defined", "_new_object_meta",
            "_tagging_header_meta", "_lock_headers", "_update_meta",
            "_object_tagging", "_object_retention", "_object_legal_hold",
            "_governance_bypass", "_delete_opts", "_content_md5",
            "_put_object", "_check_quota", "_charge_quota_usage",
            "_create_multipart", "_upload_part", "_complete_multipart",
            "_list_parts", "_delete_object", "_parse_copy_source",
            "_copy_source", "_source_body", "_copy_object",
            "_upload_part_copy", "_try_stream_put", "_auth_stream",
            "_get_object", "_preconditions_304"]
