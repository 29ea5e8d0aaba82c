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
protects answers ``ObjectLocked`` (``_delete_opts``).  ``?acl``
answers the canned private ACL, and a PUT of it takes ``private`` only.
Each handler
authorises the reference's S3 action on ``bucket/key`` (``_allow``)
before it reads a body or reaches the layer; CompleteMultipartUpload
charges its largest part to the memory governor (``multipart``).  A
write to a bucket with a hard quota is refused (403
``XMinioAdminBucketQuotaExceeded``) before its body is read when it
would take the bucket past the limit, and a committed write is charged
to the server's usage view (``_check_quota``, ``_charge_quota_usage``).
Each call fires the event the reference fires there (``srv.notify``):
a PUT, a copy, a completed upload, a tag, retention or legal-hold
update, a restore, a DELETE, a GET and a HEAD; those that change the
object also mark the data-update tracker.  A
bucket's versioning and lock configuration come from
``self.srv.bucket_meta``.  ``_make_handler`` (server.py) attaches these
functions to the request handler; ``self`` is the handler and
``self.srv`` its server.

A write's ``x-amz-storage-class`` picks its parity through the
``storage_class`` subsystem (``_storage_class_parity``; a class other
than STANDARD is recorded and answered on GET and HEAD).  A PUT's body
is compressed when the ``compression`` subsystem says so, then encrypted
when the request or the bucket's default asks for SSE, in the
reference's order (``_transform_for_put``); such a PUT takes the
buffered route.  A multipart upload's parts are each one DARE stream
under the upload's key (``_encrypt_part``).  A GET of a transformed
object streams its plain bytes one batch at a time
(``_fetch_plain_chunks``): a range of an encrypted object decrypts only
the DARE packages that cover it, read in one pass over the stored
bytes; a compressed one decodes from its start.  HEAD answers the plain
size, and an object transitioned to a tier answers InvalidObjectState
to GET (and as a copy source) and its archived size and ETag to HEAD,
until ``POST ?restore`` writes its tier copy back for some days
(``_restore_object``); a DELETE, DeleteObjects or unversioned overwrite
of a transitioned version frees its tier copy once it commits.  A copy
decodes its source the same way, with the
``x-amz-copy-source-server-side-encryption-customer-*`` key, and encodes
for its destination.  ``POST ?select&select-type=2`` runs S3 Select
over the object's plain bytes (``_select_object``).
"""

from __future__ import annotations

import base64
import datetime
import email.utils
import hashlib
import urllib.parse
import xml.etree.ElementTree as ET

from .. import compress as mtc
from .. import s3select
from ..admin import metrics as _metrics
from ..bucket import objectlock as olock
from ..bucket import tags as btags
from ..bucket.encryption import SSEConfig
from ..bucket.quota import Quota
from ..crypto import dare
from ..crypto import sse as csse
from ..iam import policy as iampol
from ..objectlayer import interface as ol
from ..objectlayer import tiering
from ..objectlayer.interface import ObjectOptions, PutObjectOptions
from ..utils import close_quietly
from ..utils.kvconfig import parse_storage_class
from ..utils.memgov import GOVERNOR
from . import errors as s3err
from . import sigv2, sigv4
from .server import (MAX_PUT_SIZE, RESERVED_BUCKETS, S3_NS,
                     STREAM_PUT_THRESHOLD, S3Error, _actual_size, _BUCKET_RE,
                     _BodyReader, _canned_acl_xml, _http_date, _iso_date,
                     _parse_range, _try, _xml)

# subresources answered on the buffered route only
SUBRESOURCES = frozenset(("acl", "tagging", "retention", "legal-hold",
                          "select", "restore"))
STORAGE_CLASS = "x-amz-storage-class"
# plain bytes decrypted per step of a transformed GET or copy: a whole
# number of DARE packages
DECRYPT_BLOCK = 64 * dare.MAX_PAYLOAD
PRECONDITIONS = ("If-Match", "If-None-Match", "If-Modified-Since",
                 "If-Unmodified-Since")


def _object_api(self, bucket, key, query, payload):
    cmd = self.command
    resource = f"{bucket}/{key}"
    if "tagging" in query:
        return self._object_tagging(bucket, key, query, payload)
    if "retention" in query:
        return self._object_retention(bucket, key, query, payload)
    if "legal-hold" in query:
        return self._object_legal_hold(bucket, key, query, payload)
    if "acl" in query:
        if cmd == "GET":
            self._allow(iampol.GET_OBJECT_ACL, resource)
            self.srv.layer.get_object_info(bucket, key)
            return self._send(200, _canned_acl_xml())
        if cmd == "PUT":
            self._allow(iampol.PUT_OBJECT_ACL, resource)
            if self.headers.get("x-amz-acl", "private") != "private":
                raise S3Error("NotImplemented")
            return self._send(200)
        raise S3Error("MethodNotAllowed")
    if cmd == "POST" and "select" in query and \
            query.get("select-type") == ["2"]:
        self._allow(iampol.GET_OBJECT, resource)
        return self._select_object(bucket, key, payload)
    if cmd == "POST" and "uploads" in query:
        self._allow(iampol.PUT_OBJECT, resource)
        return self._create_multipart(bucket, key)
    if cmd == "POST" and "uploadId" in query:
        self._allow(iampol.PUT_OBJECT, resource)
        return self._complete_multipart(bucket, key, query, payload)
    if cmd == "POST" and "restore" in query:
        self._allow("s3:RestoreObject", resource)
        return self._restore_object(bucket, key, query, payload)
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
    """Content-Type and x-amz-meta-* headers, as stored with the object."""
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

def _update_meta(self, event, bucket, key, vid, updates, removes=()):
    oi = self.srv.layer.put_object_metadata(bucket, key, vid, updates,
                                            removes)
    self.srv.notify(event, bucket, oi)


def _object_tagging(self, bucket, key, query, payload):
    resource = f"{bucket}/{key}"
    vid = _version_id(query)
    if self.command == "PUT":
        self._allow(iampol.PUT_OBJECT_TAGGING, resource)
        tags = _try(lambda: btags.parse_xml(payload))
        self._update_meta("s3:ObjectCreated:PutTagging", bucket, key, vid,
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
        self._update_meta("s3:ObjectCreated:DeleteTagging", bucket, key,
                          vid, {}, removes=(btags.TAG_KEY,))
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
        self._update_meta("s3:ObjectCreated:PutRetention", bucket, key, vid, {
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
        self._update_meta("s3:ObjectCreated:PutLegalHold", bucket, key, vid,
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


# -- transitions to a tier: restore, and the tier copy a delete or an
# -- overwrite frees (cmd/object-handlers.go PostRestoreObjectHandler) -----

def _restore_object(self, bucket, key, query, payload):
    """RestoreObject: ``<RestoreRequest><Days>N</Days></RestoreRequest>``
    (1 day without a body) writes a stub's tier copy back for N days:
    202 for a fresh copy, 200 when a valid one is already held,
    InvalidObjectState for a version that was never transitioned."""
    days = 1
    if payload:
        try:
            root = ET.fromstring(payload)
            for el in root.iter():
                if el.tag.split("}")[-1] == "Days":
                    days = int(el.text or 1)
        except (ET.ParseError, ValueError) as e:
            raise S3Error("MalformedXML") from e
    if days < 1:
        raise S3Error("InvalidArgument")
    vid = _version_id(query)
    try:
        fresh = self.srv.transition.restore(bucket, key, days, version_id=vid)
    except tiering.TierError as e:
        # only "not archived" is the client's mistake; a tier that fails
        # is the server's
        if "archived state" in str(e):
            raise S3Error("InvalidObjectState") from e
        raise S3Error("InternalError") from e
    self.srv.notify("s3:ObjectRestore:Completed", bucket,
                    self.srv.layer.get_object_info(
                        bucket, key, ObjectOptions(version_id=vid)))
    return self._send(202 if fresh else 200, b"")


def _tiered_meta_of(self, bucket, key, vid, versioned):
    """The metadata of the version a delete or an overwrite is about to
    remove (``vid`` None: the latest, "": the null version) when it is
    transitioned, so its tier copy can be freed once the call commits;
    None when there is none to free (a versioned DELETE without a
    version id only adds a marker)."""
    if not self.srv.transition.tiers or (versioned and vid is None):
        return None
    try:
        old = self.srv.layer.get_object_info(
            bucket, key, ObjectOptions(version_id=vid))
    except ol.ObjectLayerError:
        return None
    return old.user_defined if tiering.is_transitioned(old.user_defined) \
        else None


def _overwritten_tier_copy(self, bucket, key, versioned):
    """An unversioned write replaces the null version: its tier copy's
    metadata, to free after the write commits."""
    return None if versioned else \
        self._tiered_meta_of(bucket, key, "", False)


def _free_tier_copy(self, user_defined) -> None:
    if user_defined is not None:
        self.srv.transition.delete_tiered(user_defined)


# -- S3 Select (cmd/object-handlers.go SelectObjectContentHandler) ---------

# frames held before a Select answer switches from one buffered body to
# chunked transfer encoding written as the scan advances
SELECT_FLUSH_BYTES = 2 << 20
# decode blocks one scan charges to the memory governor, besides the
# frames it holds before the switch
SELECT_CHARGE_BLOCKS = 6


def _select_object(self, bucket, key, payload):
    """SelectObjectContent over the object's plain bytes
    (``_fetch_plain_chunks``: an encrypted or compressed object is
    queried in the clear, a degraded one rebuilt on the layer's device),
    ``api select_block_bytes`` at a time.  A version in a tier without a
    valid restored copy is InvalidObjectState, as GET is.  A malformed
    request is refused before anything is charged; the scan's working
    set is charged to the memory governor (``select``) before a byte is
    read, twice the plain size more for an input read whole (Parquet, a
    JSON document).  Frames up to ``SELECT_FLUSH_BYTES`` go out as one body;
    past that the answer is chunked, and an error after the status line
    becomes an error frame in the stream."""
    block = self.srv.select_block_bytes
    try:
        req = s3select.SelectRequest.parse(payload)
    except s3select.SelectError as e:
        raise S3Error(e.code) from e
    oi = self.srv.layer.get_object_info(bucket, key)
    if _stubbed(oi.user_defined):
        raise S3Error("InvalidObjectState")
    size = _actual_size(oi)
    est = SELECT_CHARGE_BLOCKS * block + SELECT_FLUSH_BYTES
    if req.input_format == "PARQUET" or (
            req.input_format == "JSON" and
            req.input_opts.get("type", "LINES") != "LINES"):
        est += 2 * size
    charge = GOVERNOR.charge(est, "select")
    chunks = None
    try:
        m = _metrics.GLOBAL
        m.inc("mt_select_requests_total")

        def on_stats(scanned, processed, returned):
            m.inc("mt_select_scanned_bytes_total", value=scanned)
            m.inc("mt_select_processed_bytes_total", value=processed)
            m.inc("mt_select_returned_bytes_total", value=returned)

        enc = None
        if csse.is_encrypted(oi.user_defined):
            enc = csse.ObjectEncryption.open(oi.user_defined, bucket, key,
                                             self.headers, self.srv.kms)
        chunks = self._fetch_plain_chunks(bucket, key, oi, enc, 0, size)
        try:
            frames = iter(s3select.run_select_stream(
                payload, chunks, block_bytes=block, on_stats=on_stats))
            head = bytearray()
            done = False
            while len(head) < SELECT_FLUSH_BYTES:
                piece = next(frames, None)
                if piece is None:
                    done = True
                    break
                head += piece
        except s3select.SelectError as e:
            raise S3Error(e.code) from e
        if done:
            return self._send(200, bytes(head),
                              content_type="application/octet-stream")

        def tail():
            try:
                yield from frames
            except s3select.SelectError as e:
                yield s3select.message.error_message(e.code, str(e))

        self._send_chunked(200, tail(), "application/octet-stream",
                           head=bytes(head))
    finally:
        charge.release()
        close_quietly(chunks)


def _content_md5(self) -> bytes | None:
    md5_hdr = self.headers.get("Content-MD5")
    if not md5_hdr:
        return None
    try:
        return base64.b64decode(md5_hdr)
    except Exception as e:  # noqa: BLE001 — any malformed header
        raise S3Error("InvalidDigest") from e


def _put_object(self, bucket, key, payload):
    """PutObject with the body in hand (cmd/object-handlers.go:1488):
    compressed and encrypted as asked, with its storage class's parity."""
    if "Content-Length" not in self.headers:
        raise S3Error("MissingContentLength")
    want = self._content_md5()
    if want is not None and hashlib.md5(payload).digest() != want:
        raise S3Error("BadDigest")
    user_defined = self._new_object_meta(bucket, key)
    self._check_quota(bucket, len(payload))
    versioned = self.srv.bucket_meta.versioning_enabled(bucket)
    tiered = self._overwritten_tier_copy(bucket, key, versioned)
    payload = self._transform_for_put(bucket, key, user_defined, payload)
    oi = self.srv.layer.put_object(bucket, key, payload, PutObjectOptions(
        user_defined=user_defined, versioned=versioned,
        parity=self._storage_class_parity(user_defined)))
    self._free_tier_copy(tiered)
    self._charge_quota_usage(bucket, oi.size)
    self.srv.notify("s3:ObjectCreated:Put", bucket, oi)
    self.srv.replicate(bucket, oi)
    self._send(200, headers=_put_headers(oi, user_defined))


# -- storage classes, SSE and compression of a write
# -- (cmd/encryption-v1.go EncryptRequest, newS2CompressReader) -----------

def _set_drive_count(layer) -> int:
    """Drives per erasure set, whatever the layer's shape: a storage
    class's parity is bounded by the set's size."""
    n = getattr(layer, "set_drive_count", 0)
    if n:
        return n
    pools = getattr(layer, "pools", None)
    if pools:
        return pools[0].set_drive_count
    return len(getattr(layer, "disks", []) or [])


def _storage_class_parity(self, user_defined: dict) -> int | None:
    """The write's parity from ``x-amz-storage-class`` and the
    ``storage_class`` subsystem (cmd/erasure-object.go:631): None for
    the set's default.  REDUCED_REDUNDANCY is recorded in
    ``user_defined`` (STANDARD is not, as on AWS); another class, or a
    class configured out of range, is InvalidStorageClass.  A bad
    ``standard`` value fails no request that named no class."""
    sc = self.headers.get(STORAGE_CLASS, "").upper()
    explicit = sc not in ("", "STANDARD")
    if not explicit:
        value = self.srv.config.get("storage_class", "standard")
    elif sc == "REDUCED_REDUNDANCY":
        value = self.srv.config.get("storage_class", "rrs")
    else:
        raise S3Error("InvalidStorageClass")
    n = _set_drive_count(self.srv.layer)
    if not value or not n:
        return None
    try:
        parity = parse_storage_class(value, n)
    except ValueError as e:
        if explicit:
            raise S3Error("InvalidStorageClass") from e
        return None
    if explicit:
        user_defined[STORAGE_CLASS] = sc
    return parity


def _bucket_sse_algo(self, bucket: str) -> str:
    """The bucket's default encryption algorithm, "" without one."""
    raw = self.srv.bucket_meta.get_config(bucket, "encryption")
    if not raw:
        return ""
    try:
        return SSEConfig.parse(raw.encode()).algorithm
    except ValueError:
        return ""


def _sse_for_put(self, bucket: str, key: str, user_defined: dict):
    """The object's encryption when the request (or the bucket's
    default) asks for SSE, its sealed key added to ``user_defined``;
    else None."""
    kind = csse.requested_sse(self.headers, self._bucket_sse_algo(bucket))
    if not kind:
        return None
    enc = csse.ObjectEncryption.new(kind, bucket, key, self.headers,
                                    self.srv.kms)
    user_defined.update(enc.meta)
    return enc


def _compression_eligible(self, key: str, size: int,
                          content_type: str | None = None) -> bool:
    """Whether the ``compression`` subsystem stores a body of ``size``
    bytes under ``key`` compressed (``content_type``: the request's
    Content-Type by default)."""
    cfg = self.srv.config
    if cfg.get("compression", "enable") != "on":
        return False
    if content_type is None:
        content_type = self.headers.get("Content-Type", "")
    exts = [e for e in cfg.get("compression", "extensions").split(",") if e]
    types = [t for t in cfg.get("compression", "mime_types").split(",")
             if t]
    return mtc.is_compressible(key, content_type, size, exts, types)


def _compress_for_put(self, key: str, user_defined: dict,
                      payload: bytes) -> bytes:
    """The body compressed when the ``compression`` subsystem takes it,
    with the marker and the plain size in ``user_defined``."""
    if not self._compression_eligible(
            key, len(payload), user_defined.get("content-type", "")):
        return payload
    user_defined[mtc.META_COMPRESSION] = mtc.COMPRESSION_ALGO
    user_defined[csse.META_ACTUAL_SIZE] = str(len(payload))
    return mtc.compress_stream(payload)


def _transform_for_put(self, bucket, key, user_defined: dict,
                       payload) -> bytes:
    """Compressed, then encrypted: the bytes a PUT stores."""
    payload = self._compress_for_put(key, user_defined, payload)
    enc = self._sse_for_put(bucket, key, user_defined)
    return payload if enc is None else enc.encrypt(bytes(payload))


def _encrypt_part(self, bucket, key, uid, payload) -> tuple[bytes, dict]:
    """A part of an encrypted upload as its own DARE stream under the
    upload's key (an SSE-C upload needs the key headers on every part),
    and the SSE headers of the answer; a plain upload's part as it is."""
    mp = self.srv.layer.get_multipart_info(bucket, key, uid)
    if not csse.is_encrypted(mp.user_defined):
        return payload, {}
    enc = csse.ObjectEncryption.open(mp.user_defined, bucket, key,
                                     self.headers, self.srv.kms)
    return enc.encrypt(bytes(payload)), csse.response_headers(
        mp.user_defined)


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


def _put_headers(oi, user_defined: dict | None = None) -> dict:
    hdrs = {"ETag": f'"{oi.etag}"'}
    hdrs.update(csse.response_headers(user_defined or {}))
    if oi.version_id:
        hdrs["x-amz-version-id"] = oi.version_id
    return hdrs


def _create_multipart(self, bucket, key):
    """CreateMultipartUpload (cmd/object-multipart-handlers.go): the
    upload's key sealed when it is SSE, its parity from its storage
    class."""
    user_defined = self._new_object_meta(bucket, key)
    self._sse_for_put(bucket, key, user_defined)
    uid = self.srv.layer.new_multipart_upload(
        bucket, key, PutObjectOptions(
            user_defined=user_defined,
            versioned=self.srv.bucket_meta.versioning_enabled(bucket),
            parity=self._storage_class_parity(user_defined)))
    root = ET.Element("InitiateMultipartUploadResult", xmlns=S3_NS)
    ET.SubElement(root, "Bucket").text = bucket
    ET.SubElement(root, "Key").text = key
    ET.SubElement(root, "UploadId").text = uid
    self._send(200, _xml(root), headers=csse.response_headers(user_defined))


def _part_number(query) -> int:
    try:
        return int(query["partNumber"][0])
    except (KeyError, ValueError) as e:
        raise S3Error("InvalidArgument") from e


def _upload_part(self, bucket, key, query, payload):
    """UploadPart with the body in hand; encrypted when the upload is
    (its Content-MD5 is then the plain body's)."""
    uid = query["uploadId"][0]
    part_num = _part_number(query)
    want = self._content_md5()
    self._check_quota(bucket, len(payload))
    stored, sse_hdrs = self._encrypt_part(bucket, key, uid, payload)
    if stored is not payload:
        if want is not None and hashlib.md5(payload).digest() != want:
            raise S3Error("BadDigest")
        want = None
    pi = self.srv.layer.put_object_part(
        bucket, key, uid, part_num, stored,
        content_md5=want.hex() if want is not None else None)
    self._charge_quota_usage(bucket, pi.size)
    self._send(200, headers={"ETag": f'"{pi.etag}"', **sse_hdrs})


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
    self.srv.notify("s3:ObjectCreated:CompleteMultipartUpload", bucket, oi)
    self.srv.replicate(bucket, oi)
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
    delete marker; a version under a lock is refused.  A transitioned
    version's tier copy is freed once the delete has committed."""
    vid = _version_id(query)
    versioned = self.srv.bucket_meta.versioning_enabled(bucket)
    tiered = self._tiered_meta_of(bucket, key, vid, versioned)
    res = self.srv.layer.delete_object(bucket, key, self._delete_opts(
        bucket, key, vid, versioned))
    self._free_tier_copy(tiered)
    self.srv.notify("s3:ObjectRemoved:DeleteMarkerCreated"
                    if res.delete_marker else "s3:ObjectRemoved:Delete",
                    bucket, res)
    self.srv.replicate(bucket, res, delete=True)
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
    """(bucket, key, version id, info, opened key) of the copy source,
    authorised for GetObject, its ``x-amz-copy-source-if-match`` and
    ``-if-none-match`` judged on its metadata before any data is read.
    An encrypted source is opened (an SSE-C one with the
    ``x-amz-copy-source-server-side-encryption-customer-*`` key); the
    key is None for a plain one.  A source transitioned to a tier is
    InvalidObjectState unless it holds a valid restored copy, which is
    copied; a delete marker is MethodNotAllowed."""
    sbucket, skey, svid = self._parse_copy_source()
    self._allow(iampol.GET_OBJECT, f"{sbucket}/{skey}")
    soi = self.srv.layer.get_object_info(sbucket, skey,
                                         ObjectOptions(version_id=svid))
    if _stubbed(soi.user_defined):
        raise S3Error("InvalidObjectState")
    if_match = self.headers.get("x-amz-copy-source-if-match")
    if_none = self.headers.get("x-amz-copy-source-if-none-match")
    if if_match and if_match.strip('"') != soi.etag:
        raise S3Error("PreconditionFailed")
    if if_none and if_none.strip('"') == soi.etag:
        raise S3Error("PreconditionFailed")
    if soi.delete_marker:
        raise ol.MethodNotAllowed(f"{sbucket}/{skey} is a delete marker")
    enc = None
    if csse.is_encrypted(soi.user_defined):
        enc = csse.ObjectEncryption.open(soi.user_defined, sbucket, skey,
                                         self.headers, self.srv.kms,
                                         copy_source=True)
    return sbucket, skey, svid, soi, enc


class _ChunkReader:
    """``read(n)`` over a layer reader's chunks: a copy's source streamed
    into the destination's PUT, one batch at a time."""

    def __init__(self, chunks):
        self._it = iter(chunks)
        self._chunks = chunks
        self._buf = memoryview(b"")

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            rest = [self._buf.tobytes(), *self._it]
            self._buf = memoryview(b"")
            return b"".join(rest)
        while not self._buf:
            try:
                self._buf = memoryview(next(self._it))
            except StopIteration:
                return b""
        out, self._buf = self._buf[:n], self._buf[n:]
        return out.tobytes()

    def close(self) -> None:
        _close(self._chunks)


def _source_body(self, sbucket, skey, soi, enc, offset, length
                 ) -> _ChunkReader:
    """The plain bytes [offset, offset + length) of the source version
    ``soi`` (the one whose conditions were judged), decrypted and
    decompressed when it is stored so, streamed one batch at a time
    without the source's read lock (``no_lock``), so a copy onto its own
    name, or two copies in opposite directions, never wait on the PUT's
    write lock."""
    if _transformed(soi.user_defined):
        return _ChunkReader(self._fetch_plain_chunks(
            sbucket, skey, soi, enc, offset, length, no_lock=True))
    _, chunks = self.srv.layer.get_object_reader(
        sbucket, skey, offset, length,
        ObjectOptions(version_id=soi.version_id or "", no_lock=True))
    return _ChunkReader(chunks)


def _copy_object(self, bucket, key):
    """CopyObject: the source's metadata (Content-Type, x-amz-meta-*) and
    tags, or with the ``REPLACE`` directives the request's, then the
    destination's lock headers or default retention.  The source's plain
    bytes are stored as a PUT of them would be: compressed, encrypted
    and with the parity of the request's storage class.  A copy onto its
    own name that changes neither metadata nor encryption is
    InvalidCopyDest.  The quota is checked before any data is read,
    against the source's plain size (a destination to be compressed or
    encrypted is read whole first, and checked at its stored size)."""
    sbucket, skey, svid, soi, senc = self._copy_source()
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
    size = _actual_size(soi)
    sse = csse.requested_sse(self.headers, self._bucket_sse_algo(bucket))
    same_name = (sbucket, skey) == (bucket, key)
    if same_name and svid is None and not replace and not sse and \
            senc is None:
        raise S3Error("InvalidCopyDest")
    versioned = self.srv.bucket_meta.versioning_enabled(bucket)
    transform = bool(sse) or self._compression_eligible(
        key, size, user_defined.get("content-type", ""))
    if not transform:
        self._check_quota(bucket, size)
    body = self._source_body(sbucket, skey, soi, senc, 0, size)
    try:
        data = body
        if transform:
            data = self._compress_for_put(key, user_defined, body.read())
            enc = self._sse_for_put(bucket, key, user_defined)
            self._check_quota(bucket, len(data))
            if enc is not None:
                data = enc.encrypt(data)
        oi = self.srv.layer.put_object(bucket, key, data, PutObjectOptions(
            user_defined=user_defined, versioned=versioned,
            parity=self._storage_class_parity(user_defined)))
    finally:
        body.close()
    self._charge_quota_usage(bucket, oi.size)
    self.srv.notify("s3:ObjectCreated:Copy", bucket, oi)
    self.srv.replicate(bucket, oi)
    root = ET.Element("CopyObjectResult", xmlns=S3_NS)
    ET.SubElement(root, "ETag").text = f'"{oi.etag}"'
    ET.SubElement(root, "LastModified").text = _iso_date(oi.mod_time)
    hdrs = csse.response_headers(user_defined)
    if oi.version_id:
        hdrs["x-amz-version-id"] = oi.version_id
    if svid is not None:
        hdrs["x-amz-copy-source-version-id"] = svid or "null"
    self._send(200, _xml(root), headers=hdrs)


def _upload_part_copy(self, bucket, key, query):
    """UploadPartCopy: the source's plain bytes, or the
    ``x-amz-copy-source-range`` of them, as one part (encrypted under
    the upload's key when the upload is).  The range is judged against
    the source's plain size, and the quota and the upload checked,
    before any data is read."""
    uid = query["uploadId"][0]
    part_num = _part_number(query)
    offset, length = 0, -1
    crng = self.headers.get("x-amz-copy-source-range")
    if crng:
        offset, length = _parse_range(crng)
        if offset < 0:
            raise S3Error("InvalidRange")
    sbucket, skey, svid, soi, senc = self._copy_source()
    size = _actual_size(soi)
    if offset > size or (size > 0 and offset == size):
        raise S3Error("InvalidRange")
    n = size - offset if length < 0 else min(length, size - offset)
    self._check_quota(bucket, n)
    mp = self.srv.layer.get_multipart_info(bucket, key, uid)
    body = self._source_body(sbucket, skey, soi, senc, offset, n)
    try:
        data = body
        if csse.is_encrypted(mp.user_defined):
            data, _ = self._encrypt_part(bucket, key, uid, body.read())
        pi = self.srv.layer.put_object_part(bucket, key, uid, part_num,
                                            data)
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
    upload, which the buffered route refuses).  A body that is to be
    compressed or encrypted is read whole, as the reference reads it,
    within ``max_body_size``."""
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
            mp = self.srv.layer.get_multipart_info(bucket, key,
                                                   query["uploadId"][0])
        except Exception:  # noqa: BLE001 — answered on the buffered route
            return False
        transforming = csse.is_encrypted(mp.user_defined)
    else:
        try:
            transforming = bool(csse.requested_sse(
                self.headers, self._bucket_sse_algo(bucket))) \
                or self._compression_eligible(key, cl)
        except csse.SSEError:
            return False                # answered on the buffered route
    if transforming and cl <= self.srv.max_body_size:
        return False
    # committed to streaming: any failure is answered here and the
    # half-read connection dropped
    try:
        if cl > MAX_PUT_SIZE or transforming:
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
            versioned = self.srv.bucket_meta.versioning_enabled(bucket)
            tiered = self._overwritten_tier_copy(bucket, key, versioned)
            oi = self.srv.layer.put_object(
                bucket, key, reader, PutObjectOptions(
                    user_defined=user_defined, versioned=versioned,
                    content_md5=md5_hex,
                    parity=self._storage_class_parity(user_defined)))
            self._free_tier_copy(tiered)
            self._charge_quota_usage(bucket, oi.size)
            self.srv.notify("s3:ObjectCreated:Put", bucket, oi)
            self.srv.replicate(bucket, oi)
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
    layer's reader, decoded when the object is encrypted or compressed
    (ranges are in plain bytes; SSE-C needs its key).  A delete marker
    answers 405 with ``x-amz-delete-marker``; a version transitioned to a
    tier answers InvalidObjectState to GET, and HEAD its archived size."""
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
                    "ETag": f'"{_display_etag(oi)}"',
                    "Last-Modified": _http_date(oi.mod_time)},
                    content_length=0)
        offset, length = _parse_range(rng) if rng else (0, -1)
        if head or rng:
            # metadata first: a delete marker's range is never read, a
            # HEAD's range is checked (InvalidRange) as the reference
            # checks it, and a transformed object's range is in plain
            # bytes, not stored ones
            oi = oi if oi is not None else \
                layer.get_object_info(bucket, key, opts)
            if rng and not head and _stubbed(oi.user_defined):
                raise S3Error("InvalidObjectState")
            if rng and not oi.delete_marker and \
                    not _transformed(oi.user_defined):
                oi, body = layer.get_object_reader(bucket, key, offset,
                                                   length, opts)
        else:
            oi, body = layer.get_object_reader(bucket, key, offset, length,
                                               opts)
        if not head and oi.delete_marker:
            raise ol.MethodNotAllowed(key)
        ud = oi.user_defined
        stubbed = _stubbed(ud)
        if stubbed and not head:
            raise S3Error("InvalidObjectState")
        live = not oi.delete_marker and not stubbed
        encrypted = live and csse.is_encrypted(ud)
        compressed = live and mtc.META_COMPRESSION in ud
        size = oi.size
        enc = None
        sse_hdrs: dict[str, str] = {}
        if stubbed:
            size = int(ud.get(tiering.META_SIZE, "0"))
        if encrypted:
            enc = csse.ObjectEncryption.open(ud, bucket, key, self.headers,
                                             self.srv.kms)
            sse_hdrs = csse.response_headers(ud)
            if not compressed:
                size = csse.decrypted_size(ud, oi.size, oi.parts)
                if rng and offset >= size:
                    raise S3Error("InvalidRange")
        if compressed:
            size = int(ud[csse.META_ACTUAL_SIZE])
            if rng and not head and offset >= size:
                raise S3Error("InvalidRange")
        start = max(0, size + offset) if offset < 0 else offset
        sent = size - start if length < 0 else min(length, size - start)
        if not head and (encrypted or compressed):
            body = self._fetch_plain_chunks(
                bucket, key, oi, enc, start, sent,
                stored=None if rng else body)
    except ol.MethodNotAllowed:
        return self._send(
            405, s3err.to_xml(s3err.get("MethodNotAllowed")),
            headers={"x-amz-delete-marker": "true"})
    except BaseException:
        _close(body)
        raise
    hdrs = {"ETag": f'"{oi.etag}"', "Last-Modified": _http_date(oi.mod_time),
            "Accept-Ranges": "bytes"}
    if tiering.is_transitioned(oi.user_defined):
        hdrs["ETag"] = f'"{_display_etag(oi)}"'
        hdrs[tiering.STORAGE_CLASS_HDR] = oi.user_defined.get(
            tiering.STORAGE_CLASS_HDR, "")
        restore = tiering.restore_header(oi.user_defined)
        if restore:
            hdrs[tiering.RESTORE_HDR] = restore
    elif oi.user_defined.get(STORAGE_CLASS):
        hdrs[STORAGE_CLASS] = oi.user_defined[STORAGE_CLASS]
    hdrs.update(sse_hdrs)
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
    self.srv.notify("s3:ObjectAccessed:Head" if head
                    else "s3:ObjectAccessed:Get", bucket, oi)
    if head:
        _close(body)
        if oi.delete_marker:
            dm_hdrs = {"x-amz-delete-marker": "true"}
            if oi.version_id:
                dm_hdrs["x-amz-version-id"] = oi.version_id
            return self._send(405, b"", headers=dm_hdrs, content_length=0)
        return self._send(200, b"", content_type=ct, headers=hdrs,
                          content_length=size)
    if rng:
        hdrs["Content-Range"] = f"bytes {start}-{start + sent - 1}/{size}"
        return self._send_stream(206, body, sent, ct, hdrs)
    return self._send_stream(200, body, size, ct, hdrs)


def _close(it) -> None:
    close = getattr(it, "close", None)
    if close is not None:
        close()


def _stubbed(user_defined: dict) -> bool:
    """A version whose data lives in a tier and has no valid restored
    copy here."""
    return tiering.is_transitioned(user_defined) and \
        not tiering.restore_valid(user_defined)


def _transformed(user_defined: dict) -> bool:
    """Stored encrypted or compressed: its bytes are not the client's."""
    return csse.is_encrypted(user_defined) or \
        mtc.META_COMPRESSION in user_defined


def _display_etag(oi) -> str:
    """The ETag clients see: a transitioned stub's is the original's."""
    if tiering.is_transitioned(oi.user_defined):
        return oi.user_defined.get(tiering.META_ETAG, oi.etag)
    return oi.etag


class _SeqCipherReader:
    """``read(offset, n)`` over one stream of an object's stored bytes
    that starts at ``start``, for reads whose offsets do not go back
    past the previous read's (a DARE package may be read twice where a
    step ends inside it): one layer reader, one lock and one metadata
    read for the whole walk.  An offset before that falls back to a
    ranged read of the version (``fallback(offset, n)``)."""

    def __init__(self, chunks, start: int, fallback):
        self._chunks = chunks
        self._it = iter(chunks)
        self._buf = bytearray()
        self._start = start                 # object offset of _buf[0]
        self._fallback = fallback

    def read(self, offset: int, n: int) -> bytes:
        if offset < self._start:
            return self._fallback(offset, n)
        rel = offset - self._start
        while len(self._buf) - rel < n:
            piece = next(self._it, None)
            if piece is None:
                break
            # the bytes before ``offset`` are never read again
            drop = min(rel, len(self._buf))
            del self._buf[:drop]
            self._start += drop
            rel -= drop
            self._buf += piece
        return bytes(self._buf[rel:rel + n])

    def close(self) -> None:
        _close(self._chunks)


def _fetch_plain_chunks(self, bucket, key, oi, enc, offset: int,
                        length: int, stored=None, no_lock: bool = False):
    """The plain bytes [offset, offset + length) of version ``oi`` of a
    transformed object, one step at a time (never the whole object).
    An encrypted one (``enc``: its opened key) decrypts only the DARE
    packages that cover what it needs, read in one pass from one layer
    reader (``_SeqCipherReader``); a compressed one decodes its stream
    from the start and skips to ``offset``.  ``stored``: a reader of the
    whole stored object already open, used instead of a new one."""
    layer = self.srv.layer
    ud = oi.user_defined
    opts = ObjectOptions(version_id=oi.version_id or "", no_lock=no_lock)
    compressed = mtc.META_COMPRESSION in ud
    if enc is None:
        if stored is None:
            _, stored = layer.get_object_reader(bucket, key, 0, -1, opts)
        inner = stored
    else:
        lo, n = offset, length
        if compressed:
            lo, n = 0, csse.decrypted_size(ud, oi.size, oi.parts)
        inner = self._decrypted_chunks(bucket, key, oi, enc, opts, lo, n,
                                       stored)
    if not compressed:
        return inner
    return _slice_chunks(mtc.decompress_chunks(inner), offset, length)


def _decrypted_chunks(self, bucket, key, oi, enc, opts, offset: int,
                      length: int, stored=None):
    """Plain bytes [offset, offset + length) of an encrypted object's DARE
    streams, ``DECRYPT_BLOCK`` at a time."""
    ud = oi.user_defined
    layer = self.srv.layer
    if length <= 0:
        _close(stored)
        return iter(())
    c0, c1 = csse.cipher_range(ud, oi.size, offset, length, oi.parts)
    if stored is None:
        _, stored = layer.get_object_reader(bucket, key, c0, c1 - c0, opts)
    else:
        c0 = 0                          # the whole object's reader
    seq = _SeqCipherReader(stored, c0, lambda o, n: layer.get_object(
        bucket, key, o, n, ObjectOptions(version_id=opts.version_id))[1])

    def steps():
        try:
            off, end = offset, offset + length
            while off < end:
                n = min(DECRYPT_BLOCK - off % DECRYPT_BLOCK, end - off)
                yield csse.decrypt_object_range(enc, ud, oi.size, seq.read,
                                                off, n, oi.parts)
                off += n
        finally:
            seq.close()
    return _Closing(steps(), seq.close)


def _slice_chunks(chunks, offset: int, length: int):
    """The bytes [offset, offset + length) of a chunk stream."""
    def cut():
        pos, end = 0, offset + length
        for c in chunks:
            lo, hi = max(offset - pos, 0), min(end - pos, len(c))
            pos += len(c)
            if hi > lo:
                yield c[lo:hi]
            if pos >= end:
                return
    return _Closing(cut(), lambda: _close(chunks))


class _Closing:
    """An iterator whose ``close`` also closes what it reads from, even
    when it was never advanced (a generator's ``finally`` would not run
    then)."""

    def __init__(self, it, close):
        self._it = it
        self._close = close

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self) -> None:
        try:
            self._it.close()
        finally:
            self._close()


class _Reads:
    """What ``_fetch_plain_chunks`` needs of its handler, for a read on
    the server's own behalf (``read_version``)."""

    _decrypted_chunks = _decrypted_chunks

    def __init__(self, srv):
        self.srv = srv


def read_version(srv, bucket: str, key: str, version_id: str) -> tuple:
    """(info, the version's plain bytes, whole), decoded as a GET of it
    decodes them: the replication worker's read.  A version transitioned
    to a tier without a valid restored copy is InvalidObjectState and a
    delete marker MethodNotAllowed; an SSE-C version cannot be opened
    without the client's key (SSEEncryptedObject)."""
    oi, stored = srv.layer.get_object_reader(
        bucket, key, 0, -1, ObjectOptions(version_id=version_id))
    try:
        ud = oi.user_defined
        if oi.delete_marker:
            raise ol.MethodNotAllowed(f"{bucket}/{key} is a delete marker")
        if _stubbed(ud):
            raise S3Error("InvalidObjectState")
        if _transformed(ud):
            enc = csse.ObjectEncryption.open(ud, bucket, key, {}, srv.kms) \
                if csse.is_encrypted(ud) else None
            stored = _fetch_plain_chunks(_Reads(srv), bucket, key, oi, enc, 0,
                                         _actual_size(oi), stored=stored)
        return oi, b"".join(stored)
    finally:
        _close(stored)


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

    etag = _display_etag(oi)

    def etag_in(header: str) -> bool:
        tags = [t.strip().strip('"') for t in header.split(",")]
        return "*" in tags or etag in tags

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
            "_get_object", "_preconditions_304", "_storage_class_parity",
            "_bucket_sse_algo", "_sse_for_put", "_compression_eligible",
            "_compress_for_put",
            "_transform_for_put", "_encrypt_part", "_fetch_plain_chunks",
            "_decrypted_chunks", "_restore_object", "_tiered_meta_of",
            "_overwritten_tier_copy", "_free_tier_copy", "_select_object"]
