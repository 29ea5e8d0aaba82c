"""S3 bucket handlers (``minio_tpu/s3/handlers_bucket.py``,
cmd/bucket-handlers.go): ListBuckets, PUT/HEAD/DELETE bucket (a bucket
created with ``x-amz-bucket-object-lock-enabled: true`` is versioned and
lock-enabled), GET ``?location``, PUT and GET ``?versioning`` (a lock
bucket cannot be suspended), PUT, GET and DELETE ``?policy`` (the bucket
policy, ``bucket/policy.py``), ``?lifecycle`` (``bucket/lifecycle.py``),
``?tagging`` (``bucket/tags.py``), ``?encryption`` (the bucket's default
encryption, ``bucket/encryption.py``) and ``?replication``
(``bucket/replication.py``: a bucket without versioning refuses it,
and once the server replicates each rule's destination ARN must name a
registered remote target), PUT and GET ``?object-lock``
(``bucket/objectlock.py``: the default retention of a lock bucket),
``?quota`` (``bucket/quota.py``) and ``?notification``
(``bucket/notification.py``: each ARN must name a registered target, an
empty document removes the stored one), ``?acl`` (the canned private
ACL only), ``?cors`` and the dummy ``?accelerate``,
``?requestPayment``, ``?logging`` and ``?website`` (fixed answers,
cmd/dummy-handlers.go), ListenNotification (GET ``?events``), ListObjects
V1 and V2, ListObjectVersions (``?versions``), ListMultipartUploads
(``?uploads``), DeleteObjects, with version ids and each locked version
refused, and the browser POST-policy upload.  A listing gives each
object's plain size (``_actual_size``) and its storage class
(``x-amz-storage-class``, STANDARD when it has none; the reference's
ListObjectVersions says STANDARD for every version).  Each authorises
the reference's S3 action on the bucket (on ``bucket/key`` for a key)
before it touches the layer.  ``_make_handler`` (server.py) attaches
them to the request handler; ``self`` is the handler and ``self.srv``
its server.
"""

from __future__ import annotations

import json
import urllib.parse
import xml.etree.ElementTree as ET

from ..bucket import notification
from ..bucket import replication
from ..bucket import tags as btags
from ..bucket.encryption import SSEConfig
from ..bucket.lifecycle import Lifecycle
from ..bucket.objectlock import LockConfig
from ..bucket.policy import BucketPolicy
from ..bucket.quota import Quota
from ..crypto import sse as csse
from ..iam import policy as iampol
from ..objectlayer import interface as ol
from ..objectlayer import metacache
from ..objectlayer.interface import PutObjectOptions
from ..utils.fed_dns import BucketTaken
from . import errors as s3err
from . import postpolicy, sigv4
from .server import (MAX_PUT_SIZE, S3_NS, S3Error, _actual_size,
                     _canned_acl_xml, _iso_date, _try, _xml)

# the dummy subresources (cmd/dummy-handlers.go) and their GET answers;
# ``website`` has none (NoSuchWebsiteConfiguration)
DUMMY = {
    "accelerate": (
        b'<?xml version="1.0" encoding="UTF-8"?>'
        b'<AccelerateConfiguration xmlns="http://s3.amazonaws'
        b'.com/doc/2006-03-01/"/>'),
    "requestPayment": (
        b'<?xml version="1.0" encoding="UTF-8"?>'
        b'<RequestPaymentConfiguration xmlns="http://s3.'
        b'amazonaws.com/doc/2006-03-01/"><Payer>BucketOwner'
        b'</Payer></RequestPaymentConfiguration>'),
    "logging": (
        b'<?xml version="1.0" encoding="UTF-8"?>'
        b'<BucketLoggingStatus xmlns="http://s3.amazonaws.com'
        b'/doc/2006-03-01/"></BucketLoggingStatus>'),
    "website": None,
}


def _list_buckets(self):
    if self.command != "GET":
        raise S3Error("MethodNotAllowed")
    self._allow(iampol.LIST_ALL_MY_BUCKETS)
    root = ET.Element("ListAllMyBucketsResult", xmlns=S3_NS)
    owner = ET.SubElement(root, "Owner")
    ET.SubElement(owner, "ID").text = "minio-tpu"
    ET.SubElement(owner, "DisplayName").text = "minio-tpu"
    buckets = ET.SubElement(root, "Buckets")
    for b in self.srv.layer.list_buckets():
        be = ET.SubElement(buckets, "Bucket")
        ET.SubElement(be, "Name").text = b.name
        ET.SubElement(be, "CreationDate").text = _iso_date(b.created)
    self._send(200, _xml(root))


def _bucket_api(self, bucket, query, payload):
    cmd = self.command
    for name in DUMMY:
        if name in query:
            return self._bucket_dummy(bucket, name)
    for name in CONFIGS:
        if name in query:
            return self._bucket_config(bucket, name, payload)
    if "notification" in query:
        return self._bucket_notification(bucket, payload)
    if "object-lock" in query:
        return self._bucket_object_lock(bucket, payload)
    if "quota" in query:
        return self._bucket_quota(bucket, payload)
    if "acl" in query:
        return self._bucket_acl(bucket, payload)
    if "cors" in query:
        self._allow(iampol.GET_BUCKET_LOCATION, bucket)
        self.srv.layer.get_bucket_info(bucket)
        raise S3Error("NoSuchCORSConfiguration" if cmd == "GET"
                      else "NotImplemented")
    if "versioning" in query:
        if cmd == "PUT":
            self._allow(iampol.PUT_BUCKET_VERSIONING, bucket)
            return self._put_versioning(bucket, payload)
        if cmd == "GET":
            self._allow(iampol.GET_BUCKET_VERSIONING, bucket)
            return self._get_versioning(bucket)
        raise S3Error("NotImplemented")
    if cmd == "GET" and "location" in query:
        self._allow(iampol.GET_BUCKET_LOCATION, bucket)
        root = ET.Element("LocationConstraint", xmlns=S3_NS)
        # us-east-1 is the empty constraint on the wire
        root.text = "" if self.srv.region == "us-east-1" \
            else self.srv.region
        self.srv.layer.get_bucket_info(bucket)
        return self._send(200, _xml(root))
    if cmd == "GET" and "versions" in query:
        self._allow(iampol.LIST_BUCKET_VERSIONS, bucket)
        return self._list_object_versions(bucket, query)
    if cmd == "GET" and "events" in query:
        self._allow(iampol.LISTEN_NOTIFICATION, bucket)
        return self._listen_notification(bucket, query)
    if cmd == "POST" and "delete" in query:
        return self._delete_objects(bucket, payload)
    if cmd == "POST" and (self.headers.get("Content-Type") or ""
                          ).startswith("multipart/form-data"):
        return self._post_policy_upload(bucket, payload)
    if cmd == "GET" and "uploads" in query:
        self._allow(iampol.LIST_MULTIPART_UPLOADS, bucket)
        return self._list_uploads(bucket, query)
    if cmd == "POST":
        raise S3Error("NotImplemented")
    if cmd == "PUT":
        self._allow(iampol.CREATE_BUCKET, bucket)
        fed = self.srv.federation
        fresh = False
        if fed is not None:
            try:
                fresh = fed.register(bucket)
            except BucketTaken:
                raise S3Error("BucketAlreadyExists") from None
        try:
            self.srv.layer.make_bucket(bucket)
        except Exception:
            if fresh:                   # only a record made just now
                fed.unregister(bucket)
            raise
        if self.headers.get("x-amz-bucket-object-lock-enabled",
                            "").lower() == "true":
            # a lock bucket is versioned (PutBucketHandler)
            self.srv.bucket_meta.set_versioning(bucket, True)
            self.srv.bucket_meta.set_config(
                bucket, "object-lock",
                LockConfig(enabled=True).to_xml().decode())
        return self._send(200, headers={"Location": f"/{bucket}"})
    if cmd == "HEAD":
        self._allow(iampol.LIST_BUCKET, bucket)
        self.srv.layer.get_bucket_info(bucket)
        return self._send(200)
    if cmd == "DELETE":
        self._allow(iampol.DELETE_BUCKET, bucket)
        self.srv.layer.delete_bucket(bucket)
        self.srv.bucket_meta.drop(bucket)
        if self.srv.federation is not None:
            self.srv.federation.unregister(bucket)
        return self._send(204)
    if cmd == "GET":
        self._allow(iampol.LIST_BUCKET, bucket)
        return self._list_objects(bucket, query)
    raise S3Error("MethodNotAllowed")


# the configs served as whole documents: (GET action, PUT and DELETE
# action, parse of a PUT body into the stored text, the code of a body
# that does not parse, the code of a GET without one, content type)
CONFIGS = {
    "policy": (iampol.GET_BUCKET_POLICY, iampol.PUT_BUCKET_POLICY,
               lambda body, b: BucketPolicy.parse(body, b).to_json(),
               "MalformedPolicy", "NoSuchBucketPolicy", "application/json"),
    "lifecycle": (iampol.GET_LIFECYCLE, iampol.PUT_LIFECYCLE,
                  lambda body, b: Lifecycle.parse(body).to_xml(),
                  "MalformedXML", "NoSuchLifecycleConfiguration",
                  "application/xml"),
    "tagging": (iampol.GET_BUCKET_TAGGING, iampol.PUT_BUCKET_TAGGING,
                lambda body, b: btags.to_xml(btags.parse_xml(
                    body, is_object=False)),
                "MalformedXML", "NoSuchTagSet", "application/xml"),
    "encryption": (iampol.GET_BUCKET_ENCRYPTION, iampol.PUT_BUCKET_ENCRYPTION,
                   lambda body, b: SSEConfig.parse(body).to_xml(),
                   "MalformedXML",
                   "ServerSideEncryptionConfigurationNotFoundError",
                   "application/xml"),
    "replication": (iampol.GET_REPLICATION, iampol.PUT_REPLICATION,
                    lambda body, b: replication.Config.parse(body).to_xml(),
                    "MalformedXML", "ReplicationConfigurationNotFoundError",
                    "application/xml"),
}


def _bucket_config(self, bucket, name, payload):
    """PUT, GET and DELETE ``?policy`` (cmd/bucket-policy-handlers.go),
    ``?lifecycle`` (cmd/bucket-lifecycle-handlers.go), ``?tagging``
    (cmd/bucket-handlers.go PutBucketTaggingHandler), ``?encryption``
    (cmd/bucket-encryption-handlers.go) and ``?replication``
    (cmd/bucket-replication-handlers.go; InvalidRequest on a bucket
    without versioning): authorised before the bucket's existence is
    checked, so a caller cannot tell a missing bucket from a refused
    one.  The stored document is the parsed one written back.  Once the
    server replicates (``srv.replication``), a replication rule whose
    destination ARN names no registered target is refused
    (ReplicationDestinationNotFoundError)."""
    get_act, put_act, parse, bad, missing, ctype = CONFIGS[name]
    cmd = self.command
    if cmd not in ("PUT", "GET", "DELETE"):
        raise S3Error("MethodNotAllowed")
    self._allow(get_act if cmd == "GET" else put_act, bucket)
    self.srv.layer.get_bucket_info(bucket)
    if cmd == "PUT":
        try:
            doc = parse(payload, bucket).decode()
        except (ValueError, KeyError) as e:
            raise S3Error(getattr(e, "code", bad)) from e
        if name == "replication":
            if not self.srv.bucket_meta.versioning_enabled(bucket):
                raise S3Error("InvalidRequest")
            repl = self.srv.replication
            if repl is not None and not all(
                    repl.arn_exists(r.destination_arn)
                    for r in replication.Config.parse(payload).rules):
                raise S3Error("ReplicationDestinationNotFoundError")
        self.srv.bucket_meta.set_config(bucket, name, doc)
        return self._send(200)
    if cmd == "GET":
        raw = self.srv.bucket_meta.get_config(bucket, name)
        if raw is None:
            raise S3Error(missing)
        return self._send(200, raw.encode(), content_type=ctype)
    self.srv.bucket_meta.set_config(bucket, name, None)
    return self._send(204)


def _bucket_notification(self, bucket, payload):
    """PUT and GET ``?notification`` (cmd/bucket-notification-handlers.go):
    a PUT naming an ARN that no registered target has is refused; one
    without a configuration removes the stored one; a GET without one
    answers the empty document."""
    cmd = self.command
    if cmd == "PUT":
        self._allow(iampol.PUT_BUCKET_NOTIFICATION, bucket)
        self.srv.layer.get_bucket_info(bucket)
        cfg = _try(lambda: notification.Config.parse(
            payload, valid_arns=self.srv.events.valid_arns()))
        self.srv.bucket_meta.set_config(
            bucket, "notification",
            cfg.to_xml().decode() if cfg.targets else None)
        return self._send(200)
    if cmd == "GET":
        self._allow(iampol.GET_BUCKET_NOTIFICATION, bucket)
        self.srv.layer.get_bucket_info(bucket)
        raw = self.srv.bucket_meta.get_config(bucket, "notification") \
            or notification.Config().to_xml().decode()
        return self._send(200, raw.encode())
    raise S3Error("MethodNotAllowed")


def _bucket_acl(self, bucket, payload):
    """GET ``?acl`` answers the canned private ACL; PUT takes only
    ``private`` or a FULL_CONTROL body (anything else NotImplemented)."""
    cmd = self.command
    if cmd == "GET":
        self._allow(iampol.GET_BUCKET_ACL, bucket)
        self.srv.layer.get_bucket_info(bucket)
        return self._send(200, _canned_acl_xml())
    if cmd == "PUT":
        self._allow(iampol.PUT_BUCKET_ACL, bucket)
        self.srv.layer.get_bucket_info(bucket)
        if self.headers.get("x-amz-acl", "private") != "private" or (
                payload and b"FULL_CONTROL" not in payload):
            raise S3Error("NotImplemented")
        return self._send(200)
    raise S3Error("MethodNotAllowed")


def _bucket_dummy(self, bucket, name):
    """The dummy subresources (cmd/dummy-handlers.go), authorised as
    GetBucketPolicy: GET answers the fixed default, DELETE ``?website``
    succeeds, anything else is NotImplemented."""
    self._allow(iampol.GET_BUCKET_POLICY, bucket)
    self.srv.layer.get_bucket_info(bucket)
    if name == "website" and self.command == "DELETE":
        return self._send(204)
    if self.command != "GET":
        raise S3Error("NotImplemented")
    if DUMMY[name] is None:
        raise S3Error("NoSuchWebsiteConfiguration")
    return self._send(200, DUMMY[name])


def _listen_notification(self, bucket, query):
    """ListenNotification (cmd/listen-notification-handlers.go): one
    chunk of newline-ended ``{"Records": [...]}`` per event of the bucket
    that matches ``prefix``, ``suffix`` and an ``events`` glob, until
    ``max-events`` (1,000) or ``timeout`` seconds (10, at most 300) or
    the server stops.  The subscription is in place when the status line
    is sent; a listener holds its request slot while it streams."""
    self.srv.layer.get_bucket_info(bucket)
    q1 = {k: v[0] for k, v in query.items()}
    prefix = q1.get("prefix", "")
    suffix = q1.get("suffix", "")
    names = query.get("events", []) or ["*"]
    try:
        timeout = min(float(q1.get("timeout", 10) or 10), 300.0)
        max_events = int(q1.get("max-events", 1000) or 1000)
    except ValueError as e:
        raise S3Error("InvalidArgument") from e

    def want(item) -> bool:
        key = item["key"]
        return item["bucket"] == bucket and key.startswith(prefix) and \
            key.endswith(suffix) and any(
                n == "*" or notification.match_pattern(n, item["name"])
                for n in names)

    sub = self.srv.events.pubsub.subscribe(want)
    try:
        self._send_chunked(200, (
            json.dumps({"Records": [item["record"]]}).encode() + b"\n"
            for item in sub.drain(max_events, timeout)), "application/json")
    finally:
        sub.close()


def _bucket_object_lock(self, bucket, payload):
    """PUT and GET ``?object-lock`` (cmd/bucket-object-lock.go): the
    default retention of a bucket created lock-enabled; a bucket created
    without is refused (InvalidBucketObjectLockConfiguration), as S3
    allows object lock only at creation."""
    cmd = self.command
    if cmd == "PUT":
        self._allow(iampol.PUT_BUCKET_OBJECT_LOCK, bucket)
        self.srv.layer.get_bucket_info(bucket)
        cfg = _try(lambda: LockConfig.parse(payload))
        if self.srv.bucket_meta.get_config(bucket, "object-lock") is None:
            raise S3Error("InvalidBucketObjectLockConfiguration")
        self.srv.bucket_meta.set_config(bucket, "object-lock",
                                        cfg.to_xml().decode())
        return self._send(200)
    if cmd == "GET":
        self._allow(iampol.GET_BUCKET_OBJECT_LOCK, bucket)
        self.srv.layer.get_bucket_info(bucket)
        raw = self.srv.bucket_meta.get_config(bucket, "object-lock")
        if raw is None:
            raise S3Error("ObjectLockConfigurationNotFoundError")
        return self._send(200, raw.encode())
    raise S3Error("MethodNotAllowed")


def _bucket_quota(self, bucket, payload):
    """PUT and GET ``?quota``, for identities allowed ``admin:*`` (the
    admin routes set it too)."""
    cmd = self.command
    if cmd == "PUT":
        self._allow(iampol.ADMIN_ALL, bucket)
        self.srv.layer.get_bucket_info(bucket)
        try:
            q = Quota.parse(payload)
        except ValueError as e:
            raise S3Error(getattr(e, "code", "MalformedXML")) from e
        self.srv.bucket_meta.set_config(bucket, "quota",
                                        q.to_json().decode())
        return self._send(200)
    if cmd == "GET":
        self._allow(iampol.ADMIN_ALL, bucket)
        self.srv.layer.get_bucket_info(bucket)
        raw = self.srv.bucket_meta.get_config(bucket, "quota") \
            or '{"quota": 0, "quotatype": "hard"}'
        return self._send(200, raw.encode(), content_type="application/json")
    raise S3Error("MethodNotAllowed")


def _post_policy_upload(self, bucket, payload):
    """Browser POST upload (PostPolicyBucketHandler): the form's policy
    signature authenticates, its conditions are checked against the
    fields and the file's size, ``s3:PutObject`` is authorised, then the
    file field is stored as the object.  ``success_action_redirect``
    answers 303, ``success_action_status`` 200 or 201 (with a
    PostResponse), else 204."""
    try:
        fields, file_data, filename = postpolicy.parse_form(
            payload, self.headers.get("Content-Type", ""))
        key = fields.get("key", "")
        if not key:
            raise S3Error("InvalidArgument")
        key = key.replace("${filename}", filename)
        self.access_key = postpolicy.verify_signature(
            self.srv.iam.lookup_secret, fields, self.srv.region)
        postpolicy.check_policy(fields.get("policy", ""),
                                {**fields, "key": key, "bucket": bucket},
                                len(file_data))
    except sigv4.SigV4Error as e:
        raise S3Error(e.code if s3err.has(e.code)
                      else "AccessDenied") from e
    self._allow(iampol.PUT_OBJECT, f"{bucket}/{key}")
    if len(file_data) > MAX_PUT_SIZE:
        raise S3Error("EntityTooLarge")
    user_defined = {}
    if fields.get("content-type"):
        user_defined["content-type"] = fields["content-type"]
    for k, v in fields.items():
        if k.startswith("x-amz-meta-"):
            user_defined[k] = v
    if fields.get("tagging"):
        # the form's Tagging document, stored as the header form
        try:
            user_defined[btags.TAG_KEY] = btags.to_header(
                btags.parse_xml(fields["tagging"].encode()))
        except btags.TagError as e:
            raise S3Error("InvalidTag") from e
    user_defined.update(self._lock_headers(bucket, key))
    self._check_quota(bucket, len(file_data))
    versioned = self.srv.bucket_meta.versioning_enabled(bucket)
    tiered = self._overwritten_tier_copy(bucket, key, versioned)
    file_data = self._transform_for_put(bucket, key, user_defined, file_data)
    oi = self.srv.layer.put_object(
        bucket, key, file_data, PutObjectOptions(
            user_defined=user_defined, versioned=versioned,
            parity=self._storage_class_parity(user_defined)))
    self._free_tier_copy(tiered)
    self._charge_quota_usage(bucket, oi.size)
    self.srv.notify("s3:ObjectCreated:Post", bucket, oi)
    self.srv.replicate(bucket, oi)
    hdrs = {"ETag": f'"{oi.etag}"', **csse.response_headers(user_defined)}
    if oi.version_id:
        hdrs["x-amz-version-id"] = oi.version_id
    hdrs["Location"] = f"/{bucket}/{urllib.parse.quote(key)}"
    redirect = fields.get("success_action_redirect", "")
    if redirect:
        sep = "&" if "?" in redirect else "?"
        hdrs["Location"] = redirect + sep + urllib.parse.urlencode(
            {"bucket": bucket, "key": key, "etag": f'"{oi.etag}"'})
        return self._send(303, headers=hdrs)
    status = fields.get("success_action_status", "204")
    if status == "201":
        root = ET.Element("PostResponse")
        ET.SubElement(root, "Location").text = hdrs["Location"]
        ET.SubElement(root, "Bucket").text = bucket
        ET.SubElement(root, "Key").text = key
        ET.SubElement(root, "ETag").text = hdrs["ETag"]
        return self._send(201, _xml(root), headers=hdrs)
    return self._send(200 if status == "200" else 204, headers=hdrs)


def _put_versioning(self, bucket, payload):
    """PutBucketVersioning: Enabled, or Suspended (any other status)."""
    self.srv.layer.get_bucket_info(bucket)
    try:
        root = ET.fromstring(payload)
        status = root.findtext(f"{{{S3_NS}}}Status") or \
            root.findtext("Status") or ""
    except ET.ParseError as e:
        raise S3Error("MalformedXML") from e
    if status != "Enabled" and \
            self.srv.bucket_meta.get_config(bucket, "object-lock") \
            is not None:
        raise S3Error("InvalidBucketState")     # a lock bucket stays versioned
    self.srv.bucket_meta.set_versioning(bucket, status == "Enabled")
    self._send(200)


def _get_versioning(self, bucket):
    """GetBucketVersioning: the stored status, none when never set."""
    self.srv.layer.get_bucket_info(bucket)
    root = ET.Element("VersioningConfiguration", xmlns=S3_NS)
    doc = self.srv.bucket_meta.get(bucket).get("versioning")
    if doc:
        ET.SubElement(root, "Status").text = doc["status"]
    self._send(200, _xml(root))


def _list_object_versions(self, bucket, query):
    """ListObjectVersions: every version, newest first within a key.
    ``key-marker``, ``version-id-marker`` and ``max-keys`` page it; the
    markers appear in the answer only when the client sent them or the
    page is truncated."""
    q1 = {k: v[0] for k, v in query.items()}
    prefix = q1.get("prefix", "")
    esc, enc = self._encoding_type(q1)
    try:
        max_keys = min(int(q1.get("max-keys", 1000) or 1000), 1000)
    except ValueError as e:
        raise S3Error("InvalidArgument") from e
    key_marker = q1.get("key-marker", "")
    vid_marker = q1.get("version-id-marker", "")
    res = self.srv.layer.list_object_versions(bucket, prefix, key_marker,
                                              vid_marker, max_keys)
    root = ET.Element("ListVersionsResult", xmlns=S3_NS)
    ET.SubElement(root, "Name").text = bucket
    ET.SubElement(root, "Prefix").text = esc(prefix)
    if key_marker:
        ET.SubElement(root, "KeyMarker").text = esc(key_marker)
    if vid_marker:
        ET.SubElement(root, "VersionIdMarker").text = vid_marker
    if enc:
        ET.SubElement(root, "EncodingType").text = "url"
    ET.SubElement(root, "IsTruncated").text = \
        "true" if res.is_truncated else "false"
    if res.is_truncated:
        ET.SubElement(root, "NextKeyMarker").text = esc(res.next_key_marker)
        ET.SubElement(root, "NextVersionIdMarker").text = \
            res.next_version_id_marker
    for o in res.objects:
        v = ET.SubElement(root, "DeleteMarker" if o.delete_marker
                          else "Version")
        ET.SubElement(v, "Key").text = esc(o.name)
        ET.SubElement(v, "VersionId").text = o.version_id or "null"
        ET.SubElement(v, "IsLatest").text = \
            "true" if o.is_latest else "false"
        ET.SubElement(v, "LastModified").text = _iso_date(o.mod_time)
        if not o.delete_marker:
            ET.SubElement(v, "ETag").text = f'"{o.etag}"'
            ET.SubElement(v, "Size").text = str(_actual_size(o))
            ET.SubElement(v, "StorageClass").text = "STANDARD"
    self._send(200, _xml(root))


def _list_uploads(self, bucket, query):
    """ListMultipartUploads: every upload in progress, by key."""
    q1 = {k: v[0] for k, v in query.items()}
    esc, enc = self._encoding_type(q1)
    uploads = self.srv.layer.list_multipart_uploads(bucket,
                                                    q1.get("prefix", ""))
    root = ET.Element("ListMultipartUploadsResult", xmlns=S3_NS)
    ET.SubElement(root, "Bucket").text = bucket
    if enc:
        ET.SubElement(root, "EncodingType").text = "url"
    ET.SubElement(root, "IsTruncated").text = "false"
    for u in uploads:
        ue = ET.SubElement(root, "Upload")
        ET.SubElement(ue, "Key").text = esc(u.object_name)
        ET.SubElement(ue, "UploadId").text = u.upload_id
    self._send(200, _xml(root))


def _encoding_type(self, q1):
    """``encoding-type``: (escape, enabled).  Keys may hold characters XML
    1.0 cannot carry; ``url`` (the awscli and boto3 default)
    percent-encodes them in the response."""
    enc = q1.get("encoding-type", "")
    if enc and enc != "url":
        raise S3Error("InvalidArgument")
    if enc:
        return (lambda s: urllib.parse.quote(s or "", safe="/")), True
    return (lambda s: s), False


def _list_objects(self, bucket, query):
    q1 = {k: v[0] for k, v in query.items()}
    v2 = q1.get("list-type") == "2"
    prefix = q1.get("prefix", "")
    delimiter = q1.get("delimiter", "")
    max_keys = min(int(q1.get("max-keys", 1000) or 1000), 1000)
    if v2 and q1.get("continuation-token"):
        try:
            marker = metacache.decode_list_token(q1["continuation-token"])
        except ValueError as e:
            raise S3Error("InvalidArgument") from e
    else:
        marker = q1.get("marker", "") if not v2 else ""
        marker = marker or q1.get("start-after", "")
    esc, enc = self._encoding_type(q1)
    res = self.srv.layer.list_objects(bucket, prefix, marker, delimiter,
                                      max_keys)
    root = ET.Element("ListBucketResult", xmlns=S3_NS)
    ET.SubElement(root, "Name").text = bucket
    ET.SubElement(root, "Prefix").text = esc(prefix)
    if delimiter:
        ET.SubElement(root, "Delimiter").text = esc(delimiter)
    if enc:
        ET.SubElement(root, "EncodingType").text = "url"
    ET.SubElement(root, "MaxKeys").text = str(max_keys)
    ET.SubElement(root, "IsTruncated").text = \
        "true" if res.is_truncated else "false"
    if v2:
        ET.SubElement(root, "KeyCount").text = \
            str(len(res.objects) + len(res.prefixes))
        if q1.get("continuation-token"):
            # opaque to clients and echoed verbatim, never url-encoded
            ET.SubElement(root, "ContinuationToken").text = \
                q1["continuation-token"]
        if q1.get("start-after"):
            ET.SubElement(root, "StartAfter").text = esc(q1["start-after"])
        if res.is_truncated:
            ET.SubElement(root, "NextContinuationToken").text = \
                metacache.encode_list_token(res.next_marker)
    else:
        ET.SubElement(root, "Marker").text = esc(marker)
        if res.is_truncated:
            ET.SubElement(root, "NextMarker").text = esc(res.next_marker)
    fetch_owner = (not v2) or q1.get("fetch-owner") == "true"
    for o in res.objects:
        c = ET.SubElement(root, "Contents")
        ET.SubElement(c, "Key").text = esc(o.name)
        ET.SubElement(c, "LastModified").text = _iso_date(o.mod_time)
        ET.SubElement(c, "ETag").text = f'"{o.etag}"'
        ET.SubElement(c, "Size").text = str(_actual_size(o))
        ET.SubElement(c, "StorageClass").text = o.user_defined.get(
            "x-amz-storage-class", "STANDARD")
        if fetch_owner:
            owner = ET.SubElement(c, "Owner")
            ET.SubElement(owner, "ID").text = "minio-tpu"
            ET.SubElement(owner, "DisplayName").text = "minio-tpu"
    for p in res.prefixes:
        cp = ET.SubElement(root, "CommonPrefixes")
        ET.SubElement(cp, "Prefix").text = esc(p)
    self._send(200, _xml(root))


def _delete_objects(self, bucket, payload):
    """Multi-object delete (cmd/bucket-handlers.go:604): one Deleted or
    Error element per key, 200 whatever each key's fate.  An entry with
    a VersionId deletes that version (ObjectLocked when its lock says
    no); one without, in a versioned bucket, adds a delete marker.  A
    removed version's tier copy is freed after its delete."""
    try:
        root = ET.fromstring(payload)
    except ET.ParseError as e:
        raise S3Error("MalformedXML") from e
    ns = f"{{{S3_NS}}}"
    quiet = (root.findtext(f"{ns}Quiet") or
             root.findtext("Quiet") or "") == "true"
    out = ET.Element("DeleteResult", xmlns=S3_NS)
    versioned = self.srv.bucket_meta.versioning_enabled(bucket)
    for obj in root.findall(f"{ns}Object") + root.findall("Object"):
        key = obj.findtext(f"{ns}Key") or obj.findtext("Key")
        vid = obj.findtext(f"{ns}VersionId") or obj.findtext("VersionId")
        try:
            self._allow(iampol.DELETE_OBJECT, f"{bucket}/{key}")
            tiered = self._tiered_meta_of(bucket, key, vid, versioned)
            res = self.srv.layer.delete_object(
                bucket, key, self._delete_opts(bucket, key, vid, versioned))
            self._free_tier_copy(tiered)
            if not quiet:
                d = ET.SubElement(out, "Deleted")
                ET.SubElement(d, "Key").text = key
                if res.delete_marker:
                    ET.SubElement(d, "DeleteMarker").text = "true"
                    ET.SubElement(d, "DeleteMarkerVersionId").text = \
                        res.version_id
        except Exception as e:  # noqa: BLE001 — reported per key
            if isinstance(e, S3Error):
                api = e.api
            elif isinstance(e, ol.ObjectLayerError):
                api = s3err.from_object_error(e)
            else:
                api = s3err.get("InternalError")
            err = ET.SubElement(out, "Error")
            ET.SubElement(err, "Key").text = key
            ET.SubElement(err, "Code").text = api.code
            ET.SubElement(err, "Message").text = api.description
    self._send(200, _xml(out))


# the methods _make_handler attaches to the request handler
HANDLERS = ["_list_buckets", "_bucket_api", "_bucket_config",
            "_bucket_notification", "_bucket_acl", "_bucket_dummy",
            "_listen_notification", "_bucket_object_lock", "_bucket_quota",
            "_post_policy_upload", "_put_versioning",
            "_get_versioning", "_list_object_versions", "_list_uploads",
            "_encoding_type", "_list_objects", "_delete_objects"]
