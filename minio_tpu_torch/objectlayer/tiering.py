"""Transitions to a remote tier and their restore
(``minio_tpu/objectlayer/tiering.py``; cmd/bucket-lifecycle.go:315
transitionObject, cmd/object-handlers.go PostRestoreObjectHandler).

A transition reads a version's stored bytes through the object layer
(Kernel B verifies every block, Kernel A rebuilds a lost shard), puts
them to the tier *verbatim* under a fresh key, and rewrites the version
in place as an empty stub whose metadata names the tier, the key, and
the original's client size and ETag: an SSE object's tier copy is
ciphertext, a compressed one's the compressed stream, and their markers
stay on the stub.  GET of a stub answers InvalidObjectState and HEAD the
archived identity with ``x-amz-storage-class``.  A restore fetches the
tier copy and writes it back under the stub's metadata, with the
original mod time (version order follows mod times) and a restore
expiry; the stored bytes are then the original's, so the usual decode
applies.  Deleting or overwriting a transitioned version frees its tier
copy (``delete_tiered``).

The tiers are a local directory (``DirTier``) or a bucket of an S3
server (``S3Tier``, through the port's own client).  ``TransitionSys``
holds them by name and persists them as ``tiers/tiers.json`` in the
system volume, in the reference's format, so either package reads the
other's tiers.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional

from .. import compress as mtc
from ..crypto import sse as csse
from ..storage.datatypes import now_ns
from .interface import (ObjectLayerError, ObjectOptions, PreconditionFailed,
                        PutObjectOptions)

# the stub's markers (x-minio-internal-transition* in the reference)
META_STATUS = "x-minio-internal-transition-status"      # "complete"
META_TIER = "x-minio-internal-transition-tier"          # the tier's name
META_KEY = "x-minio-internal-transitioned-object"       # key in the tier
META_SIZE = "x-minio-internal-transition-size"          # the original's
META_ETAG = "x-minio-internal-transition-etag"          # the original's
META_RESTORE_EXPIRY = "x-minio-internal-restore-expiry"  # unix seconds

RESTORE_HDR = "x-amz-restore"
STORAGE_CLASS_HDR = "x-amz-storage-class"
# where the tier registry lives in the system volume
TIERS_PATH = "tiers/tiers.json"


class TierError(ObjectLayerError):
    pass


class Tier:
    """A remote tier: put, get and remove whole objects by key."""

    name = ""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def remove(self, key: str) -> None:
        raise NotImplementedError


class DirTier(Tier):
    """A local directory (the NAS-style tier); a key's "/" become "_"."""

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.path, key.replace("/", "_"))

    def put(self, key: str, data: bytes) -> None:
        tmp = self._p(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._p(key))

    def get(self, key: str) -> bytes:
        try:
            with open(self._p(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise TierError(f"tier object {key} missing") from None

    def remove(self, key: str) -> None:
        try:
            os.remove(self._p(key))
        except FileNotFoundError:
            pass


class S3Tier(Tier):
    """A bucket of an S3 server, under ``prefix``."""

    def __init__(self, name: str, endpoint: str, bucket: str,
                 access_key: str, secret_key: str, prefix: str = "",
                 region: str = "us-east-1"):
        from ..s3.client import S3Client
        self.name = name
        self.client = S3Client(endpoint, access_key, secret_key, region)
        self.bucket = bucket
        self.prefix = prefix

    def _k(self, key: str) -> str:
        return f"{self.prefix}{key}"

    def put(self, key: str, data: bytes) -> None:
        self.client.put_object(self.bucket, self._k(key), data)

    def get(self, key: str) -> bytes:
        from ..s3.client import S3ClientError
        try:
            return self.client.get_object(self.bucket, self._k(key)).body
        except S3ClientError as e:
            raise TierError(f"tier fetch failed: {e}") from e

    def remove(self, key: str) -> None:
        from ..s3.client import S3ClientError
        try:
            self.client.delete_object(self.bucket, self._k(key))
        except S3ClientError:
            pass


# -- the stub's state ---------------------------------------------------------

def _client_size(info) -> int:
    """The size a client sees of a stored version: a compressed one's
    plain size, an encrypted one's decrypted size (what HEAD answers
    before the transition and after the restore)."""
    ud = info.user_defined
    if mtc.META_COMPRESSION in ud and csse.META_ACTUAL_SIZE in ud:
        return int(ud[csse.META_ACTUAL_SIZE])
    if csse.is_encrypted(ud):
        return csse.decrypted_size(ud, info.size, info.parts)
    return info.size


def is_transitioned(user_defined: dict) -> bool:
    return user_defined.get(META_STATUS) == "complete"


def restore_expiry(user_defined: dict) -> int:
    try:
        return int(user_defined.get(META_RESTORE_EXPIRY, "0"))
    except ValueError:
        return 0


def restore_valid(user_defined: dict) -> bool:
    return restore_expiry(user_defined) > time.time()


def restore_lapsed(user_defined: dict) -> bool:
    """A transitioned version restored here whose restore has run out:
    its stub is due back."""
    return is_transitioned(user_defined) and bool(
        restore_expiry(user_defined)) and not restore_valid(user_defined)


def restore_header(user_defined: dict) -> str:
    """The ``x-amz-restore`` value of a stub's HEAD and GET."""
    exp = restore_expiry(user_defined)
    if not exp:
        return ""
    if exp > time.time():
        date = time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(exp))
        return f'ongoing-request="false", expiry-date="{date}"'
    return ""


class TransitionSys:
    """The tiers of a server and the transitions and restores over its
    object layer (globalTransitionState)."""

    def __init__(self, layer):
        self.layer = layer
        self.tiers: dict[str, Tier] = {}

    def add_tier(self, tier: Tier) -> None:
        self.tiers[tier.name] = tier

    def tier_of(self, user_defined: dict) -> Optional[Tier]:
        return self.tiers.get(user_defined.get(META_TIER, ""))

    def transition(self, bucket: str, oi) -> None:
        """Move version ``oi``'s stored bytes to its tier
        (``oi.transition_tier``, else its storage class) and leave a
        stub in its place: the same version id, so a noncurrent
        version's transition never touches the latest.  A stub is left
        as it is.  The stub replaces only the version that was read: a
        write or a delete that lands while the bytes go to the tier
        stands, and the tier copy is removed."""
        tier_name = getattr(oi, "transition_tier", "") or \
            oi.user_defined.get(STORAGE_CLASS_HDR, "")
        tier = self.tiers.get(tier_name)
        if tier is None:
            raise TierError(f"no tier named {tier_name!r}")
        if is_transitioned(oi.user_defined):
            return
        vid = getattr(oi, "version_id", "") or ""
        info, data = self.layer.get_object(
            bucket, oi.name, 0, -1, ObjectOptions(version_id=vid or None))
        remote_key = f"{bucket}/{oi.name}/{vid or 'null'}/" \
                     f"{uuid.uuid4().hex}"
        tier.put(remote_key, data)
        ud = dict(info.user_defined)
        ud.update({
            META_STATUS: "complete",
            META_TIER: tier.name,
            META_KEY: remote_key,
            META_SIZE: str(_client_size(info)),
            META_ETAG: info.etag,
            STORAGE_CLASS_HDR: tier.name,
        })
        ud.pop(META_RESTORE_EXPIRY, None)
        try:
            self.layer.put_object(bucket, oi.name, b"", PutObjectOptions(
                user_defined=ud, version_id=vid,
                mod_time=info.mod_time or now_ns(),
                replaces=(info.etag, info.mod_time)))
        except PreconditionFailed:
            # a write or a delete landed since the read: it stands, and
            # the tier copy of what it replaced goes
            tier.remove(remote_key)

    def restore(self, bucket: str, key: str, days: int,
                version_id: Optional[str] = None) -> bool:
        """Write the tier copy back for ``days``; False when the version
        already holds a valid restored copy.  ``version_id`` None is the
        latest version, "" the null version; the copy goes back to the
        version resolved, never to a new one, and only over the stub
        that was read (a write or a delete meanwhile stands: TierError)."""
        oi = self.layer.get_object_info(
            bucket, key, ObjectOptions(version_id=version_id))
        if version_id is None:
            version_id = oi.version_id or ""
        if not is_transitioned(oi.user_defined):
            raise TierError("object is not in an archived state")
        if restore_valid(oi.user_defined):
            return False
        tier = self.tier_of(oi.user_defined)
        if tier is None:
            raise TierError(
                f"tier {oi.user_defined.get(META_TIER)!r} not configured")
        data = tier.get(oi.user_defined[META_KEY])
        ud = dict(oi.user_defined)
        ud[META_RESTORE_EXPIRY] = str(int(time.time()) + days * 24 * 3600)
        try:
            self.layer.put_object(bucket, key, data, PutObjectOptions(
                user_defined=ud, version_id=version_id, mod_time=oi.mod_time,
                replaces=(oi.etag, oi.mod_time)))
        except PreconditionFailed:
            raise TierError("object left its archived state during the "
                            "restore") from None
        return True

    def sweep_expired_restores(self, bucket: str) -> int:
        """Put the stub back over every restored copy of ``bucket`` whose
        window has lapsed, across all versions; returns how many.  The
        crawler does the same from its own listing (``put_stub_back``
        as its ``restub_fn``)."""
        from ..background.heal import iter_versions
        n = 0
        for oi in list(iter_versions(self.layer, bucket)):
            if oi.delete_marker:
                continue
            # "" is the null version here: None would read the latest
            full = self.layer.get_object_info(
                bucket, oi.name, ObjectOptions(version_id=oi.version_id))
            n += self.put_stub_back(bucket, full)
        return n

    def put_stub_back(self, bucket: str, oi) -> bool:
        """Rewrite version ``oi`` as its stub when its restore has lapsed
        (``restore_lapsed``); True when it did.  Only the version read
        is replaced: one rewritten or deleted since is left."""
        ud = oi.user_defined
        if not restore_lapsed(ud):
            return False
        stub = dict(ud)
        stub.pop(META_RESTORE_EXPIRY, None)
        try:
            self.layer.put_object(bucket, oi.name, b"", PutObjectOptions(
                user_defined=stub, version_id=oi.version_id or "",
                mod_time=oi.mod_time, replaces=(oi.etag, oi.mod_time)))
        except PreconditionFailed:
            return False
        return True

    def delete_tiered(self, user_defined: dict) -> None:
        """Free the tier copy of a transitioned version that was deleted
        or overwritten; a failure leaves it behind, never the request."""
        if not is_transitioned(user_defined):
            return
        tier = self.tier_of(user_defined)
        key = user_defined.get(META_KEY, "")
        if tier is not None and key:
            try:
                tier.remove(key)
            except Exception:  # noqa: BLE001 — the delete has committed
                pass

    # -- the registry (the admin ``tier`` routes) ---------------------------

    def to_json(self, redact: bool = False) -> bytes:
        """The tiers' configs; ``redact`` hides the credentials (a
        listing never returns them), the persisted form keeps them."""
        out = []
        for t in self.tiers.values():
            if isinstance(t, DirTier):
                out.append({"type": "dir", "name": t.name, "path": t.path})
            elif isinstance(t, S3Tier):
                out.append({"type": "s3", "name": t.name,
                            "endpoint": t.client.endpoint,
                            "bucket": t.bucket, "prefix": t.prefix,
                            "access_key": "REDACTED" if redact
                            else t.client.access_key,
                            "secret_key": "REDACTED" if redact
                            else t.client.secret_key,
                            "region": t.client.region})
        return json.dumps(out).encode()

    @classmethod
    def from_json(cls, layer, blob: bytes) -> "TransitionSys":
        tsys = cls(layer)
        tsys._add_docs(blob)
        return tsys

    def _add_docs(self, blob: bytes) -> None:
        """Add the tiers of a persisted registry; an entry of an unknown
        type is passed over, as the reference passes it."""
        for d in json.loads(blob or b"[]"):
            try:
                self.add_tier(tier_from_doc(d))
            except ValueError:
                continue

    def load(self) -> None:
        """Read ``tiers/tiers.json`` from the system volume (the first
        drive that has it), adding its tiers."""
        from ..storage.xl_storage import SYS_DIR
        er = self.layer.meta_set
        blobs, _ = er._fanout(lambda d: d.read_all(SYS_DIR, TIERS_PATH),
                              er.disks)
        blob = next((b for b in blobs if b), None)
        if blob:
            self._add_docs(blob)

    def save(self) -> None:
        """Write the registry, credentials and all, to every drive of the
        system volume."""
        from ..storage.xl_storage import SYS_DIR
        blob = self.to_json()
        er = self.layer.meta_set
        er._fanout(lambda d: d.write_all(SYS_DIR, TIERS_PATH, blob),
                   er.disks)


def tier_from_doc(d: dict) -> Tier:
    """A tier from its config: ``{"type": "dir", "name", "path"}`` or
    ``{"type": "s3", "name", "endpoint", "bucket", "access_key",
    "secret_key"[, "prefix", "region"]}``.  KeyError for a missing field,
    ValueError for an unknown type."""
    if d.get("type") == "dir":
        return DirTier(d["name"], d["path"])
    if d.get("type") == "s3":
        return S3Tier(d["name"], d["endpoint"], d["bucket"],
                      d["access_key"], d["secret_key"],
                      d.get("prefix", ""), d.get("region", "us-east-1"))
    raise ValueError(f"unknown tier type {d.get('type')!r}")


def transition_fn(tsys: TransitionSys):
    """The crawler's transition callback: the rule's storage class names
    the tier."""
    def fn(bucket: str, oi, storage_class: str = "") -> None:
        if storage_class:
            oi.transition_tier = storage_class
        tsys.transition(bucket, oi)
    return fn
