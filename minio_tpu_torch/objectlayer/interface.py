"""Object-layer types and errors (cmd/object-api-interface.go,
cmd/object-api-errors.go), the part the port's erasure sets and its S3
front use: buckets, objects and their versions, and multipart uploads
(``PartInfo`` and ``MultipartInfo`` as ``minio_tpu/objectlayer/
multipart.py`` defines them)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class ObjectLayerError(Exception):
    pass


class BucketNotFound(ObjectLayerError):
    pass


class BucketExists(ObjectLayerError):
    pass


class BucketNotEmpty(ObjectLayerError):
    pass


class BucketNameInvalid(ObjectLayerError):
    pass


class ObjectNotFound(ObjectLayerError):
    pass


class ObjectNameInvalid(ObjectLayerError):
    pass


class VersionNotFound(ObjectLayerError):
    pass


class MethodNotAllowed(ObjectLayerError):
    """e.g. GET of a delete marker."""


class ObjectLocked(ObjectLayerError):
    """A delete of a version its legal hold or retention protects."""


class InvalidUploadID(ObjectLayerError):
    pass


class InvalidPart(ObjectLayerError):
    pass


class InvalidPartOrder(ObjectLayerError):
    pass


class PreconditionFailed(ObjectLayerError):
    pass


class InvalidRange(ObjectLayerError):
    pass


class BadDigest(ObjectLayerError):
    """The body's MD5 is not the Content-MD5 the client sent."""


class ReadQuorumError(ObjectLayerError):
    """errErasureReadQuorum: not enough disks agree to read."""


class WriteQuorumError(ObjectLayerError):
    """errErasureWriteQuorum: not enough successful writes."""


@dataclass
class BucketInfo:
    name: str
    created: int = 0             # unix ns


@dataclass
class ObjectInfo:
    """cmd/object-api-datatypes.go ObjectInfo, the fields the port fills."""
    bucket: str = ""
    name: str = ""
    mod_time: int = 0            # unix ns
    size: int = 0
    etag: str = ""
    version_id: str = ""
    is_latest: bool = True
    delete_marker: bool = False
    content_type: str = ""
    user_defined: dict[str, str] = field(default_factory=dict)
    parity: int = 0
    data_blocks: int = 0
    num_versions: int = 0
    parts: list[tuple[int, int]] = field(default_factory=list)


@dataclass
class PutObjectOptions:
    user_defined: dict[str, str] = field(default_factory=dict)
    # a new uuid version (the bucket is versioned); ``version_id`` names
    # it instead
    versioned: bool = False
    version_id: str = ""
    mod_time: int = 0            # 0: now
    # the client's Content-MD5 as hex: the body must hash to it, checked
    # against the layer's own MD5 before the commit
    content_md5: Optional[str] = None
    # a pool move: the ETag stamped verbatim, the source version's (a
    # Content-MD5 is still checked when both are set: the move's verify)
    preserve_etag: Optional[str] = None
    # the parity a storage class asks for (x-amz-storage-class,
    # cmd/erasure-object.go:631); None: the set's
    parity: Optional[int] = None
    # (ETag, mod time) the version ``version_id`` must still have when
    # the write lock is taken, else PreconditionFailed and nothing is
    # written: a transition's stub and a restore's copy replace only the
    # version they read
    replaces: Optional[tuple[str, int]] = None


@dataclass
class ObjectOptions:
    """GET, HEAD and DELETE options: ``version_id`` None is the latest
    version, "" the null version.  ``check_lock``: a DELETE that removes
    a version refuses (ObjectLocked) when its legal hold or retention
    forbids it, judged under the name's write lock; GOVERNANCE yields to
    ``bypass_governance``.  ``no_lock``: a reader holds the name's read
    lock only while it reads the version's metadata, not while its body
    streams (a copy, whose PUT may take the same name's write lock)."""
    version_id: Optional[str] = None
    versioned: bool = False
    mod_time: int = 0            # a delete marker's; 0: now
    check_lock: bool = False
    bypass_governance: bool = False
    no_lock: bool = False


@dataclass
class PartInfo:
    part_number: int
    etag: str
    size: int
    actual_size: int
    mod_time: int = 0


@dataclass
class MultipartInfo:
    bucket: str
    object_name: str
    upload_id: str
    user_defined: dict[str, str] = field(default_factory=dict)


@dataclass
class ListObjectsInfo:
    """One listing page (cmd/object-api-datatypes.go ListObjectsInfo)."""
    is_truncated: bool = False
    next_marker: str = ""
    objects: list[ObjectInfo] = field(default_factory=list)
    prefixes: list[str] = field(default_factory=list)


@dataclass
class ListObjectVersionsInfo:
    """One page of versions, newest first within a key
    (ListObjectVersions)."""
    is_truncated: bool = False
    next_key_marker: str = ""
    next_version_id_marker: str = ""
    objects: list[ObjectInfo] = field(default_factory=list)
