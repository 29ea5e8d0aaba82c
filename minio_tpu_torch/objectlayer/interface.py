"""Object-layer types and errors (cmd/object-api-interface.go,
cmd/object-api-errors.go), the part the port's erasure set uses."""

from __future__ import annotations

from dataclasses import dataclass, field


class ObjectLayerError(Exception):
    pass


class BucketNotFound(ObjectLayerError):
    pass


class BucketExists(ObjectLayerError):
    pass


class ObjectNotFound(ObjectLayerError):
    pass


class InvalidRange(ObjectLayerError):
    pass


class ReadQuorumError(ObjectLayerError):
    """errErasureReadQuorum: not enough disks agree to read."""


class WriteQuorumError(ObjectLayerError):
    """errErasureWriteQuorum: not enough successful writes."""


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
    mod_time: int = 0            # 0: now
