"""Versioned object metadata journal (the xl.meta v2 equivalent).

Same byte format as ``minio_tpu.storage.xl_meta``: the ``MTXL2\\0`` magic
followed by a MessagePack map ``{"v": FORMAT_VERSION, "versions": [...]}``
of FileInfo dicts, newest first, encoded with the port's own MessagePack
subset (``msgpack_codec``).
"""

from __future__ import annotations

from . import errors
from .datatypes import FileInfo
from .msgpack_codec import packb, unpackb

MAGIC = b"MTXL2\x00"
FORMAT_VERSION = 1


class XLMeta:
    """In-memory journal; (de)serialized per read/write of the meta file."""

    def __init__(self, versions: list[dict] | None = None):
        self.versions: list[dict] = versions or []

    @classmethod
    def load(cls, buf: bytes) -> "XLMeta":
        if buf[:len(MAGIC)] != MAGIC:
            raise errors.FileCorrupt("bad xl.meta magic")
        try:
            payload = unpackb(buf[len(MAGIC):])
        except (ValueError, UnicodeDecodeError) as e:
            raise errors.FileCorrupt(f"xl.meta decode: {e}") from e
        if not isinstance(payload, dict) \
                or payload.get("v") != FORMAT_VERSION:
            raise errors.FileCorrupt("unsupported xl.meta version")
        return cls(payload.get("versions", []))

    def dump(self) -> bytes:
        return MAGIC + packb({"v": FORMAT_VERSION, "versions": self.versions})

    def add_version(self, fi: FileInfo) -> None:
        """Insert or replace the version ``fi.version_id``; newest first."""
        self.add_version_dict(fi.to_dict())

    def add_version_dict(self, vd: dict) -> None:
        vid = vd.get("vid", "")
        self.versions = [v for v in self.versions if v.get("vid", "") != vid]
        self.versions.append(vd)
        self.versions.sort(key=lambda v: v.get("mt", 0), reverse=True)

    def delete_version(self, version_id: str) -> str:
        """Remove a version; returns its data dir ("" if none).  A missing
        version raises FileVersionNotFound."""
        for i, v in enumerate(self.versions):
            if v.get("vid", "") == version_id:
                self.versions.pop(i)
                return v.get("ddir", "")
        raise errors.FileVersionNotFound(version_id)

    def find(self, version_id: str) -> dict:
        for v in self.versions:
            if v.get("vid", "") == version_id:
                return v
        raise errors.FileVersionNotFound(version_id)

    def to_fileinfo(self, volume: str, name: str,
                    version_id: str | None = None) -> FileInfo:
        """Latest (or the given) version as FileInfo."""
        if not self.versions:
            raise errors.FileNotFound(f"{volume}/{name}")
        v = self.versions[0] if version_id is None else self.find(version_id)
        fi = FileInfo.from_dict(v)
        fi.volume, fi.name = volume, name
        fi.is_latest = v is self.versions[0]
        fi.num_versions = len(self.versions)
        return fi

    def shared_data_dir_count(self, version_id: str, data_dir: str) -> int:
        """How many other versions reference ``data_dir``."""
        return sum(1 for v in self.versions
                   if v.get("ddir") == data_dir
                   and v.get("vid", "") != version_id)
