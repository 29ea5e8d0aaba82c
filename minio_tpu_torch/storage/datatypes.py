"""Core storage datatypes — FileInfo / ErasureInfo / ObjectPartInfo.

Mirrors cmd/storage-datatypes.go:105 (FileInfo) and
cmd/xl-storage-format-v1.go:86-101 (ErasureInfo, ChecksumInfo).  The
``to_dict``/``from_dict`` keys are ``minio_tpu``'s, unchanged: they are
the xl.meta format both packages read and write.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ..hashing.bitrot import HIGHWAYHASH256S
from ..ops import gf8

ERASURE_ALGORITHM = "rs-vandermonde"


@dataclass
class ChecksumInfo:
    """Bitrot checksum of one erasure-coded part."""
    part_number: int
    algorithm: str
    hash: bytes = b""  # empty for streaming bitrot (hash interleaved in file)

    def to_dict(self) -> dict:
        return {"n": self.part_number, "a": self.algorithm, "h": self.hash}

    @classmethod
    def from_dict(cls, d: dict) -> "ChecksumInfo":
        return cls(d["n"], d["a"], d.get("h", b""))


@dataclass
class ErasureInfo:
    """Erasure geometry and layout of one object version."""
    algorithm: str = ERASURE_ALGORITHM
    data_blocks: int = 0
    parity_blocks: int = 0
    block_size: int = 0
    index: int = 0                      # 1-based shard index on this drive
    distribution: list[int] = field(default_factory=list)
    checksums: list[ChecksumInfo] = field(default_factory=list)

    def shard_file_size(self, total_size: int) -> int:
        return gf8.shard_file_size(self.block_size, self.data_blocks,
                                   total_size)

    def shard_size(self) -> int:
        return gf8.shard_size(self.block_size, self.data_blocks)

    def get_checksum_info(self, part_number: int) -> ChecksumInfo:
        for c in self.checksums:
            if c.part_number == part_number:
                return c
        return ChecksumInfo(part_number, HIGHWAYHASH256S)

    def to_dict(self) -> dict:
        return {
            "algo": self.algorithm, "data": self.data_blocks,
            "parity": self.parity_blocks, "bsize": self.block_size,
            "index": self.index, "dist": list(self.distribution),
            "csums": [c.to_dict() for c in self.checksums],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ErasureInfo":
        return cls(
            algorithm=d.get("algo", ERASURE_ALGORITHM),
            data_blocks=d.get("data", 0), parity_blocks=d.get("parity", 0),
            block_size=d.get("bsize", 0), index=d.get("index", 0),
            distribution=list(d.get("dist", [])),
            checksums=[ChecksumInfo.from_dict(c) for c in d.get("csums", [])])


@dataclass
class ObjectPartInfo:
    """One part of an object."""
    number: int
    size: int                 # on-disk size
    actual_size: int          # original client size
    etag: str = ""
    mod_time: int = 0         # unix nanoseconds

    def to_dict(self) -> dict:
        return {"n": self.number, "s": self.size, "as": self.actual_size,
                "e": self.etag, "mt": self.mod_time}

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectPartInfo":
        return cls(d["n"], d["s"], d.get("as", d["s"]), d.get("e", ""),
                   d.get("mt", 0))


def now_ns() -> int:
    return time.time_ns()


@dataclass
class FileInfo:
    """Metadata of one object version on one drive."""
    volume: str = ""
    name: str = ""
    version_id: str = ""          # "" == null version
    is_latest: bool = True
    deleted: bool = False         # delete marker
    data_dir: str = ""            # uuid dir holding part files
    mod_time: int = 0             # unix ns
    size: int = 0
    metadata: dict[str, str] = field(default_factory=dict)
    parts: list[ObjectPartInfo] = field(default_factory=list)
    erasure: ErasureInfo = field(default_factory=ErasureInfo)
    # small-object payload kept in xl.meta
    inline_data: Optional[bytes] = None
    # this drive's packed-segment extent {sid, off, len}
    # (XLStorage.write_packed, storage/commit.py)
    seg: Optional[dict] = None
    num_versions: int = 0

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "vol": self.volume, "name": self.name, "vid": self.version_id,
            "latest": self.is_latest, "del": self.deleted,
            "ddir": self.data_dir, "mt": self.mod_time, "size": self.size,
            "meta": dict(self.metadata),
            "parts": [p.to_dict() for p in self.parts],
            "ec": self.erasure.to_dict(),
        }
        if self.inline_data is not None:
            d["inline"] = self.inline_data
        if self.seg is not None:
            d["seg"] = dict(self.seg)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileInfo":
        return cls(
            volume=d.get("vol", ""), name=d.get("name", ""),
            version_id=d.get("vid", ""), is_latest=d.get("latest", True),
            deleted=d.get("del", False), data_dir=d.get("ddir", ""),
            mod_time=d.get("mt", 0), size=d.get("size", 0),
            metadata=dict(d.get("meta", {})),
            parts=[ObjectPartInfo.from_dict(p) for p in d.get("parts", [])],
            erasure=ErasureInfo.from_dict(d.get("ec", {})),
            inline_data=d.get("inline"), seg=d.get("seg"))
