"""Quorum metadata logic (cmd/erasure-metadata.go,
cmd/erasure-metadata-utils.go): disk order for an object, and agreement on
the authoritative FileInfo among the per-drive reads."""

from __future__ import annotations

import hashlib
import zlib
from collections import Counter

from ..storage.datatypes import FileInfo
from .interface import ReadQuorumError


def hash_order(key: str, cardinality: int) -> list[int]:
    """Deterministic disk ordering for an object (CRC32-IEEE based,
    cmd/erasure-metadata-utils.go:100-114)."""
    if cardinality <= 0:
        return []
    start = (zlib.crc32(key.encode()) & 0xFFFFFFFF) % cardinality
    return [1 + ((start + i) % cardinality) for i in range(1, cardinality + 1)]


def _meta_hash(fi: FileInfo) -> str:
    h = hashlib.sha256()
    for part in fi.parts:
        h.update(f"part.{part.number}".encode())
    h.update(str(fi.erasure.distribution).encode())
    h.update(fi.data_dir.encode())
    h.update(b"1" if fi.deleted else b"0")
    return h.hexdigest()


def find_file_info_in_quorum(fis: list[FileInfo | None],
                             quorum: int) -> FileInfo:
    """The FileInfo that >= quorum drives agree on: the most common
    mod-time (ties to the later), then a majority over a hash of parts,
    distribution and data dir (cmd/erasure-metadata.go:229).  Among the
    drives of that majority, the first whose metadata most of them hold:
    an update in place (tags, retention, legal hold) keeps the mod time
    and the data, so a drive that missed one still counts for the
    quorum but does not speak for the metadata unless it ties; the
    reference takes the first drive's (ROADMAP Queue 3)."""
    times = Counter(fi.mod_time for fi in fis if fi is not None)
    if not times:
        raise ReadQuorumError("no valid metadata")
    mod_time = max(times.items(), key=lambda kv: (kv[1], kv[0]))[0]
    hashes = [_meta_hash(fi) if fi is not None and fi.mod_time == mod_time
              else None for fi in fis]
    best, count = Counter(h for h in hashes if h).most_common(1)[0]
    if count < quorum:
        raise ReadQuorumError(f"metadata agreement {count} < quorum {quorum}")
    group = [fi for fi, h in zip(fis, hashes) if h == best]
    metas = Counter(_metadata_key(fi) for fi in group)
    top = max(metas.values())
    return next(fi for fi in group if metas[_metadata_key(fi)] == top)


def _metadata_key(fi: FileInfo) -> tuple:
    return tuple(sorted(fi.metadata.items()))


def same_version(dfi: FileInfo | None, fi: FileInfo) -> bool:
    """Whether a drive's FileInfo is the quorum version ``fi``: the same
    mod time and version id (a drive that missed a write holds another)."""
    return (dfi is not None and dfi.mod_time == fi.mod_time
            and dfi.version_id == fi.version_id)


def reduce_errs(errs: list[Exception | None], quorum: int,
                quorum_error: type[Exception]) -> None:
    """reduceQuorumErrs: return when >= quorum drives succeeded; raise the
    error >= quorum drives share; else raise ``quorum_error``."""
    ok = sum(1 for e in errs if e is None)
    if ok >= quorum:
        return
    kinds = Counter(type(e).__name__ for e in errs if e is not None)
    if kinds:
        name, count = kinds.most_common(1)[0]
        if count >= quorum:
            raise next(e for e in errs
                       if e is not None and type(e).__name__ == name)
    raise quorum_error(f"{ok} successes < quorum {quorum}: "
                       f"{[str(e) for e in errs if e]}")


def shuffle_disks(disks: list, distribution: list[int]) -> list:
    """Disks in shard order: shuffled[dist[i] - 1] = disks[i]."""
    return shuffle_parts_metadata(disks, distribution)


def shuffle_parts_metadata(items: list, distribution: list[int]) -> list:
    if not distribution:
        return list(items)
    shuffled = [None] * len(items)
    for i, p in enumerate(items):
        shuffled[distribution[i] - 1] = p
    return shuffled
