"""Storage error taxonomy (cmd/storage-errors.go), the part the port uses.

Typed exceptions stand in for Go's sentinel errors; the quorum logic of
the object layer matches on these types.  Names equal ``minio_tpu``'s.
"""

from __future__ import annotations


class StorageError(OSError):
    """Base class for all per-drive storage errors."""


class DiskNotFound(StorageError):
    """errDiskNotFound: drive offline / not reachable."""


class VolumeNotFound(StorageError):
    """errVolumeNotFound: bucket does not exist on this drive."""


class VolumeExists(StorageError):
    """errVolumeExists."""


class FileNotFound(StorageError):
    """errFileNotFound: object/shard path missing."""


class FileVersionNotFound(StorageError):
    """errFileVersionNotFound: version id not present in xl.meta."""


class FileAccessDenied(StorageError):
    """errFileAccessDenied."""


class FileCorrupt(StorageError):
    """errFileCorrupt: bitrot verification failed / truncated shard."""


class PathNotEmpty(StorageError):
    """errPathNotEmpty (object path has children)."""


class DiskAccessDenied(StorageError):
    """errDiskAccessDenied."""


class FaultyDisk(StorageError):
    """errFaultyDisk: the drive failed an I/O (an fsync of a group
    commit)."""
