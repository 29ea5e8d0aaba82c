"""Storage error taxonomy (cmd/storage-errors.go), the part the port uses.

Typed exceptions stand in for Go's sentinel errors; the quorum logic of
the object layer matches on these types.  Names equal ``minio_tpu``'s.
"""

from __future__ import annotations


class StorageError(OSError):
    """Base class for all per-drive storage errors."""


class DiskNotFound(StorageError):
    """errDiskNotFound: drive offline / not reachable."""


class UnformattedDisk(StorageError):
    """errUnformattedDisk: fresh drive without format.json."""


class CorruptedFormat(StorageError):
    """errCorruptedFormat: unreadable format.json, or one of another
    deployment."""


class VolumeNotFound(StorageError):
    """errVolumeNotFound: bucket does not exist on this drive."""


class VolumeExists(StorageError):
    """errVolumeExists."""


class VolumeNotEmpty(StorageError):
    """errVolumeNotEmpty."""


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


class DiskFull(StorageError):
    """errDiskFull."""


class FileNameTooLong(StorageError):
    """errFileNameTooLong."""


class IsNotRegular(StorageError):
    """errIsNotRegular: the path is not a regular file."""


class MethodNotAllowed(StorageError):
    """errMethodNotAllowed."""
