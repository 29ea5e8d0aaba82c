"""The per-drive contract (``minio_tpu/storage/api.py``,
cmd/storage-interface.go:25).

Every drive the object layer talks to satisfies ``StorageAPI``: a local
``XLStorage``, a ``RemoteStorage`` on another node's drive
(``storage/remote.py``), and the ``HealthDisk`` proxy around either
(``storage/health.py``, which forwards by name and is registered here).
The signatures are the port's: ``walk_dir`` and ``walk_entries`` take the
``after`` a listing page resumes from, and ``walk_entries`` yields
``(name, FileInfo)`` (or ``(name, [FileInfo, ...])`` with ``versions``),
which the storage service turns into the reference's wire documents.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Iterable

from .datatypes import FileInfo


@dataclass
class DiskInfo:
    """cmd/storage-datatypes.go DiskInfo."""
    total: int = 0
    free: int = 0
    used: int = 0
    free_inodes: int = 0
    fs_type: str = ""
    root_disk: bool = False
    healing: bool = False
    endpoint: str = ""
    mount_path: str = ""
    disk_id: str = ""
    error: str = ""


@dataclass
class VolInfo:
    name: str
    created: int = 0  # unix ns


@dataclass
class FilesInfo:
    files: list[FileInfo] = field(default_factory=list)
    is_truncated: bool = False


class StorageAPI(abc.ABC):
    """An abstract drive (cmd/storage-interface.go:25-92)."""

    # -- identity / health -------------------------------------------------

    @abc.abstractmethod
    def is_online(self) -> bool: ...

    @abc.abstractmethod
    def endpoint(self) -> str: ...

    @abc.abstractmethod
    def is_local(self) -> bool: ...

    @abc.abstractmethod
    def get_disk_id(self) -> str: ...

    @abc.abstractmethod
    def set_disk_id(self, disk_id: str) -> None: ...

    @abc.abstractmethod
    def disk_info(self) -> DiskInfo: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    def reopen(self) -> None:
        """Take back a drive that returned empty and was just formatted
        (``health.HealthDisk.probe``); nothing to do by default."""

    # -- volumes -----------------------------------------------------------

    @abc.abstractmethod
    def make_vol(self, volume: str) -> None: ...

    @abc.abstractmethod
    def list_vols(self) -> list[VolInfo]: ...

    @abc.abstractmethod
    def stat_vol(self, volume: str) -> VolInfo: ...

    @abc.abstractmethod
    def delete_vol(self, volume: str, force: bool = False) -> None: ...

    # -- files -------------------------------------------------------------

    @abc.abstractmethod
    def list_dir(self, volume: str, dir_path: str,
                 count: int = -1) -> list[str]: ...

    @abc.abstractmethod
    def read_all(self, volume: str, path: str) -> bytes: ...

    @abc.abstractmethod
    def write_all(self, volume: str, path: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def create_file(self, volume: str, path: str, data,
                    file_size: int = -1) -> None: ...

    @abc.abstractmethod
    def append_file(self, volume: str, path: str, data) -> None: ...

    @abc.abstractmethod
    def read_file_stream(self, volume: str, path: str, offset: int,
                         length: int) -> bytes: ...

    @abc.abstractmethod
    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None: ...

    @abc.abstractmethod
    def delete(self, volume: str, path: str,
               recursive: bool = False) -> None: ...

    @abc.abstractmethod
    def stat_info_file(self, volume: str, path: str) -> int:
        """The size of a regular file; FileNotFound when missing."""

    # -- metadata (the xl.meta journal) ------------------------------------

    @abc.abstractmethod
    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        """Move a staged data dir into place and merge the version into
        xl.meta (cmd/xl-storage.go:1965 RenameData)."""

    @abc.abstractmethod
    def write_data_commit(self, volume: str, path: str, fi: FileInfo,
                          data, shard_index: int | None = None,
                          version_dict: dict | None = None,
                          meta_gate=None) -> None:
        """A single-part commit: ``<ddir>/part.1``, then the version.
        ``meta_gate`` blocks until the object's MD5 is known and returns
        the final version dict (raising aborts before any version is
        visible)."""

    @abc.abstractmethod
    def write_packed(self, volume: str, path: str, fi: FileInfo, data,
                     shard_index: int | None = None,
                     version_dict: dict | None = None) -> None:
        """A packed small-object commit into the drive's segment file."""

    @abc.abstractmethod
    def read_segment(self, sid: int, off: int, length: int) -> bytes: ...

    @abc.abstractmethod
    def write_metadata(self, volume: str, path: str,
                       fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def update_metadata(self, volume: str, path: str,
                        fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def read_version(self, volume: str, path: str,
                     version_id: str | None = None,
                     read_data: bool = False) -> FileInfo: ...

    @abc.abstractmethod
    def list_versions(self, volume: str, path: str) -> list[FileInfo]: ...

    @abc.abstractmethod
    def delete_version(self, volume: str, path: str, fi: FileInfo,
                       force_del_marker: bool = False) -> None: ...

    # -- integrity ---------------------------------------------------------

    @abc.abstractmethod
    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Full bitrot verification of every part; FileCorrupt."""

    @abc.abstractmethod
    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        """Every part exists with its framed size."""

    # -- walking (listings) ------------------------------------------------

    @abc.abstractmethod
    def walk_dir(self, volume: str, base_dir: str = "", after: str = "",
                 recursive: bool = True) -> Iterable[str]:
        """Object names under ``base_dir`` in flat key order."""

    @abc.abstractmethod
    def walk_entries(self, volume: str, base_dir: str = "",
                     versions: bool = False, after: str = "",
                     recursive: bool = True) -> Iterable[tuple]:
        """``(name, FileInfo)`` per object in ``walk_dir`` order, or
        ``(name, [FileInfo, ...])`` with ``versions``."""

    # -- staging -----------------------------------------------------------

    @abc.abstractmethod
    def tmp_dir(self) -> str: ...

    @abc.abstractmethod
    def clean_tmp(self, rel_dir: str) -> None: ...
