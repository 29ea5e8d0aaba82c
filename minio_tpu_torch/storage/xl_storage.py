"""One local drive (cmd/xl-storage.go), trimmed to the erasure data path.

Layout per drive root, identical to ``minio_tpu``'s:

    <root>/.mt.sys/tmp/<uuid>/...            staging for in-flight writes
    <root>/<bucket>/<object>/xl.meta         version journal (xl_meta.py)
    <root>/<bucket>/<object>/<ddir>/part.1   bitrot-framed shard file
    <root>/.mt.sys/seg/seg.<sid>.dat         packed shards (read only here)

Writes are stage-then-commit: shard files land in tmp and ``rename_data``
moves the data dir into place and merges the version into xl.meta, or
``write_data_commit`` writes a single-batch part straight into its data
dir and merges xl.meta last.  Every commit fsyncs file contents before
the rename that makes them visible and fsyncs the parent directory after.

``minio_tpu``'s commit plane packs objects just above the inline
threshold into per-drive segment files; such a version has no data dir
and a ``seg`` extent ``{sid, off, len}`` in xl.meta.  The port reads and
checks those extents (``read_segment``, ``check_parts``) and writes none.
"""

from __future__ import annotations

import os
import shutil
import uuid
from dataclasses import dataclass

from ..hashing.bitrot import bitrot_shard_file_size
from . import errors
from .datatypes import FileInfo
from .xl_meta import XLMeta

SYS_DIR = ".mt.sys"
TMP_DIR = os.path.join(SYS_DIR, "tmp")
META_FILE = "xl.meta"
SEG_DIR = "seg"                       # under SYS_DIR (minio_tpu's commit.py)


def _seg_name(sid: int) -> str:
    return f"seg.{sid:08x}.dat"


@dataclass
class VolInfo:
    name: str
    created: int = 0   # unix ns


def _write_full(fd: int, data) -> None:
    mv = memoryview(data).cast("B")
    written = 0
    while written < len(mv):
        written += os.write(fd, mv[written:])


def _write_fsync(path: str, data, flags: int) -> None:
    fd = os.open(path, flags, 0o644)
    try:
        _write_full(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path: str, data) -> None:
    """tmp -> fsync -> replace -> fsync(parent)."""
    tmp = f"{path}.tmp.{os.getpid():x}.{uuid.uuid4().hex[:8]}"
    _write_fsync(tmp, data, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _is_valid_volname(volume: str) -> bool:
    return (len(volume) >= 3 or volume.startswith(SYS_DIR)) \
        and "/" not in volume and volume not in ("", ".", "..")


class XLStorage:
    """One local drive."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        if not os.path.isdir(self.root):
            raise errors.DiskNotFound(self.root)
        os.makedirs(os.path.join(self.root, TMP_DIR), exist_ok=True)

    def endpoint(self) -> str:
        return self.root

    # -- paths -------------------------------------------------------------

    def _vol_path(self, volume: str) -> str:
        if not _is_valid_volname(volume):
            raise errors.VolumeNotFound(volume)
        return os.path.join(self.root, volume)

    def _file_path(self, volume: str, path: str) -> str:
        vol = self._vol_path(volume)
        full = os.path.normpath(os.path.join(vol, path))
        if not full.startswith(vol + os.sep) and full != vol:
            raise errors.FileAccessDenied(path)  # path traversal guard
        return full

    def _check_vol(self, volume: str) -> str:
        p = self._vol_path(volume)
        if not os.path.isdir(p):
            raise errors.VolumeNotFound(volume)
        return p

    # -- volumes -----------------------------------------------------------

    def make_vol(self, volume: str) -> None:
        p = self._vol_path(volume)
        if os.path.isdir(p):
            raise errors.VolumeExists(volume)
        try:
            os.makedirs(p)
        except PermissionError as e:
            raise errors.DiskAccessDenied(str(e)) from e

    def stat_vol(self, volume: str) -> VolInfo:
        try:
            st = os.stat(self._check_vol(volume))
        except FileNotFoundError:
            raise errors.VolumeNotFound(volume) from None
        return VolInfo(volume, int(st.st_ctime * 1e9))

    # -- files -------------------------------------------------------------

    def read_all(self, volume: str, path: str) -> bytes:
        full = self._file_path(volume, path)
        self._check_vol(volume)
        try:
            with open(full, "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            raise errors.FileNotFound(path) from None
        except PermissionError as e:
            raise errors.FileAccessDenied(path) from e

    def create_file(self, volume: str, path: str, data) -> None:
        """Whole-file write into a staging path (``rename_data`` later
        moves the staging dir as a unit)."""
        full = self._file_path(volume, path)
        self._check_vol(volume)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        _write_fsync(full, data, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)

    def append_file(self, volume: str, path: str, data) -> None:
        full = self._file_path(volume, path)
        self._check_vol(volume)
        _write_fsync(full, data, os.O_WRONLY | os.O_CREAT | os.O_APPEND)

    def read_file_stream(self, volume: str, path: str, offset: int,
                         length: int) -> bytes:
        full = self._file_path(volume, path)
        try:
            with open(full, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        except PermissionError as e:
            raise errors.FileAccessDenied(path) from e
        if len(data) < length:
            raise errors.FileCorrupt(
                f"short read {len(data)} < {length} at {path}")
        return data

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        full = self._file_path(volume, path)
        vol = self._check_vol(volume)
        try:
            if os.path.isdir(full):
                if recursive:
                    shutil.rmtree(full)
                else:
                    os.rmdir(full)
            else:
                os.remove(full)
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        except OSError as e:
            raise errors.PathNotEmpty(path) from e
        parent = os.path.dirname(full)     # prune now-empty parents
        while parent != vol:
            try:
                os.rmdir(parent)
            except OSError:
                break
            parent = os.path.dirname(parent)

    # -- xl.meta -----------------------------------------------------------

    def _read_meta(self, volume: str, path: str) -> XLMeta:
        try:
            buf = self.read_all(volume, os.path.join(path, META_FILE))
        except errors.FileNotFound:
            raise errors.FileNotFound(f"{volume}/{path}") from None
        return XLMeta.load(buf)

    def _merge_meta(self, volume: str, path: str, vd: dict) -> None:
        """Merge one version dict into xl.meta (created if missing or
        unreadable); a replaced version's unshared data dir is removed."""
        try:
            meta = self._read_meta(volume, path)
        except (errors.FileNotFound, errors.FileCorrupt):
            meta = XLMeta()
        try:
            old_ddir = meta.find(vd.get("vid", "")).get("ddir", "")
        except errors.FileVersionNotFound:
            old_ddir = ""
        meta.add_version_dict(vd)
        obj_dir = self._file_path(volume, path)
        os.makedirs(obj_dir, exist_ok=True)
        _write_atomic(os.path.join(obj_dir, META_FILE), meta.dump())
        _fsync_dir(os.path.dirname(obj_dir))   # a fresh object dir's entry
        if old_ddir and old_ddir != vd.get("ddir", "") \
                and meta.shared_data_dir_count(vd.get("vid", ""),
                                               old_ddir) == 0:
            shutil.rmtree(os.path.join(obj_dir, old_ddir),
                          ignore_errors=True)

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        """Merge ``fi`` into xl.meta: the whole commit of an inline
        object."""
        self._check_vol(volume)
        self._merge_meta(volume, path, fi.to_dict())

    def read_version(self, volume: str, path: str,
                     version_id: str | None = None) -> FileInfo:
        return self._read_meta(volume, path).to_fileinfo(volume, path,
                                                         version_id)

    def write_data_commit(self, volume: str, path: str, fi: FileInfo,
                          data, shard_index: int) -> None:
        """Single-part commit: ``data`` lands as ``<ddir>/part.1`` in the
        object dir, then the version (with this drive's shard index)
        merges into xl.meta, which is what makes it visible."""
        self._check_vol(volume)
        ddir = os.path.join(self._file_path(volume, path), fi.data_dir)
        os.makedirs(ddir)
        _write_fsync(os.path.join(ddir, "part.1"), data,
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        _fsync_dir(ddir)
        vd = fi.to_dict()
        vd["ec"] = dict(vd["ec"], index=shard_index)
        self._merge_meta(volume, path, vd)

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        """Atomic commit (cmd/xl-storage.go:1965): move the staged data
        dir into the object path, then merge the version into xl.meta."""
        src_dir = self._file_path(src_volume, src_path)
        self._check_vol(dst_volume)
        obj_dir = self._file_path(dst_volume, dst_path)
        if fi.data_dir:
            if not os.path.isdir(src_dir):
                raise errors.FileNotFound(src_path)
            dst_dir = os.path.join(obj_dir, fi.data_dir)
            os.makedirs(obj_dir, exist_ok=True)
            if os.path.isdir(dst_dir):
                shutil.rmtree(dst_dir)
            os.replace(src_dir, dst_dir)
            _fsync_dir(obj_dir)
        self._merge_meta(dst_volume, dst_path, fi.to_dict())

    def _seg_path(self, sid: int) -> str:
        return os.path.join(self.root, SYS_DIR, SEG_DIR, _seg_name(sid))

    def read_segment(self, sid: int, off: int, length: int) -> bytes:
        """``length`` bytes of packed segment ``sid`` at ``off``
        (FileNotFound without the segment, FileCorrupt on a short
        read)."""
        try:
            fd = os.open(self._seg_path(sid), os.O_RDONLY)
        except FileNotFoundError:
            raise errors.FileNotFound(f"segment {sid}") from None
        try:
            data = os.pread(fd, length, off)
        finally:
            os.close(fd)
        if len(data) < length:
            raise errors.FileCorrupt(
                f"segment {sid}: short read {len(data)} < {length} "
                f"at +{off}")
        return data

    def _stat_segment(self, seg: dict) -> int:
        """The extent's length once its segment is known to hold it."""
        try:
            size = os.stat(self._seg_path(seg["sid"])).st_size
        except FileNotFoundError:
            raise errors.FileNotFound(f"segment {seg['sid']}") from None
        if size < seg["off"] + seg["len"]:
            raise errors.FileCorrupt(
                f"segment {seg['sid']}: {size} < {seg['off'] + seg['len']}")
        return seg["len"]

    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        """Every part file, or the packed extent, exists with its framed
        size (FileCorrupt or FileNotFound otherwise)."""
        ec = fi.erasure
        ss = ec.shard_size()
        for part in fi.parts:
            if fi.seg is not None:
                pf = f"seg.{fi.seg['sid']:08x}+{fi.seg['off']}"
                size = self._stat_segment(fi.seg)
            else:
                pf = os.path.join(path, fi.data_dir, f"part.{part.number}")
                try:
                    size = os.stat(self._file_path(volume, pf)).st_size
                except FileNotFoundError:
                    raise errors.FileNotFound(pf) from None
            want = bitrot_shard_file_size(
                ec.shard_file_size(part.size), ss,
                ec.get_checksum_info(part.number).algorithm)
            if size != want:
                raise errors.FileCorrupt(f"{pf}: size {size} != {want}")

    # -- staging -----------------------------------------------------------

    def tmp_dir(self) -> str:
        """A new staging dir, relative to the SYS_DIR volume."""
        d = os.path.join("tmp", uuid.uuid4().hex)
        try:
            os.mkdir(os.path.join(self.root, SYS_DIR, d))
        except FileNotFoundError:
            raise errors.DiskNotFound(self.root) from None
        return d

    def clean_tmp(self, rel_dir: str) -> None:
        shutil.rmtree(os.path.join(self.root, SYS_DIR, rel_dir),
                      ignore_errors=True)
