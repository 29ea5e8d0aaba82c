"""One local drive (cmd/xl-storage.go), trimmed to the erasure data path.

Layout per drive root, identical to ``minio_tpu``'s:

    <root>/.mt.sys/tmp/<uuid>/...            staging for in-flight writes
    <root>/<bucket>/<object>/xl.meta         version journal (xl_meta.py)
    <root>/<bucket>/<object>/<ddir>/part.1   bitrot-framed shard file
    <root>/.mt.sys/seg/journal               packed-segment journal
    <root>/.mt.sys/seg/seg.<sid>.dat         packed shards (commit.py)

Writes are stage-then-commit: shard files land in tmp and ``rename_data``
moves the data dir into place and merges the version into xl.meta;
``write_data_commit`` writes a single-batch part straight into its data
dir and merges xl.meta last; ``write_packed`` appends the shard to the
drive's open segment and points xl.meta at the extent.  Every commit
fsyncs file contents before the rename that makes them visible and
fsyncs the parent directory after.

On a drive writer's thread with a group commit armed
(``commit.collector()``), the same order runs batched: fsyncs defer into
the batch's flush and the visibility-flipping xl.meta replace runs after
them (``storage/commit.py``).
"""

from __future__ import annotations

import itertools
import os
import shutil
import uuid
from dataclasses import dataclass

from ..hashing.bitrot import bitrot_shard_file_size
from . import commit as _commit
from . import errors
from .datatypes import FileInfo
from .xl_meta import XLMeta

SYS_DIR = ".mt.sys"
TMP_DIR = os.path.join(SYS_DIR, "tmp")
META_FILE = "xl.meta"


@dataclass
class VolInfo:
    name: str
    created: int = 0   # unix ns


_TMP_SEQ = itertools.count()


def _fsync_fd(fd: int) -> None:
    """fsync now, or under a group commit at the batch's flush (a dup'd
    fd: the caller closes its own, and the file may be renamed first)."""
    col = _commit.collector()
    if col is not None:
        col.defer_fd(os.dup(fd))
    else:
        os.fsync(fd)


def _write_fsync(path: str, data, flags: int) -> None:
    fd = os.open(path, flags, 0o644)
    try:
        _commit.write_full(fd, data)
        _fsync_fd(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Persist a directory's entries; under a group commit the fsync
    defers into the flush, where the same path collapses to one call."""
    col = _commit.collector()
    if col is not None:
        col.defer_dir(path)
        return
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_atomic(path: str, data: bytes) -> None:
    """tmp -> fsync -> replace.  Under a group commit the replace parks
    behind the batch's fsyncs (this file's and every batch-mate's) and
    registers its directory's fsync for the next round; the pending
    content is published so a batch-mate's read-merge-write of the same
    path sees it."""
    tmp = f"{path}.tmp.{os.getpid():x}.{next(_TMP_SEQ):x}"
    _write_fsync(tmp, data, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    col = _commit.collector()
    if col is None:
        os.replace(tmp, path)
        return
    col.pending_put(path, data)

    def flip():
        os.replace(tmp, path)
        col.defer_dir(os.path.dirname(path))
    col.after_flush(flip)


def _purge_later(path: str) -> None:
    """Remove a replaced version's data dir, never before the replacing
    xl.meta is durable: under a group commit two continuation rounds out
    (past the deferred replace and past its directory fsync)."""
    col = _commit.collector()
    if col is None:
        shutil.rmtree(path, ignore_errors=True)
        return
    col.after_flush(lambda: col.after_flush(
        lambda: shutil.rmtree(path, ignore_errors=True)))


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
        # opened on the first packed op; the journal replays then
        self.segments = _commit.SegmentStore(
            os.path.join(self.root, SYS_DIR, _commit.SEG_DIR))

    def endpoint(self) -> str:
        return self.root

    def close(self) -> None:
        self.segments.close()

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

    def _meta_path(self, volume: str, path: str) -> str:
        return self._file_path(volume, os.path.join(path, META_FILE))

    def _read_meta(self, volume: str, path: str) -> XLMeta:
        col = _commit.collector()
        if col is not None:
            # a batch-mate's xl.meta replace may still be parked behind
            # the flush: merge against it, not the older file
            pending = col.pending_get(self._meta_path(volume, path))
            if pending is not None:
                return XLMeta.load(pending)
        try:
            buf = self.read_all(volume, os.path.join(path, META_FILE))
        except errors.FileNotFound:
            raise errors.FileNotFound(f"{volume}/{path}") from None
        return XLMeta.load(buf)

    def _write_meta(self, volume: str, path: str, meta: XLMeta) -> None:
        full = self._meta_path(volume, path)
        _write_atomic(full, meta.dump())
        _fsync_dir(os.path.dirname(full))

    def _object_dir(self, volume: str, path: str) -> tuple[str, bool]:
        """The object's directory, created if missing; (path, fresh)."""
        dst_obj = self._file_path(volume, path)
        try:
            os.mkdir(dst_obj)
            return dst_obj, True
        except FileExistsError:
            return dst_obj, False
        except FileNotFoundError:
            # a wiped volume is not resurrected
            self._check_vol(volume)
            os.makedirs(dst_obj, exist_ok=True)   # nested object name
            return dst_obj, True

    def _merge_version(self, volume: str, path: str, dst_obj: str,
                       fresh: bool, fi: FileInfo, vd: dict) -> dict:
        """Merge ``vd`` into the object's xl.meta, written last; returns
        the replaced version ({} without one).  Its unshared data dir is
        purged once the new xl.meta is durable."""
        meta, old = XLMeta(), {}
        if not fresh:
            try:
                meta = self._read_meta(volume, path)
                old = meta.find(fi.version_id)
            except (errors.FileNotFound, errors.FileCorrupt,
                    errors.FileVersionNotFound):
                pass
        meta.add_version_dict(vd)
        _write_atomic(os.path.join(dst_obj, META_FILE), meta.dump())
        _fsync_dir(dst_obj)
        if fresh:
            _fsync_dir(os.path.dirname(dst_obj))
        old_ddir = old.get("ddir", "")
        if old_ddir and old_ddir != vd.get("ddir", "") \
                and meta.shared_data_dir_count(fi.version_id, old_ddir) == 0:
            _purge_later(os.path.join(dst_obj, old_ddir))
        return old

    @staticmethod
    def _version_dict(fi: FileInfo, shard_index: int | None,
                      version_dict: dict | None) -> dict:
        vd = dict(version_dict) if version_dict is not None \
            else fi.to_dict()
        if shard_index is not None:
            vd["ec"] = dict(vd["ec"], index=shard_index)
        return vd

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        """Merge ``fi`` into xl.meta: the whole commit of an inline
        object."""
        self._check_vol(volume)
        dst_obj, fresh = self._object_dir(volume, path)
        self._merge_version(volume, path, dst_obj, fresh, fi, fi.to_dict())

    def read_version(self, volume: str, path: str,
                     version_id: str | None = None) -> FileInfo:
        return self._read_meta(volume, path).to_fileinfo(volume, path,
                                                         version_id)

    def write_data_commit(self, volume: str, path: str, fi: FileInfo,
                          data, shard_index: int | None = None,
                          version_dict: dict | None = None,
                          meta_gate=None) -> None:
        """Single-part commit: ``data`` lands as ``<ddir>/part.1`` in the
        object dir, then the version (with this drive's shard index)
        merges into xl.meta, which is what makes it visible.

        ``meta_gate``: called between the two; it blocks until the
        object's MD5 is known and returns the final version dict (so the
        part bytes land while the MD5 still runs).  If it raises, no
        version becomes visible and the caller purges the data dir."""
        self._check_vol(volume)
        dst_obj, fresh = self._object_dir(volume, path)
        ddir = os.path.join(dst_obj, fi.data_dir)
        os.mkdir(ddir)
        _write_fsync(os.path.join(ddir, "part.1"), data,
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        _fsync_dir(ddir)
        if meta_gate is not None:
            version_dict = meta_gate()
        self._merge_version(volume, path, dst_obj, fresh, fi,
                            self._version_dict(fi, shard_index,
                                               version_dict))

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        """Atomic commit (cmd/xl-storage.go:1965): move the staged data
        dir into the object path, then merge the version into xl.meta."""
        src_dir = self._file_path(src_volume, src_path)
        self._check_vol(dst_volume)
        obj_dir = self._file_path(dst_volume, dst_path)
        fresh = not os.path.isdir(obj_dir)
        if fi.data_dir:
            if not os.path.isdir(src_dir):
                raise errors.FileNotFound(src_path)
            dst_dir = os.path.join(obj_dir, fi.data_dir)
            os.makedirs(obj_dir, exist_ok=True)
            if os.path.isdir(dst_dir):
                shutil.rmtree(dst_dir)
            os.replace(src_dir, dst_dir)
            _fsync_dir(obj_dir)
        else:
            os.makedirs(obj_dir, exist_ok=True)
        self._merge_version(dst_volume, dst_path, obj_dir, fresh, fi,
                            fi.to_dict())

    # -- packed segments ---------------------------------------------------

    def write_packed(self, volume: str, path: str, fi: FileInfo,
                     data, shard_index: int | None = None,
                     version_dict: dict | None = None) -> None:
        """Packed small-object commit: the framed shard appends to this
        drive's open segment (one journaled ``add``) and xl.meta points
        at the extent (the version's ``seg`` field, no data dir).  Under
        a group commit the segment and journal fsyncs are shared by the
        batch and the xl.meta replace waits for them.  A replaced packed
        version's extent is freed once the new xl.meta is durable."""
        self._check_vol(volume)
        dst_obj, fresh = self._object_dir(volume, path)
        col = _commit.collector()
        sid, off = self.segments.append(data, volume, path, fi.version_id)
        if col is not None:
            self.segments.defer_sync(col)
            col.seg_bytes += len(data)
        else:
            self.segments.sync()
        vd = self._version_dict(fi, shard_index, version_dict)
        vd["ddir"] = ""
        vd["seg"] = {"sid": sid, "off": off, "len": len(data)}
        old_seg = self._merge_version(volume, path, dst_obj, fresh, fi,
                                      vd).get("seg")
        if old_seg:
            osid, ooff = old_seg["sid"], old_seg["off"]
            if col is None:
                self.segments.free(osid, ooff)
            else:
                col.after_flush(lambda: col.after_flush(
                    lambda: self.segments.free(osid, ooff)))

    def read_segment(self, sid: int, off: int, length: int) -> bytes:
        """One packed extent's bytes (the GET side of ``seg``)."""
        return self.segments.read(sid, off, length)

    def compact_segments(self) -> dict:
        """Move the live extents of mostly-dead sealed segments to the
        open one and point their owners' xl.meta there; extents whose
        owner moved on are freed.  Per extent: new bytes durable, then
        the owner's xl.meta, then the old extent freed."""
        def rewrite(vol: str, name: str, vid: str, sid: int, off: int,
                    length: int) -> bool:
            try:
                meta = self._read_meta(vol, name)
                v = meta.find(vid)
            except errors.StorageError:
                return False
            seg = v.get("seg")
            if not seg or seg["sid"] != sid or seg["off"] != off:
                return False
            data = self.segments.read(sid, off, length)
            nsid, noff = self.segments.append(data, vol, name, vid)
            self.segments.sync()
            meta.add_version_dict(
                dict(v, seg={"sid": nsid, "off": noff, "len": length}))
            self._write_meta(vol, name, meta)
            return True
        return self.segments.compact(rewrite)

    # -- delete ------------------------------------------------------------

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        """Remove version ``fi.version_id``: its unshared data dir goes,
        xl.meta is rewritten (or removed with the object path when no
        version is left), then a packed extent is freed."""
        self._check_vol(volume)
        meta = self._read_meta(volume, path)
        old_seg = meta.find(fi.version_id).get("seg")
        ddir = meta.delete_version(fi.version_id)
        obj_dir = self._file_path(volume, path)
        if ddir and meta.shared_data_dir_count(fi.version_id, ddir) == 0:
            shutil.rmtree(os.path.join(obj_dir, ddir), ignore_errors=True)
        if meta.versions:
            self._write_meta(volume, path, meta)
        else:
            self.delete(volume, os.path.join(path, META_FILE))
        if old_seg:
            self.segments.free(old_seg["sid"], old_seg["off"])

    # -- integrity ---------------------------------------------------------

    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        """Every part file, or the packed extent, exists with its framed
        size (FileCorrupt or FileNotFound otherwise)."""
        ec = fi.erasure
        ss = ec.shard_size()
        for part in fi.parts:
            if fi.seg is not None:
                pf = f"seg.{fi.seg['sid']:08x}+{fi.seg['off']}"
                size = self.segments.stat(fi.seg["sid"], fi.seg["off"],
                                          fi.seg["len"])
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
