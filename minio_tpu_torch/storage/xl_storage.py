"""One local drive (cmd/xl-storage.go), trimmed to the erasure data path.

Layout per drive root, identical to ``minio_tpu``'s:

    <root>/.mt.sys/tmp/<uuid>/...            staging for in-flight writes
    <root>/<bucket>/<object>/xl.meta         version journal (xl_meta.py)
    <root>/<bucket>/<object>/<ddir>/part.1   bitrot-framed shard file
    <root>/.mt.sys/seg/journal               packed-segment journal
    <root>/.mt.sys/seg/seg.<sid>.dat         packed shards (commit.py)
    <root>/.mt.sys/multipart/<h>/<upload>/   a multipart upload's staged
                                             parts (objectlayer/multipart.py)
    <root>/.mt.sys/buckets/<b>/bucket-meta.json  a bucket's versioning
    <root>/.mt.sys/format.json               the drive's identity
                                             (storage/format.py)

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

Every drive op in ``_TIMED_OPS`` records its duration and bytes into the
drive's last-minute windows (``self.latency``), which slow-drive
detection and the ``mt_node_disk_latency_*`` scrape read; the commit
phases (create, append, fsync, rename, meta_merge; a group commit's
fsyncs at its flush) feed the ``mt_drive_op_seconds`` histogram, at the
points where ``minio_tpu``'s drive takes them.
"""

from __future__ import annotations

import itertools
import os
import shutil
import stat as stat_mod
import threading
import time
import uuid

from ..admin import metrics as _metrics
from ..hashing.bitrot import bitrot_shard_file_size
from ..obs import lastminute as _lastminute
from . import commit as _commit
from . import errors
from .api import DiskInfo, StorageAPI, VolInfo
from .datatypes import FileInfo
from .xl_meta import XLMeta

SYS_DIR = ".mt.sys"
TMP_DIR = os.path.join(SYS_DIR, "tmp")
META_FILE = "xl.meta"
# mt_drive_op_seconds: tmpfs phases run in microseconds, a failing
# spindle's fsync in hundreds of milliseconds
DRIVE_OP_BUCKETS = (0.000025, 0.00005, 0.0001, 0.00025, 0.0005, 0.001,
                    0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25)


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


class XLStorage(StorageAPI):
    """One local drive."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._disk_id = ""
        self.latency = _lastminute.OpWindows(self.root)
        if not os.path.isdir(self.root):
            raise errors.DiskNotFound(self.root)
        os.makedirs(os.path.join(self.root, TMP_DIR), exist_ok=True)
        # opened on the first packed op; the journal replays then
        self.segments = _commit.SegmentStore(
            os.path.join(self.root, SYS_DIR, _commit.SEG_DIR))

    # -- identity / health -------------------------------------------------

    def is_online(self) -> bool:
        return os.path.isdir(self.root)

    def endpoint(self) -> str:
        return self.root

    def is_local(self) -> bool:
        return True

    def get_disk_id(self) -> str:
        return self._disk_id

    def set_disk_id(self, disk_id: str) -> None:
        self._disk_id = disk_id

    def disk_info(self) -> DiskInfo:
        st = os.statvfs(self.root)
        total = st.f_blocks * st.f_frsize
        free = st.f_bavail * st.f_frsize
        return DiskInfo(total=total, free=free, used=total - free,
                        free_inodes=st.f_favail, endpoint=self.root,
                        mount_path=self.root, disk_id=self._disk_id)

    def close(self) -> None:
        self.segments.close()

    def _prof(self, op: str, t0_ns: int, nbytes: int = 0) -> int:
        """One commit-phase sample since ``t0_ns`` (monotonic) into
        ``mt_drive_op_seconds``; returns now, so phases chain."""
        t1 = time.monotonic_ns()
        _metrics.GLOBAL.observe("mt_drive_op_seconds", {"op": op},
                                (t1 - t0_ns) / 1e9,
                                buckets=DRIVE_OP_BUCKETS)
        return t1

    def reopen(self) -> None:
        """Take back a drive that returned empty and was just formatted
        (``health.HealthDisk.probe``): recreate the staging root and
        forget the segment files that went with the old tree, so staged
        heals land and the next packed write opens a fresh segment
        instead of appending to an unlinked one."""
        os.makedirs(os.path.join(self.root, TMP_DIR), exist_ok=True)
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

    def list_vols(self) -> list[VolInfo]:
        """Every volume but the system volume, by name."""
        out = []
        for name in sorted(os.listdir(self.root)):
            path = os.path.join(self.root, name)
            if name == SYS_DIR or not os.path.isdir(path):
                continue
            out.append(VolInfo(name, int(os.stat(path).st_ctime * 1e9)))
        return out

    def delete_vol(self, volume: str, force: bool = False) -> None:
        """Remove an empty volume (VolumeNotEmpty otherwise), or with
        ``force`` the volume and everything in it."""
        p = self._check_vol(volume)
        try:
            if force:
                shutil.rmtree(p)
            else:
                os.rmdir(p)
        except FileNotFoundError:
            raise errors.VolumeNotFound(volume) from None
        except OSError as e:
            raise errors.VolumeNotEmpty(volume) from e

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

    def create_file(self, volume: str, path: str, data,
                    file_size: int = -1) -> None:
        """Whole-file write into a staging path (``rename_data`` later
        moves the staging dir as a unit); FileCorrupt when ``file_size``
        is given and the data is not that long."""
        if file_size >= 0 and len(data) != file_size:
            raise errors.FileCorrupt(
                f"size mismatch: {len(data)} != {file_size}")
        full = self._file_path(volume, path)
        self._check_vol(volume)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        self._write_phased(full, data,
                           os.O_WRONLY | os.O_CREAT | os.O_TRUNC, "create")

    def append_file(self, volume: str, path: str, data) -> None:
        full = self._file_path(volume, path)
        self._check_vol(volume)
        self._write_phased(full, data,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, "append")

    def _write_phased(self, path: str, data, flags: int, op: str,
                      sync_dir: str | None = None) -> None:
        """``_write_fsync`` with its two commit phases timed: the write
        as ``op``, then the fsync (and of ``sync_dir``, if given)."""
        t0 = time.monotonic_ns()
        fd = os.open(path, flags, 0o644)
        try:
            _commit.write_full(fd, data)
            t0 = self._prof(op, t0, len(data))
            _fsync_fd(fd)
        finally:
            os.close(fd)
        if sync_dir is not None:
            _fsync_dir(sync_dir)
        self._prof("fsync", t0)

    def write_stream(self, volume: str, path: str, chunks,
                     op: str = "create", file_size: int = -1) -> int:
        """``create_file`` or ``append_file`` from an iterator of chunks,
        each written as it arrives (the landing side of a framed RPC
        stream, ``parallel/rpc.py``), one fsync at the end.  A created
        file that fails part way is removed; returns the bytes
        written."""
        full = self._file_path(volume, path)
        self._check_vol(volume)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        created = op != "append"
        flags = os.O_WRONLY | os.O_CREAT | \
            (os.O_TRUNC if created else os.O_APPEND)
        total = 0
        t0 = time.monotonic_ns()
        try:
            fd = os.open(full, flags, 0o644)
            try:
                for chunk in chunks:
                    _commit.write_full(fd, chunk)
                    total += len(chunk)
                if file_size >= 0 and total != file_size:
                    raise errors.FileCorrupt(
                        f"size mismatch: {total} != {file_size}")
                t0 = self._prof("create" if created else "append", t0, total)
                _fsync_fd(fd)
            finally:
                os.close(fd)
        except BaseException:
            if created:
                try:
                    os.remove(full)
                except OSError:
                    pass
            raise
        self._prof("fsync", t0)
        return total

    def list_dir(self, volume: str, dir_path: str,
                 count: int = -1) -> list[str]:
        """The entries of a directory, sorted, subdirectories with a
        trailing slash; with ``count`` > 0 at most that many, the first
        the directory yields."""
        base = self._file_path(volume, dir_path)
        self._check_vol(volume)
        try:
            names = []
            with os.scandir(base) as it:
                for e in it:
                    names.append(e.name + "/" if e.is_dir() else e.name)
                    if 0 < count <= len(names):
                        break
            return sorted(names)
        except (FileNotFoundError, NotADirectoryError):
            raise errors.FileNotFound(dir_path) from None

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        """A whole small file, atomically (tmp, fsync, replace), its
        parent directories created; a missing volume is not."""
        full = self._file_path(volume, path)
        self._check_vol(volume)
        os.makedirs(os.path.dirname(full), exist_ok=True)
        _write_atomic(full, data)
        _fsync_dir(os.path.dirname(full))

    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None:
        src = self._file_path(src_volume, src_path)
        dst = self._file_path(dst_volume, dst_path)
        self._check_vol(src_volume)
        self._check_vol(dst_volume)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            raise errors.FileNotFound(src_path) from None
        _fsync_dir(os.path.dirname(dst))

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

    def read_stream(self, volume: str, path: str, offset: int,
                    length: int, chunk: int):
        """``[offset, offset + length)`` in ``chunk``-sized slices from one
        open (the serving side of a streamed raw read).  The file is
        opened now, so a missing one raises here; a short file raises
        FileCorrupt from the slice that finds its end."""
        full = self._file_path(volume, path)
        try:
            f = open(full, "rb")
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        except PermissionError as e:
            raise errors.FileAccessDenied(path) from e

        def gen():
            with f:
                f.seek(offset)
                left = length
                while left > 0:
                    b = f.read(min(chunk, left))
                    if not b:
                        raise errors.FileCorrupt(
                            f"short read {length - left} < {length} "
                            f"at {path}")
                    left -= len(b)
                    yield b

        return gen()

    def stat_info_file(self, volume: str, path: str) -> int:
        full = self._file_path(volume, path)
        try:
            st = os.stat(full)
        except FileNotFoundError:
            raise errors.FileNotFound(path) from None
        if not stat_mod.S_ISREG(st.st_mode):
            raise errors.IsNotRegular(path)
        return st.st_size

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
        t0 = time.monotonic_ns()
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
        self._prof("meta_merge", t0)
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

    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        """Replace an existing version's entry (FileVersionNotFound when
        the journal lacks it)."""
        meta = self._read_meta(volume, path)
        meta.find(fi.version_id)
        meta.add_version(fi)
        self._write_meta(volume, path, meta)

    def read_version(self, volume: str, path: str,
                     version_id: str | None = None,
                     read_data: bool = False) -> FileInfo:
        """The latest version, or ``version_id`` ("" the null version;
        FileVersionNotFound when the journal lacks it).  Inline data is
        always in it (``read_data`` is the reference's flag, unread
        there too)."""
        return self._read_meta(volume, path).to_fileinfo(volume, path,
                                                         version_id)

    def list_versions(self, volume: str, path: str) -> list[FileInfo]:
        return self._read_meta(volume, path).list_versions(volume, path)

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
        # an iterator of chunks is a framed RPC stream: a part that fails
        # to land, or whose gate aborts, is removed here at once
        streamed = hasattr(data, "__next__")
        try:
            if streamed:
                self.write_stream(volume, os.path.relpath(
                    os.path.join(ddir, "part.1"),
                    self._vol_path(volume)), data)
                _fsync_dir(ddir)
            else:
                self._write_phased(os.path.join(ddir, "part.1"), data,
                                   os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                                   "create", sync_dir=ddir)
        except BaseException:
            if streamed:
                shutil.rmtree(ddir, ignore_errors=True)
            raise
        t0 = time.monotonic_ns()
        if meta_gate is not None:
            try:
                version_dict = meta_gate()
            except BaseException:
                if streamed:
                    shutil.rmtree(ddir, ignore_errors=True)
                raise
            # the wait on the object's MD5 is not drive time
            _IN_OP.exclude_ns = getattr(_IN_OP, "exclude_ns", 0) + \
                time.monotonic_ns() - t0
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
            t0 = time.monotonic_ns()
            os.replace(src_dir, dst_dir)
            t0 = self._prof("rename", t0)
            _fsync_dir(obj_dir)
            self._prof("fsync", t0)
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
        t0 = time.monotonic_ns()
        sid, off = self.segments.append(data, volume, path, fi.version_id)
        t0 = self._prof("create", t0, len(data))
        if col is not None:
            self.segments.defer_sync(col)
            col.seg_bytes += len(data)
        else:
            self.segments.sync()
            self._prof("fsync", t0)
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

    def delete_version(self, volume: str, path: str, fi: FileInfo,
                       force_del_marker: bool = False) -> None:
        """Remove version ``fi.version_id``: its data dir goes unless
        another version shares it, xl.meta is rewritten (or removed with
        the object path when no version is left), then a packed extent is
        freed.  A delete marker (``fi.deleted``) is added as a version
        instead, and with ``force_del_marker`` also where the object has
        no xl.meta (cmd/xl-storage.go DeleteVersion)."""
        self._check_vol(volume)
        try:
            meta = self._read_meta(volume, path)
        except errors.FileNotFound:
            if fi.deleted and force_del_marker:
                self.write_metadata(volume, path, fi)
                return
            raise
        if fi.deleted:
            meta.add_version(fi)
            self._write_meta(volume, path, meta)
            return
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

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        """Check every block digest of every part (cmd/xl-storage.go:2305
        VerifyFile), on the CPU with HighwayHash's plain version;
        FileCorrupt on a size or digest mismatch."""
        import torch
        from ..hashing import bitrot
        ec = fi.erasure
        ss = ec.shard_size()
        for part in fi.parts:
            if fi.seg is not None:
                pf = f"seg.{fi.seg['sid']:08x}+{fi.seg['off']}"
                data = self.segments.read(fi.seg["sid"], fi.seg["off"],
                                          fi.seg["len"])
            else:
                pf = os.path.join(path, fi.data_dir, f"part.{part.number}")
                data = self.read_all(volume, pf)
            length = ec.shard_file_size(part.size)
            want = bitrot_shard_file_size(
                length, ss, ec.get_checksum_info(part.number).algorithm)
            if len(data) != want:
                raise errors.FileCorrupt(f"{pf}: size {len(data)} != {want}")
            if not length:
                continue
            try:
                bitrot.verify_extract(
                    torch.frombuffer(bytearray(data), dtype=torch.uint8),
                    ss, length)
            except bitrot.BitrotError as e:
                raise errors.FileCorrupt(f"{pf}: {e}") from e

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

    # -- walking -----------------------------------------------------------

    def walk_dir(self, volume: str, base_dir: str = "", after: str = "",
                 recursive: bool = True):
        """Object names (directories holding xl.meta) under ``base_dir``
        in flat key order, the byte order S3 listings promise
        (cmd/metacache-walk.go WalkDir): a subtree ``x`` holds keys
        ``x/...``, which sort after a sibling object ``x-1`` ('-' < '/'),
        so subtrees sort by ``name + "/"`` and objects by ``name``.  Each
        drive's stream being sorted lets the listing merge them lazily.
        A subtree whose every name sorts before ``after`` is not entered,
        so a page that resumes late in the namespace walks little.
        Without ``recursive`` only ``base_dir`` itself is yielded, if it
        is an object."""
        vol = self._check_vol(volume)
        base = self._file_path(volume, base_dir) if base_dir else vol

        def walk(d: str):
            try:
                entries = sorted(os.scandir(d), key=lambda e: e.name)
            except (FileNotFoundError, NotADirectoryError):
                return
            rel = os.path.relpath(d, vol).replace(os.sep, "/")
            if any(e.name == META_FILE for e in entries):
                yield rel
                return
            under = "" if rel == "." else rel + "/"
            keyed = []
            for e in entries:
                if not e.is_dir():
                    continue
                sub = under + e.name + "/"
                if sub < after and not after.startswith(sub):
                    continue        # ``name`` and ``name/...`` < after
                leaf = os.path.isfile(os.path.join(e.path, META_FILE))
                keyed.append((e.name if leaf else e.name + "/", e.path))
            if recursive:
                for _, path in sorted(keyed):
                    yield from walk(path)

        yield from walk(base)

    def walk_entries(self, volume: str, base_dir: str = "",
                     versions: bool = False, after: str = "",
                     recursive: bool = True):
        """``(name, FileInfo of its latest version)`` per object, in
        ``walk_dir`` order: part-file, inline and packed objects alike;
        with ``versions``, ``(name, [FileInfo of every version, newest
        first])``.  Names before ``after`` are passed over unread (a
        listing page resumes there).  An entry whose xl.meta does not
        read is skipped (the other drives decide it)."""
        for name in self.walk_dir(volume, base_dir, after, recursive):
            if name < after:
                continue
            try:
                yield name, (self.list_versions(volume, name) if versions
                             else self.read_version(volume, name))
            except errors.StorageError:
                continue

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


# -- per-op latency windows ---------------------------------------------------

_TIMED_OPS = ("read_all", "read_file_stream", "write_all", "create_file",
              "append_file", "write_data_commit", "write_packed",
              "read_segment", "rename_data", "rename_file",
              "write_metadata", "read_version", "list_versions",
              "delete_version", "delete", "list_dir", "check_parts")
# the payload's position after ``self`` for the write ops; the read ops
# count the bytes they return
_OP_IN_ARG = {"write_all": 2, "create_file": 2, "append_file": 2,
              "write_data_commit": 3, "write_packed": 3}
# drive ops call each other (a meta read goes through read_all): only
# the outermost call records, so one logical op counts once
_IN_OP = threading.local()


def _timed_op(op: str, fn, in_arg: int | None):
    def timed(self, *a, **kw):
        if getattr(_IN_OP, "depth", 0):
            return fn(self, *a, **kw)
        _IN_OP.depth = 1
        _IN_OP.exclude_ns = 0
        t0 = time.monotonic_ns()
        out = None
        try:
            out = fn(self, *a, **kw)
            return out
        finally:
            _IN_OP.depth = 0
            dt = max(0, time.monotonic_ns() - t0 - _IN_OP.exclude_ns)
            nbytes = 0
            if in_arg is not None:
                data = a[in_arg] if len(a) > in_arg else kw.get("data")
                nbytes = len(data) if hasattr(data, "__len__") else 0
            elif isinstance(out, (bytes, bytearray)):
                nbytes = len(out)
            self.latency.record(op, dt, nbytes)
    timed.__name__ = op
    timed.__qualname__ = f"XLStorage.{op}"
    timed.__doc__ = fn.__doc__
    timed.__wrapped__ = fn
    return timed


for _op in _TIMED_OPS:
    setattr(XLStorage, _op,
            _timed_op(_op, getattr(XLStorage, _op), _OP_IN_ARG.get(_op)))
