"""One erasure set doing PUT, ranged and degraded GET, delete and heal
(cmd/erasure-object.go), with the data path on a device.

  * PUT: objects up to 128 KiB are framed into xl.meta (inline); larger
    ones are encoded in 64 MiB stripe batches (a whole number of blocks),
    each batch one Kernel A launch for the parity and one Kernel B launch
    for the bitrot digests (a short last block adds one of each) — or, on
    a mesh set, one Kernel C launch for both (``rs_mesh``) — then
    written to the drives: one ``write_data_commit`` per drive when the
    object fits one batch, else tmp create/append and a quorum
    ``rename_data`` at the end.
  * GET: per batch of blocks, read the framed ranges of k shards that
    hold the quorum version (inline, in part files, or in a packed segment
    that ``minio_tpu`` wrote), verify them on the device (Kernel B), extend
    into parity shards on failure, and rebuild missing data shards in one
    launch (Kernel A).
  * heal: ``healing.heal_object``.

The ETag is the body's MD5 (the reference's strict-compat mode).  Calls
are serial: one lock per set, no writer plane, no caches, no MRF queue.
The on-disk result equals ``minio_tpu``'s for the same body, geometry and
block size.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..hashing import bitrot
from ..ops import gf8, rs_kernels, rs_mesh
from ..ops.codec import Erasure
from ..parallel.mesh import Mesh
from ..storage import errors as serrors
from ..storage.datatypes import (ChecksumInfo, ErasureInfo, FileInfo,
                                 ObjectPartInfo, now_ns)
from ..storage.xl_storage import SYS_DIR
from . import metadata as meta
from .interface import (BucketExists, BucketNotFound, InvalidRange,
                        ObjectInfo, ObjectNotFound, PutObjectOptions,
                        ReadQuorumError, WriteQuorumError)

# blockSizeV1 (cmd/object-api-common.go:32)
DEFAULT_BLOCK_SIZE = 10 * 1024 * 1024
INLINE_THRESHOLD = 128 * 1024           # small objects live in xl.meta
STREAM_BATCH_BYTES = 64 * 1024 * 1024   # bytes of body encoded per batch
ETAG_KEY = "etag"


def default_parity_count(drive_count: int) -> int:
    """Default parity by set size (cmd/format-erasure.go:896-906)."""
    if drive_count <= 1:
        return 0
    if drive_count <= 3:
        return 1
    if drive_count <= 5:
        return 2
    if drive_count <= 7:
        return 3
    return 4


def _write_quorum(k: int, m: int) -> int:
    return k + 1 if k == m else k


def _chunks(data, batch: int):
    """The body as ``batch``-byte chunks (the last may be short)."""
    if hasattr(data, "read"):
        while True:
            parts, left = [], batch
            while left:
                c = data.read(left)
                if not c:
                    break
                parts.append(c)
                left -= len(c)
            chunk = b"".join(parts)
            if chunk:
                yield chunk
            if left:
                return
    else:
        mv = memoryview(data).cast("B")
        for off in range(0, len(mv), batch):
            yield mv[off:off + batch]


class ErasureObjects:
    """One erasure set over ``len(disks)`` drives (cmd/erasure.go:48)."""

    def __init__(self, disks: list, parity: Optional[int] = None,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 device: str | torch.device = "cuda",
                 mesh: Optional[Mesh] = None):
        """``mesh``: run the data path on that device mesh (the mesh data
        plane, ``minio_tpu``'s ``backend="mesh"``); ``device`` is then not
        read."""
        if not disks:
            raise ValueError("no disks")
        self.disks = list(disks)
        n = len(self.disks)
        self.parity = default_parity_count(n) if parity is None else parity
        self.data_blocks = n - self.parity
        if self.data_blocks <= 0:
            raise ValueError("parity too large for drive count")
        self.block_size = block_size
        self.codec = Erasure(self.data_blocks, self.parity, block_size,
                             device=device, mesh=mesh)
        self.device = self.codec.device
        self._pool = ThreadPoolExecutor(max_workers=n)
        self._lock = threading.Lock()

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    # -- drive fan-out -----------------------------------------------------

    def _fanout(self, fn, items) -> tuple[list, list]:
        """fn(item) for every item concurrently; (results, errors)
        aligned with items.  A None item is an offline drive."""

        def run(x):
            if x is None:
                return None, serrors.DiskNotFound("offline")
            try:
                return fn(x), None
            except OSError as e:          # StorageError, BitrotError, I/O
                return None, e

        out = list(self._pool.map(run, items))
        return [r for r, _ in out], [e for _, e in out]

    # -- buckets -----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        with self._lock:
            _, errs = self._fanout(lambda d: d.make_vol(bucket), self.disks)
            wq = _write_quorum(self.data_blocks, self.parity)
            if sum(isinstance(e, serrors.VolumeExists) for e in errs) >= wq:
                raise BucketExists(bucket)
            meta.reduce_errs([None if isinstance(e, serrors.VolumeExists)
                              else e for e in errs], wq, WriteQuorumError)

    def _check_bucket(self, bucket: str) -> None:
        res, _ = self._fanout(lambda d: d.stat_vol(bucket), self.disks)
        if all(r is None for r in res):
            raise BucketNotFound(bucket)

    # -- PUT (cmd/erasure-object.go:614 putObject) -------------------------

    def _batch_bytes(self) -> int:
        return max(1, STREAM_BATCH_BYTES // self.block_size) * self.block_size

    def _encode_and_frame(self, chunk) -> np.ndarray:
        """Encode one batch of blocks and frame every shard on the device;
        returns the (k + m, framed_len) on-disk bytes on the host."""
        codec = self.codec
        if codec.mesh is not None:
            framed = rs_mesh.encode_object_framed_fused(
                codec.data_blocks, codec.parity_blocks, codec.block_size,
                chunk, mesh=codec.mesh)
        else:
            framed = bitrot.frame_batch(codec.encode_object(chunk),
                                        codec.shard_size())
        return framed.cpu().numpy()

    def put_object(self, bucket: str, object_name: str, data,
                   opts: Optional[PutObjectOptions] = None) -> ObjectInfo:
        """PUT from bytes-like ``data`` or a reader with ``.read(n)``."""
        opts = opts or PutObjectOptions()
        n, k, m = len(self.disks), self.data_blocks, self.parity
        with self._lock:
            self._check_bucket(bucket)
            mod_time = opts.mod_time or now_ns()
            distribution = meta.hash_order(f"{bucket}/{object_name}", n)
            fi = FileInfo(
                volume=bucket, name=object_name, data_dir=str(uuid.uuid4()),
                mod_time=mod_time,
                erasure=ErasureInfo(
                    data_blocks=k, parity_blocks=m,
                    block_size=self.block_size, distribution=distribution,
                    checksums=[ChecksumInfo(1, bitrot.HIGHWAYHASH256S)]))
            shuffled = meta.shuffle_disks(self.disks, distribution)
            chunks = _chunks(data, self._batch_bytes())
            first = next(chunks, b"")
            second = next(chunks, None)
            if second is None:
                self._put_single(fi, first, opts, shuffled)
            else:
                self._put_streaming(
                    fi, itertools.chain((first, second), chunks), opts,
                    shuffled)
            return self._to_object_info(fi)

    def _stamp(self, fi: FileInfo, size: int, etag: str,
               opts: PutObjectOptions) -> None:
        fi.size = size
        fi.metadata = {ETAG_KEY: etag, **opts.user_defined}
        fi.parts = [ObjectPartInfo(1, size, size, etag, fi.mod_time)]

    def _put_single(self, fi: FileInfo, data, opts: PutObjectOptions,
                    shuffled: list) -> None:
        """The whole body in one batch: inline into xl.meta, or one
        direct part-file commit per drive."""
        self._stamp(fi, len(data), hashlib.md5(data).hexdigest(), opts)
        framed = self._encode_and_frame(data)
        inline = fi.size <= INLINE_THRESHOLD

        def write_one(pair):
            idx, disk = pair
            if disk is None:
                raise serrors.DiskNotFound("offline")
            if inline:
                dfi = _disk_fileinfo(fi, idx)
                dfi.inline_data = framed[idx].tobytes()
                dfi.data_dir = ""
                disk.write_metadata(fi.volume, fi.name, dfi)
            else:
                disk.write_data_commit(fi.volume, fi.name, fi, framed[idx],
                                       shard_index=idx + 1)

        _, errs = self._fanout(write_one, list(enumerate(shuffled)))
        self._reduce_write(errs, fi)

    def _reduce_write(self, errs: list, fi: FileInfo) -> None:
        wq = _write_quorum(fi.erasure.data_blocks, fi.erasure.parity_blocks)
        try:
            meta.reduce_errs(errs, wq, WriteQuorumError)
        except serrors.VolumeNotFound:
            raise BucketNotFound(fi.volume) from None
        except serrors.StorageError as e:
            raise WriteQuorumError(str(e)) from e

    def _put_streaming(self, fi: FileInfo, chunks, opts: PutObjectOptions,
                       shuffled: list) -> None:
        """Batch by batch into per-drive staging files, then one
        ``rename_data`` per drive (cmd/erasure-encode.go:80-107)."""
        n = len(shuffled)
        wq = _write_quorum(fi.erasure.data_blocks, fi.erasure.parity_blocks)
        tmps: list[Optional[str]] = [None] * n
        errs: list[Optional[Exception]] = [None] * n
        md5 = hashlib.md5()
        total = 0
        try:
            for chunk in chunks:
                md5.update(chunk)
                total += len(chunk)
                framed = self._encode_and_frame(chunk)

                def write_batch(idx, framed=framed):
                    disk = shuffled[idx]
                    if disk is None:
                        raise serrors.DiskNotFound("offline")
                    if tmps[idx] is None:
                        tmps[idx] = disk.tmp_dir()
                        disk.create_file(SYS_DIR, f"{tmps[idx]}/part.1",
                                         framed[idx])
                    else:
                        disk.append_file(SYS_DIR, f"{tmps[idx]}/part.1",
                                         framed[idx])

                live = [i for i in range(n) if errs[i] is None]
                _, werrs = self._fanout(write_batch, live)
                for i, e in zip(live, werrs):
                    errs[i] = e
                alive = sum(e is None for e in errs)
                if alive < wq:
                    raise WriteQuorumError(
                        f"{alive} of {n} drives writable, need {wq}")
            self._stamp(fi, total, md5.hexdigest(), opts)

            def commit_one(idx):
                if errs[idx] is not None:
                    raise errs[idx]
                shuffled[idx].rename_data(SYS_DIR, tmps[idx],
                                          _disk_fileinfo(fi, idx),
                                          fi.volume, fi.name)

            _, cerrs = self._fanout(commit_one, list(range(n)))
            self._reduce_write(cerrs, fi)
        finally:
            for disk, tmp in zip(shuffled, tmps):
                if tmp is not None:
                    disk.clean_tmp(tmp)

    # -- GET (cmd/erasure-object.go:242 getObjectWithFileInfo) -------------

    def _read_quorum_fileinfo(self, bucket: str, object_name: str
                              ) -> tuple[FileInfo, list]:
        fis, errs = self._fanout(
            lambda d: d.read_version(bucket, object_name), self.disks)
        nf = sum(isinstance(e, (serrors.FileNotFound,
                                serrors.FileVersionNotFound)) for e in errs)
        if nf > len(self.disks) // 2:
            raise ObjectNotFound(f"{bucket}/{object_name}")
        fi = meta.find_file_info_in_quorum(fis, max(1, len(self.disks) // 2))
        if fi.deleted:
            raise ObjectNotFound(f"{bucket}/{object_name} is a delete marker")
        return fi, fis

    def get_object_info(self, bucket: str, object_name: str) -> ObjectInfo:
        with self._lock:
            self._check_bucket(bucket)
            fi, _ = self._read_quorum_fileinfo(bucket, object_name)
            return self._to_object_info(fi)

    def get_object(self, bucket: str, object_name: str, offset: int = 0,
                   length: int = -1) -> tuple[ObjectInfo, bytes]:
        """The object's bytes [offset, offset + length): HTTP range rules
        (negative offset = suffix, length < 0 = to the end, overlong
        ranges clamp, a start past the end is InvalidRange)."""
        with self._lock:
            self._check_bucket(bucket)
            fi, fis = self._read_quorum_fileinfo(bucket, object_name)
            size = fi.size
            if offset < 0:
                offset = max(0, size + offset)
            if length < 0:
                length = size - offset
            if offset > size or (size > 0 and offset == size):
                raise InvalidRange(f"{offset}+{length} vs {size}")
            length = min(length, size - offset)
            info = self._to_object_info(fi)
            if size == 0 or length == 0:
                return info, b""
            return info, b"".join(self._read_range(fi, fis, offset, length))

    def _read_range(self, fi: FileInfo, fis: list, offset: int, length: int):
        """The range, one batch of blocks at a time.  A shard that fails
        stays dead for the rest of the read (parallelReader,
        cmd/erasure-decode.go:120-188)."""
        ec = fi.erasure
        k, m, bs, ss = ec.data_blocks, ec.parity_blocks, ec.block_size, \
            ec.shard_size()
        hlen = bitrot.digest_size()
        if len(fi.parts) != 1:
            raise ReadQuorumError("multipart objects are not in this slice")
        part = fi.parts[0]
        shuffled = meta.shuffle_disks(self.disks, ec.distribution)
        sfis = meta.shuffle_parts_metadata(fis, ec.distribution)
        # only drives holding the quorum version are read: a drive that
        # missed an overwrite keeps a self-consistent old shard, which
        # would pass the bitrot check (listOnlineDisks)
        dead = {j for j in range(k + m)
                if shuffled[j] is None or not meta.same_version(sfis[j], fi)}
        batch_blocks = max(1, self._batch_bytes() // bs)
        sfsize = ec.shard_file_size(part.size)
        end = offset + length
        for bb0 in range(offset // bs, -(-end // bs), batch_blocks):
            bb1 = min(bb0 + batch_blocks, -(-end // bs))
            seg_off = bb0 * ss
            seg_len = min(bb1 * ss, sfsize) - seg_off
            covered = min(bb1 * bs, part.size) - bb0 * bs
            got = self._read_verified(
                fi, part.number, shuffled, sfis, dead,
                seg_off + bb0 * hlen, seg_len + (bb1 - bb0) * hlen, seg_len)
            body = _assemble(self.codec, got, fi, covered)
            lo = max(offset - bb0 * bs, 0)
            hi = min(end - bb0 * bs, covered)
            yield body[lo:hi].tobytes()

    def _read_verified(self, fi: FileInfo, part_number: int, shuffled: list,
                       sfis: list, dead: set, framed_off: int,
                       framed_len: int, seg_len: int) -> dict:
        """Read one framed window from k healthy shards, verified on the
        device; failures extend into the next shards.  Every shard not in
        ``dead`` holds the quorum version (``sfis``).  Returns
        {shard index: payload (seg_len,) tensor on the device}."""
        k = fi.erasure.data_blocks
        ss = fi.erasure.shard_size()
        path = f"{fi.name}/{fi.data_dir}/part.{part_number}"

        def read_one(j):
            disk, dfi = shuffled[j], sfis[j]
            if dfi.inline_data is not None:
                framed = dfi.inline_data[framed_off:framed_off + framed_len]
                if len(framed) < framed_len:
                    raise serrors.FileCorrupt("short inline data")
                return framed
            if dfi.seg is not None:             # a packed extent
                return disk.read_segment(dfi.seg["sid"],
                                         dfi.seg["off"] + framed_off,
                                         framed_len)
            return disk.read_file_stream(fi.volume, path, framed_off,
                                         framed_len)

        got: dict[int, torch.Tensor] = {}
        candidates = [j for j in range(len(shuffled)) if j not in dead]
        while len(got) < k and candidates:
            batch = candidates[:k - len(got)]
            candidates = candidates[len(batch):]
            res, errs = self._fanout(read_one, batch)
            read = [(j, r) for j, r, e in zip(batch, res, errs) if e is None]
            dead.update(j for j, e in zip(batch, errs) if e is not None)
            if not read:
                continue
            framed = np.stack([np.frombuffer(r, dtype=np.uint8)
                               for _, r in read])
            try:
                payload, ok = bitrot.verify_frames(
                    torch.from_numpy(framed).to(self.device), ss, seg_len)
            except bitrot.BitrotError:
                dead.update(j for j, _ in read)
                continue
            for (j, _), good, row in zip(read, ok.tolist(), payload):
                if good:
                    got[j] = row
                else:
                    dead.add(j)
        if len(got) < k:
            raise ReadQuorumError(f"only {len(got)} of {k} shards readable")
        return got

    # -- DELETE ------------------------------------------------------------

    def delete_object(self, bucket: str, object_name: str) -> ObjectInfo:
        """Remove the object from every drive; absent objects delete
        quietly (S3 DELETE is idempotent)."""
        with self._lock:
            self._check_bucket(bucket)
            _, errs = self._fanout(
                lambda d: d.delete(bucket, object_name, recursive=True),
                self.disks)
            errs = [None if isinstance(e, serrors.FileNotFound) else e
                    for e in errs]
            wq = _write_quorum(self.data_blocks, self.parity)
            meta.reduce_errs(errs, wq, WriteQuorumError)
            return ObjectInfo(bucket=bucket, name=object_name)

    # -- heal --------------------------------------------------------------

    def heal_object(self, bucket: str, object_name: str):
        from . import healing
        with self._lock:
            return healing.heal_object(self, bucket, object_name)

    # -- helpers -----------------------------------------------------------

    def _to_object_info(self, fi: FileInfo) -> ObjectInfo:
        md = dict(fi.metadata)
        return ObjectInfo(
            bucket=fi.volume, name=fi.name, mod_time=fi.mod_time,
            size=fi.size, etag=md.pop(ETAG_KEY, ""),
            version_id=fi.version_id, is_latest=fi.is_latest,
            delete_marker=fi.deleted,
            content_type=md.get("content-type", ""),
            user_defined=md, parity=fi.erasure.parity_blocks,
            data_blocks=fi.erasure.data_blocks,
            num_versions=fi.num_versions,
            parts=[(p.number, p.size) for p in fi.parts])


def _disk_fileinfo(fi: FileInfo, shard_idx: int) -> FileInfo:
    """fi as drive ``shard_idx`` (0-based, shuffled order) stores it."""
    dfi = FileInfo(**{**fi.__dict__})
    dfi.erasure = ErasureInfo(**{**fi.erasure.__dict__})
    dfi.erasure.index = shard_idx + 1
    dfi.inline_data = None
    dfi.seg = None
    return dfi


def rebuild(codec: Erasure, rows: np.ndarray, surv: torch.Tensor,
            nfull: int, ss: int, out: torch.Tensor) -> None:
    """out[j] = rows[j] (GF) @ surv over a shard-file segment through the
    codec's GF engine: all full stripes in one launch, the short last
    stripe in one more.  surv: (k, L) survivor payloads, out:
    (len(rows), L)."""
    if nfull:
        span = nfull * ss
        codec.apply_matrix(
            rows, surv[:, :span].unflatten(1, (nfull, ss)).transpose(0, 1),
            out=out[:, :span].unflatten(1, (nfull, ss)).transpose(0, 1))
    if surv.shape[1] > nfull * ss:
        codec.apply_matrix(rows, surv[:, nfull * ss:],
                           out=out[:, nfull * ss:])


def _assemble(codec: Erasure, got: dict, fi: FileInfo,
              covered: int) -> np.ndarray:
    """Rebuild missing data shards of a segment and concatenate the data
    blocks without their padding (writeDataBlocks, cmd/erasure-utils.go:40);
    returns ``covered`` bytes on the host."""
    ec = fi.erasure
    k, m, bs, ss = ec.data_blocks, ec.parity_blocks, ec.block_size, \
        ec.shard_size()
    nfull, tail = divmod(covered, bs)
    present = sorted(got)[:k]
    missing = [i for i in range(k) if i not in got]
    any_row = got[present[0]]
    data = any_row.new_empty((k, any_row.numel()))
    for i in range(k):
        if i in got:
            data[i] = got[i]
    if missing:
        rows = rs_kernels.decode_rows(gf8.rs_matrix(k, k + m), k, present,
                                      missing)
        rebuilt = any_row.new_empty((len(missing), any_row.numel()))
        rebuild(codec, rows, torch.stack([got[i] for i in present]), nfull,
                ss, rebuilt)
        data[missing] = rebuilt
    out = any_row.new_empty(covered)
    if nfull:
        out[:nfull * bs].view(nfull, bs).copy_(
            data[:, :nfull * ss].unflatten(1, (nfull, ss)).transpose(0, 1)
            .reshape(nfull, k * ss)[:, :bs])
    if tail:
        out[nfull * bs:] = data[:, nfull * ss:].reshape(-1)[:tail]
    return out.cpu().numpy()
