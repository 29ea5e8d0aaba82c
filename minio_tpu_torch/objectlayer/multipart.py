"""Multipart uploads (``minio_tpu/objectlayer/multipart.py``,
cmd/erasure-multipart.go), the ``MultipartOps`` mixin of the port's
``ErasureObjects``.

An upload stages on every drive under the system volume at
``multipart/<sha256(bucket/object)>/<uploadID>/``: an xl.meta with the
upload's geometry, data dir and metadata (``__versioned``, ``__bucket``,
``__object`` ride in it and are dropped at complete), one framed shard
file ``part.N`` per part and a sidecar ``part.N.meta`` holding
``<md5>:<size>``.  The upload's geometry is the set's, or that of the
parity its storage class asked for (``PutObjectOptions.parity``), and
every part is encoded in it, whichever package began the upload.  A
part streams through the set's PUT pipeline (a
chained hashlib MD5, encode + frame on the device, the drives' writer
queues) into a uniquely named staging file, then is promoted by rename,
so a retried or concurrent upload of the same part never truncates one
that verified.  A part is always a part file, never inline or packed.
Complete checks the parts against the client's list (ascending, ETags
equal, every part but the last at least ``MIN_PART_SIZE``), renames the
staged part files into the object's data dir with one ``rename_data``
per drive and stamps the ETag ``md5(concat(part md5s))-N``.
"""

from __future__ import annotations

import hashlib
import time
import uuid
from typing import Optional

from ..hashing.bitrot import HIGHWAYHASH256S
from ..storage import errors as serrors
from ..storage.datatypes import (ChecksumInfo, ErasureInfo, FileInfo,
                                 ObjectPartInfo, now_ns)
from ..storage.xl_storage import SYS_DIR
from . import metadata as meta
from .interface import (BadDigest, InvalidPart, InvalidPartOrder,
                        InvalidUploadID, MultipartInfo, ObjectInfo,
                        PartInfo, PutObjectOptions, WriteQuorumError)

MIN_PART_SIZE = 5 * 1024 * 1024     # S3's limit; the last part is exempt
MAX_PARTS = 10_000                  # docs/minio-limits.md


def _mp_dir(bucket: str, object_name: str, upload_id: str) -> str:
    h = hashlib.sha256(f"{bucket}/{object_name}".encode()).hexdigest()
    return f"multipart/{h}/{upload_id}"


def _indexed(shuffled: list) -> list:
    """(shard index, drive) per drive of ``shuffled``, None when
    offline: the items of an ``ErasureObjects._fanout``."""
    return [None if d is None else (i, d) for i, d in enumerate(shuffled)]


class MultipartOps:
    """The multipart side of ``ErasureObjects``."""

    def _reduce_quorum(self, errs: list, wq: int) -> None:
        try:
            meta.reduce_errs(errs, wq, WriteQuorumError)
        except serrors.StorageError as e:
            raise WriteQuorumError(str(e)) from e

    def _set_write_quorum(self) -> int:
        from .erasure_object import _write_quorum
        return _write_quorum(self.data_blocks, self.parity)

    @staticmethod
    def _fi_write_quorum(fi: FileInfo) -> int:
        from .erasure_object import _write_quorum
        return _write_quorum(fi.erasure.data_blocks, fi.erasure.parity_blocks)

    def new_multipart_upload(self, bucket: str, object_name: str,
                             opts: Optional[PutObjectOptions] = None) -> str:
        """Stage the upload's xl.meta on every drive; returns its id."""
        opts = opts or PutObjectOptions()
        self._check_bucket(bucket)
        upload_id = uuid.uuid4().hex
        mp = _mp_dir(bucket, object_name, upload_id)
        distribution = meta.hash_order(f"{bucket}/{object_name}",
                                       len(self.disks))
        k, m = self._geometry(opts.parity)
        fi = FileInfo(
            volume=bucket, name=object_name, version_id="",
            data_dir=str(uuid.uuid4()), mod_time=now_ns(),
            metadata={**opts.user_defined,
                      "__versioned": "1" if opts.versioned else "0",
                      "__bucket": bucket, "__object": object_name},
            erasure=ErasureInfo(
                data_blocks=k, parity_blocks=m,
                block_size=self.block_size, distribution=distribution))
        from .erasure_object import _disk_fileinfo

        def init_one(item):
            idx, disk = item
            disk.write_metadata(SYS_DIR, mp, _disk_fileinfo(fi, idx))

        shuffled = meta.shuffle_disks(self.disks, distribution)
        _, errs = self._fanout(init_one, _indexed(shuffled))
        self._reduce_quorum(errs, self._fi_write_quorum(fi))
        return upload_id

    def _mp_fileinfo(self, bucket: str, object_name: str,
                     upload_id: str) -> FileInfo:
        """The upload's quorum xl.meta; InvalidUploadID when fewer than
        half the drives hold it."""
        mp = _mp_dir(bucket, object_name, upload_id)
        fis, _ = self._fanout(lambda d: d.read_version(SYS_DIR, mp),
                              self.disks)
        quorum = max(1, len(self.disks) // 2)
        if sum(fi is not None for fi in fis) < quorum:
            raise InvalidUploadID(upload_id)
        return meta.find_file_info_in_quorum(fis, quorum)

    def put_object_part(self, bucket: str, object_name: str, upload_id: str,
                        part_number: int, data,
                        content_md5: Optional[str] = None) -> PartInfo:
        """PutObjectPart (cmd/erasure-multipart.go:342) from bytes or a
        reader with ``.read(n)``, one stream batch at a time, in the
        upload's geometry.  ``content_md5`` (hex): the part must hash to
        it (BadDigest otherwise, and nothing is promoted)."""
        if not 1 <= part_number <= MAX_PARTS:
            raise InvalidPart(f"part number {part_number}")
        self._check_bucket(bucket)
        fi = self._mp_fileinfo(bucket, object_name, upload_id)
        ec = fi.erasure
        mp = _mp_dir(bucket, object_name, upload_id)
        from .erasure_object import _read_full
        batch = self._batch_bytes()
        if hasattr(data, "read"):
            def reader_chunks(reader=data):
                first = True
                while True:
                    c = _read_full(reader, batch)
                    if c or first:      # an empty body still stages a part
                        yield c
                    first = False
                    if len(c) < batch:
                        return
            chunks = reader_chunks()
        else:
            mv = memoryview(data).cast("B")
            chunks = (mv[o:o + batch]
                      for o in range(0, max(1, len(mv)), batch))
        shuffled = meta.shuffle_disks(self.disks, ec.distribution)
        staging = f"{mp}/part.{part_number}.in.{uuid.uuid4().hex[:8]}"
        run = (self._put_part_pipelined if self._pipeline_on()
               else self._put_part_serial)
        etag, size = run(chunks, shuffled, staging, content_md5,
                         self._fi_codec(fi), self._fi_write_quorum(fi))
        return PartInfo(part_number, etag, size, size, now_ns())

    def _promote(self, mp_part: str, staging: str, etag: str, size: int):
        """The per-drive promote: the staged file renamed to
        ``part.N``, then its sidecar, which complete reads."""
        def promote(disk):
            disk.rename_file(SYS_DIR, staging, SYS_DIR, mp_part)
            disk.write_all(SYS_DIR, f"{mp_part}.meta",
                           f"{etag}:{size}".encode())
        return promote

    @staticmethod
    def _check_md5(etag: str, content_md5: Optional[str]) -> None:
        if content_md5 and etag != content_md5.lower():
            raise BadDigest(f"Content-MD5 {content_md5} but the part's "
                            f"is {etag}")

    def _put_part_pipelined(self, chunks, shuffled: list, staging: str,
                            content_md5: Optional[str], codec,
                            wq: int) -> tuple[str, int]:
        """The part on the writer plane: the streaming PUT's pump
        (chained MD5, encode into a pooled buffer, the drives' queues),
        then the promote on every drive that kept up."""
        n = len(shuffled)
        started = [False] * n
        md5 = hashlib.md5()
        stats = {"md5_s": 0.0, "encode_s": 0.0, "body_wait_s": 0.0}
        sw = self._write_plane.stream(shuffled)
        mp_part = staging.rsplit(".in.", 1)[0]
        t_wall = time.perf_counter()
        try:
            def write_batch_for(framed):
                def write_batch(idx, disk):
                    if not started[idx]:
                        started[idx] = True
                        disk.create_file(SYS_DIR, staging, framed[idx])
                    else:
                        disk.append_file(SYS_DIR, staging, framed[idx])
                return write_batch

            size, _ = self._pump_put_pipeline(chunks, sw, md5, stats,
                                              write_batch_for, wq, codec)
            etag = md5.hexdigest()
            self._check_md5(etag, content_md5)
            t0 = time.perf_counter()
            sw.drain()
            alive = sw.alive()
            if alive < wq:
                raise WriteQuorumError(
                    f"{alive} of {n} drives writable, need {wq}")
            t1 = time.perf_counter()
            promote = self._promote(mp_part, staging, etag, size)
            sw.submit_batch(lambda idx, disk: promote(disk))
            sw.drain()
            self._reduce_quorum(list(sw.errs), wq)
            t2 = time.perf_counter()
            # stage seconds of this part: waiting on the body, MD5 and
            # encode + frame (beside the drive writes), the wait for the
            # drive writes after the last batch, the promote
            self.part_stats.append(dict(
                stats, wall_s=t2 - t_wall, writes_wait_s=t1 - t0,
                promote_s=t2 - t1, bytes=size))
            return etag, size
        finally:
            sw.abort()
            sw.drain(timeout=10.0)
            # a staging file that was not promoted goes, once its drive
            # settled (a drive stuck past the wait cleans up when its op
            # settles, so a late append cannot bring the file back)
            for idx, disk in enumerate(shuffled):
                if disk is not None and started[idx]:
                    sw.when_drive_idle(
                        idx, lambda d=disk: _delete_quietly(d, staging))

    def _put_part_serial(self, chunks, shuffled: list, staging: str,
                         content_md5: Optional[str], codec,
                         wq: int) -> tuple[str, int]:
        """One fan-out round per batch, then the promote (the single-core
        path: the same bytes on the drives)."""
        n = len(shuffled)
        errs: list[Optional[Exception]] = [None] * n
        started = [False] * n
        md5 = hashlib.md5()
        size = 0
        mp_part = staging.rsplit(".in.", 1)[0]
        try:
            for chunk in chunks:
                md5.update(chunk)
                size += len(chunk)
                framed, release = self._encode_framed_pooled(chunk, codec)

                def write_batch(item, framed=framed):
                    idx, disk = item
                    if not started[idx]:
                        started[idx] = True
                        disk.create_file(SYS_DIR, staging, framed[idx])
                    else:
                        disk.append_file(SYS_DIR, staging, framed[idx])

                live = [None if d is None or errs[i] is not None
                        else (i, d) for i, d in enumerate(shuffled)]
                try:
                    _, werrs = self._fanout(write_batch, live)
                finally:
                    release()
                for i, e in enumerate(werrs):
                    if errs[i] is None and live[i] is not None:
                        errs[i] = e
                alive = sum(1 for i, d in enumerate(shuffled)
                            if d is not None and errs[i] is None)
                if alive < wq:
                    raise WriteQuorumError(
                        f"{alive} of {n} drives writable, need {wq}")
            etag = md5.hexdigest()
            self._check_md5(etag, content_md5)
            promote = self._promote(mp_part, staging, etag, size)

            def promote_one(item):
                idx, disk = item
                if errs[idx] is not None:
                    raise errs[idx]
                promote(disk)

            _, perrs = self._fanout(promote_one, _indexed(shuffled))
            self._reduce_quorum(perrs, wq)
            return etag, size
        finally:
            self._fanout(lambda item: started[item[0]]
                         and _delete_quietly(item[1], staging),
                         _indexed(shuffled))

    def get_multipart_info(self, bucket: str, object_name: str,
                           upload_id: str) -> MultipartInfo:
        self._check_bucket(bucket)
        fi = self._mp_fileinfo(bucket, object_name, upload_id)
        return MultipartInfo(bucket, object_name, upload_id,
                             {k: v for k, v in fi.metadata.items()
                              if not k.startswith("__")})

    def list_object_parts(self, bucket: str, object_name: str,
                          upload_id: str) -> list[PartInfo]:
        """The promoted parts, by number, merged over every drive: a part
        that met write quorum may be absent from any one drive."""
        self._check_bucket(bucket)
        self._mp_fileinfo(bucket, object_name, upload_id)
        mp = _mp_dir(bucket, object_name, upload_id)
        parts: dict[int, PartInfo] = {}
        found_any = False
        for disk in self.disks:
            if disk is None:
                continue
            try:
                names = disk.list_dir(SYS_DIR, mp)
                found_any = True
            except serrors.StorageError:
                continue
            for name in names:
                if not (name.startswith("part.") and name.endswith(".meta")):
                    continue
                num = int(name[5:-5])
                if num in parts:
                    continue
                try:
                    etag, size = disk.read_all(
                        SYS_DIR, f"{mp}/{name}").decode().split(":")
                except (serrors.StorageError, ValueError):
                    continue
                parts[num] = PartInfo(num, etag, int(size), int(size))
        if not found_any:
            raise InvalidUploadID(upload_id)
        return sorted(parts.values(), key=lambda p: p.part_number)

    def abort_multipart_upload(self, bucket: str, object_name: str,
                               upload_id: str) -> None:
        self._check_bucket(bucket)
        self._mp_fileinfo(bucket, object_name, upload_id)
        mp = _mp_dir(bucket, object_name, upload_id)
        self._fanout(lambda d: d.delete(SYS_DIR, mp, recursive=True),
                     self.disks)

    def list_multipart_uploads(self, bucket: str,
                               prefix: str = "") -> list[MultipartInfo]:
        """Every upload of the bucket whose key starts with ``prefix``, by
        key, merged over every drive."""
        self._check_bucket(bucket)
        out: dict[str, MultipartInfo] = {}
        for disk in self.disks:
            if disk is None:
                continue
            try:
                hashes = disk.list_dir(SYS_DIR, "multipart")
            except serrors.StorageError:
                continue
            for h in hashes:
                try:
                    uploads = disk.list_dir(SYS_DIR,
                                            f"multipart/{h.strip('/')}")
                except serrors.StorageError:
                    continue
                for u in uploads:
                    uid = u.strip("/")
                    if uid in out:
                        continue
                    try:
                        fi = disk.read_version(
                            SYS_DIR, f"multipart/{h.strip('/')}/{uid}")
                    except serrors.StorageError:
                        continue
                    obj = fi.metadata.get("__object", "")
                    if obj.startswith(prefix) and \
                            fi.metadata.get("__bucket") == bucket:
                        out[uid] = MultipartInfo(
                            bucket, obj, uid,
                            {k: v for k, v in fi.metadata.items()
                             if not k.startswith("__")})
        return sorted(out.values(), key=lambda m: m.object_name)

    def complete_multipart_upload(self, bucket: str, object_name: str,
                                  upload_id: str,
                                  parts: list[tuple[int, str]],
                                  opts: Optional[PutObjectOptions] = None
                                  ) -> ObjectInfo:
        """CompleteMultipartUpload (cmd/erasure-multipart.go:678).
        ``parts``: [(part number, ETag)] as the client lists them, which
        must ascend.  ``opts`` may name the version id and mod time."""
        self._check_bucket(bucket)
        fi = self._mp_fileinfo(bucket, object_name, upload_id)
        mp = _mp_dir(bucket, object_name, upload_id)
        if not parts:
            raise InvalidPart("no parts specified")
        if [p[0] for p in parts] != sorted({p[0] for p in parts}):
            raise InvalidPartOrder("parts not in ascending order")
        uploaded = {p.part_number: p for p in
                    self.list_object_parts(bucket, object_name, upload_id)}
        part_infos: list[ObjectPartInfo] = []
        md5s = b""
        total = 0
        for i, (num, etag) in enumerate(parts):
            got = uploaded.get(num)
            if got is None or got.etag != etag.strip('"'):
                raise InvalidPart(f"part {num}")
            if got.size < MIN_PART_SIZE and i != len(parts) - 1 \
                    and self.enforce_min_part_size:
                raise InvalidPart(f"part {num} too small")
            part_infos.append(ObjectPartInfo(num, got.size, got.size,
                                             got.etag, now_ns()))
            md5s += bytes.fromhex(got.etag)
            total += got.size
        etag = hashlib.md5(md5s).hexdigest() + f"-{len(parts)}"

        # the internal keys go in the reference's order, so xl.meta is
        # the same bytes whichever package completes
        versioned = fi.metadata.pop("__versioned", "0") == "1"
        if opts is not None and opts.versioned:
            versioned = True
        version_id = str(uuid.uuid4()) if versioned else ""
        mod_time = now_ns()
        if opts is not None:
            version_id = opts.version_id or version_id
            mod_time = opts.mod_time or mod_time
        fi.volume, fi.name = bucket, object_name
        fi.version_id = version_id
        fi.mod_time = mod_time
        fi.size = total
        fi.parts = part_infos
        fi.metadata = {k: v for k, v in fi.metadata.items()
                       if not k.startswith("__")}
        fi.metadata["etag"] = etag
        fi.erasure.checksums = [ChecksumInfo(p.number, HIGHWAYHASH256S)
                                for p in part_infos]
        shuffled = meta.shuffle_disks(self.disks, fi.erasure.distribution)
        from .erasure_object import _disk_fileinfo

        def commit_one(item):
            idx, disk = item
            tmp = disk.tmp_dir()
            try:
                for p in part_infos:
                    disk.rename_file(SYS_DIR, f"{mp}/part.{p.number}",
                                     SYS_DIR, f"{tmp}/part.{p.number}")
                disk.rename_data(SYS_DIR, tmp, _disk_fileinfo(fi, idx),
                                 bucket, object_name)
            finally:
                disk.clean_tmp(tmp)
            disk.delete(SYS_DIR, mp, recursive=True)

        lk = self.ns_lock.new_lock(bucket, object_name)
        lk.lock(write=True)
        try:
            _, errs = self._fanout(commit_one, _indexed(shuffled))
            self._reduce_quorum(errs, self._fi_write_quorum(fi))
        finally:
            lk.unlock()
        fi.is_latest = True
        self.metacache.invalidate(bucket)
        return self._to_object_info(fi)


def _delete_quietly(disk, path: str) -> None:
    try:
        disk.delete(SYS_DIR, path)
    except serrors.StorageError:
        pass                        # promoted or gone
