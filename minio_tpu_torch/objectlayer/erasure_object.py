"""One erasure set doing PUT, ranged and degraded GET, delete and heal
(cmd/erasure-object.go), with the data path on a device and the drive
writes on a per-drive writer plane.

  * PUT: objects up to 128 KiB are framed into xl.meta (inline); larger
    ones are encoded in 64 MiB stripe batches (a whole number of blocks),
    each batch one Kernel A launch for the parity and one Kernel B launch
    for the bitrot digests (a short last block adds one of each), or, on
    a mesh set, one Kernel C launch for both (``rs_mesh``).  The framed
    batch comes back to the host into a pooled (on a card, pinned)
    buffer (``utils/bufpool.py``).  Objects of one batch commit with one
    storage call per drive: packed into the drive's segment file below
    1 MiB (``XLStorage.write_packed``), else a part file
    (``write_data_commit``) whose xl.meta waits for the MD5 hashed
    beside it.  Larger objects stream: a chained MD5 task, encode, and
    the drives' create/append run side by side, at most two batches in
    flight, then one ``rename_data`` per drive commits.
  * Drive writes go through ``storage/writers.py``: one thread per drive
    whose queued ops, from concurrent PUTs and heals, commit in groups
    behind shared fsyncs (``storage/commit.py``).  Each object takes its
    own namespace lock (``parallel/dsync.py``): write for PUT, delete and
    heal, read for GET.
  * GET: part by part, per batch of blocks, read the framed ranges of k
    shards that hold the quorum version (inline, in part files, or in a
    packed segment), verify them on the device (Kernel B), extend into
    parity shards on failure, and rebuild missing data shards in one
    launch (Kernel A).  Every part ends in its own short last block, so
    a multi-part object launches per part.
  * Versions: a PUT with ``PutObjectOptions.versioned`` adds a uuid
    version beside the others (else it replaces the null version); GET,
    HEAD, DELETE and heal take a version id (``ObjectOptions``); a
    versioned DELETE without one adds a delete marker, whose GET is
    MethodNotAllowed.  ``list_object_versions`` pages every version.
  * Multipart uploads: the ``MultipartOps`` mixin (``multipart.py``).
  * heal: ``healing.heal_object``, one version, every part.
  * buckets and listing: bucket info, list and delete over every drive's
    volumes; ``list_objects`` k-way merges the drives' sorted walks and
    resolves each entry by quorum (the reference's walk without its
    metacache), then ``metacache.paginate``.

The ETag is the body's MD5 (the reference's strict-compat mode).  No
caches and no MRF queue.  The pipeline's knobs (the ``pipeline`` kvconfig
subsystem: batches in flight per stream, per-drive queue depth) are read
at construction from the environment and reloaded live by
``reload_pipeline_config``; depth 0 takes the serial fan-out.
``pipe_stats`` holds the last streaming PUT's stage seconds and overlap
efficiency (the ``mt_put_pipeline_*`` scrape reads it).  Several sets on
one card form a namespace in ``sets.py``; each launches on the card's
default stream.  The drives hold the same bytes as after the
same calls to ``minio_tpu``'s default layer with the same geometry and
block size (xl.meta, part files, segment files and journal).  On a host
with one core the drive fan-out runs in line and nothing is pipelined or
packed, as the reference does there.
"""

from __future__ import annotations

import collections
import hashlib
import heapq
import itertools
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..hashing import bitrot
from ..ops import gf8, rs_kernels
from ..ops.codec import Erasure
from ..parallel.dsync import NamespaceLock
from ..parallel.mesh import Mesh
from ..storage import commit as _commit
from ..storage import errors as serrors
from ..storage.datatypes import (ChecksumInfo, ErasureInfo, FileInfo,
                                 ObjectPartInfo, now_ns)
from ..ops import codec as codec_mod
from ..storage.writers import QUEUE_DEPTH, WriterPlane, held_release
from ..storage.xl_storage import SYS_DIR
from ..utils import bufpool
from ..utils.kvconfig import Config
from ..utils.readahead import readahead
from . import metadata as meta
from .interface import (BadDigest, BucketExists, BucketInfo, BucketNotEmpty,
                        BucketNotFound, InvalidRange, ListObjectsInfo,
                        ListObjectVersionsInfo, MethodNotAllowed,
                        ObjectInfo, ObjectNotFound,
                        ObjectOptions, PutObjectOptions, ReadQuorumError,
                        VersionNotFound, WriteQuorumError)
from .metacache import paginate, paginate_versions
from .multipart import MultipartOps

# blockSizeV1 (cmd/object-api-common.go:32)
DEFAULT_BLOCK_SIZE = 10 * 1024 * 1024
INLINE_THRESHOLD = 128 * 1024           # small objects live in xl.meta
STREAM_BATCH_BYTES = 64 * 1024 * 1024   # bytes of body encoded per batch
ETAG_KEY = "etag"
OVERLAP_MD5_BYTES = 1 << 20             # hash beside encode from here on
ABORT_DRAIN_S = 5.0                     # a failed commit's wait on its ops
# one core: the drive fan-out runs in line, without pipeline or packing
SERIAL_FANOUT = (os.cpu_count() or 2) <= 1


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


def _read_full(source, n: int) -> bytes:
    """Exactly n bytes of a reader unless it ends first."""
    parts, left = [], n
    while left > 0:
        c = source.read(left)
        if not c:
            break
        parts.append(c)
        left -= len(c)
    return b"".join(parts)


class ErasureObjects(MultipartOps):
    """One erasure set over ``len(disks)`` drives (cmd/erasure.go:48)."""

    def __init__(self, disks: list, parity: Optional[int] = None,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 device: str | torch.device = "cuda",
                 mesh: Optional[Mesh] = None,
                 enforce_min_part_size: bool = True):
        """``mesh``: run the data path on that device mesh (the mesh data
        plane, ``minio_tpu``'s ``backend="mesh"``); ``device`` is then not
        read.  ``enforce_min_part_size``: complete refuses a part below
        5 MiB that is not the last."""
        if not disks:
            raise ValueError("no disks")
        self.disks = list(disks)
        n = len(self.disks)
        self.parity = default_parity_count(n) if parity is None else parity
        self.data_blocks = n - self.parity
        if self.data_blocks <= 0:
            raise ValueError("parity too large for drive count")
        self.block_size = block_size
        self.enforce_min_part_size = enforce_min_part_size
        self.codec = Erasure(self.data_blocks, self.parity, block_size,
                             device=device, mesh=mesh)
        self.device = self.codec.device
        self.ns_lock = NamespaceLock()
        # request concurrency x drive fan-out, and the MD5 links
        self._pool = ThreadPoolExecutor(max_workers=min(4 * max(4, n), 64))
        self._serial = SERIAL_FANOUT
        self.reload_pipeline_config(Config())
        self._write_plane = WriterPlane(
            queue_depth=lambda: self._pipe_queue_depth)
        # the last streaming PUT's stage times and overlap (the scrape
        # and chip_smoke.py read them), and the last parts'
        self.pipe_stats: dict = {}
        self.part_stats: collections.deque = collections.deque(maxlen=64)
        # seconds each device-to-host copy of a framed batch waited on its
        # event (the stream is shared with every other set on the card)
        self.d2h_waits: collections.deque = collections.deque(maxlen=4096)

    def close(self) -> None:
        """Join the writer threads and the fan-out pool, and close the
        drives' segment files."""
        self._write_plane.close()
        self._pool.shutdown(wait=True)
        for d in self.disks:
            if d is not None:
                d.close()

    def reload_pipeline_config(self, config) -> None:
        """Take the ``pipeline`` knobs from a kvconfig ``Config``: batches
        in flight per stream (``depth``; 0, and always on one core, the
        serial fan-out: no writer plane, no packing) and ops queued per
        drive writer (``queue_depth``)."""
        try:
            depth = int(config.get("pipeline", "depth"))
        except (KeyError, ValueError):
            depth = 2
        try:
            qd = int(config.get("pipeline", "queue_depth"))
        except (KeyError, ValueError):
            qd = QUEUE_DEPTH
        self._pipe_depth = 0 if self._serial else max(0, depth)
        self._pipe_queue_depth = max(1, qd)

    def _pipeline_on(self) -> bool:
        return self._pipe_depth > 0

    # -- drive fan-out -----------------------------------------------------

    def _fanout(self, fn, items) -> tuple[list, list]:
        """fn(item) for every item (concurrently unless serial);
        (results, errors) aligned with items.  A None item is an offline
        drive."""

        def run(x):
            if x is None:
                return None, serrors.DiskNotFound("offline")
            try:
                return fn(x), None
            except OSError as e:          # StorageError, BitrotError, I/O
                return None, e

        out = ([run(x) for x in items] if self._serial
               else list(self._pool.map(run, items)))
        return [r for r, _ in out], [e for _, e in out]

    def _commit_fanout(self, write_one, shuffled: list, buf) -> list:
        """One storage call ``write_one(idx, disk)`` per drive; returns the
        per-drive errors.  On the writer plane, where concurrent streams'
        commits coalesce into group commits; the queue bound widens to a
        group's size so one object's fan-out enqueues without waiting on
        itself.  ``buf`` (``writers.held_release``) counts every queued
        op, so the buffer they read is recycled only once the last one
        settled, also when a failed commit stops waiting for them.  A
        drive its health proxy holds offline is skipped: ``write_packed``
        passes the proxy unguarded, and a swapped drive must never be
        written."""
        shuffled = [None if getattr(d, "offline", False) else d
                    for d in shuffled]
        if not self._pipeline_on():
            _, errs = self._fanout(lambda p: write_one(*p),
                                   [None if d is None else (i, d)
                                    for i, d in enumerate(shuffled)])
            return errs
        sw = self._write_plane.stream(shuffled)
        bound = max(self._write_plane.queue_bound(),
                    _commit.CONFIG.max_batch)
        try:
            for i in range(len(shuffled)):
                buf.hold()
                sw.submit(i, write_one, buf, bound)
            sw.drain()
        except BaseException:
            sw.abort()
            sw.drain(ABORT_DRAIN_S)
            raise
        return list(sw.errs)

    # -- buckets -----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        _, errs = self._fanout(lambda d: d.make_vol(bucket), self.disks)
        wq = _write_quorum(self.data_blocks, self.parity)
        if sum(isinstance(e, serrors.VolumeExists) for e in errs) >= wq:
            raise BucketExists(bucket)
        meta.reduce_errs([None if isinstance(e, serrors.VolumeExists)
                          else e for e in errs], wq, WriteQuorumError)

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        res, _ = self._fanout(lambda d: d.stat_vol(bucket), self.disks)
        for r in res:
            if r is not None:
                return BucketInfo(r.name, r.created)
        raise BucketNotFound(bucket)

    _check_bucket = get_bucket_info

    def list_buckets(self) -> list[BucketInfo]:
        """Every volume any drive holds, the system volume hidden."""
        res, _ = self._fanout(lambda d: d.list_vols(), self.disks)
        seen: dict[str, BucketInfo] = {}
        for vols in res:
            for v in vols or ():
                seen.setdefault(v.name, BucketInfo(v.name, v.created))
        return sorted(seen.values(), key=lambda b: b.name)

    def heal_bucket(self, bucket: str) -> int:
        """Make the bucket on every drive that lacks it (healBucket,
        cmd/erasure-healing.go:56); returns the drives made."""
        healed = 0
        for disk in self.disks:
            if disk is None:
                continue
            try:
                disk.stat_vol(bucket)
            except serrors.StorageError:
                try:
                    disk.make_vol(bucket)
                    healed += 1
                except serrors.StorageError:
                    pass
        return healed

    @property
    def meta_set(self) -> "ErasureObjects":
        """The set whose drives keep the bucket metadata: this one."""
        return self

    def health(self, maintenance: bool = False) -> dict:
        """Healthy while the online drives keep write quorum
        (cmd/erasure-server-pool.go:1462); with ``maintenance`` the local
        drives do not count (may this node be taken down?), and no drive
        may be healing.  ``healing_drives`` counts drives mid-heal."""
        wq = self._set_write_quorum()
        up = healing = 0
        for d in self.disks:
            if d is None:
                continue
            try:
                if not d.is_online():
                    continue
            except Exception:  # noqa: BLE001 — a dead drive is offline
                continue
            if getattr(d, "healing", False):
                healing += 1
            if maintenance and d.is_local():
                continue
            up += 1
        return {"healthy": up >= wq and (not maintenance or healing == 0),
                "write_quorum": wq, "healing_drives": healing,
                "online_drives": up}

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        """Remove the bucket from every drive; BucketNotEmpty while it
        holds an object of any layout (packed ones keep their xl.meta in
        the bucket), unless ``force``."""
        self.get_bucket_info(bucket)
        _, errs = self._fanout(lambda d: d.delete_vol(bucket, force),
                               self.disks)
        if not force and any(isinstance(e, serrors.VolumeNotEmpty)
                             for e in errs):
            raise BucketNotEmpty(bucket)

    # -- LIST (cmd/metacache-set.go listPath, without the cache) -----------

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000
                     ) -> ListObjectsInfo:
        self._check_bucket(bucket)
        return paginate(self._gather_listing_iter(bucket, prefix, marker),
                        prefix, marker, delimiter, max_keys)

    def _walk_merged(self, bucket: str, prefix: str, versions: bool,
                     after: str = ""):
        """(name, [each drive's entry]) under ``prefix`` from ``after`` on:
        one lazy walk per drive (flat key order), k-way merged: memory
        O(drives), not O(namespace).  An entry is the latest FileInfo, or
        with ``versions`` the list of every version.  A drive that fails
        to walk is left out."""
        base_dir = prefix.rsplit("/", 1)[0] if "/" in prefix else ""

        def drive_stream(d):
            try:
                yield from d.walk_entries(bucket, base_dir, versions,
                                          after=after)
            except OSError:
                return

        merged = heapq.merge(*(drive_stream(d) for d in self.disks
                               if d is not None), key=lambda e: e[0])
        for name, group in itertools.groupby(merged, key=lambda e: e[0]):
            if prefix:
                if name < prefix:
                    continue
                if not name.startswith(prefix):
                    break           # sorted: nothing later matches
            yield name, [e for _, e in group]

    def _gather_listing_iter(self, bucket: str, prefix: str,
                             after: str = ""):
        """The latest version of every entry from ``after`` on (a page's
        marker: nothing before it is read), resolved entry by entry at
        quorum ``max(1, n // 2)``; an entry below quorum, or whose latest
        version is a delete marker, is skipped."""
        quorum = max(1, len(self.disks) // 2)
        for _, fis in self._walk_merged(bucket, prefix, False, after):
            try:
                fi = meta.find_file_info_in_quorum(fis, quorum)
            except ReadQuorumError:
                continue
            if not fi.deleted:
                yield self._to_object_info(fi)

    # -- encode ------------------------------------------------------------

    def _batch_bytes(self) -> int:
        return max(1, STREAM_BATCH_BYTES // self.block_size) * self.block_size

    def _frame(self, chunk) -> torch.Tensor:
        """Encode one batch of blocks and frame every shard; returns the
        (k + m, framed_len) on-disk bytes on the device."""
        codec = self.codec
        if codec.mesh is not None:
            return codec.encode_object_framed(chunk)
        return bitrot.frame_batch(codec.encode_object(chunk),
                                  codec.shard_size())

    def _to_host(self, framed: torch.Tensor):
        """(host rows, release): ``framed`` copied into a pooled host
        buffer, pinned on a card, and read only after the copy is done;
        ``release`` recycles it once every drive has written it."""
        pinned = framed.device.type == "cuda"
        buf = bufpool.GLOBAL.acquire(framed.shape, pinned)
        buf.copy_(framed, non_blocking=pinned)
        if pinned:
            done = torch.cuda.Event()
            done.record()
            t0 = time.perf_counter()
            done.synchronize()
            self.d2h_waits.append(time.perf_counter() - t0)
            codec_mod.settle_observations()
        return buf.numpy(), lambda: bufpool.GLOBAL.release(buf)

    def _encode_framed_pooled(self, chunk):
        return self._to_host(self._frame(chunk))

    # -- PUT (cmd/erasure-object.go:614 putObject) -------------------------

    def put_object(self, bucket: str, object_name: str, data,
                   opts: Optional[PutObjectOptions] = None) -> ObjectInfo:
        """PUT from bytes-like ``data`` or a reader with ``.read(n)``.  A
        body larger than one stream batch streams through the pipeline;
        smaller ones commit with one call per drive."""
        opts = opts or PutObjectOptions()
        batch = self._batch_bytes()
        if hasattr(data, "read"):
            self._check_bucket(bucket)
            first = _read_full(data, batch)
            if len(first) < batch:
                return self._put_object_bytes(bucket, object_name, first,
                                              opts)

            def chunks():
                c = first
                while c:
                    yield c
                    if len(c) < batch:
                        return
                    c = _read_full(data, batch)

            return self._put_object_streaming(bucket, object_name,
                                              chunks(), opts, True)
        mv = memoryview(data).cast("B")
        if len(mv) > STREAM_BATCH_BYTES:
            return self._put_object_streaming(
                bucket, object_name,
                (mv[o:o + batch] for o in range(0, len(mv), batch)), opts,
                False)
        return self._put_object_bytes(bucket, object_name, mv, opts)

    def _new_fileinfo(self, bucket: str, object_name: str,
                      opts: PutObjectOptions) -> FileInfo:
        """A new version's FileInfo: a uuid version id when the PUT is
        versioned (drawn before the data dir, as the reference does),
        else the null version."""
        n, k, m = len(self.disks), self.data_blocks, self.parity
        version_id = opts.version_id or (
            str(uuid.uuid4()) if opts.versioned else "")
        return FileInfo(
            volume=bucket, name=object_name, version_id=version_id,
            data_dir=str(uuid.uuid4()), mod_time=opts.mod_time or now_ns(),
            erasure=ErasureInfo(
                data_blocks=k, parity_blocks=m, block_size=self.block_size,
                distribution=meta.hash_order(f"{bucket}/{object_name}", n),
                checksums=[ChecksumInfo(1, bitrot.HIGHWAYHASH256S)]))

    @staticmethod
    def _stamp(fi: FileInfo, size: int, etag: str,
               opts: PutObjectOptions) -> None:
        """Size, ETag and parts into ``fi``, once the body's MD5 is known
        and before anything commits; BadDigest when the client's
        Content-MD5 differs (the reference layer's ``_stamp_etag``)."""
        if opts.content_md5 and etag != opts.content_md5.lower():
            raise BadDigest(f"{fi.volume}/{fi.name}: Content-MD5 "
                            f"{opts.content_md5} but the body's is {etag}")
        fi.size = size
        fi.metadata = {ETAG_KEY: etag, **opts.user_defined}
        fi.parts = [ObjectPartInfo(1, size, size, etag, fi.mod_time)]

    def _reduce_write(self, errs: list, fi: FileInfo) -> None:
        wq = _write_quorum(fi.erasure.data_blocks, fi.erasure.parity_blocks)
        try:
            meta.reduce_errs(errs, wq, WriteQuorumError)
        except serrors.VolumeNotFound:
            raise BucketNotFound(fi.volume) from None
        except serrors.StorageError as e:
            raise WriteQuorumError(str(e)) from e

    def _put_object_bytes(self, bucket: str, object_name: str, data,
                          opts: PutObjectOptions) -> ObjectInfo:
        """The whole body in one batch: MD5 on the pool beside the encode
        (from 1 MiB up; first, when a Content-MD5 must match), then one
        commit call per drive under the object's write lock."""
        self._check_bucket(bucket)
        fi = self._new_fileinfo(bucket, object_name, opts)
        size = len(data)
        etag_future = None
        if self._pipeline_on() and size >= OVERLAP_MD5_BYTES \
                and not opts.content_md5:
            etag_future = self._pool.submit(
                lambda: hashlib.md5(data).hexdigest())
        else:
            self._stamp(fi, size, hashlib.md5(data).hexdigest(), opts)
        framed, release = self._encode_framed_pooled(data)
        buf = held_release(release)
        inline = size <= INLINE_THRESHOLD
        shuffled = meta.shuffle_disks(self.disks, fi.erasure.distribution)
        lk = self.ns_lock.new_lock(bucket, object_name)
        try:
            lk.lock(write=True)
            if etag_future is not None and not inline \
                    and self._pipeline_on():
                self._commit_put_overlapped(fi, framed, shuffled,
                                            etag_future, opts, size, buf)
            else:
                if etag_future is not None:
                    self._stamp(fi, size, etag_future.result(), opts)
                self._commit_put(fi, framed, inline, shuffled, buf)
            return self._to_object_info(fi)
        finally:
            lk.unlock()
            buf.done_one()

    def _commit_put(self, fi: FileInfo, framed: np.ndarray, inline: bool,
                    shuffled: list, buf) -> None:
        """Inline into xl.meta, packed into each drive's segment (past
        the inline threshold and up to ``commit.CONFIG.pack_threshold``, on the
        writer plane only, where group commits amortise the journal), or
        one part file per drive."""
        packed = (not inline and self._pipeline_on()
                  and 0 < fi.size <= _commit.CONFIG.pack_threshold)
        if packed:
            fi.data_dir = ""            # the segment extent replaces it
        vdict = None if inline else fi.to_dict()
        bucket, name = fi.volume, fi.name

        def write_one(idx, disk):
            if inline:
                dfi = _disk_fileinfo(fi, idx)
                dfi.inline_data = framed[idx].tobytes()
                dfi.data_dir = ""
                disk.write_metadata(bucket, name, dfi)
            elif packed:
                disk.write_packed(bucket, name, fi, framed[idx].tobytes(),
                                  shard_index=idx + 1, version_dict=vdict)
            else:
                disk.write_data_commit(bucket, name, fi, framed[idx],
                                       shard_index=idx + 1,
                                       version_dict=vdict)

        self._reduce_write(self._commit_fanout(write_one, shuffled, buf),
                           fi)

    def _commit_put_overlapped(self, fi: FileInfo, framed: np.ndarray,
                               shuffled: list, etag_future,
                               opts: PutObjectOptions, size: int,
                               buf) -> None:
        """Part-file commit with the MD5 still running: each drive writes
        its part bytes first and waits on a gate before its xl.meta
        merge; a pool task opens the gate with the final version once
        the digest lands (pkg/hash/reader.go's overlap carried through
        the commit).  It is submitted after the MD5 task, so it runs even
        while every drive writer waits on the gate."""
        gate = threading.Event()
        state: dict = {}

        def resolve():
            try:
                self._stamp(fi, size, etag_future.result(), opts)
                state["vdict"] = fi.to_dict()
            finally:
                gate.set()

        def meta_gate() -> dict:
            gate.wait()
            if "vdict" not in state:
                raise serrors.StorageError("commit aborted: no ETag")
            return state["vdict"]

        def write_one(idx, disk):
            disk.write_data_commit(fi.volume, fi.name, fi, framed[idx],
                                   shard_index=idx + 1, meta_gate=meta_gate)

        resolver = self._pool.submit(resolve)
        try:
            errs = self._commit_fanout(write_one, shuffled, buf)
            resolver.result()
            self._reduce_write(errs, fi)
        finally:
            gate.set()          # never leave a drive writer waiting

    def _put_object_streaming(self, bucket: str, object_name: str, chunks,
                              opts: PutObjectOptions,
                              readahead_body: bool) -> ObjectInfo:
        """Stream batch by batch into per-drive staging files, then one
        ``rename_data`` per drive (cmd/erasure-encode.go:80-107,
        cmd/erasure-object.go:772-779)."""
        self._check_bucket(bucket)
        fi = self._new_fileinfo(bucket, object_name, opts)
        shuffled = meta.shuffle_disks(self.disks, fi.erasure.distribution)
        lk = self.ns_lock.new_lock(bucket, object_name)
        lk.lock(write=True)
        try:
            run = (self._stream_put_pipelined if self._pipeline_on()
                   else self._stream_put_serial)
            run(fi, chunks, opts, shuffled, readahead_body)
            return self._to_object_info(fi)
        finally:
            lk.unlock()

    @staticmethod
    def _md5_link(prev, h, chunk, stats) -> None:
        """One chained MD5 update on the pool: waits for the previous
        link (updates are ordered), then hashes its chunk (hashlib
        releases the GIL, so the chain runs beside encode and the drive
        writers).  Each link waits only on an earlier submission and the
        pool starts tasks in order, so the chain cannot deadlock it."""
        if prev is not None:
            prev.result()
        t0 = time.perf_counter()
        h.update(chunk)
        stats["md5_s"] += time.perf_counter() - t0

    def _pump_put_pipeline(self, chunks, sw, md5, stats, write_batch_for,
                           wq: int) -> tuple[int, int]:
        """Chained MD5 on the pool, encode into a pooled buffer, the
        drives' writer queues: at most ``_pipe_depth`` batches in flight,
        quorum re-checked as completions drain.  Returns (bytes,
        batches).  ``stats["body_wait_s"]``: time spent waiting for the
        next batch of the body (a reader's socket and digests)."""
        links: collections.deque = collections.deque()
        inflight: collections.deque = collections.deque()
        total = batches = 0
        chunks = iter(chunks)
        while True:
            t0 = time.perf_counter()
            chunk = next(chunks, None)
            stats["body_wait_s"] += time.perf_counter() - t0
            if chunk is None:
                break
            total += len(chunk)
            batches += 1
            links.append(self._pool.submit(
                self._md5_link, links[-1] if links else None, md5, chunk,
                stats))
            while len(links) > self._pipe_depth:
                links.popleft().result()
            t0 = time.perf_counter()
            framed, release = self._encode_framed_pooled(chunk)
            stats["encode_s"] += time.perf_counter() - t0
            inflight.append(sw.submit_batch(write_batch_for(framed),
                                            release=release))
            while len(inflight) > self._pipe_depth:
                inflight.popleft().done.wait()
            alive = sw.alive()
            if alive < wq:
                sw.abort()
                raise WriteQuorumError(
                    f"{alive} of {len(self.disks)} drives writable, "
                    f"need {wq}")
        for f in links:
            f.result()
        return total, batches

    def _stream_put_pipelined(self, fi: FileInfo, chunks,
                              opts: PutObjectOptions, shuffled: list,
                              readahead_body: bool) -> None:
        """Body readahead, chained MD5, encode into a pooled buffer, the
        drives' writer queues.  Per drive the ops run create, appends,
        then ``rename_data``, in order; errors latch per drive."""
        n = len(shuffled)
        wq = _write_quorum(fi.erasure.data_blocks, fi.erasure.parity_blocks)
        tmps: list[Optional[str]] = [None] * n
        stats = {"md5_s": 0.0, "encode_s": 0.0, "body_wait_s": 0.0}
        md5 = hashlib.md5()
        sw = self._write_plane.stream(shuffled)
        src = None
        t_wall = time.perf_counter()
        try:
            # the batch in hand plus depth - 1 read ahead
            src = readahead(chunks, depth=max(1, self._pipe_depth - 1)) \
                if readahead_body else chunks

            def write_batch_for(framed):
                def write_batch(idx, disk):
                    # only this drive's writer touches tmps[idx] until
                    # the stream drains
                    if tmps[idx] is None:
                        tmps[idx] = disk.tmp_dir()
                        disk.create_file(SYS_DIR, f"{tmps[idx]}/part.1",
                                         framed[idx])
                    else:
                        disk.append_file(SYS_DIR, f"{tmps[idx]}/part.1",
                                         framed[idx])
                return write_batch

            total, batches = self._pump_put_pipeline(
                src, sw, md5, stats, write_batch_for, wq)
            self._stamp(fi, total, md5.hexdigest(), opts)
            sw.drain()
            alive = sw.alive()
            if alive < wq:
                raise WriteQuorumError(
                    f"{alive} of {n} drives writable, need {wq}")

            def commit_one(idx, disk):
                disk.rename_data(SYS_DIR, tmps[idx], _disk_fileinfo(fi, idx),
                                 fi.volume, fi.name)

            sw.submit_batch(commit_one)
            sw.drain()
            self._reduce_write(list(sw.errs), fi)
            wall = time.perf_counter() - t_wall
            write_s = sw.max_busy_s()
            # the slowest stage over the wall: 1.0 when the pipeline hid
            # every other stage behind it
            crit = max(stats["md5_s"], stats["encode_s"], write_s)
            self.pipe_stats = {"wall_s": wall, "batches": batches,
                               "bytes": total, "write_s": write_s,
                               "overlap_efficiency": crit / wall, **stats}
        finally:
            if src is not None and readahead_body:
                src.close()
            sw.abort()
            # settle the queues before cleaning up; a drive stuck past the
            # wait cleans up when its op settles
            sw.drain(timeout=10.0)
            for idx, disk in enumerate(shuffled):
                if disk is not None:
                    sw.when_drive_idle(
                        idx, lambda d=disk, i=idx:
                        tmps[i] is not None and d.clean_tmp(tmps[i]))

    def _stream_put_serial(self, fi: FileInfo, chunks,
                           opts: PutObjectOptions, shuffled: list,
                           readahead_body: bool) -> None:
        """One fan-out round per batch, then the commit (the single-core
        path: same bytes on the drives as the pipeline)."""
        n = len(shuffled)
        wq = _write_quorum(fi.erasure.data_blocks, fi.erasure.parity_blocks)
        tmps: list[Optional[str]] = [None] * n
        errs: list[Optional[Exception]] = [None] * n
        md5 = hashlib.md5()
        total = 0
        src = readahead(chunks, depth=1) if readahead_body else chunks
        try:
            for chunk in src:
                md5.update(chunk)
                total += len(chunk)
                framed, release = self._encode_framed_pooled(chunk)

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
                try:
                    _, werrs = self._fanout(write_batch, live)
                finally:
                    release()
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
            if readahead_body:
                src.close()
            for disk, tmp in zip(shuffled, tmps):
                if tmp is not None:
                    disk.clean_tmp(tmp)

    # -- GET (cmd/erasure-object.go:242 getObjectWithFileInfo) -------------

    def _read_quorum_fileinfo(self, bucket: str, object_name: str,
                              version_id: Optional[str] = None
                              ) -> tuple[FileInfo, list]:
        """The quorum FileInfo of the latest version, or of
        ``version_id``, and every drive's; a delete marker is returned
        like any version."""
        fis, errs = self._fanout(
            lambda d: d.read_version(bucket, object_name, version_id),
            self.disks)
        nf = sum(isinstance(e, (serrors.FileNotFound,
                                serrors.FileVersionNotFound)) for e in errs)
        if nf > len(self.disks) // 2:
            if version_id is not None and any(
                    isinstance(e, serrors.FileVersionNotFound)
                    for e in errs):
                raise VersionNotFound(f"{bucket}/{object_name}@{version_id}")
            raise ObjectNotFound(f"{bucket}/{object_name}")
        fi = meta.find_file_info_in_quorum(fis, max(1, len(self.disks) // 2))
        return fi, fis

    def get_object_info(self, bucket: str, object_name: str,
                        opts: Optional[ObjectOptions] = None) -> ObjectInfo:
        """HEAD: the version's info; a delete marker's says so
        (``delete_marker``)."""
        opts = opts or ObjectOptions()
        self._check_bucket(bucket)
        lk = self.ns_lock.new_lock(bucket, object_name)
        lk.lock(write=False)
        try:
            fi, _ = self._read_quorum_fileinfo(bucket, object_name,
                                               opts.version_id)
            return self._to_object_info(fi)
        finally:
            lk.unlock()

    def get_object(self, bucket: str, object_name: str, offset: int = 0,
                   length: int = -1, opts: Optional[ObjectOptions] = None
                   ) -> tuple[ObjectInfo, bytes]:
        """The object's bytes [offset, offset + length), joined."""
        info, chunks = self.get_object_reader(bucket, object_name, offset,
                                              length, opts,
                                              readahead_depth=0)
        return info, b"".join(chunks)

    def get_object_reader(self, bucket: str, object_name: str,
                          offset: int = 0, length: int = -1,
                          opts: Optional[ObjectOptions] = None,
                          readahead_depth: int | None = None):
        """(info, chunk iterator) of the bytes [offset, offset + length)
        of the latest version or of ``opts.version_id``, under HTTP range
        rules (negative offset = suffix, length < 0 = to the end,
        overlong ranges clamp, a start past the end is InvalidRange); a
        delete marker is MethodNotAllowed.  The body streams one batch of
        blocks at a time, part by part, ``readahead_depth`` batches read
        and decoded ahead in a thread (None: one less than the pipeline
        depth, at least one), and is never joined.  The object's
        read lock is held until the iterator ends, fails or is closed or
        dropped, advanced or not."""
        opts = opts or ObjectOptions()
        self._check_bucket(bucket)
        lk = self.ns_lock.new_lock(bucket, object_name)
        lk.lock(write=False)
        try:
            fi, fis = self._read_quorum_fileinfo(bucket, object_name,
                                                 opts.version_id)
            if fi.deleted:
                raise MethodNotAllowed(f"{bucket}/{object_name} is a "
                                       "delete marker")
            size = fi.size
            if offset < 0:
                offset = max(0, size + offset)
            if length < 0:
                length = size - offset
            if offset > size or (size > 0 and offset == size):
                raise InvalidRange(f"{offset}+{length} vs {size}")
            length = min(length, size - offset)
            info = self._to_object_info(fi)
        except BaseException:
            lk.unlock()
            raise
        if size == 0 or length == 0:
            lk.unlock()
            return info, iter(())
        chunks = _LockedStream(lk, self._read_range(fi, fis, offset, length))
        if readahead_depth is None:
            readahead_depth = max(1, self._pipe_depth - 1)
        if readahead_depth > 0:
            return info, readahead(chunks, depth=readahead_depth)
        return info, chunks

    def _read_range(self, fi: FileInfo, fis: list, offset: int, length: int):
        """The range, part by part and one batch of blocks at a time
        within a part (the reference's ``_stream_range``).  A shard that
        fails stays dead for the rest of the read (parallelReader,
        cmd/erasure-decode.go:120-188)."""
        ec = fi.erasure
        k, m, bs, ss = ec.data_blocks, ec.parity_blocks, ec.block_size, \
            ec.shard_size()
        hlen = bitrot.digest_size()
        shuffled = meta.shuffle_disks(self.disks, ec.distribution)
        sfis = meta.shuffle_parts_metadata(fis, ec.distribution)
        # only drives holding the quorum version are read: a drive that
        # missed an overwrite keeps a self-consistent old shard, which
        # would pass the bitrot check (listOnlineDisks)
        dead = {j for j in range(k + m)
                if shuffled[j] is None or not meta.same_version(sfis[j], fi)}
        batch_blocks = max(1, self._batch_bytes() // bs)
        end = offset + length
        part_start = 0
        for part in fi.parts:
            if part_start + part.size <= offset:
                part_start += part.size
                continue
            if part_start >= end:
                break
            p0 = max(0, offset - part_start)
            p1 = min(part.size, end - part_start)
            sfsize = ec.shard_file_size(part.size)
            for bb0 in range(p0 // bs, -(-p1 // bs), batch_blocks):
                bb1 = min(bb0 + batch_blocks, -(-p1 // bs))
                seg_off = bb0 * ss
                seg_len = min(bb1 * ss, sfsize) - seg_off
                covered = min(bb1 * bs, part.size) - bb0 * bs
                got = self._read_verified(
                    fi, part.number, shuffled, sfis, dead,
                    seg_off + bb0 * hlen, seg_len + (bb1 - bb0) * hlen,
                    seg_len)
                body = _assemble(self.codec, got, fi, covered)
                lo = max(p0 - bb0 * bs, 0)
                hi = min(p1 - bb0 * bs, covered)
                yield body[lo:hi].tobytes()
            part_start += part.size

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

    def delete_object(self, bucket: str, object_name: str,
                      opts: Optional[ObjectOptions] = None) -> ObjectInfo:
        """DELETE (cmd/erasure-object.go:803).  Versioned and without a
        version id: a delete marker becomes the latest version.  Else the
        version ``opts.version_id`` (the null version by default) goes
        from every drive, with its data dir unless another version
        shares it, or its packed extent; absent objects delete quietly
        (S3 DELETE is idempotent)."""
        opts = opts or ObjectOptions()
        self._check_bucket(bucket)
        mod_time = opts.mod_time or now_ns()
        wq = _write_quorum(self.data_blocks, self.parity)
        lk = self.ns_lock.new_lock(bucket, object_name)
        lk.lock(write=True)
        try:
            if opts.versioned and opts.version_id is None:
                dm = FileInfo(volume=bucket, name=object_name,
                              version_id=str(uuid.uuid4()), deleted=True,
                              mod_time=mod_time)
                _, errs = self._fanout(
                    lambda d: d.delete_version(bucket, object_name, dm,
                                               force_del_marker=True),
                    self.disks)
                self._reduce_quorum(errs, wq)
                return ObjectInfo(bucket=bucket, name=object_name,
                                  version_id=dm.version_id,
                                  delete_marker=True, mod_time=mod_time)
            vid = opts.version_id or ""
            fi = FileInfo(volume=bucket, name=object_name, version_id=vid,
                          mod_time=mod_time)
            _, errs = self._fanout(
                lambda d: d.delete_version(bucket, object_name, fi),
                self.disks)
            missing = (serrors.FileNotFound, serrors.FileVersionNotFound)
            if sum(isinstance(e, missing) for e in errs) \
                    <= len(self.disks) // 2:
                meta.reduce_errs(
                    [None if isinstance(e, missing) else e for e in errs],
                    wq, WriteQuorumError)
            return ObjectInfo(bucket=bucket, name=object_name,
                              version_id=vid)
        finally:
            lk.unlock()

    def list_object_versions(self, bucket: str, prefix: str = "",
                             key_marker: str = "",
                             version_id_marker: str = "",
                             max_keys: int = -1) -> ListObjectVersionsInfo:
        """Every version of every object under ``prefix``, by key and
        newest first within a key, from the drive that holds the quorum
        latest version (ListObjectVersions); paged after ``key_marker``
        (and its ``version_id_marker``), ``max_keys`` versions a page
        (all when negative)."""
        self._check_bucket(bucket)
        return paginate_versions(
            self._versions_iter(bucket, prefix, key_marker), key_marker,
            version_id_marker, max_keys)

    def _versions_iter(self, bucket: str, prefix: str, after: str = ""):
        """ObjectInfo per version from key ``after`` on: each entry's
        version list taken from a drive whose latest version is the
        quorum's."""
        quorum = max(1, len(self.disks) // 2)
        for _, lists in self._walk_merged(bucket, prefix, True, after):
            per_drive = [fis for fis in lists if fis]
            try:
                fi = meta.find_file_info_in_quorum(
                    [fis[0] for fis in per_drive], quorum)
            except ReadQuorumError:
                continue
            for fis in per_drive:
                if fis[0].mod_time == fi.mod_time \
                        and fis[0].version_id == fi.version_id:
                    for v in fis:
                        yield self._to_object_info(v)
                    break

    # -- heal --------------------------------------------------------------

    def heal_object(self, bucket: str, object_name: str,
                    version_id: Optional[str] = None, deep: bool = False,
                    dry_run: bool = False, remove_dangling: bool = False):
        """Heal one version (the latest by default) on every drive that
        lacks it or holds a stale or corrupt copy (``healing.py``)."""
        from . import healing
        lk = self.ns_lock.new_lock(bucket, object_name)
        lk.lock(write=True)
        try:
            return healing.heal_object(self, bucket, object_name,
                                       version_id, deep, dry_run,
                                       remove_dangling)
        finally:
            lk.unlock()

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


class _LockedStream:
    """An iterator that holds a lock until its inner generator ends,
    fails, or is closed or dropped.  A class, not a generator: a
    generator that was never advanced does not run its ``finally`` when
    it is closed, so an abandoned one would keep the lock."""

    def __init__(self, lk, inner):
        self._lk = lk
        self._inner = inner

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._inner)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        lk, self._lk = self._lk, None
        if lk is not None:
            try:
                self._inner.close()
            finally:
                lk.unlock()

    def __del__(self):
        self.close()


def _disk_fileinfo(fi: FileInfo, shard_idx: int) -> FileInfo:
    """fi as drive ``shard_idx`` (0-based, shuffled order) stores it.  A
    packed extent is per drive, so ``seg`` is cleared: a target drive
    packs its own."""
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
