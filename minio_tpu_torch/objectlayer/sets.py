"""Several erasure sets as one namespace (``minio_tpu/objectlayer/
sets.py``, cmd/erasure-sets.go:54).

Objects spread over ``set_count`` independent ``ErasureObjects`` sets,
all on one device, by a SipHash of the object name keyed by the
deployment id (sipHashMod, cmd/erasure-sets.go:629; the legacy CRC mode,
crcHashMod :638, for formats that name it).  Every bucket exists on
every set.  Object, multipart and heal calls go to the object's set;
bucket calls fan out to every set; listings merge the sets' sorted
streams, each from the set's own listing snapshot (``metacache.py``),
before they are paged, so a page is the one a single set holding every
key would give.  The bucket metadata (versioning) lives on set 0's
drives, as the reference keeps it.
"""

from __future__ import annotations

import heapq
import itertools
import zlib
from typing import Optional

from ..hashing.siphash import sip_hash_mod
from ..storage import health as health_mod
from ..storage.format import DISTRIBUTION_ALGO_V3, load_or_init_format
from ..storage.xl_storage import XLStorage
from .erasure_object import ErasureObjects
from .interface import (BucketInfo, BucketNotFound, ListObjectsInfo,
                        ListObjectVersionsInfo, MultipartInfo, ObjectInfo)
from .metacache import SnapshotGone, paginate, paginate_versions

DISTRIBUTION_ALGO_CRC = "CRCMOD"


def aggregate_health(children: list, maintenance: bool) -> dict:
    """Healthy only if every child keeps its write quorum
    (cmd/erasure-server-pool.go:1509)."""
    results = [c.health(maintenance) for c in children]
    return {
        "healthy": all(r["healthy"] for r in results),
        "write_quorum": max(r["write_quorum"] for r in results),
        "healing_drives": sum(r["healing_drives"] for r in results),
        "online_drives": sum(r["online_drives"] for r in results),
    }


def _newest_per_name(entries):
    """One entry per name of a name-sorted stream: the latest written
    (a name two pools hold while it moves)."""
    for _, group in itertools.groupby(entries, key=lambda o: o.name):
        yield max(group, key=lambda o: o.mod_time)


def list_leaves(leaves: list, bucket: str, prefix: str, marker: str,
                delimiter: str, max_keys: int) -> ListObjectsInfo:
    """One page of the erasure sets' listing snapshots merged into one
    sorted stream from ``marker`` on, a name held twice listed once; a
    snapshot whose block vanished is forgotten and walked again, and
    after a second loss the page comes off fresh walks."""
    for _ in range(2):
        snaps = [s.listing_snapshot(bucket, prefix) for s in leaves]
        try:
            return paginate(_newest_per_name(heapq.merge(
                *(snap.iter_from(marker) for snap in snaps),
                key=lambda o: o.name)), prefix, marker, delimiter, max_keys)
        except SnapshotGone:
            for s in leaves:
                s.metacache.forget(bucket, prefix)
    merged = heapq.merge(*(s._gather_listing_iter(bucket, prefix, marker)
                           for s in leaves), key=lambda o: o.name)
    return paginate(_newest_per_name(merged), prefix, marker, delimiter,
                    max_keys)


class ErasureSets:
    """cmd/erasure-sets.go erasureSets."""

    def __init__(self, disks: list, set_count: int, set_drive_count: int,
                 deployment_id: str = "",
                 distribution_algo: str = DISTRIBUTION_ALGO_V3,
                 **set_kwargs):
        """``set_kwargs`` go to every set's ``ErasureObjects`` (parity,
        block_size, device, mesh, enforce_min_part_size, and a cluster's
        ns_lock, which every set shares)."""
        if len(disks) != set_count * set_drive_count:
            raise ValueError(f"{len(disks)} drives are not {set_count} "
                             f"sets of {set_drive_count}")
        self.set_count = set_count
        self.set_drive_count = set_drive_count
        self.deployment_id = deployment_id
        self.distribution_algo = distribution_algo
        self.monitor: Optional[health_mod.DriveMonitor] = None
        self.sets: list[ErasureObjects] = []
        try:
            for i in range(set_count):
                self.sets.append(ErasureObjects(
                    disks[i * set_drive_count:(i + 1) * set_drive_count],
                    **set_kwargs))
        except BaseException:
            self.close()
            raise
        self.disks = [d for s in self.sets for d in s.disks]

    @property
    def meta_set(self) -> ErasureObjects:
        """The set whose drives keep the bucket metadata (the reference's
        ``_fanout``, ``minio_tpu/objectlayer/sets.py:257``)."""
        return self.sets[0]

    @classmethod
    def from_dirs(cls, dirs: list[str], set_count: int,
                  set_drive_count: int, health: bool = True,
                  **set_kwargs) -> "ErasureSets":
        """Load or write every drive's format.json (waitForFormatErasure),
        then build the sets.  With ``health`` each drive is wrapped in a
        ``HealthDisk`` that expects its place in the format and heals its
        set when it returns (cmd/erasure-sets.go:196-332)."""
        disks = [XLStorage(d) for d in dirs]
        fmt = load_or_init_format(disks, set_count, set_drive_count)
        bind = None
        if health:
            disks, bind = health_mod.wrap_with_heal(disks, fmt,
                                                    set_drive_count)
        obj = cls(disks, set_count, set_drive_count, deployment_id=fmt.id,
                  distribution_algo=fmt.distribution_algo, **set_kwargs)
        if bind is not None:
            bind(obj)
        return obj

    def set_for_disk(self, disk) -> Optional[ErasureObjects]:
        """The set that holds ``disk`` (by identity)."""
        for s in self.sets:
            if any(d is disk for d in s.disks):
                return s
        return None

    def start_drive_monitor(self, interval_s: float = 5.0
                            ) -> health_mod.DriveMonitor:
        """The reconnect loop over every wrapped drive
        (monitorAndConnectEndpoints, cmd/erasure-sets.go:269)."""
        self.monitor = health_mod.DriveMonitor(self.disks,
                                               interval_s=interval_s)
        self.monitor.start()
        return self.monitor

    def close(self) -> None:
        """Stop the drive monitor, then close every set (its writer
        threads, fan-out pool and segment files)."""
        if self.monitor is not None:
            self.monitor.stop()
        for s in self.sets:
            s.close()

    # -- placement (cmd/erasure-sets.go:629-661) ----------------------------

    def get_hashed_set_index(self, object_name: str) -> int:
        if self.distribution_algo == DISTRIBUTION_ALGO_CRC:
            crc = zlib.crc32(object_name.encode()) & 0xFFFFFFFF
            return crc % self.set_count
        key = self.deployment_id.replace("-", "")[:32].ljust(32, "0")
        return sip_hash_mod(object_name, self.set_count,
                            bytes.fromhex(key))

    def get_hashed_set(self, object_name: str) -> ErasureObjects:
        return self.sets[self.get_hashed_set_index(object_name)]

    # -- buckets: every set -------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        self.sets[0].make_bucket(bucket)
        for s in self.sets[1:]:
            try:
                s.make_bucket(bucket)
            except Exception:  # noqa: BLE001 — healed by heal_bucket
                pass

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        return self.sets[0].get_bucket_info(bucket)

    _check_bucket = get_bucket_info

    def list_buckets(self) -> list[BucketInfo]:
        return self.sets[0].list_buckets()

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        """Delete from every set; when one refuses (not empty), the sets
        already deleted get the bucket back, so it never half exists
        (cmd/erasure-sets.go DeleteBucket)."""
        done = []
        for s in self.sets:
            try:
                s.delete_bucket(bucket, force)
            except Exception:
                for prev in done:
                    try:
                        prev.make_bucket(bucket)
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                raise
            done.append(s)

    def heal_bucket(self, bucket: str) -> int:
        """Make the bucket on every set that lacks it (healBucket,
        cmd/erasure-healing.go:56); returns the sets made."""
        healed = 0
        for s in self.sets:
            try:
                s.get_bucket_info(bucket)
            except BucketNotFound:
                try:
                    s.make_bucket(bucket)
                    healed += 1
                except Exception:  # noqa: BLE001 — the next sweep retries
                    pass
        return healed

    def health(self, maintenance: bool = False) -> dict:
        return aggregate_health(self.sets, maintenance)

    # -- objects: the object's set ------------------------------------------

    def put_object(self, bucket, object_name, data, opts=None) -> ObjectInfo:
        return self.get_hashed_set(object_name).put_object(
            bucket, object_name, data, opts)

    def get_object(self, bucket, object_name, offset=0, length=-1,
                   opts=None):
        return self.get_hashed_set(object_name).get_object(
            bucket, object_name, offset, length, opts)

    def get_object_reader(self, bucket, object_name, offset=0, length=-1,
                          opts=None, **kw):
        return self.get_hashed_set(object_name).get_object_reader(
            bucket, object_name, offset, length, opts, **kw)

    def get_object_info(self, bucket, object_name, opts=None) -> ObjectInfo:
        return self.get_hashed_set(object_name).get_object_info(
            bucket, object_name, opts)

    def delete_object(self, bucket, object_name, opts=None) -> ObjectInfo:
        return self.get_hashed_set(object_name).delete_object(
            bucket, object_name, opts)

    def put_object_metadata(self, bucket, object_name, version_id, updates,
                            removes=()) -> ObjectInfo:
        return self.get_hashed_set(object_name).put_object_metadata(
            bucket, object_name, version_id, updates, removes)

    def heal_object(self, bucket, object_name, version_id=None, deep=False,
                    dry_run=False, remove_dangling=False):
        return self.get_hashed_set(object_name).heal_object(
            bucket, object_name, version_id, deep, dry_run, remove_dangling)

    # -- listings: the sets' sorted streams merged, then paged --------------

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000
                     ) -> ListObjectsInfo:
        """One page of the sets' snapshots merged from ``marker`` on
        (each set's metacache); a lost block is handled as one set's
        ``list_objects`` handles it."""
        self._check_bucket(bucket)
        return list_leaves(self.sets, bucket, prefix, marker, delimiter,
                           max_keys)

    def list_object_versions(self, bucket: str, prefix: str = "",
                             key_marker: str = "",
                             version_id_marker: str = "",
                             max_keys: int = -1) -> ListObjectVersionsInfo:
        """Every set's versions merged by key (a key lives in one set, so
        its versions stay newest first), then paged."""
        self._check_bucket(bucket)
        merged = heapq.merge(*(s._versions_iter(bucket, prefix, key_marker)
                               for s in self.sets), key=lambda o: o.name)
        return paginate_versions(merged, key_marker, version_id_marker,
                                 max_keys)

    # -- multipart: the object's set ----------------------------------------

    def new_multipart_upload(self, bucket, object_name, opts=None) -> str:
        return self.get_hashed_set(object_name).new_multipart_upload(
            bucket, object_name, opts)

    def put_object_part(self, bucket, object_name, upload_id, part_number,
                        data, content_md5=None):
        return self.get_hashed_set(object_name).put_object_part(
            bucket, object_name, upload_id, part_number, data, content_md5)

    def get_multipart_info(self, bucket, object_name, upload_id
                           ) -> MultipartInfo:
        return self.get_hashed_set(object_name).get_multipart_info(
            bucket, object_name, upload_id)

    def list_object_parts(self, bucket, object_name, upload_id):
        return self.get_hashed_set(object_name).list_object_parts(
            bucket, object_name, upload_id)

    def complete_multipart_upload(self, bucket, object_name, upload_id,
                                  parts, opts=None) -> ObjectInfo:
        return self.get_hashed_set(object_name).complete_multipart_upload(
            bucket, object_name, upload_id, parts, opts)

    def abort_multipart_upload(self, bucket, object_name, upload_id) -> None:
        return self.get_hashed_set(object_name).abort_multipart_upload(
            bucket, object_name, upload_id)

    def list_multipart_uploads(self, bucket: str,
                               prefix: str = "") -> list[MultipartInfo]:
        out = []
        for s in self.sets:
            out.extend(s.list_multipart_uploads(bucket, prefix))
        return sorted(out, key=lambda m: m.object_name)
