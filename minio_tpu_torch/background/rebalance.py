"""The rebalance and decommission drain (``minio_tpu/background/
rebalance.py``; cmd/erasure-server-pool-rebalance.go,
cmd/erasure-server-pool-decom.go).

The ``Rebalancer`` moves object versions off a source pool, a draining
one first, else the fullest active pool once the pools' free fractions
spread past ``threshold``, onto the active pool with the most free
bytes.  A move copies a version with its identity (version id, mod
time, ETag, metadata, a multipart object's part table, a delete
marker's own version id), verifies it (the destination's Content-MD5
check, or the merged multipart ETag) and deletes the source; a repeated
move finds its copy and only deletes.  A journal on pool 0's metadata
set (``rebalance/journal.json``, the highest ``seq`` wins) keeps the
buckets done and the last key moved, so a restart resumes the drain
without losing or repeating a version.  The ``rebalance`` kvconfig sets
``enable``, ``max_workers`` (keys moved at once) and ``bandwidth`` (a
token bucket, bytes/s); ``pace_s`` (``heal.max_sleep``) yields the drives
after each move, as the heal sweep does.

Left out, as the port has no such plane yet: the reference's hot-read
fence before the source delete (ROADMAP Queue 1 item 17; the listing
cache is still invalidated) and its flight-recorder rows for failed
moves (item 11).  The versions are listed in pages (``_names_from``),
not in one list; the null version is read by its id, not as the latest;
a null version with a later copy in another pool is not copied back over
it; and with ``enable`` off the loop still drains a decommissioned pool
(ROADMAP Queue 3).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import uuid
from dataclasses import dataclass, field

from ..objectlayer.interface import (MethodNotAllowed, ObjectNotFound,
                                     ObjectOptions, PutObjectOptions,
                                     VersionNotFound)
from ..objectlayer.pools import STATUS_DRAINING
from ..storage.datatypes import FileInfo
from ..storage.xl_storage import SYS_DIR
from .progress import CycleProgress
from .replication import BandwidthMonitor

JOURNAL_PATH = "rebalance/journal.json"
# the token bucket's key in the BandwidthMonitor (not an S3 bucket)
_BW_KEY = "rebalance"
_PAGE = 1000


def _is_plain_md5(etag: str) -> bool:
    if len(etag) != 32:
        return False
    try:
        int(etag, 16)
        return True
    except ValueError:
        return False


@dataclass
class RebalanceStats:
    """madmin's rebalance status counters."""
    moved_objects: int = 0
    moved_bytes: int = 0
    failed: int = 0
    skipped: int = 0
    cycles: int = 0
    last_cycle_ns: int = 0

    def to_dict(self) -> dict:
        return {
            "movedObjects": self.moved_objects,
            "movedBytes": self.moved_bytes,
            "failed": self.failed,
            "skipped": self.skipped,
            "cycles": self.cycles,
            "lastCycle": self.last_cycle_ns,
        }


def move_version(pools, src_idx: int, dst_idx: int, bucket: str,
                 oi) -> int:
    """Copy one version from pool ``src_idx`` to ``dst_idx``, verify it,
    delete it from the source; the bytes copied (0 when the copy was
    already there, a later copy of a null version lives in another
    pool, or the version is gone).  The whole move holds the pools'
    name lock, so no PUT, delete or completed upload of the name lands
    between its checks and its commit, and the version is read again
    under it (the listing that named it may be stale).  The source's
    listing cache is dropped before the source delete, so a read
    mid-move finds the source version or its copy, never neither."""
    src, dst = pools.pools[src_idx], pools.pools[dst_idx]
    name, vid = oi.name, oi.version_id or ""
    ropts = ObjectOptions(version_id=vid)
    with pools.name_lock(bucket, name):
        try:
            oi = src.get_object_info(bucket, name, ropts)
        except (ObjectNotFound, VersionNotFound):
            return 0
        copied = 0
        if not _dest_has_version(dst, bucket, oi) and \
                not (not vid and _newer_elsewhere(pools, src_idx, bucket,
                                                  oi)):
            if oi.delete_marker:
                _copy_delete_marker(dst, bucket, oi)
            elif "-" in (oi.etag or "") and oi.parts:
                copied = _copy_multipart(src, dst, bucket, oi, ropts)
            else:
                _, data = src.get_object(bucket, name, opts=ropts)
                popts = PutObjectOptions(
                    user_defined=dict(oi.user_defined), versioned=bool(vid),
                    version_id=vid, mod_time=oi.mod_time,
                    preserve_etag=oi.etag)
                if _is_plain_md5(oi.etag):
                    # the write's Content-MD5 check is the verify: a bad
                    # read raises BadDigest before the copy is visible
                    popts.content_md5 = oi.etag
                dst.put_object(bucket, name, data, popts)
                copied = oi.size
        src.get_hashed_set(name).metacache.invalidate(bucket)
        src.delete_object(bucket, name, ObjectOptions(version_id=vid))
    return copied


def _dest_has_version(dst, bucket: str, oi) -> bool:
    """Did an earlier attempt land this version on ``dst``?  For the null
    version, a copy as new or newer counts (an overwrite placed there
    after the drain began)."""
    try:
        doi = dst.get_object_info(bucket, oi.name,
                                  ObjectOptions(version_id=oi.version_id
                                                or ""))
    except (ObjectNotFound, VersionNotFound):
        return False
    except MethodNotAllowed:
        return oi.delete_marker
    if oi.version_id:
        return True
    return doi.mod_time >= oi.mod_time


def _newer_elsewhere(pools, src_idx: int, bucket: str, oi) -> bool:
    """A null version as new or newer than ``oi`` in a pool other than
    the source: an overwrite placed there while this pool drained, which
    a copy would leave beside an older one."""
    for i, p in enumerate(pools.pools):
        if i != src_idx and _dest_has_version(p, bucket, oi):
            return True
    return False


def _copy_delete_marker(dst, bucket: str, oi) -> None:
    """The delete marker with its own version id and mod time on the
    destination's set (``put_object`` cannot write a marker)."""
    leaf = dst.get_hashed_set(oi.name)
    dm = FileInfo(volume=bucket, name=oi.name, version_id=oi.version_id,
                  deleted=True, data_dir="", mod_time=oi.mod_time)
    lk = leaf.ns_lock.new_lock(bucket, oi.name)
    lk.lock(write=True)
    try:
        _, errs = leaf._fanout(
            lambda d: d.delete_version(bucket, oi.name, dm,
                                       force_del_marker=True), leaf.disks)
        leaf._reduce_quorum(errs, leaf._set_write_quorum())
        leaf.metacache.invalidate(bucket)
    finally:
        lk.unlock()


def _copy_multipart(src, dst, bucket: str, oi, ropts) -> int:
    """A multipart version part by part: ranged reads at the source's
    part boundaries uploaded as the same parts, so the part MD5s and the
    ``md5(concat)-N`` ETag come out the same; a copy whose ETag differs
    is deleted and the source kept."""
    vid = oi.version_id or ""
    uid = dst.new_multipart_upload(
        bucket, oi.name, PutObjectOptions(user_defined=dict(oi.user_defined),
                                          versioned=bool(vid)))
    try:
        done = []
        offset = 0
        for num, size in oi.parts:
            _, data = src.get_object(bucket, oi.name, offset, size, ropts)
            pi = dst.put_object_part(bucket, oi.name, uid, num, data)
            done.append((num, pi.etag))
            offset += size
        noi = dst.complete_multipart_upload(
            bucket, oi.name, uid, done,
            PutObjectOptions(versioned=bool(vid), version_id=vid,
                             mod_time=oi.mod_time))
    except BaseException:
        try:
            dst.abort_multipart_upload(bucket, oi.name, uid)
        except Exception:  # noqa: BLE001 — nothing staged, or gone
            pass
        raise
    if noi.etag != oi.etag:
        dst.delete_object(bucket, oi.name, ObjectOptions(version_id=vid))
        raise ValueError(
            f"multipart move etag mismatch: {noi.etag} != {oi.etag}")
    return oi.size


def _names_from(layer, bucket: str, after: str, stop):
    """(name, versions) of every key after ``after``, paged through
    ``list_object_versions``.  A key's versions are gathered whole
    before it is yielded, so the next page is asked for while its marker
    version still exists."""
    def versions():
        key, vid = after, ""
        while not stop.is_set():
            out = layer.list_object_versions(bucket, key_marker=key,
                                             version_id_marker=vid,
                                             max_keys=_PAGE)
            yield from out.objects
            if not out.is_truncated:
                return
            key, vid = out.next_key_marker, out.next_version_id_marker
    for name, group in itertools.groupby(versions(), key=lambda o: o.name):
        yield name, list(group)


@dataclass
class Rebalancer:
    """The drain loop, shaped like the heal sweep: a thread wakes every
    ``interval_s`` (or at ``kick()``), picks a source pool and drains it
    bucket by bucket, the journal written after every chunk of keys."""

    pools: object                      # ErasureServerPools
    interval_s: float = 60.0
    pace_s: float = 0.0
    bandwidth_bps: int = 0             # 0: no limit
    max_workers: int = 1
    enabled: bool = True
    threshold: float = 0.1             # free-fraction spread that triggers
    stats: RebalanceStats = field(default_factory=RebalanceStats)

    def __post_init__(self):
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._journal_seq = 0
        self.progress = CycleProgress("rebalance")
        self.monitor = BandwidthMonitor()

    def reload(self, cfg, pace_s: float) -> None:
        """The live ``rebalance`` knobs (``enable``, ``max_workers``,
        ``bandwidth``) from the server's config, and ``pace_s``
        (``heal.max_sleep``); a value that does not parse changes
        nothing."""
        try:
            enabled = cfg.get("rebalance", "enable") == "on"
            workers = int(cfg.get("rebalance", "max_workers") or 1)
            bandwidth = int(cfg.get("rebalance", "bandwidth") or 0)
        except (KeyError, ValueError):
            return
        self.enabled, self.max_workers = enabled, workers
        self.bandwidth_bps, self.pace_s = bandwidth, pace_s
        self.monitor.set_limit(_BW_KEY, bandwidth)

    # -- the journal ------------------------------------------------------

    def _save_journal(self, doc: dict) -> None:
        self._journal_seq += 1
        doc["seq"] = self._journal_seq
        blob = json.dumps(doc).encode()
        self.pools._sys_fanout(lambda d: d.write_all(SYS_DIR, JOURNAL_PATH,
                                                     blob))

    def load_journal(self) -> dict | None:
        """The copy with the highest ``seq``."""
        res, _ = self.pools._sys_fanout(
            lambda d: d.read_all(SYS_DIR, JOURNAL_PATH))
        best = None
        for blob in res:
            if blob is None:
                continue
            try:
                doc = json.loads(blob)
            except ValueError:
                continue
            if best is None or doc.get("seq", 0) > best.get("seq", 0):
                best = doc
        if best is not None:
            self._journal_seq = max(self._journal_seq, best.get("seq", 0))
        return best

    # -- which pool, to where -----------------------------------------------

    def _pool_free_fractions(self) -> list[float]:
        out = []
        for p in self.pools.pools:
            free = total = 0
            for d in p.disks:
                if d is None:
                    continue
                try:
                    di = d.disk_info()
                except Exception:  # noqa: BLE001 — an offline drive
                    continue
                free += di.free
                total += di.total
            out.append(free / total if total else 1.0)
        return out

    def pick_source(self, draining_only: bool = False) -> int | None:
        """A draining pool, unconditionally; else (unless
        ``draining_only``) the fullest active pool when the active pools'
        free fractions spread past ``threshold``."""
        for i, sp in enumerate(self.pools.specs):
            if sp.status == STATUS_DRAINING:
                return i
        active = self.pools._active_idxs()
        if draining_only or len(active) < 2:
            return None
        fracs = self._pool_free_fractions()
        lo = min(active, key=lambda i: fracs[i])
        hi = max(active, key=lambda i: fracs[i])
        if fracs[hi] - fracs[lo] <= self.threshold:
            return None
        return lo

    def _pick_dest(self, src_idx: int) -> int | None:
        active = [i for i in self.pools._active_idxs() if i != src_idx]
        if not active:
            return None
        frees = self.pools._free_spaces()
        return max(active, key=frees.__getitem__)

    # -- the drain ------------------------------------------------------------

    def _move_name(self, src_idx: int, bucket: str, name: str,
                   versions: list) -> None:
        """Every version of one key, oldest first: the journal's unit."""
        dst_idx = self._pick_dest(src_idx)
        if dst_idx is None:
            raise RuntimeError("no active destination pool")
        for oi in sorted(versions, key=lambda o: o.mod_time):
            t0 = time.monotonic()
            try:
                nbytes = move_version(self.pools, src_idx, dst_idx, bucket,
                                      oi)
            except Exception:
                self.stats.failed += 1
                raise
            finally:
                if self.pace_s > 0:
                    time.sleep(min(self.pace_s, time.monotonic() - t0))
            if nbytes:
                self.stats.moved_objects += 1
                self.stats.moved_bytes += nbytes
            else:
                self.stats.skipped += 1
            self.progress.update(bucket, name, nbytes=nbytes)
            if self.bandwidth_bps > 0 and nbytes:
                self.monitor.throttle(_BW_KEY, nbytes)

    def _move_chunk(self, src_idx: int, bucket: str, chunk: list) -> None:
        """A chunk of (name, versions), ``max_workers`` keys at once; any
        failure raises after all have ended (the journal's cursor passes
        only a chunk moved whole; a retry skips what landed)."""
        if len(chunk) == 1:
            self._move_name(src_idx, bucket, *chunk[0])
            return
        errs: list[Exception] = []

        def one(name, versions):
            try:
                self._move_name(src_idx, bucket, name, versions)
            except Exception as e:  # noqa: BLE001 — raised below
                errs.append(e)

        threads = [threading.Thread(target=one, args=item, daemon=True,
                                    name=f"mt-rebalance-mv{i}")
                   for i, item in enumerate(chunk)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]

    def rebalance_pool(self, src_idx: int) -> bool:
        """Drain one pool to its end, or until ``stop()``; resumes the
        journal when it is this pool's and running.  True when the whole
        namespace was passed."""
        self.monitor.set_limit(_BW_KEY, self.bandwidth_bps)
        src_id = self.pools.specs[src_idx].pool_id
        journal = self.load_journal()
        if journal is None or journal.get("srcPool") != src_id or \
                journal.get("state") != "running":
            journal = {"version": 1, "id": uuid.uuid4().hex,
                       "srcPool": src_id, "state": "running",
                       "doneBuckets": [], "cursor": {}, "stats": {}}
            self._save_journal(journal)
        src = self.pools.pools[src_idx]
        self.progress.begin()
        completed = False
        try:
            for b in self.pools.list_buckets():
                if self._stop.is_set():
                    return False
                if b.name in journal["doneBuckets"]:
                    continue
                cursor = journal.get("cursor", {})
                after = cursor.get("key", "") \
                    if cursor.get("bucket") == b.name else ""
                names = _names_from(src, b.name, after, self._stop)
                workers = max(1, int(self.max_workers))
                while True:
                    chunk = list(itertools.islice(names, workers))
                    if self._stop.is_set():
                        return False
                    if not chunk:
                        break
                    self._move_chunk(src_idx, b.name, chunk)
                    journal["cursor"] = {"bucket": b.name,
                                         "key": chunk[-1][0]}
                    journal["stats"] = self.stats.to_dict()
                    self._save_journal(journal)
                journal["doneBuckets"].append(b.name)
                journal["cursor"] = {}
                self._save_journal(journal)
            journal["state"] = "done"
            journal["stats"] = self.stats.to_dict()
            self._save_journal(journal)
            completed = True
            return True
        finally:
            if completed:
                self.progress.end()
                self.stats.cycles += 1
                self.stats.last_cycle_ns = time.time_ns()
            else:
                self.progress.abort()

    def run_once(self, draining_only: bool = False) -> bool:
        """Pick a source, drain it, and retire it when it was draining
        and is empty now.  True when there was work."""
        src_idx = self.pick_source(draining_only)
        if src_idx is None:
            return False
        finished = self.rebalance_pool(src_idx)
        if finished and \
                self.pools.specs[src_idx].status == STATUS_DRAINING:
            versions, uploads = self.pools.decommission_pending(src_idx)
            if versions == 0 and uploads == 0:
                self.pools.finish_decommission(src_idx)
        return True

    # -- the loop -------------------------------------------------------------

    def start(self) -> None:
        def loop():
            while True:
                self._wake.wait(self.interval_s)
                self._wake.clear()
                if self._stop.is_set():
                    return
                try:
                    # off, the loop still drains a decommissioned pool
                    self.run_once(draining_only=not self.enabled)
                except Exception:  # noqa: BLE001 — the loop survives;
                    time.sleep(1)  # the journal resumes the drain

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mt-rebalance")
        self._thread.start()

    def kick(self) -> None:
        """Wake the loop now (pool-add, pool-decommission)."""
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def status(self) -> dict:
        return {
            "enabled": self.enabled,
            "draining": [sp.pool_id for sp in self.pools.specs
                         if sp.status == STATUS_DRAINING],
            "bandwidth": self.monitor.report().get(_BW_KEY, {}),
            "stats": self.stats.to_dict(),
            "progress": self.progress.snapshot(),
        }
