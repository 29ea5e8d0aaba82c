"""The data crawler: usage accounting and lifecycle expiry
(``minio_tpu/background/crawler.py``; cmd/data-crawler.go,
cmd/data-usage-cache.go, the enforcement side of
cmd/bucket-lifecycle.go).

A cycle lists every version of every bucket through the object layer and
sums a ``DataUsageInfo``: per bucket the objects, versions, bytes and a
size histogram, and on a pools layer each pool's bytes and objects
(``poolsUsageInfo``, from the same listing pass).  Where the bucket has
a lifecycle configuration, each version's due action is computed in
every cycle (a rule falls due with time alone, so a bucket nothing
changed in is evaluated too), and the expiries are carried out (current
versions, as a delete marker in a versioned bucket; noncurrent versions
dated from their successor's write; delete markers that are their
object's only version).  A version whose object lock refuses the delete
(a legal hold, a retention not yet ended) is left.  A due Transition
(of the current version, or of a noncurrent one by its version id) goes
to ``transition_fn`` with the rule's storage class, which names the tier
(``objectlayer/tiering.py transition_fn``); one that fails is tried
again next cycle.  Every listed version goes to ``restub_fn``, which
puts the stub back over a restore from the tier that has lapsed
(``TransitionSys.put_stub_back``).  The usage is persisted at
``datausage/usage.json`` in the metadata set's system volume, the
reference's bytes, where the admin ``datausageinfo`` route, the metrics
scrape and the hard quota (``UsageCache``) read it.
"""

from __future__ import annotations

import heapq
import json
import threading
import time
from dataclasses import dataclass, field

from ..bucket.lifecycle import Action, Lifecycle, ObjectOpts
from ..bucket.tags import TAG_KEY, TagError, parse_header
from ..objectlayer import interface as ol
from ..objectlayer.pools import is_pooled, merge_versions
from ..storage.datatypes import now_ns
from .progress import CycleProgress
from .tracker import DataUpdateTracker

USAGE_PATH = "datausage/usage.json"
# cmd/data-usage-cache.go sizeHistogram
HISTOGRAM = [
    ("LESS_THAN_1024_B", 0, 1024),
    ("BETWEEN_1024_B_AND_1_MB", 1024, 1 << 20),
    ("BETWEEN_1_MB_AND_10_MB", 1 << 20, 10 << 20),
    ("BETWEEN_10_MB_AND_64_MB", 10 << 20, 64 << 20),
    ("BETWEEN_64_MB_AND_128_MB", 64 << 20, 128 << 20),
    ("BETWEEN_128_MB_AND_512_MB", 128 << 20, 512 << 20),
    ("GREATER_THAN_512_MB", 512 << 20, 1 << 62),
]


@dataclass
class BucketUsage:
    objects_count: int = 0
    versions_count: int = 0
    size: int = 0
    histogram: dict[str, int] = field(default_factory=dict)


@dataclass
class DataUsageInfo:
    """cmd/data-usage-utils.go DataUsageInfo."""
    last_update_ns: int = 0
    buckets_count: int = 0
    objects_total_count: int = 0
    objects_total_size: int = 0
    bucket_usage: dict[str, BucketUsage] = field(default_factory=dict)
    # pool id -> {"bytes", "objects"} on a pools layer
    pools_usage: dict[str, dict] = field(default_factory=dict)

    def to_json(self) -> bytes:
        doc = {
            "lastUpdate": self.last_update_ns,
            "bucketsCount": self.buckets_count,
            "objectsCount": self.objects_total_count,
            "objectsTotalSize": self.objects_total_size,
            "bucketsUsageInfo": {
                b: {"objectsCount": u.objects_count,
                    "versionsCount": u.versions_count,
                    "size": u.size,
                    "objectsSizesHistogram": u.histogram}
                for b, u in self.bucket_usage.items()},
        }
        if self.pools_usage:        # a layer without pools: no section
            doc["poolsUsageInfo"] = self.pools_usage
        return json.dumps(doc).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "DataUsageInfo":
        doc = json.loads(blob)
        out = cls(last_update_ns=doc.get("lastUpdate", 0),
                  buckets_count=doc.get("bucketsCount", 0),
                  objects_total_count=doc.get("objectsCount", 0),
                  objects_total_size=doc.get("objectsTotalSize", 0))
        for b, u in doc.get("bucketsUsageInfo", {}).items():
            out.bucket_usage[b] = BucketUsage(
                u.get("objectsCount", 0), u.get("versionsCount", 0),
                u.get("size", 0), u.get("objectsSizesHistogram", {}))
        out.pools_usage = doc.get("poolsUsageInfo", {})
        return out


def _list_versions_with_pools(layer, bucket: str):
    """(every version of the bucket, per-pool usage or None) in one
    listing pass: on a pools layer each pool is listed once, counted,
    and the lists merged as the layer's own version listing merges
    them."""
    if not is_pooled(layer):
        return layer.list_object_versions(bucket).objects, None
    per_pool: dict[str, dict] = {}
    lists = []
    for pool, spec in zip(*layer.topology()):
        acc = per_pool.setdefault(spec.pool_id, {"bytes": 0, "objects": 0})
        versions = pool.list_object_versions(bucket).objects
        for oi in versions:
            if not oi.delete_marker:
                acc["bytes"] += oi.size
                acc["objects"] += 1
        lists.append(versions)
    return list(merge_versions(heapq.merge(*lists, key=lambda o: o.name))
                ), per_pool


def _histogram_bucket(size: int) -> str:
    for name, lo, hi in HISTOGRAM:
        if lo <= size < hi:
            return name
    return HISTOGRAM[-1][0]


@dataclass
class ScanResult:
    usage: DataUsageInfo
    expired: list[tuple[str, str, str]] = field(default_factory=list)
    transitioned: list[tuple[str, str]] = field(default_factory=list)
    # (bucket, name, version id) of each lapsed restore put back as a stub
    restubbed: list[tuple[str, str, str]] = field(default_factory=list)


def scan_usage(layer, bucket_meta=None, apply_lifecycle: bool = True,
               transition_fn=None, restub_fn=None,
               progress: CycleProgress | None = None) -> ScanResult:
    """One cycle: the usage of every bucket, the lifecycle expiries and
    transitions (``transition_fn(bucket, oi, storage_class)``) that are
    due, and the stubs put back over lapsed restores
    (``restub_fn(bucket, oi)`` for every version, True when it put one
    back).  The rules
    of every bucket with a lifecycle configuration are evaluated, since
    a rule falls due with time alone (the reference skips a bucket its
    tracker saw no change in, ROADMAP Queue 3 item 49).  ``progress``
    advances once per bucket."""
    res = ScanResult(DataUsageInfo(last_update_ns=now_ns()))
    info = res.usage
    for b in layer.list_buckets():
        bu = BucketUsage()
        info.bucket_usage[b.name] = bu
        lc, versioned = None, False
        if apply_lifecycle and bucket_meta is not None:
            try:
                lc = bucket_meta.get_parsed(b.name, "lifecycle",
                                            Lifecycle.parse)
            except Exception:  # noqa: BLE001 — unparseable: no lifecycle
                lc = None
            if lc is not None:
                versioned = bucket_meta.versioning_enabled(b.name)
        versions, per_pool = _list_versions_with_pools(layer, b.name)
        for pid, acc in (per_pool or {}).items():
            pu = info.pools_usage.setdefault(pid, {"bytes": 0, "objects": 0})
            pu["bytes"] += acc["bytes"]
            pu["objects"] += acc["objects"]
        # a noncurrent version became noncurrent when the version that
        # directly superseded it was written, not when the latest was
        succ_mod: dict[tuple, int] = {}
        by_name: dict[str, list] = {}
        for oi in versions:
            by_name.setdefault(oi.name, []).append(oi)
        for name, vs in by_name.items():
            vs.sort(key=lambda o: o.mod_time, reverse=True)
            for newer, older in zip(vs, vs[1:]):
                succ_mod[(name, older.version_id)] = newer.mod_time
        for oi in versions:
            if not oi.delete_marker:
                bu.versions_count += 1
                bu.size += oi.size
                h = _histogram_bucket(oi.size)
                bu.histogram[h] = bu.histogram.get(h, 0) + 1
                if oi.is_latest:
                    bu.objects_count += 1
            if restub_fn is not None and not oi.delete_marker and \
                    restub_fn(b.name, oi):
                res.restubbed.append((b.name, oi.name, oi.version_id))
            if lc is None:
                continue
            oopts = ObjectOpts(
                name=oi.name, mod_time_ns=oi.mod_time,
                user_tags=_tags_of(oi), is_latest=oi.is_latest,
                delete_marker=oi.delete_marker,
                num_versions=oi.num_versions or 1,
                successor_mod_time_ns=0 if oi.is_latest
                else succ_mod.get((oi.name, oi.version_id), 0))
            action = lc.compute_action(oopts)
            if action in (Action.DELETE, Action.DELETE_VERSION,
                          Action.DELETE_MARKER_DELETE):
                _expire(layer, b.name, oi, action, res, versioned)
            elif action in (Action.TRANSITION, Action.TRANSITION_VERSION) \
                    and transition_fn is not None:
                try:
                    transition_fn(b.name, oi,
                                  lc.transition_storage_class(oopts))
                    res.transitioned.append((b.name, oi.name))
                except Exception:  # noqa: BLE001 — tried again next cycle
                    pass
        info.buckets_count += 1
        info.objects_total_count += bu.objects_count
        info.objects_total_size += bu.size
        if progress is not None:
            progress.update(b.name, objects=bu.versions_count,
                            nbytes=bu.size)
    return res


def _tags_of(oi) -> dict[str, str]:
    """The object's stored tags (``TAG_KEY``); {} when absent or invalid
    (``bucket/tags.py parse_header``, the parser the front uses)."""
    raw = oi.user_defined.get(TAG_KEY, "")
    if not raw:
        return {}
    try:
        return parse_header(raw)
    except TagError:
        return {}


def _expire(layer, bucket: str, oi, action: Action, res: ScanResult,
            versioned: bool = False) -> None:
    """Carry out one expiry: ``DELETE`` deletes the latest version as an
    S3 DELETE without a version id does (a delete marker when the
    bucket is ``versioned``), the others delete the version named.  The
    layer refuses to remove a version its lock protects (``check_lock``,
    no bypass: a legal hold, or a retention that has not ended), judged
    on the version's metadata under the name's write lock, not on the
    listing's; such a version is passed, and so is a version a client
    removed first."""
    if action is Action.DELETE:
        opts = ol.ObjectOptions(versioned=versioned, check_lock=True)
    else:
        opts = ol.ObjectOptions(version_id=oi.version_id or "",
                                check_lock=True)
    try:
        layer.delete_object(bucket, oi.name, opts)
        res.expired.append((bucket, oi.name, oi.version_id))
    except ol.ObjectLayerError:
        pass


class UsageCache:
    """The hard quota's view of bucket usage: the last crawler snapshot
    plus the bytes written since (cmd/bucket-quota.go
    enforceBucketQuotaHard).

    Every committed write adds its size (``add_pending``); a new
    snapshot clears the deltas, which it now counts.  Charges are plain
    dict updates, so the PUT path takes no lock: a lost race undercounts
    one write until the next cycle.  Without a crawler cycle the
    persisted snapshot is re-read at most every ``reload_ttl_s``, and
    only for a bucket that has a quota (``bucket_size``)."""

    def __init__(self, layer=None, reload_ttl_s: float = 30.0):
        self.layer = layer
        self.reload_ttl_s = reload_ttl_s
        self.info: DataUsageInfo | None = None
        self._pending: dict[str, int] = {}
        self._loaded_at = float("-inf")
        self._mu = threading.Lock()
        if layer is not None:
            try:
                self.refresh(load_usage(layer))
            except Exception:  # noqa: BLE001 — no snapshot yet
                pass

    def refresh(self, info: DataUsageInfo | None) -> None:
        """Take a snapshot; None (no usage.json yet) still stamps the
        clock, so an empty cluster is not re-read on every PUT.  The
        writes since are cleared only by a newer snapshot than the one
        held, which counts them: a lazy re-read of the same usage.json
        keeps them (the reference's clears them, ROADMAP Queue 3)."""
        with self._mu:
            if info is not None and (
                    self.info is None
                    or info.last_update_ns > self.info.last_update_ns):
                self.info = info
                self._pending = {}
            self._loaded_at = time.monotonic()

    def add_pending(self, bucket: str, nbytes: int) -> None:
        if nbytes > 0:
            self._pending[bucket] = self._pending.get(bucket, 0) + nbytes

    def snapshot_doc(self) -> dict:
        """The admin ``data-usage`` route's view of the cache."""
        info = self.info
        return {
            "snapshotUpdateNs": info.last_update_ns
            if info is not None else 0,
            "pendingBytes": dict(self._pending),
            "bucketSizes": {b: u.size for b, u in info.bucket_usage.items()}
            if info is not None else {},
        }

    def bucket_size(self, bucket: str) -> int:
        """The bucket's snapshot size plus its writes since: what the
        hard quota charges a new write against."""
        if self.layer is not None and \
                time.monotonic() - self._loaded_at > self.reload_ttl_s:
            try:
                self.refresh(load_usage(self.layer))
            except Exception:  # noqa: BLE001 — stale beats failing
                pass
        info = self.info
        base = 0
        if info is not None:
            bu = info.bucket_usage.get(bucket)
            if bu is not None:
                base = bu.size
        return base + self._pending.get(bucket, 0)


def persist_usage(layer, info: DataUsageInfo) -> None:
    from ..storage.xl_storage import SYS_DIR
    blob = info.to_json()
    er = layer.meta_set
    er._fanout(lambda d: d.write_all(SYS_DIR, USAGE_PATH, blob), er.disks)


def load_usage(layer) -> DataUsageInfo | None:
    from ..storage.xl_storage import SYS_DIR
    er = layer.meta_set
    res, _ = er._fanout(lambda d: d.read_all(SYS_DIR, USAGE_PATH), er.disks)
    for r in res:
        if r is not None:
            try:
                return DataUsageInfo.from_json(r)
            except (ValueError, KeyError):
                continue
    return None


class Crawler:
    """The scan loop (initDataCrawler, cmd/server-main.go:499): a cycle
    every ``interval_s`` plus the ``scanner`` pacing, usage persisted,
    the tracker advanced (the listing caches read its history)."""

    def __init__(self, layer, bucket_meta=None, interval_s: float = 60.0,
                 transition_fn=None, tracker: DataUpdateTracker | None = None,
                 restub_fn=None):
        self.layer = layer
        self.bucket_meta = bucket_meta
        self.interval_s = interval_s
        self.transition_fn = transition_fn
        self.restub_fn = restub_fn
        self.tracker = tracker or DataUpdateTracker()
        self.last: ScanResult | None = None
        self.cycles = 0
        self.progress = CycleProgress("scanner")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # the ``scanner`` kvconfig (delay, max_wait), pushed live by
        # S3Server.reload_background_config: after a cycle the loop also
        # waits delay x that cycle's seconds, at most max_wait, so a
        # costly walk slows itself down
        self.delay_mult = 0.0
        self.max_wait_s = 15.0
        self._last_cycle_s = 0.0
        # the server's UsageCache, refreshed at the end of every cycle
        self.usage_cache: UsageCache | None = None

    def _wait_s(self) -> float:
        return self.interval_s + min(self.max_wait_s,
                                     self.delay_mult * self._last_cycle_s)

    def run_cycle(self) -> ScanResult:
        t0 = time.monotonic()
        self.progress.begin()
        try:
            res = scan_usage(self.layer, self.bucket_meta,
                             transition_fn=self.transition_fn,
                             restub_fn=self.restub_fn,
                             progress=self.progress)
        except BaseException:
            # a partial walk is not a cycle
            self.progress.abort()
            raise
        self.progress.end()
        persist_usage(self.layer, res.usage)
        if self.usage_cache is not None:
            self.usage_cache.refresh(res.usage)
        self.tracker.advance()
        self.last = res
        self.cycles += 1
        self._last_cycle_s = time.monotonic() - t0
        return res

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self._wait_s()):
                try:
                    self.run_cycle()
                except Exception:  # noqa: BLE001 — the loop survives
                    time.sleep(1)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mt-crawler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
