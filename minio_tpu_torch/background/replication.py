"""Bucket replication between servers and bandwidth throttling
(``minio_tpu/background/replication.py``; cmd/bucket-replication.go:456
replicateObject, cmd/bucket-targets.go, pkg/bucket/bandwidth/monitor.go:63
and throttle.go).

``ReplicationSys`` holds one remote target per source bucket, persisted
at ``replication/targets.json`` in the metadata set's system volume in
the reference's bytes (each package loads the other's), and a pool of
workers.  ``queue`` decides through the bucket's replication config
(``Config.replicate``, mustReplicate) whether a write or a delete
replicates, stamps the queued version PENDING and hands the task to the
worker its key hashes to, so the tasks of one key run in queue order.
A worker reads the queued version's plain bytes whole (``read_fn``: the
server's GET decode, ``s3/handlers_object.py read_version``), paces them
through the bucket's bandwidth limit, PUTs them to the target with the
version's ``x-amz-meta-*`` headers, its content type and
``x-amz-replication-status: REPLICA``, and stamps that version
COMPLETED; a task that fails (a stub without a valid restore, an SSE-C
object whose key only its client holds, a target that does not answer)
stamps it FAILED and counts in ``stats.failed``.  A delete replicates as
a DELETE of the name on the target.  ``stop`` joins the workers; tasks
still queued stay PENDING.  There are no trace spans (ROADMAP Queue 1
item 11).  ``BandwidthMonitor`` is also the rebalancer's throttle.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import zlib
from dataclasses import dataclass

from ..bucket.replication import Config as ReplConfig
from .crawler import _tags_of
from .progress import CycleProgress

STATUS_KEY = "x-amz-replication-status"   # xhttp.AmzBucketReplicationStatus
TARGETS_PATH = "replication/targets.json"


class BandwidthMonitor:
    """Per-key token-bucket throttle and byte accounting (the monitor
    measures, the throttle enforces)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._limits: dict[str, int] = {}       # key -> bytes/s
        self._tokens: dict[str, tuple[float, float]] = {}  # (tokens, ts)
        self._moved: dict[str, int] = {}        # key -> total bytes

    def set_limit(self, key: str, bytes_per_s: int) -> None:
        """``bytes_per_s`` <= 0 lifts the limit."""
        with self._mu:
            if bytes_per_s <= 0:
                self._limits.pop(key, None)
            else:
                self._limits[key] = bytes_per_s

    def throttle(self, key: str, nbytes: int) -> float:
        """Account ``nbytes``; sleep as long as keeps ``key`` under its
        limit.  Returns the seconds slept."""
        with self._mu:
            self._moved[key] = self._moved.get(key, 0) + nbytes
            limit = self._limits.get(key)
            if not limit:
                return 0.0
            now = time.monotonic()
            tokens, ts = self._tokens.get(key, (float(limit), now))
            tokens = min(float(limit), tokens + (now - ts) * limit)
            tokens -= nbytes
            self._tokens[key] = (tokens, now)
            wait = -tokens / limit if tokens < 0 else 0.0
        if wait > 0:
            time.sleep(wait)
        return wait

    def report(self) -> dict:
        """madmin.BucketBandwidthReport's shape."""
        with self._mu:
            return {k: {"limitInBytesPerSecond": self._limits.get(k, 0),
                        "totalBytesMoved": self._moved.get(k, 0)}
                    for k in set(self._limits) | set(self._moved)}


@dataclass
class ReplicationTarget:
    """A remote bucket (cmd/bucket-targets.go TargetClient)."""
    arn: str
    endpoint: str
    target_bucket: str
    access_key: str = ""
    secret_key: str = ""
    region: str = "us-east-1"

    def to_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class ReplStats:
    queued: int = 0
    replicated: int = 0
    replica_bytes: int = 0
    failed: int = 0
    deletes_replicated: int = 0

    def to_dict(self) -> dict:
        return {"queued": self.queued, "replicated": self.replicated,
                "replicaBytes": self.replica_bytes, "failed": self.failed,
                "deletesReplicated": self.deletes_replicated}


def load_targets(layer) -> dict[str, ReplicationTarget]:
    """The persisted targets (source bucket -> target), from the first
    drive of the metadata set that holds a readable ``targets.json``."""
    from ..storage.xl_storage import SYS_DIR
    er = layer.meta_set
    res, _ = er._fanout(lambda d: d.read_all(SYS_DIR, TARGETS_PATH),
                        er.disks)
    for r in res:
        if r is None:
            continue
        try:
            return {b: ReplicationTarget(**t)
                    for b, t in json.loads(r).items()}
        except (ValueError, TypeError):
            continue
    return {}


class ReplicationSys:
    """The targets, the queues and the workers; the server's
    ``replication``."""

    def __init__(self, layer, bucket_meta, read_fn, workers: int = 2,
                 monitor: BandwidthMonitor | None = None):
        """``read_fn(bucket, name, version_id) -> (info, bytes)``: what a
        task sends, the version's plain bytes (the server's
        ``read_version``)."""
        self.layer = layer
        self.bucket_meta = bucket_meta
        self.monitor = monitor or BandwidthMonitor()
        self.read_fn = read_fn
        self.stats = ReplStats()
        self.progress = CycleProgress("replication")
        self._mu = threading.Lock()
        self._targets = load_targets(layer)     # bucket -> target
        # one queue per worker: a key's tasks go to one of them
        self._queues = [queue.Queue() for _ in range(max(1, workers))]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- the target registry -------------------------------------------------

    def set_target(self, bucket: str, target: ReplicationTarget) -> None:
        with self._mu:
            self._targets[bucket] = target
            self._persist_targets()

    def remove_target(self, bucket: str) -> None:
        with self._mu:
            self._targets.pop(bucket, None)
            self._persist_targets()

    def get_target(self, bucket: str) -> ReplicationTarget | None:
        return self._targets.get(bucket)

    def targets(self) -> dict[str, ReplicationTarget]:
        return dict(self._targets)

    def arn_exists(self, arn: str) -> bool:
        """A registered target has this ARN (the check of a replication
        config's Destination; the reference calls it but lacks it)."""
        return any(t.arn == arn for t in list(self._targets.values()))

    def _persist_targets(self) -> None:
        from ..storage.xl_storage import SYS_DIR
        blob = json.dumps({b: t.to_dict()
                           for b, t in self._targets.items()}).encode()
        er = self.layer.meta_set
        er._fanout(lambda d: d.write_all(SYS_DIR, TARGETS_PATH, blob),
                   er.disks)

    # -- the decision and the queue (mustReplicate, queueReplicaTask) --------

    def _config(self, bucket: str) -> ReplConfig | None:
        try:
            return self.bucket_meta.get_parsed(bucket, "replication",
                                               ReplConfig.parse)
        except Exception:  # noqa: BLE001 — unparseable: nothing replicates
            return None

    def queue(self, bucket: str, oi, delete: bool = False) -> bool:
        """Queue the replication of version ``oi`` (a write, or with
        ``delete`` a delete whose result ``oi`` is) when the bucket has a
        target and a rule that takes it; a write's version is stamped
        PENDING first."""
        cfg = self._config(bucket)
        if cfg is None or self._targets.get(bucket) is None:
            return False
        rule = cfg.replicate(oi.name, _tags_of(oi),
                             delete_marker=delete and oi.delete_marker,
                             versioned_delete=delete and not oi.delete_marker)
        if rule is None:
            return False
        vid = oi.version_id or ""
        if not delete:
            # a crash leaves a visibly pending version (replicateObject)
            try:
                self.layer.put_object_metadata(bucket, oi.name, vid,
                                               {STATUS_KEY: "PENDING"})
            except Exception:  # noqa: BLE001 — the stamp is advisory;
                pass           # the queued task is what matters
        key = f"{bucket}/{oi.name}".encode()
        self._queues[zlib.crc32(key) % len(self._queues)].put(
            (bucket, oi.name, vid, delete))
        with self._mu:
            self.stats.queued += 1
        return True

    def pending(self) -> int:
        """Tasks queued and not yet taken by a worker."""
        return sum(q.qsize() for q in self._queues)

    # -- the workers ----------------------------------------------------------

    def _replicate_one(self, bucket: str, name: str, version_id: str,
                       delete: bool) -> int:
        """One task; the bytes it sent."""
        from ..s3.client import S3Client
        tgt = self._targets.get(bucket)
        if tgt is None:
            return 0
        client = S3Client(tgt.endpoint, tgt.access_key, tgt.secret_key,
                          region=tgt.region)
        if delete:
            client.delete_object(tgt.target_bucket, name)
            with self._mu:
                self.stats.deletes_replicated += 1
            return 0
        oi, data = self.read_fn(bucket, name, version_id)
        self.monitor.throttle(bucket, len(data))
        headers = {STATUS_KEY: "REPLICA"}
        for k, v in oi.user_defined.items():
            if k.startswith("x-amz-meta-"):
                headers[k] = v
        ct = oi.user_defined.get("content-type", "")
        if ct:
            headers["Content-Type"] = ct
        client.request("PUT", f"/{tgt.target_bucket}/{name}", body=data,
                       headers=headers)
        self.layer.put_object_metadata(bucket, name, version_id,
                                       {STATUS_KEY: "COMPLETED"})
        with self._mu:
            self.stats.replicated += 1
            self.stats.replica_bytes += len(data)
        return len(data)

    def _worker(self, q: queue.Queue) -> None:
        while not self._stop.is_set():
            try:
                bucket, name, vid, delete = q.get(timeout=0.2)
            except queue.Empty:
                continue
            moved = 0
            try:
                moved = self._replicate_one(bucket, name, vid, delete)
            except Exception:  # noqa: BLE001 — the task fails, the worker
                if not delete:  # goes on
                    try:
                        self.layer.put_object_metadata(
                            bucket, name, vid, {STATUS_KEY: "FAILED"})
                    except Exception:  # noqa: BLE001 — best effort: the
                        pass           # version may be gone
                # counted once stamped, as a task that succeeds: a caller
                # that waits on the counts reads the stamp
                with self._mu:
                    self.stats.failed += 1
            finally:
                q.task_done()
            self.progress.update(bucket, name, nbytes=moved)

    def start(self) -> None:
        """Start the workers; their progress spans the pool's life
        (the rates are the work since start over the time since)."""
        self.progress.begin()
        for wi, q in enumerate(self._queues):
            t = threading.Thread(target=self._worker, args=(q,), daemon=True,
                                 name=f"mt-repl-worker-{wi}")
            t.start()
            self._threads.append(t)

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until every queued task has finished, at most
        ``timeout`` seconds; True when none is left."""
        deadline = time.monotonic() + timeout
        while any(q.unfinished_tasks for q in self._queues):
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True

    def stop(self) -> None:
        """Stop and join the workers (a task in flight finishes)."""
        self._stop.set()
        for t in self._threads:
            t.join()
        self._threads.clear()
