"""A bucket's versioning state and its configs
(``minio_tpu/objectlayer/bucket_meta.py``, cmd/bucket-metadata-sys.go).

The document is the reference's: JSON in every drive's system volume at
``.mt.sys/buckets/<bucket>/bucket-meta.json``, written with quorum,
``{"versioning": {"status": "Enabled" | "Suspended"}, "policy": "<raw
JSON>", "lifecycle": "<raw XML>", "quota": "<raw JSON>", "_rev": n}``.
A read takes the copy with the highest ``_rev``, so a drive that missed
the last write cannot roll the state back.  Either package serving the
drives sees the same state.  Over several sets the document lives on set
0's drives, as the reference's ``ErasureSets._fanout`` keeps it.  The
other configs are kept in the same document as raw text: tagging,
object lock, encryption, replication and notification.  Every S3
request looks up its bucket's policy, and every PUT its versioning, so a
bucket found without a document is remembered as such (up to
``ABSENT_CAP`` names, so probes of random names cannot grow it) until
this process writes one: a request on such a bucket reads no drive.  The
reference rereads every drive each time.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Optional

from ..storage import errors as serrors
from ..storage.xl_storage import SYS_DIR

ABSENT_CAP = 4096


class BucketMetadataSys:
    def __init__(self, layer):
        # the ErasureObjects it reads and writes
        self._er = layer.meta_set
        self._cache: dict[str, dict] = {}
        self._absent: set[str] = set()     # read, and found without one
        # (bucket, name) -> (raw document, parsed): parsed once per raw
        self._parsed: dict[tuple[str, str], tuple[str, Any]] = {}
        self._mu = threading.Lock()
        # called with the bucket after every write of its document (a
        # cluster's peer fan-out, S3Server.attach_peers)
        self.on_change = None

    def invalidate(self, bucket: str) -> None:
        """Forget what is cached of one bucket (a peer changed it): the
        next access reads the drives."""
        with self._mu:
            self._cache.pop(bucket, None)
            self._absent.discard(bucket)

    @staticmethod
    def _path(bucket: str) -> str:
        return f"buckets/{bucket}/bucket-meta.json"

    def get(self, bucket: str) -> dict:
        """The bucket's document, {} when it has none."""
        with self._mu:
            if bucket in self._cache:
                return self._cache[bucket]
            if bucket in self._absent:
                return {}
        er = self._er
        res, errs = er._fanout(
            lambda d: d.read_all(SYS_DIR, self._path(bucket)), er.disks)
        doc: dict = {}
        for r in res:
            if r is None:
                continue
            try:
                cand = json.loads(r)
            except json.JSONDecodeError:
                continue
            if cand.get("_rev", 0) >= doc.get("_rev", 0):
                doc = cand
        with self._mu:
            if doc:
                self._cache[bucket] = doc
            elif len(self._absent) < ABSENT_CAP and sum(
                    isinstance(e, serrors.FileNotFound) for e in errs) \
                    > len(errs) // 2:
                # a quorum of drives says so: not an outage
                self._absent.add(bucket)
        return doc

    def update(self, bucket: str, key: str, value: Any) -> None:
        """Set one key (None removes it) and write the document, a
        revision up, to every drive; a write below quorum raises."""
        doc = dict(self.get(bucket))
        if value is None:
            doc.pop(key, None)
        else:
            doc[key] = value
        doc["_rev"] = doc.get("_rev", 0) + 1
        blob = json.dumps(doc).encode()
        er = self._er
        _, errs = er._fanout(
            lambda d: d.write_all(SYS_DIR, self._path(bucket), blob),
            er.disks)
        ok = sum(1 for e in errs if e is None)
        if ok < len(errs) // 2 + 1:
            raise serrors.FaultyDisk(
                f"bucket metadata write reached only {ok} drives")
        with self._mu:
            self._cache[bucket] = doc
            self._absent.discard(bucket)
        if self.on_change is not None:
            self.on_change(bucket)

    def drop(self, bucket: str) -> None:
        """Forget a deleted bucket's document, on the drives too."""
        er = self._er
        er._fanout(lambda d: d.delete(SYS_DIR, f"buckets/{bucket}",
                                      recursive=True), er.disks)
        with self._mu:
            self._cache.pop(bucket, None)
            self._absent.discard(bucket)
            for k in [k for k in self._parsed if k[0] == bucket]:
                del self._parsed[k]

    def get_config(self, bucket: str, name: str) -> Optional[str]:
        """A stored config document, raw, or None."""
        v = self.get(bucket).get(name)
        if isinstance(v, dict):
            return v.get("raw")
        return v

    def set_config(self, bucket: str, name: str, raw: Optional[str]) -> None:
        self.update(bucket, name, raw)

    def get_parsed(self, bucket: str, name: str, parser):
        """A stored config parsed by ``parser(raw bytes)``, or None;
        parsed once for each stored document, not on every request."""
        raw = self.get_config(bucket, name)
        if raw is None:
            return None
        key = (bucket, name)
        with self._mu:
            cached = self._parsed.get(key)
            if cached is not None and cached[0] == raw:
                return cached[1]
        parsed = parser(raw.encode())
        with self._mu:
            self._parsed[key] = (raw, parsed)
        return parsed

    def get_bucket_policy(self, bucket: str):
        from ..bucket.policy import BucketPolicy
        return self.get_parsed(bucket, "policy", BucketPolicy.parse)

    def versioning_enabled(self, bucket: str) -> bool:
        return self.get(bucket).get("versioning", {}).get(
            "status") == "Enabled"

    def set_versioning(self, bucket: str, enabled: bool) -> None:
        self.update(bucket, "versioning",
                    {"status": "Enabled" if enabled else "Suspended"})
