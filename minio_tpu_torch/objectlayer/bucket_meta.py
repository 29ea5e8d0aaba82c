"""A bucket's versioning state (``minio_tpu/objectlayer/bucket_meta.py``,
cmd/bucket-metadata-sys.go), trimmed to the versioning document.

The document is the reference's: JSON in every drive's system volume at
``.mt.sys/buckets/<bucket>/bucket-meta.json``, written with quorum,
``{"versioning": {"status": "Enabled" | "Suspended"}, "_rev": n}``.  A
read takes the copy with the highest ``_rev``, so a drive that missed the
last write cannot roll the state back.  Either package serving the drives
sees the same state.  Over several sets the document lives on set 0's
drives, as the reference's ``ErasureSets._fanout`` keeps it.  The other
configs the reference keeps in the same document (policy, lifecycle, ...)
are not read or written here.
"""

from __future__ import annotations

import json
import threading
from typing import Any

from ..storage import errors as serrors
from ..storage.xl_storage import SYS_DIR


class BucketMetadataSys:
    def __init__(self, layer):
        # the ErasureObjects it reads and writes
        self._er = layer.meta_set
        self._cache: dict[str, dict] = {}
        self._mu = threading.Lock()

    @staticmethod
    def _path(bucket: str) -> str:
        return f"buckets/{bucket}/bucket-meta.json"

    def get(self, bucket: str) -> dict:
        """The bucket's document, {} when it has none."""
        with self._mu:
            if bucket in self._cache:
                return self._cache[bucket]
        er = self._er
        res, _ = er._fanout(lambda d: d.read_all(SYS_DIR, self._path(bucket)),
                            er.disks)
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
        if doc:
            # an empty document is never cached: probes of random bucket
            # names must not grow the cache
            with self._mu:
                self._cache[bucket] = doc
        return doc

    def update(self, bucket: str, key: str, value: Any) -> None:
        """Set one key and write the document, a revision up, to every
        drive; a write below quorum raises."""
        doc = dict(self.get(bucket))
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

    def drop(self, bucket: str) -> None:
        """Forget a deleted bucket's document, on the drives too."""
        er = self._er
        er._fanout(lambda d: d.delete(SYS_DIR, f"buckets/{bucket}",
                                      recursive=True), er.disks)
        with self._mu:
            self._cache.pop(bucket, None)

    def versioning_enabled(self, bucket: str) -> bool:
        return self.get(bucket).get("versioning", {}).get(
            "status") == "Enabled"

    def set_versioning(self, bucket: str, enabled: bool) -> None:
        self.update(bucket, "versioning",
                    {"status": "Enabled" if enabled else "Suspended"})
