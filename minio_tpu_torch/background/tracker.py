"""The data-update tracker (``minio_tpu/background/tracker.py``,
cmd/data-update-tracker.go).

A bloom filter over the paths that changed, closed into a history once
per crawler cycle: the crawler asks "did anything in this bucket change
since cycle N?" to skip the lifecycle pass of an unchanged bucket, and
the listing metacache asks when the bucket last changed to drop a
snapshot before its TTL.  The filter hashes with xxHash64, seeded by the
hash's index, and its bits and persisted JSON
(``tracker/update-tracker.json`` in the system volume) equal the
reference's for the same marks.  The S3 front marks it on mutations
only; the reference also marks it on GET and HEAD (ROADMAP Queue 3).
"""

from __future__ import annotations

import json
import threading
import time

from ..hashing.xxhash import xxh64

# 8 Mib and 4 hashes: about 2% false positives at 1M marked paths
DEFAULT_BITS = 1 << 23
DEFAULT_HASHES = 4
MAX_HISTORY = 16            # dataUpdateTrackerKeepCycles


class _Bloom:
    def __init__(self, bits: int = DEFAULT_BITS,
                 hashes: int = DEFAULT_HASHES):
        self.bits = bits
        self.hashes = hashes
        self.data = bytearray(bits // 8)

    def _positions(self, key: bytes):
        for seed in range(self.hashes):
            yield xxh64(key, seed) % self.bits

    def add(self, key: bytes) -> None:
        for p in self._positions(key):
            self.data[p >> 3] |= 1 << (p & 7)

    def contains(self, key: bytes) -> bool:
        return all(self.data[p >> 3] & (1 << (p & 7))
                   for p in self._positions(key))


class DataUpdateTracker:
    """Cycle-based change tracker.  Bound to an object layer it persists
    on the drives of the layer's metadata set at every ``advance`` and
    resumes from them, history included."""

    _STORE_PATH = "tracker/update-tracker.json"

    def __init__(self, layer=None, bits: int = DEFAULT_BITS):
        self._mu = threading.Lock()
        self._layer = layer
        self._bits = bits
        self.cycle = 1
        self._current = _Bloom(bits)
        self._history: list[tuple[int, _Bloom]] = []
        # exact wall time of each bucket's last change, beside the
        # blooms: the metacache reads it (no false positives); wall
        # clock, so it orders across processes sharing the drives
        self._bucket_time: dict[str, float] = {}
        if layer is not None:
            self._load()

    def mark(self, bucket: str, object_name: str) -> None:
        """Record that ``bucket/object_name`` changed this cycle; the
        bucket's own key too, for the crawler's per-bucket question."""
        with self._mu:
            self._current.add(bucket.encode())
            self._current.add(f"{bucket}/{object_name}".encode())
            self._bucket_time[bucket] = time.time()

    def bucket_changed_at(self, bucket: str) -> float:
        """Wall time of the bucket's last change (0: never)."""
        with self._mu:
            return self._bucket_time.get(bucket, 0.0)

    def changed_since(self, cycle: int, bucket: str,
                      object_name: str = "") -> bool:
        """True if the path may have changed since ``cycle`` (a bloom
        filter gives false positives, never false negatives); a cycle
        older than the history reports changed."""
        key = f"{bucket}/{object_name}".encode() if object_name \
            else bucket.encode()
        with self._mu:
            if cycle >= self.cycle:
                return self._current.contains(key)
            oldest = self._history[0][0] if self._history else self.cycle
            if cycle < oldest:
                return True
            hit = self._current.contains(key)
            for c, bloom in self._history:
                if c >= cycle:
                    hit = hit or bloom.contains(key)
            return hit

    def advance(self) -> int:
        """Close the current cycle into the history and start the next
        (the crawler, once per cycle); returns the new cycle."""
        with self._mu:
            self._history.append((self.cycle, self._current))
            self._history = self._history[-MAX_HISTORY:]
            self.cycle += 1
            self._current = _Bloom(self._bits)
            cyc = self.cycle
        self._persist()
        return cyc

    # -- at rest -------------------------------------------------------------

    def _persist(self) -> None:
        if self._layer is None:
            return
        from ..storage.xl_storage import SYS_DIR
        with self._mu:
            doc = {
                "cycle": self.cycle, "bits": self._bits,
                "current": self._current.data.hex(),
                "history": [(c, b.data.hex()) for c, b in self._history],
            }
        blob = json.dumps(doc).encode()
        er = self._layer.meta_set
        er._fanout(lambda d: d.write_all(SYS_DIR, self._STORE_PATH, blob),
                   er.disks)

    def _load(self) -> None:
        from ..storage.xl_storage import SYS_DIR
        er = self._layer.meta_set
        res, _ = er._fanout(lambda d: d.read_all(SYS_DIR, self._STORE_PATH),
                            er.disks)
        for r in res:
            if r is None:
                continue
            try:
                doc = json.loads(r)
                self.cycle = doc["cycle"]
                self._bits = doc["bits"]
                self._current = _Bloom(self._bits)
                self._current.data = bytearray.fromhex(doc["current"])
                self._history = []
                for c, hexdata in doc["history"]:
                    b = _Bloom(self._bits)
                    b.data = bytearray.fromhex(hexdata)
                    self._history.append((c, b))
                return
            except (KeyError, ValueError):
                continue
