"""Bandwidth throttling (``minio_tpu/background/replication.py``,
pkg/bucket/bandwidth/monitor.go:63 and throttle.go): the token bucket
the rebalancer paces its moves with.  Bucket replication itself is not
ported (ROADMAP Queue 1 item 16.8)."""

from __future__ import annotations

import threading
import time


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
