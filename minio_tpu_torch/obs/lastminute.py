"""Last-minute rolling latency windows (``minio_tpu/obs/lastminute.py``,
cmd/last-minute.go lastMinuteLatencies), without the admin ``top`` rows.

A 60 x 1 s sliding window of (count, total ns, bytes) per labelled
operation: one :class:`OpWindows` per drive (keyed by storage op) and one
per S3 server (keyed by API name).  The windows feed the
``mt_node_disk_latency_*`` and ``mt_s3_api_last_minute_*`` gauges at
scrape time (``admin/metrics.py``) and slow-drive detection
(``storage/health.py``).

Recording takes no lock: slot updates are plain list mutations under the
GIL, and a concurrent slot rotation can lose a few samples, which is
fine for minute-grained statistics; the storage path must not serialise
on an observability lock.  p50 and p99 come from a 64-sample overwrite
ring per window and read 0 when the last minute saw no traffic, so a
drive that was slow once and is idle now is not flagged for ever.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Tuple

_SLOTS = 60
_RESERVOIR = 64


class Window:
    """One operation's 60x1s window + latency sample ring."""

    __slots__ = ("marks", "counts", "totals", "nbytes", "samples",
                 "sample_marks", "_si")

    def __init__(self):
        self.marks = [-1] * _SLOTS      # epoch second owning each slot
        self.counts = [0] * _SLOTS
        self.totals = [0] * _SLOTS      # ns
        self.nbytes = [0] * _SLOTS
        self.samples = [0] * _RESERVOIR
        self.sample_marks = [-1] * _RESERVOIR
        self._si = 0

    def record(self, duration_ns: int, nbytes: int = 0,
               now_s: float | None = None) -> None:
        sec = int(time.monotonic() if now_s is None else now_s)
        i = sec % _SLOTS
        if self.marks[i] != sec:        # slot aged out: reclaim it
            self.marks[i] = sec
            self.counts[i] = 0
            self.totals[i] = 0
            self.nbytes[i] = 0
        self.counts[i] += 1
        self.totals[i] += duration_ns
        self.nbytes[i] += nbytes
        si = self._si
        self.samples[si] = duration_ns
        self.sample_marks[si] = sec
        self._si = (si + 1) % _RESERVOIR

    def total(self, now_s: float | None = None) -> Tuple[int, int, int]:
        """(count, total_ns, bytes) over the live 60s window."""
        sec = int(time.monotonic() if now_s is None else now_s)
        lo = sec - (_SLOTS - 1)
        c = t = b = 0
        for i in range(_SLOTS):
            m = self.marks[i]
            if m >= 0 and lo <= m <= sec:   # -1 = never-written sentinel
                c += self.counts[i]
                t += self.totals[i]
                b += self.nbytes[i]
        return c, t, b

    def live_samples(self, now_s: float | None = None) -> list[int]:
        sec = int(time.monotonic() if now_s is None else now_s)
        lo = sec - (_SLOTS - 1)
        return [self.samples[i] for i in range(_RESERVOIR)
                if self.sample_marks[i] >= 0
                and lo <= self.sample_marks[i] <= sec]

    def p50(self, now_s: float | None = None) -> int:
        """Median of the last-minute latency samples (0 when idle)."""
        live = self.live_samples(now_s)
        if not live:
            return 0
        live.sort()
        return live[len(live) // 2]

    def p99(self, now_s: float | None = None) -> int:
        """Nearest-rank tail estimate from the same 64-sample
        reservoir as p50 (0 when idle) — an estimate by construction
        (the reservoir overwrites), good enough for the burn-rate
        rules that only need 'the tail moved'."""
        live = self.live_samples(now_s)
        if not live:
            return 0
        live.sort()
        return live[min(len(live) - 1, int(0.99 * (len(live) - 1) + 0.5))]


class OpWindows:
    """A labelled family of windows: one per operation/API name."""

    __slots__ = ("label", "windows")

    def __init__(self, label: str = ""):
        self.label = label
        self.windows: Dict[str, Window] = {}

    def record(self, op: str, duration_ns: int, nbytes: int = 0,
               now_s: float | None = None) -> None:
        w = self.windows.get(op)
        if w is None:
            # racing creators: last assignment wins, one lost sample
            w = self.windows[op] = Window()
        w.record(duration_ns, nbytes, now_s)

    def totals(self, now_s: float | None = None
               ) -> Dict[str, Tuple[int, int, int]]:
        """{op: (count, total_ns, bytes)} for ops live in the window."""
        out = {}
        for op, w in list(self.windows.items()):
            c, t, b = w.total(now_s)
            if c:
                out[op] = (c, t, b)
        return out

    def p50_all(self, now_s: float | None = None) -> int:
        """Median over every op's live samples combined — the per-drive
        latency figure slow-drive detection compares across a set."""
        merged: list[int] = []
        for w in list(self.windows.values()):
            merged.extend(w.live_samples(now_s))
        if not merged:
            return 0
        merged.sort()
        return merged[len(merged) // 2]

    def p99_all(self, now_s: float | None = None) -> int:
        """Nearest-rank tail over every op's live samples combined —
        the per-drive tail figure beside :meth:`p50_all`."""
        merged: list[int] = []
        for w in list(self.windows.values()):
            merged.extend(w.live_samples(now_s))
        if not merged:
            return 0
        merged.sort()
        return merged[min(len(merged) - 1,
                          int(0.99 * (len(merged) - 1) + 0.5))]


def drive_windows(disks: Iterable) -> Dict[str, OpWindows]:
    """{endpoint: OpWindows} for every drive in ``disks`` that records
    latencies."""
    out: Dict[str, OpWindows] = {}
    for d in disks:
        if d is None:
            continue
        lm = getattr(d, "latency", None)
        if isinstance(lm, OpWindows):
            out[lm.label] = lm
    return out
