"""Per-cycle progress of a background loop (``minio_tpu/background/progress.py``):
the madmin BgHealState "currentObject" / "objectsHealed" role.

The heal sweep and the crawler each own one :class:`CycleProgress` and
call ``begin()``, ``update()`` once per version (the crawler once per
bucket), then ``end()`` (or ``abort()`` for a cycle cut short).
``rates()`` feeds the ``mt_heal_*`` and ``mt_scanner_*`` rate gauges at
scrape time: live rates while a cycle runs, else the last completed
cycle's; ``snapshot()`` is the admin ``background-status`` route's view,
with an ETA at the last cycle's pace.  Updates are attribute writes
under one small lock.
"""

from __future__ import annotations

import threading
import time


class CycleProgress:
    """Progress of one background loop across cycles."""

    def __init__(self, name: str):
        self.name = name
        self._mu = threading.Lock()
        self.active = False
        self.bucket = ""
        self.object = ""
        self.objects = 0
        self.nbytes = 0
        self.started_ns = 0
        self.cycles = 0
        # the last completed cycle: totals and rates
        self.last: dict = {}

    def begin(self) -> None:
        with self._mu:
            self.active = True
            self.bucket = ""
            self.object = ""
            self.objects = 0
            self.nbytes = 0
            self.started_ns = time.monotonic_ns()

    def update(self, bucket: str, object_name: str = "",
               nbytes: int = 0, objects: int = 1) -> None:
        with self._mu:
            self.bucket = bucket
            self.object = object_name
            self.objects += objects
            self.nbytes += nbytes

    def abort(self) -> None:
        """A cycle stopped early: clear the in-cycle state without
        recording its rates or counting it (a partial walk's rates would
        mislead, and a leaked ``active`` would scrape as a cycle that
        never ends)."""
        with self._mu:
            self.active = False
            self.bucket = ""
            self.object = ""

    def end(self) -> None:
        with self._mu:
            dur_ns = time.monotonic_ns() - self.started_ns
            secs = max(dur_ns / 1e9, 1e-9)
            self.last = {
                "durationNs": dur_ns,
                "objects": self.objects,
                "bytes": self.nbytes,
                "objectsPerSecond": round(self.objects / secs, 3),
                "bytesPerSecond": round(self.nbytes / secs, 1),
            }
            self.cycles += 1
            self.active = False
            self.bucket = ""
            self.object = ""

    def rates(self) -> tuple[float, float]:
        """(objects/s, bytes/s): live while a cycle runs, else the last
        completed cycle's."""
        with self._mu:
            if self.active and self.started_ns:
                secs = max(
                    (time.monotonic_ns() - self.started_ns) / 1e9, 1e-9)
                return (self.objects / secs, self.nbytes / secs)
            if self.last:
                return (self.last["objectsPerSecond"],
                        self.last["bytesPerSecond"])
            return (0.0, 0.0)

    def snapshot(self) -> dict:
        with self._mu:
            out = {
                "name": self.name,
                "active": self.active,
                "cycles": self.cycles,
                "currentBucket": self.bucket,
                "currentObject": self.object,
                "objects": self.objects,
                "bytes": self.nbytes,
                "lastCycle": dict(self.last),
            }
            if self.active and self.started_ns:
                secs = max(
                    (time.monotonic_ns() - self.started_ns) / 1e9, 1e-9)
                out["elapsedSeconds"] = round(secs, 3)
                out["objectsPerSecond"] = round(self.objects / secs, 3)
                out["bytesPerSecond"] = round(self.nbytes / secs, 1)
                # what is left of the last cycle's count, at its rate
                rate = self.last.get("objectsPerSecond", 0)
                total = self.last.get("objects", 0)
                if rate > 0 and total > self.objects:
                    out["etaSeconds"] = round(
                        (total - self.objects) / rate, 1)
            return out
