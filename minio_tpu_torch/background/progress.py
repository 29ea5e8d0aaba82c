"""Per-cycle progress of a background loop (``minio_tpu/background/progress.py``):
the madmin BgHealState "currentObject" / "objectsHealed" role.

The heal sweep owns one :class:`CycleProgress` and calls ``begin()``,
``update()`` once per version, then ``end()`` (or ``abort()`` for a cycle
cut short).  ``rates()`` feeds the ``mt_heal_objects_per_second`` /
``mt_heal_bytes_per_second`` / ``mt_heal_cycle_active`` gauges at scrape
time: live rates while a cycle runs, else the last completed cycle's.
Updates are attribute writes under one small lock, once per version.
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
