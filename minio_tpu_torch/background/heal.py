"""The background heal sweep (``minio_tpu/background/heal.py``,
cmd/global-heal.go:123 healErasureSet), without its MRF queue, trace
spans, pacing and progress record (the admin API that sets and reads
those is not ported).

``BackgroundHealer.sweep`` walks every bucket of a layer (a set, or
``ErasureSets``), heals the bucket, then heals every listed object, deep
(bitrot-verifying every shard) every ``deep_every`` cycles, and last
compacts the packed segments of every online drive.  ``start`` runs it
every ``interval_s`` on a thread; ``stop`` ends it between objects.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


def _online(disk) -> bool:
    try:
        return disk.is_online()
    except Exception:  # noqa: BLE001 — a dead drive is offline
        return False


@dataclass
class HealStats:
    """The sweep's counters (madmin.BgHealState)."""
    objects_scanned: int = 0
    objects_healed: int = 0
    objects_failed: int = 0
    last_cycle_ns: int = 0
    cycles: int = 0


@dataclass
class BackgroundHealer:
    """Every ``interval_s``, heal every bucket and object of ``layer``;
    deep every ``deep_every`` cycles (0: never)."""

    layer: object
    interval_s: float = 3600.0
    deep_every: int = 0
    stats: HealStats = field(default_factory=HealStats)

    def __post_init__(self):
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sweep(self) -> HealStats:
        """One pass over the namespace.  ``stop()`` ends it between
        buckets, listing pages and objects; a cycle so cut keeps its
        counts but is not counted as a cycle."""
        deep = bool(self.deep_every) and \
            (self.stats.cycles + 1) % self.deep_every == 0
        for b in self.layer.list_buckets():
            if self._stop.is_set():
                return self.stats
            try:
                self.layer.heal_bucket(b.name)
            except Exception:  # noqa: BLE001 — one bucket's failure
                pass           # must not end the sweep
            marker = ""
            while True:
                if self._stop.is_set():
                    return self.stats
                out = self.layer.list_objects(b.name, marker=marker,
                                              max_keys=1000)
                for oi in out.objects:
                    if self._stop.is_set():
                        return self.stats
                    self.stats.objects_scanned += 1
                    try:
                        r = self.layer.heal_object(b.name, oi.name,
                                                   deep=deep)
                        if r is not None and r.healed_disks:
                            self.stats.objects_healed += 1
                    except Exception:  # noqa: BLE001
                        self.stats.objects_failed += 1
                if not out.is_truncated:
                    break
                marker = out.next_marker
        # reclaim the dead space of packed segments; an offline drive
        # (gone, or one of another deployment) is not touched
        for d in self.layer.disks:
            if self._stop.is_set():
                return self.stats
            if d is None or not _online(d):
                continue
            try:
                d.compact_segments()
            except Exception:  # noqa: BLE001 — the next sweep retries
                pass
        self.stats.cycles += 1
        self.stats.last_cycle_ns = time.time_ns()
        return self.stats

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sweep()
                except Exception:  # noqa: BLE001 — the healer must survive
                    time.sleep(1)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mt-heal-sweeper")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
