"""The background heal sweep (``minio_tpu/background/heal.py``,
cmd/global-heal.go:123 healErasureSet), without its MRF queue and trace
spans (ROADMAP Queue 1 item 11).

``BackgroundHealer.sweep`` walks every bucket of a layer (a set, or
``ErasureSets``), heals the bucket, then heals every version of every
object, delete markers included, each by its version id, deep
(bitrot-verifying every shard) every ``deep_every`` cycles, and last
compacts the packed segments of every online drive.  After each heal
the sweep sleeps as long as that heal took, at most ``pace_s`` (the
``heal.max_sleep`` knob), so heal yields the drives to foreground
traffic.  ``progress`` is the cycle's progress record.  ``start`` runs
the sweep every ``interval_s`` on a thread; ``stop`` ends it between
objects.

The reference's sweep lists only each key's latest version
(``list_objects``), so a drive that returns empty gets back no older
version and no key whose latest version is a delete marker; this one
pages ``list_object_versions``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .progress import CycleProgress


def _online(disk) -> bool:
    try:
        return disk.is_online()
    except Exception:  # noqa: BLE001 — a dead drive is offline
        return False


def iter_versions(layer, bucket: str, prefix: str = "", stop=None):
    """Every version under ``prefix``, delete markers included, paged
    1,000 at a time through ``list_object_versions``; ``stop`` (an
    Event) ends the walk between pages."""
    key_marker = vid_marker = ""
    while stop is None or not stop.is_set():
        out = layer.list_object_versions(
            bucket, prefix, key_marker=key_marker,
            version_id_marker=vid_marker, max_keys=1000)
        yield from out.objects
        if not out.is_truncated:
            return
        key_marker = out.next_key_marker
        vid_marker = out.next_version_id_marker


@dataclass
class HealStats:
    """The sweep's counters (madmin.BgHealState); ``objects_scanned``
    counts versions.  The ``mrf_*`` fields stay 0 until the MRF queue is
    ported."""
    objects_scanned: int = 0
    objects_healed: int = 0
    objects_failed: int = 0
    mrf_queued: int = 0
    mrf_healed: int = 0
    mrf_dropped: int = 0
    last_cycle_ns: int = 0
    cycles: int = 0

    def to_dict(self) -> dict:
        return {
            "objectsScanned": self.objects_scanned,
            "objectsHealed": self.objects_healed,
            "objectsFailed": self.objects_failed,
            "mrfQueued": self.mrf_queued,
            "mrfHealed": self.mrf_healed,
            "mrfDropped": self.mrf_dropped,
            "lastCycle": self.last_cycle_ns,
            "cycles": self.cycles,
        }


@dataclass
class BackgroundHealer:
    """Every ``interval_s``, heal every bucket and version of ``layer``;
    deep every ``deep_every`` cycles (0: never); after each heal, sleep
    as long as it took, at most ``pace_s`` (0: never)."""

    layer: object
    interval_s: float = 3600.0
    deep_every: int = 0
    pace_s: float = 0.0
    stats: HealStats = field(default_factory=HealStats)

    def __post_init__(self):
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.progress = CycleProgress("healing")

    def sweep(self) -> HealStats:
        """One pass over the namespace.  ``stop()`` ends it between
        buckets, listing pages and versions; a cycle so cut keeps its
        counts but is not counted as a cycle."""
        deep = bool(self.deep_every) and \
            (self.stats.cycles + 1) % self.deep_every == 0
        self.progress.begin()
        if not self._sweep(deep):
            self.progress.abort()
            return self.stats
        self.progress.end()
        self.stats.cycles += 1
        self.stats.last_cycle_ns = time.time_ns()
        return self.stats

    def _sweep(self, deep: bool) -> bool:
        """The walk; False when ``stop()`` cut it."""
        for b in self.layer.list_buckets():
            if self._stop.is_set():
                return False
            try:
                self.layer.heal_bucket(b.name)
            except Exception:  # noqa: BLE001 — one bucket's failure
                pass           # must not end the sweep
            for oi in iter_versions(self.layer, b.name, stop=self._stop):
                if self._stop.is_set():
                    return False
                self.stats.objects_scanned += 1
                self.progress.update(b.name, oi.name, nbytes=oi.size)
                t0 = time.monotonic()
                try:
                    r = self.layer.heal_object(b.name, oi.name,
                                               version_id=oi.version_id,
                                               deep=deep)
                    if r is not None and r.healed_disks:
                        self.stats.objects_healed += 1
                except Exception:  # noqa: BLE001
                    self.stats.objects_failed += 1
                if self.pace_s > 0:
                    time.sleep(min(self.pace_s, time.monotonic() - t0))
        # reclaim the dead space of packed segments; an offline drive
        # (gone, or one of another deployment) is not touched
        for d in self.layer.disks:
            if self._stop.is_set():
                return False
            if d is None or not _online(d):
                continue
            try:
                d.compact_segments()
            except Exception:  # noqa: BLE001 — the next sweep retries
                pass
        return True

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
