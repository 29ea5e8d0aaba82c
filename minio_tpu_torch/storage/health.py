"""Drive lifecycle: the circuit breaker, identity checks, heal-on-return
and slow-drive detection (``minio_tpu/storage/health.py``).

  * cmd/erasure-sets.go:196-332 connectDisks and
    monitorAndConnectEndpoints: a background monitor reconnects offline
    drives and checks their format before it admits them again;
  * cmd/xl-storage-disk-id-check.go: a swapped drive is never written as
    if it were the drive it replaced;
  * cmd/background-newdisks-heal-ops.go:44,113: a drive that returns
    empty is formatted with its expected identity and its set is healed
    onto it.

``HealthDisk`` wraps a drive: the data calls in ``_GUARDED`` on an
offline drive raise DiskNotFound at once; after a cooldown one call goes
through as a half-open probe.  Every other attribute passes through to
the drive unguarded, as in the reference (the writer plane's
``write_packed``, ``read_segment`` and ``compact_segments`` among them).
``DriveMonitor`` is the reconnect loop: it probes offline drives,
revalidates online drives' identity every ``verify_every`` cycles, and
a drive that comes back fires the heal callback.  ``slow_drives`` flags
a drive whose last-minute p50 latency is far above its set's (the
``drive`` kvconfig knobs); a slow drive is flagged in the metrics and
``storageinfo``, never ejected.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from . import errors
from .api import StorageAPI
from .format import FORMAT_FILE, FormatErasure
from .xl_storage import SYS_DIR

# data calls gated by the circuit breaker; identity and health accessors
# pass straight through
_GUARDED = {
    "make_vol", "list_vols", "stat_vol", "delete_vol", "list_dir",
    "read_all", "write_all", "create_file", "append_file",
    "read_file_stream", "rename_file", "delete", "stat_info_file",
    "rename_data", "write_data_commit", "write_metadata",
    "update_metadata", "read_version",
    "list_versions", "delete_version", "verify_file", "check_parts",
    "walk_dir", "walk_entries", "tmp_dir", "clean_tmp", "disk_info",
}


def slow_drive_knobs(config=None) -> tuple[float, int]:
    """(multiple, min_samples) from the ``drive`` subsystem of
    ``config`` (a fresh ``Config``, so the environment and defaults,
    when None), read at every call so a live change lands at the next
    scrape."""
    if config is None:
        from ..utils.kvconfig import Config
        config = Config()
    try:
        multiple = float(config.get("drive", "slow_latency_multiple"))
    except (KeyError, ValueError):
        multiple = 4.0
    try:
        min_samples = int(config.get("drive", "slow_min_samples"))
    except (KeyError, ValueError):
        min_samples = 10
    return max(multiple, 1.0), max(min_samples, 1)


def slow_drives(disks, multiple: float = 4.0, min_samples: int = 10
                ) -> dict[str, dict]:
    """Slow-drive detection over one set's last-minute windows: a drive
    whose p50 exceeds ``multiple`` x the median p50 of the set's other
    drives, over at least ``min_samples`` ops, is slow.  The median
    leaves the drive itself out, so one outlier in a small set cannot
    drag the median up to its own p50.  {endpoint: {"p50_ns", "samples",
    "median_ns", "slow"}} for the drives with last-minute traffic."""
    from ..obs.lastminute import drive_windows
    stats = {}
    for endpoint, w in drive_windows(disks).items():
        samples = sum(c for c, _, _ in w.totals().values())
        if samples:
            stats[endpoint] = {"p50_ns": w.p50_all(), "samples": samples}
    for endpoint, v in stats.items():
        others = sorted(o["p50_ns"] for e, o in stats.items()
                        if e != endpoint)
        median = others[len(others) // 2] if others else 0
        v["median_ns"] = median
        v["slow"] = bool(median > 0 and v["samples"] >= min_samples
                         and v["p50_ns"] > multiple * median)
    return stats


def disks_by_set(layer) -> list[list]:
    """The drives of each erasure set of ``layer`` (server pools,
    ``ErasureSets`` or one set)."""
    if hasattr(layer, "sets"):
        return [list(s.disks) for s in layer.sets]
    return [list(layer.disks)]


def slow_drives_for_layer(layer, multiple: float = 4.0,
                          min_samples: int = 10) -> dict[str, dict]:
    """``slow_drives`` per erasure set: a drive is compared with its set's
    drives only (the same workload and shard fan-out)."""
    out: dict[str, dict] = {}
    for dlist in disks_by_set(layer):
        out.update(slow_drives(dlist, multiple=multiple,
                               min_samples=min_samples))
    return out


class HealthDisk:
    """A drive behind a circuit breaker, its identity checked on
    return."""

    def __init__(self, inner, expected_format: Optional[FormatErasure] = None,
                 cooldown_s: float = 2.0,
                 on_return: Optional[Callable[["HealthDisk", str], None]]
                 = None, clock: Callable[[], float] = time.monotonic):
        self.inner = inner
        self.expected_format = expected_format
        self.cooldown_s = cooldown_s
        self.on_return = on_return
        self._clock = clock
        self._offline = False
        self._next_probe = 0.0
        self._mu = threading.Lock()
        # one probe at a time: a second prober sees the first's format
        # instead of formatting and reopening the drive again
        self._probe_mu = threading.Lock()

    # -- state -------------------------------------------------------------

    def is_online(self) -> bool:
        return not self._offline and self.inner.is_online()

    @property
    def offline(self) -> bool:
        return self._offline

    def endpoint(self) -> str:
        return self.inner.endpoint()

    def is_local(self) -> bool:
        return self.inner.is_local()

    def get_disk_id(self) -> str:
        return self.inner.get_disk_id()

    def set_disk_id(self, disk_id: str) -> None:
        self.inner.set_disk_id(disk_id)

    def close(self) -> None:
        self.inner.close()

    def _mark_offline(self) -> None:
        with self._mu:
            self._offline = True
            self._next_probe = self._clock() + self.cooldown_s

    def _mark_online(self, how: str) -> None:
        fire = False
        with self._mu:
            if self._offline:
                self._offline = False
                fire = True
        if fire and self.on_return is not None:
            # the heal must not hold up the call that found the drive
            threading.Thread(target=self.on_return, args=(self, how),
                             daemon=True,
                             name="mt-drive-heal-kick").start()

    # -- probe and reconnect (connectDisks, cmd/erasure-sets.go:196) -------

    def probe(self) -> str | None:
        """Try to admit the drive again: 'reconnected', 'reformatted', or
        None while it is still unhealthy.  Its format.json must name the
        expected drive; a drive without one (wiped or replaced) is
        formatted with the expected identity; one with another identity
        (a swapped drive) stays offline and is not written."""
        with self._probe_mu:
            return self._probe()

    def _probe(self) -> str | None:
        try:
            if not self.inner.is_online():
                self._mark_offline()
                return None
            try:
                raw = self.inner.read_all(SYS_DIR, FORMAT_FILE)
                fmt = FormatErasure.from_json(raw)
            except (errors.FileNotFound, errors.VolumeNotFound):
                fmt = None
            if fmt is None:
                if self.expected_format is None:
                    # a deployment without formats: admit
                    self._mark_online("reconnected")
                    return "reconnected"
                try:
                    self.inner.make_vol(SYS_DIR)
                except errors.VolumeExists:
                    pass
                self.inner.write_all(
                    SYS_DIR, FORMAT_FILE,
                    self.expected_format.to_json().encode())
                self.inner.set_disk_id(self.expected_format.this)
                self.inner.reopen()
                self._mark_online("reformatted")
                return "reformatted"
            if self.expected_format is not None and (
                    fmt.id != self.expected_format.id
                    or fmt.this != self.expected_format.this):
                self._mark_offline()
                return None
            self.inner.set_disk_id(fmt.this)
            self._mark_online("reconnected")
            return "reconnected"
        except Exception:  # noqa: BLE001 — still down
            self._mark_offline()
            return None

    # -- the guarded call path ---------------------------------------------

    def _guard(self, fn, *args, **kwargs):
        if self._offline:
            if self._clock() < self._next_probe:
                raise errors.DiskNotFound(
                    f"{self.endpoint()}: drive offline")
            # half-open: one probe per cooldown window
            if self.probe() is None:
                raise errors.DiskNotFound(
                    f"{self.endpoint()}: drive offline")
        try:
            return fn(*args, **kwargs)
        except Exception:
            # a missing file must not trip the breaker; only a drive
            # that is gone goes offline
            try:
                healthy = self.inner.is_online()
            except Exception:  # noqa: BLE001
                healthy = False
            if not healthy:
                self._mark_offline()
            raise

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name in _GUARDED and callable(attr):
            def guarded(*args, _fn=attr, **kwargs):
                return self._guard(_fn, *args, **kwargs)
            return guarded
        return attr


# a proxy forwards every StorageAPI call by name
StorageAPI.register(HealthDisk)


def wrap_disks(disks: list, fmt: Optional[FormatErasure] = None,
               set_drive_count: int | None = None,
               on_return: Optional[Callable[[HealthDisk, str], None]] = None,
               cooldown_s: float = 2.0) -> list[HealthDisk]:
    """Each drive of a flat list in a HealthDisk that expects its place
    in the format's grid."""
    out = []
    for i, d in enumerate(disks):
        expected = None
        if fmt is not None and fmt.sets:
            expected = fmt.for_drive(i, set_drive_count or len(fmt.sets[0]))
        out.append(HealthDisk(d, expected_format=expected,
                              cooldown_s=cooldown_s, on_return=on_return))
    return out


class DriveMonitor:
    """monitorAndConnectEndpoints (cmd/erasure-sets.go:269): probe the
    offline drives every interval; check the online drives' identity
    every ``verify_every`` cycles."""

    def __init__(self, disks: list, interval_s: float = 5.0,
                 verify_every: int = 12):
        self.disks = [d for d in disks if isinstance(d, HealthDisk)]
        self.interval_s = interval_s
        self.verify_every = verify_every
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cycles = 0

    def poll_once(self) -> None:
        self._cycles += 1
        deep = self.verify_every and self._cycles % self.verify_every == 0
        for d in self.disks:
            try:
                if d.offline:
                    d.probe()
                elif deep:
                    # catches a drive swapped while online
                    if not d.inner.is_online():
                        d._mark_offline()
                    elif d.expected_format is not None:
                        try:
                            raw = d.inner.read_all(SYS_DIR, FORMAT_FILE)
                            fmt = FormatErasure.from_json(raw)
                            if fmt.this != d.expected_format.this:
                                d._mark_offline()
                        except (errors.FileNotFound,
                                errors.VolumeNotFound):
                            d._mark_offline()
            except Exception:  # noqa: BLE001 — the monitor must survive
                pass

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                self.poll_once()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="mt-drive-health-poll")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def wrap_with_heal(disks: list, fmt: Optional[FormatErasure],
                   set_drive_count: int | None
                   ) -> tuple[list[HealthDisk], Callable]:
    """Wrap the drives so that a returning drive heals the set that owns
    it.  Returns (wrapped drives, bind_layer); call bind_layer(sets)
    once the ErasureSets exists: the callback finds the set through
    it."""
    holder: dict = {}

    def layer_for(hd):
        layer = holder.get("layer")
        return layer.set_for_disk(hd) if layer else None

    wrapped = wrap_disks(disks, fmt, set_drive_count,
                         on_return=heal_on_return(layer_for))

    def bind_layer(layer) -> None:
        holder["layer"] = layer

    return wrapped, bind_layer


def heal_on_return(layer_for) -> Callable[[HealthDisk, str], None]:
    """The on_return callback: a heal sweep of the set that holds the
    returned drive (monitorLocalDisksAndHeal,
    cmd/background-newdisks-heal-ops.go:113).  One sweep runs per set at
    a time, as MinIO heals a set once for the drives that came back: a
    drive that returns while its set is swept asks for one more sweep,
    which the running callback makes when it ends (the running sweep may
    have passed that drive's objects already)."""
    mu = threading.Lock()
    again: dict[int, bool] = {}     # id(set) -> sweep once more

    def cb(disk: HealthDisk, how: str) -> None:
        try:
            target = layer_for(disk)
        except Exception:  # noqa: BLE001 — the next sweep retries
            return
        if target is None:
            return
        key = id(target)
        with mu:
            if key in again:
                again[key] = True
                return
            again[key] = False
        from ..background.heal import BackgroundHealer
        while True:
            try:
                BackgroundHealer(layer=target).sweep()
            except Exception:  # noqa: BLE001 — the next sweep retries
                pass
            with mu:
                if not again[key]:
                    del again[key]
                    return
                again[key] = False

    return cb
