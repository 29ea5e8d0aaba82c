"""Per-object namespace locks on one node: the local part of
``minio_tpu/parallel/dsync.py`` (cmd/namespace-lock.go NewNSLock over
cmd/local-locker.go), without remote lockers, grant TTLs or their
refresh thread.

A PUT, DELETE or heal takes its object's write lock; a GET or HEAD takes
its read lock.  Different objects never wait on each other, so concurrent
PUTs reach the writer plane together and their commits form group
commits.  The locker is write-preferring, bounded: while a writer waits
on an object, new readers are refused so the readers drain, but only for
``WRITER_PREF_MAX_S``, so one long read cannot be starved out for good
either.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from dataclasses import dataclass, field

LOCK_TIMEOUT_S = 10.0


class LockTimeout(Exception):
    pass


@dataclass
class _LockEntry:
    writer: bool
    owners: dict[str, int] = field(default_factory=dict)   # uid -> count


class LocalLocker:
    """In-process lock table (cmd/local-locker.go)."""

    WRITER_WAIT_TTL_S = 1.0
    WRITER_PREF_MAX_S = 3.0

    def __init__(self):
        self._mu = threading.Lock()
        self._map: dict[str, _LockEntry] = {}
        # resource -> (first marked, expiry) of a waiting writer
        self._writer_waiting: dict[str, tuple[float, float]] = {}

    def _writer_pref_active(self, resource: str, now: float) -> bool:
        ww = self._writer_waiting.get(resource)
        if ww is None:
            return False
        first, expiry = ww
        if expiry <= now:
            del self._writer_waiting[resource]
            return False
        return now - first < self.WRITER_PREF_MAX_S

    def lock(self, resource: str, uid: str, write: bool) -> bool:
        now = time.monotonic()
        with self._mu:
            e = self._map.get(resource)
            if e is None:
                if not write and self._writer_pref_active(resource, now):
                    return False       # let the waiting writer in first
                self._map[resource] = _LockEntry(write, {uid: 1})
                if write:
                    self._writer_waiting.pop(resource, None)
                return True
            if write or e.writer:
                if write:
                    # mark intent; the first mark's time bounds the
                    # preference window
                    prev = self._writer_waiting.get(resource)
                    first = prev[0] if prev is not None \
                        and prev[1] > now else now
                    self._writer_waiting[resource] = (
                        first, now + self.WRITER_WAIT_TTL_S)
                return False
            if self._writer_pref_active(resource, now):
                return False
            e.owners[uid] = e.owners.get(uid, 0) + 1
            return True

    def unlock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._map.get(resource)
            if e is None or uid not in e.owners:
                return False
            e.owners[uid] -= 1
            if e.owners[uid] <= 0:
                del e.owners[uid]
            if not e.owners:
                del self._map[resource]
            return True


class DRWMutex:
    """A read-write lock on one resource of a locker
    (pkg/dsync/drwmutex.go with a single locker)."""

    def __init__(self, locker: LocalLocker, resource: str):
        self.locker = locker
        self.resource = resource
        self.uid = str(uuid.uuid4())
        self._held = False

    def lock(self, write: bool = True,
             timeout: float = LOCK_TIMEOUT_S) -> None:
        """Acquire, retrying with growing jittered backoff
        (drwmutex.go:299-321); LockTimeout after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        backoff = 0.002
        while not self.locker.lock(self.resource, self.uid, write):
            if time.monotonic() >= deadline:
                raise LockTimeout(self.resource)
            time.sleep(random.uniform(backoff / 2, backoff))
            backoff = min(backoff * 2, 0.25)
        self._held = True

    def unlock(self) -> None:
        if self._held:
            self._held = False
            self.locker.unlock(self.resource, self.uid)


class NamespaceLock:
    """Per-object lock factory (cmd/namespace-lock.go)."""

    def __init__(self, locker: LocalLocker | None = None):
        self.locker = locker if locker is not None else LocalLocker()

    def new_lock(self, bucket: str, *objects: str) -> DRWMutex:
        return DRWMutex(self.locker, bucket + "/" + ",".join(objects))
