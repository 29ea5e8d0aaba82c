"""Namespace locks (``minio_tpu/parallel/dsync.py``): dsync quorum locks
(pkg/dsync/drwmutex.go) over lock tables (cmd/local-locker.go:50), and
the per-object namespace map (cmd/namespace-lock.go:67).

A PUT, DELETE or heal takes its object's write lock; a GET or HEAD takes
its read lock.  Different objects never wait on each other, so
concurrent PUTs reach the writer plane together and their commits form
group commits.  A lock table is write-preferring, bounded: while a writer
waits on an object, new readers are refused so the readers drain, but
only for ``WRITER_PREF_MAX_S``, so one long read cannot be starved out
for good either.

On one node a ``NamespaceLock()`` holds one in-process ``LocalLocker``;
its grants never expire and nothing refreshes them.  In a cluster
(``cluster.py``) it holds every node's locker, the local one and a
``RemoteLocker`` per peer over the internode RPC (``register_lock_service``
exports a node's table), and a ``DRWMutex`` asks them all at once: it
holds the lock when a quorum granted it (write: n/2+1, read: n/2), else
it gives its grants back and retries with growing jittered backoff.
Those grants carry a TTL: the shared refresher renews a held lock's
grants every ttl/3, the table's expiry sweep drops the grants of a
holder that stopped refreshing (a crashed node), and a holder whose
grants fell below quorum sees ``LockLost`` at its commit point.
"""

from __future__ import annotations

import math
import random
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from .rpc import RPCClient, RPCError, RPCServer

LOCK_TIMEOUT_S = 10.0
# grant lifetime in a cluster; holders refresh every ttl/3
DEFAULT_TTL_S = 30.0
# the per-locker acquire deadline (drwmutex.go:207's fan-out context)
ACQUIRE_TIMEOUT_S = 3.0
# a grant of a lock taken with this TTL never expires (one node)
NO_TTL = math.inf


class LockTimeout(Exception):
    pass


class LockLost(Exception):
    """The holder's grants fell below quorum (its refreshes failed after
    a pause or a partition): the critical section is unprotected."""


@dataclass
class _Grant:
    refcount: int = 1
    deadline: float = 0.0


@dataclass
class _LockEntry:
    writer: bool
    owners: dict[str, _Grant] = field(default_factory=dict)


class LocalLocker:
    """One node's lock table (cmd/local-locker.go), its grants with a
    TTL (``ttl_s`` of a call, else ``default_ttl_s``; ``NO_TTL`` never
    expires).  ``clock`` is injectable, so a test steps time."""

    WRITER_WAIT_TTL_S = 1.0
    WRITER_PREF_MAX_S = 3.0

    def __init__(self, default_ttl_s: float = DEFAULT_TTL_S,
                 clock=time.monotonic):
        self._mu = threading.Lock()
        self._map: dict[str, _LockEntry] = {}
        # resource -> (first marked, expiry) of a waiting writer
        self._writer_waiting: dict[str, tuple[float, float]] = {}
        self.default_ttl_s = default_ttl_s
        self._clock = clock

    def _purge_expired(self, resource: str, now: float) -> None:
        """Drop one resource's expired grants; the caller holds _mu."""
        ww = self._writer_waiting.get(resource)
        if ww is not None and ww[1] <= now:
            del self._writer_waiting[resource]
        e = self._map.get(resource)
        if e is None:
            return
        for uid in [u for u, g in e.owners.items() if g.deadline <= now]:
            del e.owners[uid]
        if not e.owners:
            self._map.pop(resource, None)

    def _writer_pref_active(self, resource: str, now: float) -> bool:
        ww = self._writer_waiting.get(resource)
        if ww is None:
            return False
        first, expiry = ww
        return expiry > now and now - first < self.WRITER_PREF_MAX_S

    def lock(self, resource: str, uid: str, write: bool,
             ttl_s: float | None = None) -> bool:
        ttl = ttl_s or self.default_ttl_s
        now = self._clock()
        with self._mu:
            self._purge_expired(resource, now)
            e = self._map.get(resource)
            if e is None:
                if not write and self._writer_pref_active(resource, now):
                    return False       # let the waiting writer in first
                self._map[resource] = _LockEntry(
                    write, {uid: _Grant(1, now + ttl)})
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
            g = e.owners.get(uid)
            if g is None:
                e.owners[uid] = _Grant(1, now + ttl)
            else:
                g.refcount += 1
                g.deadline = max(g.deadline, now + ttl)
            return True

    def refresh(self, resource: str, uid: str,
                ttl_s: float | None = None) -> bool:
        """Extend a held grant; False tells the holder it is gone."""
        ttl = ttl_s or self.default_ttl_s
        now = self._clock()
        with self._mu:
            self._purge_expired(resource, now)
            e = self._map.get(resource)
            if e is None or uid not in e.owners:
                return False
            e.owners[uid].deadline = now + ttl
            return True

    def unlock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._map.get(resource)
            if e is None or uid not in e.owners:
                return False
            g = e.owners[uid]
            g.refcount -= 1
            if g.refcount <= 0:
                del e.owners[uid]
            if not e.owners:
                del self._map[resource]
            return True

    def force_unlock(self, resource: str) -> bool:
        with self._mu:
            return self._map.pop(resource, None) is not None

    def is_locked(self, resource: str) -> bool:
        with self._mu:
            self._purge_expired(resource, self._clock())
            return resource in self._map

    def expire_old_locks(self) -> int:
        """The whole table's expiry sweep (expireOldLocks); returns the
        grants dropped."""
        now = self._clock()
        dropped = 0
        with self._mu:
            for resource in list(self._map):
                before = len(self._map[resource].owners)
                self._purge_expired(resource, now)
                e = self._map.get(resource)
                dropped += before - (len(e.owners) if e else 0)
            for resource in list(self._writer_waiting):
                if self._writer_waiting[resource][1] <= now:
                    del self._writer_waiting[resource]
        return dropped


def register_lock_service(rpc: RPCServer, locker: LocalLocker,
                          sweep_interval_s: float = 10.0) -> None:
    """Export a node's table as the ``lock`` service
    (cmd/lock-rest-server.go:383), and run its expiry sweep until the
    server stops."""
    rpc.register("lock", {
        "lock": lambda resource, uid, write, ttl_s=None:
            locker.lock(resource, uid, write, ttl_s),
        "refresh": lambda resource, uid, ttl_s=None:
            locker.refresh(resource, uid, ttl_s),
        "unlock": lambda resource, uid: locker.unlock(resource, uid),
        "force_unlock": lambda resource: locker.force_unlock(resource),
    })

    def sweeper():
        while not rpc.stopped.wait(sweep_interval_s):
            try:
                locker.expire_old_locks()
            except Exception:  # noqa: BLE001 — the sweep outlives a hiccup
                pass

    threading.Thread(target=sweeper, daemon=True,
                     name="mt-dsync-expiry").start()


class RemoteLocker:
    """A peer's table over its ``lock`` service."""

    def __init__(self, client: RPCClient):
        self._c = client

    def lock(self, resource: str, uid: str, write: bool,
             ttl_s: float | None = None) -> bool:
        try:
            return bool(self._c.call("lock", "lock", resource=resource,
                                     uid=uid, write=write, ttl_s=ttl_s))
        except RPCError:
            return False

    def refresh(self, resource: str, uid: str,
                ttl_s: float | None = None) -> bool:
        # a transport failure raises: False would say the grant is gone,
        # and a network blip is not that
        return bool(self._c.call("lock", "refresh", resource=resource,
                                 uid=uid, ttl_s=ttl_s))

    def unlock(self, resource: str, uid: str) -> bool:
        try:
            return bool(self._c.call("lock", "unlock", resource=resource,
                                     uid=uid))
        except RPCError:
            return False

    def force_unlock(self, resource: str) -> bool:
        try:
            return bool(self._c.call("lock", "force_unlock",
                                     resource=resource))
        except RPCError:
            return False


class _Refresher:
    """One keep-alive thread for every held lock with a TTL (the
    reference's startContinousLockRefresh also renews all from one loop);
    each renewal runs on a small pool, so one stalled peer delays only
    its own lock.  Started by the first lock, ended by ``stop`` (which
    joins it and its pool); the next lock starts it again."""

    def __init__(self):
        self._mu = threading.Lock()
        self._items: dict[int, "DRWMutex"] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._pool: ThreadPoolExecutor | None = None

    def add(self, m: "DRWMutex") -> None:
        with self._mu:
            self._items[id(m)] = m
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._pool = ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="mt-lock-renew")
                self._thread = threading.Thread(
                    target=self._loop, args=(self._pool,),
                    name="mt-lock-refresh", daemon=True)
                self._thread.start()
        self._wake.set()

    def remove(self, m: "DRWMutex") -> None:
        with self._mu:
            self._items.pop(id(m), None)

    def stop(self) -> None:
        with self._mu:
            thread, pool = self._thread, self._pool
            self._thread = self._pool = None
            self._stop.set()
        self._wake.set()
        if thread is not None:
            thread.join()
        if pool is not None:
            pool.shutdown(wait=True)

    def _loop(self, pool: ThreadPoolExecutor) -> None:
        def run_one(m):
            try:
                m._do_refresh()
            except Exception:  # noqa: BLE001 — never kill the loop
                pass
            finally:
                m._next_refresh = time.monotonic() + m.ttl_s / 3
                m._refreshing = False

        while not self._stop.is_set():
            with self._mu:
                items = list(self._items.values())
            now = time.monotonic()
            nxt = now + 1.0
            for m in items:
                if m._next_refresh <= now:
                    if not m._refreshing:
                        m._refreshing = True
                        try:
                            pool.submit(run_one, m)
                        except RuntimeError:     # the pool shut down
                            return
                    nxt = min(nxt, now + 0.25)
                else:
                    nxt = min(nxt, m._next_refresh)
            self._wake.wait(max(0.05, nxt - time.monotonic()))
            self._wake.clear()


_REFRESHER = _Refresher()


def stop_refresher() -> None:
    """Stop the process's lock refresher and join its threads."""
    _REFRESHER.stop()


class DRWMutex:
    """A read-write lock on one resource over n lockers, held at quorum
    (pkg/dsync/drwmutex.go)."""

    # consecutive failed refreshes of one grant before it is presumed
    # expired (3 rounds of ttl/3: a whole TTL without word)
    REFRESH_FAILS_MAX = 3

    def __init__(self, lockers: list, resource: str,
                 ttl_s: float = DEFAULT_TTL_S,
                 acquire_timeout_s: float = ACQUIRE_TIMEOUT_S):
        self.lockers = lockers
        self.resource = resource
        self.uid = str(uuid.uuid4())
        self.ttl_s = ttl_s
        self.acquire_timeout_s = acquire_timeout_s
        self._granted: list[bool] = [False] * len(lockers)
        self._refresh_fails: list[int] = [0] * len(lockers)
        self._registered = False
        self._refreshing = False
        self._next_refresh = 0.0
        self._write = False
        self.lost = threading.Event()

    def _quorum(self, write: bool) -> int:
        n = len(self.lockers)
        tolerance = n // 2
        q = n - tolerance
        if write and q == tolerance:
            q += 1                                 # drwmutex.go:164-175
        return q

    def _try_acquire(self, write: bool) -> bool:
        """Ask every locker at once, each bounded by
        ``acquire_timeout_s``; a grant that lands after the deadline is
        given back.  With one locker the call runs inline."""
        if len(self.lockers) == 1:
            try:
                ok = bool(self.lockers[0].lock(self.resource, self.uid,
                                               write, self.ttl_s))
            except Exception:  # noqa: BLE001 — a locker down grants nothing
                ok = False
            self._granted = [ok]
            return ok
        mu = threading.Lock()
        state = {"accepting": True}
        self._granted = [False] * len(self.lockers)

        def one(i, lk):
            try:
                ok = bool(lk.lock(self.resource, self.uid, write,
                                  self.ttl_s))
            except Exception:  # noqa: BLE001 — a locker down grants nothing
                ok = False
            with mu:
                if state["accepting"]:
                    self._granted[i] = ok
                    return
            if ok:
                try:
                    lk.unlock(self.resource, self.uid)
                except Exception:  # noqa: BLE001 — its grant expires
                    pass

        threads = [threading.Thread(target=one, args=(i, lk), daemon=True,
                                    name=f"mt-dsync-lock-{i}")
                   for i, lk in enumerate(self.lockers)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.acquire_timeout_s
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with mu:
            state["accepting"] = False
            got = sum(self._granted)
        if got >= self._quorum(write):
            return True
        self._release_all()
        return False

    def _release_all(self) -> None:
        for i, lk in enumerate(self.lockers):
            if self._granted[i]:
                try:
                    lk.unlock(self.resource, self.uid)
                except Exception:  # noqa: BLE001 — its grant expires
                    pass
                self._granted[i] = False

    def lock(self, write: bool = True,
             timeout: float = LOCK_TIMEOUT_S) -> None:
        """Acquire, retrying with growing jittered backoff
        (drwmutex.go:299-321); LockTimeout after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        backoff = 0.002
        self._write = write
        self._refresh_fails = [0] * len(self.lockers)
        self.lost.clear()
        while not self._try_acquire(write):
            if time.monotonic() >= deadline:
                raise LockTimeout(self.resource)
            time.sleep(random.uniform(backoff / 2, backoff))
            backoff = min(backoff * 2, 0.25)
        if self.ttl_s != NO_TTL:
            self._next_refresh = time.monotonic() + self.ttl_s / 3
            self._registered = True
            _REFRESHER.add(self)

    def _do_refresh(self) -> None:
        """Renew every grant; one that a locker denies, or that failed to
        renew ``REFRESH_FAILS_MAX`` times running, is counted lost, and
        below quorum the holder is told (``lost``)."""
        for i, lk in enumerate(self.lockers):
            if not self._granted[i]:
                continue
            try:
                if not lk.refresh(self.resource, self.uid, self.ttl_s):
                    self._granted[i] = False
                self._refresh_fails[i] = 0
            except Exception:  # noqa: BLE001 — unreachable: maybe a blip
                self._refresh_fails[i] += 1
                if self._refresh_fails[i] >= self.REFRESH_FAILS_MAX:
                    self._granted[i] = False
        if sum(self._granted) < self._quorum(self._write):
            self.lost.set()

    def ensure_valid(self) -> None:
        """At a commit point: LockLost when the grants fell below
        quorum."""
        if self.lost.is_set():
            raise LockLost(self.resource)

    def unlock(self) -> None:
        if self._registered:
            self._registered = False
            _REFRESHER.remove(self)
        self._release_all()


class NamespaceLock:
    """The per-object lock factory (cmd/namespace-lock.go NewNSLock):
    over one in-process table by default (its grants never expire), or
    over ``lockers``, every node's, whose grants carry ``DEFAULT_TTL_S``.
    ``locker`` is the first table (the only one on one node)."""

    def __init__(self, lockers: list | None = None):
        self.distributed = lockers is not None
        self.lockers = lockers if lockers is not None else [LocalLocker()]
        self.locker = self.lockers[0]

    def new_lock(self, bucket: str, *objects: str) -> DRWMutex:
        return DRWMutex(self.lockers, bucket + "/" + ",".join(objects),
                        ttl_s=DEFAULT_TTL_S if self.distributed else NO_TTL)
