"""The store-and-forward delivery engine of the event targets
(``minio_tpu/obs/egress.py``, cmd/logger/target/http with
pkg/event/target/queuestore.go), the part the webhook target needs.

A :class:`DeliveryTarget` owns one destination and keeps it off the
request path:

* ``send`` puts the record on a bounded queue without waiting; a full
  queue spills to the disk store when there is one, else the record is
  counted dropped;
* one sender thread per target drains the queue, retrying a record
  ``max_attempts`` times with jittered exponential backoff;
* ``offline_after`` failures in a row take the target offline: later
  records go to the store without a network attempt until
  ``cooldown_s`` has passed, when one delivery is let through as the
  probe; its success brings the target back online and replays the
  store in the background;
* a record that used up its attempts, or came while offline, goes to
  the bounded :class:`QueueStore`; without one, or with it full, it is
  dead-lettered: counted, never raised to the caller.

The store's files are the reference's (one JSON document per record,
named by time and a uuid draw, replayed in name order), so each package
replays the other's ``queue_dir``.  Each target counts its deliveries
and their latency (``DELIVERY_BUCKETS``); the scrape reads them through
the :class:`EgressRegistry` (``mt_target_*``, ``admin/metrics.py``), and
a registry with no target adds no family and starts no thread.

The reference takes its locks from ``utils/locktrace.mtlock`` and logs
the offline and online turns through ``obs/logger``'s ``log_once``
(ROADMAP Queue 1 item 11); here the locks are plain and the turns go to
the ``minio_tpu_torch.egress`` logger, once per target and turn in 30 s.
``rng``, ``sleep``, ``clock`` and ``log`` can be injected.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

ONLINE = "online"
OFFLINE = "offline"
PROBING = "probing"

# a delivery is a network round trip: milliseconds when healthy, the
# target's timeout when not
DELIVERY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_CLOSE = object()       # the sender's shutdown sentinel

_LOG = logging.getLogger("minio_tpu_torch.egress")
_ONCE_S = 30.0
_once: dict[str, float] = {}
_once_mu = threading.Lock()


def log_once(level: str, message: str, dedup_key: str = "") -> bool:
    """Log unless the same key was logged in the last 30 s
    (cmd/logger/logonce.go); True when logged."""
    key = dedup_key or message
    now = time.monotonic()
    with _once_mu:
        if now - _once.get(key, -_ONCE_S) < _ONCE_S:
            return False
        _once[key] = now
        for k in [k for k, t in _once.items() if now - t >= _ONCE_S]:
            del _once[k]
    _LOG.log(logging.getLevelName(level), message)
    return True


class QueueStoreFull(Exception):
    """The disk store is at its limit: the record is dead-lettered."""


def config_queue_limit(cfg, subsys: str, key: str,
                       default: int = 10000) -> int:
    """A queue or store bound from the kvconfig, at least 1."""
    try:
        return max(1, int(cfg.get(subsys, key) or default))
    except (KeyError, ValueError):
        return default


class QueueStore:
    """The disk queue (pkg/event/target/queuestore.go): one JSON file per
    undelivered record, replayed in the order of its name, at most
    ``limit`` of them."""

    def __init__(self, directory: str, limit: int = 10000):
        self.dir = directory
        self.limit = limit
        self._mu = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        # the count is kept, not listed: the sender reads it every pass
        self._count = sum(1 for n in os.listdir(directory)
                          if not n.startswith("."))

    def put(self, record: dict) -> str:
        with self._mu:
            if self._count >= self.limit:
                raise QueueStoreFull("queue store full")
            key = f"{time.time_ns():020d}-{uuid.uuid4().hex[:8]}.json"
            tmp = os.path.join(self.dir, f".{key}.tmp")
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, os.path.join(self.dir, key))
            self._count += 1
            return key

    def list(self) -> list[str]:
        with self._mu:
            return sorted(n for n in os.listdir(self.dir)
                          if not n.startswith("."))

    def get(self, key: str) -> dict:
        with open(os.path.join(self.dir, key)) as f:
            return json.load(f)

    def delete(self, key: str) -> None:
        with self._mu:
            try:
                os.remove(os.path.join(self.dir, key))
            except FileNotFoundError:
                return
            self._count -= 1

    def __len__(self) -> int:
        with self._mu:
            return self._count


class DeliveryTarget:
    """The delivery engine of one destination.  A subclass gives
    ``_deliver(record)``, which raises on failure; ``target_type`` names
    the plane (``notify``) and ``name`` the destination, which label
    every metric and status row."""

    QUEUE_SIZE = 10000

    def __init__(self, target_type: str, name: str, *,
                 queue_limit: int | None = None,
                 store_dir: Optional[str] = None,
                 store_limit: int = 10000,
                 max_attempts: int = 3, offline_after: int = 3,
                 cooldown_s: float = 3.0,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 rng: random.Random | None = None,
                 sleep=time.sleep, clock=time.monotonic, log=None):
        self.target_type = target_type
        self.name = name
        self.store = QueueStore(store_dir, limit=store_limit) \
            if store_dir else None
        self.max_attempts = max(1, int(max_attempts))
        self.offline_after = max(1, int(offline_after))
        self.cooldown_s = cooldown_s
        self._backoff = (backoff_base_s, backoff_cap_s)
        self._rng = rng or random.Random()
        self._sleep = sleep
        self._clock = clock
        self._log = log                 # a log_once-shaped callable
        self._q: "queue.Queue" = queue.Queue(queue_limit or self.QUEUE_SIZE)
        self._mu = threading.Lock()
        # one delivery at a time, whoever drives it (the sender, its
        # replay, the admin replay): a record is never sent twice by two
        # drains of the store
        self._deliver_mu = threading.Lock()
        self._state = ONLINE
        self._consecutive = 0
        self._opened_at = 0.0
        # records queued and not yet delivered, stored or dead-lettered,
        # counted at enqueue so flush() sees no gap
        self._pending = 0
        self._closed = False
        self._worker: threading.Thread | None = None
        self.sent = 0
        self.failed = 0                 # failed delivery attempts
        self.dropped = 0                # discarded before any attempt
        self.dead_letter = 0            # given up: attempts or store full
        self.store_errors = 0           # store I/O faults, not deliveries
        self.last_error = ""
        self.last_error_at = 0.0        # wall clock, for status
        self.last_success_at = 0.0
        self._hist = [0] * (len(DELIVERY_BUCKETS) + 1) + [0.0]

    def _deliver(self, record: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    # -- the request path ------------------------------------------------

    def send(self, record: Dict[str, Any]) -> None:
        """Queue the record; never waits and never raises."""
        # the closed check, the sender's start and the enqueue are one
        # decision: a send racing close() lands before the drain (which
        # stores it) or is counted dropped
        with self._mu:
            if self._closed:
                self.dropped += 1
                return
            self._ensure_worker_locked()
            self._pending += 1
            try:
                self._q.put_nowait(record)
                return
            except queue.Full:
                self._pending -= 1
        if not self._spill(record):
            with self._mu:
                self.dropped += 1

    # -- life ------------------------------------------------------------

    def start(self) -> None:
        """Called at registration: a backlog a previous process left on
        disk starts replaying without new traffic.  Not called from
        ``__init__``, so the sender never races a subclass still setting
        its endpoint."""
        if self.store is not None and len(self.store):
            with self._mu:
                self._ensure_worker_locked()

    def _ensure_worker_locked(self) -> None:
        if self._worker is not None or self._closed:
            return
        self._worker = threading.Thread(
            target=self._run, daemon=True,
            name=f"mt-egress-{self.target_type}")
        self._worker.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the sender and join it; queued records go to the store
        when there is one."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            w = self._worker
        if w is None:
            return
        try:
            self._q.put_nowait(_CLOSE)
        except queue.Full:
            pass                # the sender checks ``_closed`` every pass
        w.join(timeout=timeout)

    def flush(self, timeout: float = 5.0) -> None:
        """Wait, at most ``timeout`` s, until every queued record has been
        delivered, stored or dead-lettered."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._mu:
                if self._pending == 0:
                    return
            time.sleep(0.01)

    # -- the sender ------------------------------------------------------

    def _run(self) -> None:
        while True:
            if self._closed:
                self._drain_close()
                return
            try:
                timeout = self._idle_timeout()
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    item = None
                if item is _CLOSE:
                    self._drain_close()
                    return
                if item is not None:
                    try:
                        self._process(item)
                    finally:
                        with self._mu:
                            self._pending -= 1
                self._replay_ready()
            except Exception as e:  # noqa: BLE001 — a store fault (a
                # removed queue_dir, a full disk) must not end the sender;
                # it is counted apart from the deliveries
                self._note_store_error(e)
                time.sleep(0.25)

    def _idle_timeout(self) -> float | None:
        """How long the sender may wait on the queue: for ever online
        with an empty store, briefly while a probe or a replay is due."""
        with self._mu:
            state, opened = self._state, self._opened_at
        backlog = self.store is not None and len(self.store) > 0
        if state == ONLINE:
            return 0.05 if backlog else None
        remaining = self.cooldown_s - (self._clock() - opened)
        if remaining <= 0 and not backlog:
            return None         # the next record is the probe
        return max(0.01, min(remaining, 0.25))

    def _process(self, record: dict) -> None:
        attempt = 0
        while True:
            with self._deliver_mu:
                if attempt == 0 and not self._may_attempt():
                    self._spill_or_dead_letter(record)
                    return
                if self._try_deliver(record):
                    return
            attempt += 1
            with self._mu:
                still_online = self._state == ONLINE
                closing = self._closed
            # a close() mid-retry stores the record now instead of
            # spending the rest of its attempts
            if closing or not still_online or attempt >= self.max_attempts:
                break
            # the backoff waits outside the delivery lock, so an admin
            # replay does not wait out this record's retries
            base, cap = self._backoff
            self._sleep(self._rng.uniform(0.0, min(cap, base * 2 **
                                                   (attempt - 1))))
        with self._deliver_mu:
            self._spill_or_dead_letter(record)

    def _may_attempt(self) -> bool:
        """Online, always; offline, once the cooldown has passed: that
        delivery is the probe."""
        with self._mu:
            if self._state == ONLINE:
                return True
            if self._clock() - self._opened_at >= self.cooldown_s:
                self._state = PROBING
                return True
            return False

    def _try_deliver(self, record: dict) -> bool:
        t0 = time.perf_counter()
        try:
            self._deliver(record)
        except Exception as e:  # noqa: BLE001 — any failure is a miss
            self._on_failure(e)
            return False
        self._observe(time.perf_counter() - t0)
        self._on_success()
        return True

    def _on_failure(self, e: Exception) -> None:
        with self._mu:
            self.failed += 1
            self._consecutive += 1
            self.last_error = f"{type(e).__name__}: {e}"
            self.last_error_at = time.time()
            went_offline = False
            if self._state == PROBING or (
                    self._state == ONLINE
                    and self._consecutive >= self.offline_after):
                went_offline = self._state == ONLINE
                self._state = OFFLINE
                self._opened_at = self._clock()
        if went_offline:
            self._log_transition(offline=True)

    def _on_success(self) -> None:
        with self._mu:
            self.sent += 1
            self._consecutive = 0
            self.last_success_at = time.time()
            recovered = self._state != ONLINE
            self._state = ONLINE
        if recovered:
            self._log_transition(offline=False)

    def _observe(self, seconds: float) -> None:
        with self._mu:
            for i, ub in enumerate(DELIVERY_BUCKETS):
                if seconds <= ub:
                    self._hist[i] += 1
            self._hist[len(DELIVERY_BUCKETS)] += 1
            self._hist[-1] += seconds

    def _spill(self, record: dict) -> bool:
        """Put the record in the store; True when it got there.  A full
        store is the dead-letter path; any other failure is a store
        fault, counted."""
        if self.store is None:
            return False
        try:
            self.store.put(record)
            return True
        except QueueStoreFull:
            return False
        except Exception as e:  # noqa: BLE001 — an unwritable store
            self._note_store_error(e)
            return False

    def _note_store_error(self, e: Exception) -> None:
        with self._mu:
            self.store_errors += 1
            self.last_error = f"{type(e).__name__}: {e}"
            self.last_error_at = time.time()
        self._log_once("ERROR", f"egress target {self.target_type}/"
                       f"{self.name} store error: {e}",
                       f"egress-store-{self.target_type}-{self.name}")

    def _spill_or_dead_letter(self, record: dict) -> None:
        if not self._spill(record):
            with self._mu:
                self.dead_letter += 1

    # -- replay ----------------------------------------------------------

    def _replay_ready(self) -> None:
        """The background replay: drain the store while deliveries
        succeed; offline, the first attempt is the probe, and new
        traffic interrupts the drain."""
        if self.store is None or self._closed or not len(self.store):
            return
        with self._deliver_mu:
            if self._may_attempt():
                self._drain_store(preempt_on_traffic=True)

    def replay(self) -> int:
        """Drain the store now (the admin ``targets/replay``); the number
        delivered, stopping at the first failure."""
        if self.store is None:
            return 0
        with self._deliver_mu:
            return self._drain_store(preempt_on_traffic=False)

    def _drain_store(self, preempt_on_traffic: bool) -> int:
        """Deliver the stored records in order until one fails; an
        unreadable one is dead-lettered.  The caller holds
        ``_deliver_mu``."""
        n = 0
        for key in self.store.list():
            try:
                rec = self.store.get(key)
            except Exception:  # noqa: BLE001 — a corrupt entry
                self.store.delete(key)
                with self._mu:
                    self.dead_letter += 1
                continue
            if not self._try_deliver(rec):
                break
            self.store.delete(key)
            n += 1
            if preempt_on_traffic and self._q.qsize():
                break
        return n

    def _drain_close(self) -> None:
        """At close: the queued records go to the store (dropped when
        there is none)."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is _CLOSE:
                continue
            try:
                if not self._spill(item):
                    with self._mu:
                        self.dropped += 1
            finally:
                with self._mu:
                    self._pending -= 1

    # -- introspection ---------------------------------------------------

    def _log_once(self, level: str, message: str, key: str) -> None:
        try:
            (self._log or log_once)(level, message, dedup_key=key)
        except Exception:  # noqa: BLE001 — logging never stops delivery
            pass

    def _log_transition(self, offline: bool) -> None:
        ident = f"{self.target_type}/{self.name}"
        if offline:
            self._log_once("ERROR", f"egress target {ident} is offline: "
                           f"{self.last_error}", f"egress-offline-{ident}")
        else:
            self._log_once("INFO", f"egress target {ident} is back online",
                           f"egress-online-{ident}")

    @property
    def online(self) -> bool:
        with self._mu:
            return self._state == ONLINE

    def delivery_hist(self) -> tuple:
        """(buckets, cumulative counts and the count, sum)."""
        with self._mu:
            return DELIVERY_BUCKETS, list(self._hist[:-1]), self._hist[-1]

    def status(self) -> Dict[str, Any]:
        """One row of the admin ``targets`` route."""

        def iso(ts: float) -> str:
            return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)) \
                if ts else ""

        with self._mu:
            return {
                "type": self.target_type,
                "target": self.name,
                "state": self._state,
                "online": self._state == ONLINE,
                "queued": self._q.qsize(),
                "stored": len(self.store) if self.store is not None else 0,
                "sent": self.sent,
                "failed": self.failed,
                "dropped": self.dropped,
                "deadLettered": self.dead_letter,
                "storeErrors": self.store_errors,
                "lastError": self.last_error,
                "lastErrorTime": iso(self.last_error_at),
                "lastSuccessTime": iso(self.last_success_at),
            }


class EgressRegistry:
    """The server's live delivery targets: what the scrape exports and
    the admin ``targets`` and ``targets/replay`` routes walk."""

    def __init__(self):
        self._mu = threading.Lock()
        self._targets: Dict[tuple, DeliveryTarget] = {}

    def register(self, target: DeliveryTarget) -> DeliveryTarget:
        with self._mu:
            self._targets[(target.target_type, target.name)] = target
        target.start()          # a backlog on disk replays at once
        return target

    def remove(self, target: DeliveryTarget) -> None:
        with self._mu:
            self._targets.pop((target.target_type, target.name), None)

    def targets(self) -> List[DeliveryTarget]:
        with self._mu:
            return [self._targets[k] for k in sorted(self._targets)]

    def status(self) -> List[Dict[str, Any]]:
        return [t.status() for t in self.targets()]

    def replay_all(self) -> Dict[str, int]:
        """A replay of every target with a store: {"type/name":
        delivered}.  A target whose store fails (its ``queue_dir``
        removed, say) counts a store error and 0, and the others replay
        all the same (ROADMAP Queue 3 record 59; the reference's raises,
        so its admin replay answers 500)."""
        out = {}
        for t in self.targets():
            if t.store is None:
                continue
            try:
                out[f"{t.target_type}/{t.name}"] = t.replay()
            except Exception as e:  # noqa: BLE001 — a store fault
                t._note_store_error(e)
                out[f"{t.target_type}/{t.name}"] = 0
        return out
