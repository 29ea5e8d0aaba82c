"""An in-memory pub/sub that never blocks its publisher
(``minio_tpu/utils/pubsub.py``, pkg/pubsub/pubsub.go).

A subscriber that cannot keep up loses messages: each has a bounded
queue, and a publish to a full one drops the item (pubsub.go:37-39
writes in a select with a default).  ListenNotification streams the
bucket events through it.  ``close`` ends every subscription, so a
stream held open by a listener ends when its server stops.  The
reference's sequence-numbered ring, which its peers poll for trace
streams, is left out with the trace plane (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

_END = object()                 # wakes a subscriber: the pubsub closed


class PubSub:
    def __init__(self, max_queue: int = 1000):
        self._subs: list[tuple[queue.Queue, Optional[Callable]]] = []
        self._mu = threading.Lock()
        self._max_queue = max_queue
        self.closed = False

    def publish(self, item: Any) -> None:
        with self._mu:
            subs = list(self._subs)
        for q, flt in subs:
            if flt is not None:
                try:
                    if not flt(item):
                        continue
                except Exception:  # noqa: BLE001 — a broken filter never
                    continue       # fails the publisher
            try:
                q.put_nowait(item)
            except queue.Full:
                pass                # a slow subscriber: dropped, not waited on

    def subscribe(self, filter_fn: Optional[Callable] = None
                  ) -> "Subscription":
        q: queue.Queue = queue.Queue(self._max_queue)
        with self._mu:
            if self.closed:
                q.put_nowait(_END)
            self._subs.append((q, filter_fn))
        return Subscription(self, q)

    def _unsubscribe(self, q: queue.Queue) -> None:
        with self._mu:
            self._subs = [(qq, f) for qq, f in self._subs if qq is not q]

    @property
    def num_subscribers(self) -> int:
        with self._mu:
            return len(self._subs)

    def close(self) -> None:
        """End every subscription now, and each one taken later."""
        with self._mu:
            self.closed = True
            subs = list(self._subs)
        for q, _ in subs:
            try:
                q.put_nowait(_END)
            except queue.Full:
                pass                # its reader sees ``closed`` next item


class Subscription:
    def __init__(self, ps: PubSub, q: queue.Queue):
        self._ps = ps
        self._q = q
        self.closed = False

    def get(self, timeout: Optional[float] = None) -> Any:
        """The next item, or None on timeout or once the pubsub closed."""
        if self._ps.closed and self._q.empty():
            return None
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        return None if item is _END else item

    def drain(self, max_items: int, timeout: float) -> Iterator[Any]:
        """Items until ``max_items``, ``timeout`` seconds or the close."""
        deadline = time.monotonic() + timeout
        n = 0
        while n < max_items and not self._ps.closed:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            item = self.get(timeout=remaining)
            if item is None:
                return
            yield item
            n += 1

    def close(self) -> None:
        if not self.closed:
            self._ps._unsubscribe(self._q)
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
