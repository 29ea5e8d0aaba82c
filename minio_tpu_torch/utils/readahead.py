"""Bounded readahead over an iterator (``minio_tpu/utils/readahead.py``,
without its trace hooks): the body of a streaming PUT is read in a
background thread up to ``depth`` items ahead of the encode, so reading
batch N+1 overlaps batch N (klauspost/readahead's role at
cmd/xl-storage.go:1544-1546).

Order is kept and a producer's exception is raised at the consumer's
position.  The queue is bounded, so memory stays O(depth x item).
``close()`` (or GC) stops the producer and joins it: the caller must not
read the source again while the thread may still be reading it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


class Readahead:
    def __init__(self, it: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(it),), daemon=True,
            name="mt-readahead")
        self._thread.start()

    def _produce(self, it: Iterator) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
            self._put((_SENTINEL, None))
        except BaseException as e:  # noqa: BLE001 — raised consumer-side
            self._put((_SENTINEL, e))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _put(self, item) -> bool:
        """Queue ``item`` unless closed first; False once closed."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed.is_set():
            raise StopIteration
        item = self._q.get()
        if isinstance(item, tuple) and len(item) == 2 \
                and item[0] is _SENTINEL:
            self._closed.set()
            if item[1] is not None:
                raise item[1]
            raise StopIteration
        return item

    def close(self, _empty=queue.Empty) -> None:
        # _empty is bound at def time: __del__ may run at interpreter
        # shutdown after module globals are cleared
        self._closed.set()
        try:                    # a blocked producer sees the flag soon
            while True:
                self._q.get_nowait()
        except _empty:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=60)

    def __del__(self):          # abandoned mid-stream
        self.close()


def readahead(it: Iterable, depth: int = 2) -> Readahead:
    """Wrap ``it`` so it is produced ``depth`` items ahead in a thread."""
    return Readahead(it, depth)
