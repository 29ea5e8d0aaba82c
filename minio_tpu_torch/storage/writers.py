"""Per-drive writer plane: the I/O stage of the pipelined PUT
(``minio_tpu/storage/writers.py``, without its trace and stage hooks).

MinIO gives every drive its own goroutine and pipe for the life of a
stream (cmd/erasure-encode.go:80-107 parallelWriter).  Here one
persistent writer thread per drive consumes a bounded in-order queue:

  * enqueue does not block until the per-drive depth bound, so batch
    N+1's encode overlaps batch N's drive writes;
  * per-drive order is strict FIFO: a stream's create lands before its
    appends and its appends before its commit;
  * errors latch per (stream, drive): once a drive fails a stream's op,
    the stream's later ops on that drive are skipped (an append after a
    failed one would corrupt the staged file) and the caller re-checks
    quorum as completions drain;
  * each drive's drain is a group commit (``storage/commit.py``): up to
    ``commit.MAX_BATCH`` queued ops, from any streams, run their bodies
    with a GroupCollector armed, one flush of deduplicated file and
    directory fsyncs settles them all, and only then does each op settle.

``close()`` wakes blocked enqueuers (they see PlaneClosed), fails queued
ops so ``drain()`` returns, and joins the writer threads.  The plane
restarts lazily on the next stream.
"""

from __future__ import annotations

import itertools
import threading
import time

from . import commit as _commit
from . import errors as serrors

QUEUE_DEPTH = 2             # per-drive queued ops before enqueue blocks


class PlaneClosed(serrors.StorageError):
    """The writer plane shut down while ops were queued or submitting."""


class _Batch:
    """Refcount across one batch's per-drive ops; fires ``release``
    exactly once when the last op settles (the framed-buffer recycle
    hook) and sets ``done``, which the PUT loop bounds its depth on."""

    __slots__ = ("_n", "_release", "_mu", "done")

    def __init__(self, n: int, release=None):
        self._n = n
        self._release = release
        self._mu = threading.Lock()
        self.done = threading.Event()
        if n <= 0:
            self._fire()

    def _fire(self) -> None:
        rel, self._release = self._release, None
        try:
            if rel is not None:
                rel()
        finally:
            self.done.set()

    def hold(self) -> None:
        """Count one more op (taken before it is submitted)."""
        with self._mu:
            self._n += 1

    def done_one(self) -> None:
        with self._mu:
            self._n -= 1
            if self._n > 0:
                return
        self._fire()


def held_release(release) -> _Batch:
    """A batch whose one count the caller holds: ``release`` fires once
    the caller's ``done_one()`` and every op submitted with the batch
    (each after a ``hold()``) have settled, so a buffer those ops read
    goes back only after the last of them, even one that outlives an
    aborted stream's drain."""
    return _Batch(1, release)


class _Op:
    __slots__ = ("stream", "idx", "fn", "batch")

    def __init__(self, stream, idx, fn, batch):
        self.stream = stream
        self.idx = idx
        self.fn = fn
        self.batch = batch

    def run_body(self, disk) -> Exception | None:
        """Run the op body without settling it.  An error latches into
        the stream at once, so a same-stream batch-mate later in the
        batch skips instead of appending after the failure."""
        st = self.stream
        if st.cancelled or st.errs[self.idx] is not None:
            return None
        try:
            self.fn(self.idx, disk)
            return None
        except Exception as e:  # noqa: BLE001 — latched, quorum decides
            st._latch_err(self.idx, e)
            return e

    def settle(self, err: Exception | None) -> None:
        self.stream._op_done(self.idx, err, self.batch)


class _DriveWriter:
    """One persistent thread and bounded FIFO queue for one drive."""

    def __init__(self, disk, name: str):
        self.disk = disk
        self._q: list[_Op] = []
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def put(self, op: _Op, bound: int) -> None:
        with self._cv:
            while len(self._q) >= bound and not self._closed:
                self._cv.wait()
            if self._closed:
                raise PlaneClosed("writer plane closed")
            self._q.append(op)
            self._cv.notify_all()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q:          # closed and drained
                    return
                ops = self._q[:_commit.MAX_BATCH]
                del self._q[:len(ops)]
                closed = self._closed
                self._cv.notify_all()    # wake putters at the bound
            if closed:
                for op in ops:
                    op.settle(PlaneClosed("writer plane closed"))
            else:
                self._group_commit(ops)

    def _group_commit(self, ops: list[_Op]) -> None:
        """Run every op body with the collector armed, flush once, then
        settle each op, so a stream's quorum is re-checked only after its
        covering fsync landed."""
        col = _commit.GroupCollector()
        _commit.arm(col)
        errs: list = []
        try:
            for op in ops:
                col.current_op = op
                errs.append(op.run_body(self.disk))
            col.current_op = None
            col.flush()
        except Exception as e:  # noqa: BLE001 — the flush must not kill us
            for op in ops:
                op.stream._latch_err(op.idx, e)
        finally:
            _commit.disarm()
            _commit.COUNTS.add(col, len(ops))
            errs += [None] * (len(ops) - len(errs))
            for op, err in zip(ops, errs):
                # a flush-time failure is already latched in the stream
                op.settle(err)

    def close(self, timeout: float) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        # a worker stuck in a hung drive op cannot drain its queue: fail
        # the leftovers here so stream drains return
        while True:
            with self._cv:
                if not self._q:
                    return
                op = self._q.pop(0)
                self._cv.notify_all()
            op.settle(PlaneClosed("writer plane closed"))

    def is_alive(self) -> bool:
        return self._thread.is_alive()


class StreamWriter:
    """One stream's view of the plane: positional drives (the PUT's
    shuffled order), per-drive latched errors, pending-op accounting."""

    def __init__(self, plane: "WriterPlane", disks: list, gen: int):
        self._plane = plane
        self._gen = gen          # plane generation at the stream's birth
        self.disks = list(disks)
        self.errs: list[Exception | None] = [
            None if d is not None else serrors.DiskNotFound("offline")
            for d in self.disks]
        self.cancelled = False
        self._pending = 0
        self._drive_pending = [0] * len(self.disks)
        self._on_idle: dict[int, list] = {}
        self._cv = threading.Condition()

    # -- submission --------------------------------------------------------

    def _latch_err(self, idx: int, err: Exception) -> None:
        """Latch a drive error ahead of the op's settlement (a body or a
        flush-time fsync failed)."""
        with self._cv:
            if self.errs[idx] is None:
                self.errs[idx] = err

    def submit(self, idx: int, fn, batch: _Batch | None = None,
               bound: int | None = None) -> bool:
        """Queue ``fn(idx, disk)`` on drive idx's writer, in order per
        drive.  Returns False (settling ``batch``) for a drive already
        dead for this stream.  Blocks only at the queue bound (``bound``
        overrides the plane's); raises PlaneClosed if the plane shuts
        down meanwhile."""
        disk = self.disks[idx]
        if disk is None or self.errs[idx] is not None or self.cancelled:
            if batch is not None:
                batch.done_one()
            return False
        op = _Op(self, idx, fn, batch)
        with self._cv:
            self._pending += 1
            self._drive_pending[idx] += 1
        try:
            self._plane._enqueue(disk, op, bound)
        except BaseException:
            with self._cv:
                self._pending -= 1
                self._drive_pending[idx] -= 1
                cbs = (self._on_idle.pop(idx, [])
                       if self._drive_pending[idx] == 0 else [])
                self._cv.notify_all()
            self._run_idle_cbs(cbs)
            if batch is not None:
                batch.done_one()
            raise
        return True

    def submit_batch(self, fn, release=None) -> _Batch:
        """Queue one batch of ``fn(idx, disk)`` across all live drives;
        ``release`` fires once every drive's op settled.  Dead drives
        settle at once."""
        idxs = [i for i in range(len(self.disks))
                if self.disks[i] is not None and self.errs[i] is None
                and not self.cancelled]
        batch = _Batch(len(idxs), release)
        done = 0
        try:
            for i in idxs:
                self.submit(i, fn, batch)
                done += 1
        except BaseException:
            for _ in range(len(idxs) - done - 1):
                batch.done_one()   # never-submitted ops settle here
            raise
        return batch

    # -- progress / settlement --------------------------------------------

    def _op_done(self, idx: int, err: Exception | None,
                 batch: _Batch | None) -> None:
        with self._cv:
            if err is not None and self.errs[idx] is None:
                self.errs[idx] = err
            self._pending -= 1
            self._drive_pending[idx] -= 1
            cbs = (self._on_idle.pop(idx, [])
                   if self._drive_pending[idx] == 0 else [])
            self._cv.notify_all()
        self._run_idle_cbs(cbs)
        if batch is not None:
            batch.done_one()

    @staticmethod
    def _run_idle_cbs(cbs) -> None:
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — cleanup is best-effort
                pass

    def when_drive_idle(self, idx: int, fn) -> None:
        """Run ``fn()`` once drive idx has no unsettled op of this stream:
        now when it is idle, else on the thread that settles its last
        op.  Tmp cleanup after a timed-out ``drain`` rides this, so a
        stuck append that resumes cannot recreate a removed staging
        dir."""
        with self._cv:
            if self._drive_pending[idx] > 0:
                self._on_idle.setdefault(idx, []).append(fn)
                return
        self._run_idle_cbs([fn])

    def alive(self) -> int:
        return sum(1 for i, d in enumerate(self.disks)
                   if d is not None and self.errs[i] is None)

    def abort(self) -> None:
        """Cancel this stream: its queued ops become no-ops (their slots
        still drain, so other streams' per-drive order holds)."""
        self.cancelled = True

    def drain(self, timeout: float | None = None) -> bool:
        """Wait for every submitted op to settle; True when idle."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending:
                if end is None:
                    self._cv.wait()
                else:
                    left = end - time.monotonic()
                    if left <= 0:
                        return False
                    self._cv.wait(left)
        return True


class WriterPlane:
    """The per-layer registry of drive writers (started lazily)."""

    _NAMES = itertools.count()

    def __init__(self):
        self._writers: dict[int, _DriveWriter] = {}
        self._mu = threading.Lock()
        self._closed = False
        self._gen = 0            # bumped by close(); older streams die

    def stream(self, disks: list) -> StreamWriter:
        with self._mu:
            gen = self._gen
        return StreamWriter(self, disks, gen)

    def _enqueue(self, disk, op: _Op, bound: int | None = None) -> None:
        key = id(disk)
        with self._mu:
            if self._closed or op.stream._gen != self._gen:
                # a stream born before the last close() must not respawn
                # writers: its PUT aborts instead
                raise PlaneClosed("writer plane closed")
            w = self._writers.get(key)
            if w is None or not w.is_alive():
                w = _DriveWriter(
                    disk, f"mt-putw-{next(WriterPlane._NAMES)}")
                self._writers[key] = w
        w.put(op, bound if bound is not None else QUEUE_DEPTH)

    def threads(self) -> list[threading.Thread]:
        with self._mu:
            return [w._thread for w in self._writers.values()]

    def close(self, timeout: float = 10.0) -> None:
        """Stop every writer: wake blocked enqueuers with PlaneClosed,
        fail queued ops so drains return, join the threads.  Streams
        created after the close reopen the plane; streams in flight get
        PlaneClosed on their next enqueue."""
        with self._mu:
            self._closed = True
            self._gen += 1
            writers = list(self._writers.values())
            self._writers.clear()
        per = timeout / max(1, len(writers))
        for w in writers:
            w.close(per)
        with self._mu:
            self._closed = False
