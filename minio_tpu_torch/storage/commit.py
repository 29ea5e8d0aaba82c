"""Per-drive group commit and packed small-object segments
(``minio_tpu/storage/commit.py``), without its kvconfig, metrics and lock
tracing.

Two pieces:

  * :class:`GroupCollector`: the deferred-durability ledger a drive
    writer (``storage/writers.py``) arms on its thread around one batch
    of queued ops.  Drive op bodies (``xl_storage.py``) register dup'd
    file descriptors and parent-dir paths instead of fsyncing at once,
    and park the ``os.replace`` that makes an xl.meta visible as an
    ``after_flush`` continuation; :meth:`GroupCollector.flush` then runs
    rounds of fsync, then continuations, until nothing is left.  So an
    xl.meta replace runs only after every fsync registered before it (its
    part or segment bytes and its own tmp file) has landed, the same
    order the eager path keeps, batched.  The fds are dup'd because the
    op body closes its own and may rename the file before the flush.

  * :class:`SegmentStore`: per-drive journaled append-only segment files
    under ``<root>/.mt.sys/seg/`` that pack many small objects' framed
    shards behind one fsync; xl.meta points into them through the
    version's ``seg`` extent ``{sid, off, len}``.  The journal is a run
    of msgpack ``add``/``free``/``seal``/``drop`` records; recovery is an
    idempotent replay that truncates a torn tail record.

The reference's defaults are this module's constants: group commit on,
16 ops per group, no extra wait for batch-mates, objects up to 1 MiB
packed, segments rotated at 64 MiB.
"""

from __future__ import annotations

import os
import threading

from . import errors
from .msgpack_codec import packb, unpack_stream

MAX_BATCH = 16                       # ops coalesced per group commit
PACK_THRESHOLD = 1 << 20             # objects packed up to this size
SEGMENT_MAX_BYTES = 64 << 20         # segment rotation point
COMPACT_DEAD_RATIO = 0.5             # a sealed segment this dead compacts


class CommitCounts:
    """What the group commits did, summed over every drive writer (the
    reference publishes the same as its mt_commit_group_* metrics)."""

    def __init__(self):
        self._mu = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.batches = 0        # flushed batches that deferred work
        self.ops = 0            # ops in those batches
        self.grouped = 0        # batches of more than one op
        self.largest = 0        # most ops in one batch
        self.streams = 0        # distinct streams per batch, summed
        self.deferred = 0       # eager fsyncs the batches replaced
        self.fsyncs = 0         # fsync syscalls the flushes issued
        self.seg_bytes = 0      # bytes packed into segments

    def add(self, col: "GroupCollector", n_ops: int) -> None:
        if n_ops <= 1 and col.deferred == 0:
            return
        with self._mu:
            self.batches += 1
            self.ops += n_ops
            self.grouped += n_ops > 1
            self.largest = max(self.largest, n_ops)
            self.streams += max(1, len(col.streams))
            self.deferred += col.deferred
            self.fsyncs += col.synced
            self.seg_bytes += col.seg_bytes


COUNTS = CommitCounts()

# -- the per-batch collector ------------------------------------------------

_TLS = threading.local()


def collector() -> "GroupCollector | None":
    """The GroupCollector armed on this thread (a drive writer running a
    grouped batch), or None: drive op bodies defer their durability work
    into it instead of fsyncing at once."""
    return getattr(_TLS, "collector", None)


def arm(col: "GroupCollector") -> None:
    _TLS.collector = col


def disarm() -> None:
    _TLS.collector = None


class GroupCollector:
    """Deferred-durability ledger for one drive-writer batch.  It runs on
    the drive's single writer thread only.  Every registration is tagged
    with the op whose body is running (``current_op``), so a flush-time
    fsync failure latches onto exactly the streams whose writes it
    covered."""

    def __init__(self):
        self.current_op = None
        self._fds: list = []                # (fd, [ops], dedup key)
        self._dirs: dict[str, list] = {}    # path -> registering ops
        self._after: list = []              # (fn, op) continuations
        # xl.meta replaces still parked in ``_after``: a batch-mate's
        # read-merge-write of the same object must see the pending content
        self._pending: dict[str, bytes] = {}
        self.deferred = 0
        self.synced = 0
        self.seg_bytes = 0
        self.streams: set = set()

    def _note_stream(self) -> None:
        if self.current_op is not None:
            self.streams.add(id(self.current_op.stream))

    def defer_fd(self, fd: int, key=None) -> None:
        """Own dup'd ``fd`` and fsync it at flush.  A non-None ``key``
        dedups: many packed writes of one batch register the same segment
        fd once (that is the saved fsync)."""
        self.deferred += 1
        self._note_stream()
        if key is not None:
            for rec in self._fds:
                if rec[2] == key:
                    os.close(fd)
                    rec[1].append(self.current_op)
                    return
        self._fds.append((fd, [self.current_op], key))

    def defer_dir(self, path: str) -> None:
        """Defer a directory fsync; the same path across the batch
        collapses to one syscall."""
        self.deferred += 1
        self._note_stream()
        self._dirs.setdefault(path, []).append(self.current_op)

    def after_flush(self, fn) -> None:
        """Run ``fn`` after every fsync registered so far has landed."""
        self._after.append((fn, self.current_op))

    def pending_put(self, path: str, data: bytes) -> None:
        self._pending[path] = data

    def pending_get(self, path: str) -> bytes | None:
        return self._pending.get(path)

    @staticmethod
    def _latch(ops, err: Exception) -> None:
        for op in ops:
            if op is not None:
                op.stream._latch_err(op.idx, err)

    def flush(self) -> None:
        """Rounds until quiescent: fsync the registered fds, fsync the
        dedup'd dirs, then run the continuations (which may register
        more of both: a deferred xl.meta replace registers its parent
        dir)."""
        while self._fds or self._dirs or self._after:
            fds, self._fds = self._fds, []
            dirs, self._dirs = self._dirs, {}
            for fd, ops, _ in fds:
                try:
                    os.fsync(fd)
                except OSError as e:
                    self._latch(ops, errors.FaultyDisk(str(e)))
                finally:
                    os.close(fd)
                self.synced += 1
            for path in dirs:
                self.synced += 1
                try:
                    dfd = os.open(path, os.O_RDONLY
                                  | getattr(os, "O_DIRECTORY", 0))
                except OSError:
                    continue        # the eager _fsync_dir's tolerance
                try:
                    os.fsync(dfd)
                except OSError:
                    pass
                finally:
                    os.close(dfd)
            after, self._after = self._after, []
            for fn, op in after:
                self.current_op = op
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 — latched per op
                    self._latch([op], e)
            self.current_op = None
        self._pending.clear()


# -- packed small-object segments -------------------------------------------

SEG_DIR = "seg"                      # under <root>/.mt.sys/
JOURNAL = "journal"


def seg_name(sid: int) -> str:
    return f"seg.{sid:08x}.dat"


def write_full(fd: int, data) -> None:
    mv = memoryview(data).cast("B")
    written = 0
    while written < len(mv):
        written += os.write(fd, mv[written:])


class SegmentStore:
    """Journaled append-only segment files packing many small objects'
    framed shards on one drive.

    Layout under ``dir_path`` (``<root>/.mt.sys/seg``):

        journal            msgpack add/free/seal/drop records, append-only
        seg.<sid>.dat      framed shards back to back, append-only

    The journal record and the segment bytes are fsynced in the same
    flush round before the owner's xl.meta replace runs, so a version
    never points at bytes that could vanish.  Recovery replays the
    journal; duplicate adds and frees are idempotent."""

    def __init__(self, dir_path: str,
                 segment_max_bytes: int = SEGMENT_MAX_BYTES):
        self.dir = dir_path
        self.segment_max_bytes = segment_max_bytes
        self._mu = threading.Lock()
        # sid -> {"size": int, "sealed": bool,
        #         "live": {off: (length, vol, name, vid)}}
        self._segs: dict[int, dict] = {}
        self._cur = 0
        self._cur_fd = -1
        self._jfd = -1
        self._loaded = False

    # -- journal -----------------------------------------------------------

    def _jpath(self) -> str:
        return os.path.join(self.dir, JOURNAL)

    def _seg_path(self, sid: int) -> str:
        return os.path.join(self.dir, seg_name(sid))

    def _replay(self) -> None:
        """Idempotent journal replay; truncates a torn tail record."""
        try:
            with open(self._jpath(), "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            return
        good = 0
        try:
            for rec, end in unpack_stream(buf):
                self._apply(rec)
                good = end
        except Exception:  # noqa: BLE001 — a torn tail ends the replay
            pass
        if good < len(buf):
            with open(self._jpath(), "r+b") as f:
                f.truncate(good)

    def _apply(self, rec: dict) -> None:
        op = rec.get("op")
        if op == "add":
            s = self._segs.setdefault(
                rec["sid"], {"size": 0, "sealed": False, "live": {}})
            s["live"][rec["off"]] = (rec["len"], rec.get("vol", ""),
                                     rec.get("name", ""),
                                     rec.get("vid", ""))
            s["size"] = max(s["size"], rec["off"] + rec["len"])
        elif op == "free":
            s = self._segs.get(rec["sid"])
            if s is not None:
                s["live"].pop(rec["off"], None)
        elif op == "seal":
            s = self._segs.get(rec["sid"])
            if s is not None:
                s["sealed"] = True
        elif op == "drop":
            self._segs.pop(rec["sid"], None)

    def _journal(self, rec: dict) -> None:
        write_full(self._jfd, packb(rec))

    def _open_segment(self, sid: int) -> None:
        self._cur = sid
        self._cur_fd = os.open(self._seg_path(sid),
                               os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                               0o644)

    def _ensure(self) -> None:
        if self._loaded:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._replay()
        self._jfd = os.open(self._jpath(),
                            os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        open_sids = [sid for sid, s in self._segs.items()
                     if not s["sealed"]]
        self._open_segment(max(open_sids) if open_sids
                           else (max(self._segs) + 1 if self._segs else 1))
        s = self._segs.setdefault(
            self._cur, {"size": 0, "sealed": False, "live": {}})
        # a crash may have left appended-but-unjournaled bytes at the
        # tail; append past them (extents are journal-defined)
        s["size"] = max(s["size"], os.fstat(self._cur_fd).st_size)
        self._loaded = True

    def _lost(self, s: dict) -> bool:
        """Whether the open segment lost bytes its journal holds (removed
        or truncated under the store): an append there would not land at
        its journaled offset."""
        st = os.fstat(self._cur_fd)
        return st.st_nlink == 0 or st.st_size < s["size"]

    # -- extents -----------------------------------------------------------

    def append(self, framed, vol: str, name: str,
               vid: str) -> tuple[int, int]:
        """Append one framed shard; returns (sid, off).  Durability is the
        caller's: :meth:`sync` or :meth:`defer_sync` before any xl.meta
        references the extent."""
        data = framed if isinstance(framed, bytes) else bytes(framed)
        with self._mu:
            self._ensure()
            s = self._segs[self._cur]
            if s["size"] and (s["size"] + len(data) > self.segment_max_bytes
                              or self._lost(s)):
                self._rotate()
                s = self._segs[self._cur]
            sid, off = self._cur, s["size"]
            write_full(self._cur_fd, data)
            s["size"] = off + len(data)
            s["live"][off] = (len(data), vol, name, vid)
            self._journal({"op": "add", "sid": sid, "off": off,
                           "len": len(data), "vol": vol, "name": name,
                           "vid": vid})
            return sid, off

    def _rotate(self) -> None:
        # caller holds self._mu
        self._journal({"op": "seal", "sid": self._cur})
        self._segs[self._cur]["sealed"] = True
        os.close(self._cur_fd)
        self._open_segment(self._cur + 1)
        self._segs[self._cur] = {"size": 0, "sealed": False, "live": {}}

    def sync(self) -> None:
        """Eager durability: fsync the open segment and the journal."""
        with self._mu:
            if self._cur_fd >= 0:
                os.fsync(self._cur_fd)
            if self._jfd >= 0:
                os.fsync(self._jfd)

    def defer_sync(self, col: GroupCollector) -> None:
        """Grouped durability: register dup'd segment and journal fds with
        the batch's collector, dedup'd per store, so N packed writes in
        one batch cost one segment fsync and one journal fsync."""
        with self._mu:
            if self._cur_fd >= 0:
                col.defer_fd(os.dup(self._cur_fd),
                             key=("seg", id(self), self._cur))
            if self._jfd >= 0:
                col.defer_fd(os.dup(self._jfd), key=("segj", id(self)))

    def read(self, sid: int, off: int, length: int) -> bytes:
        """``length`` bytes of segment ``sid`` at ``off`` (FileNotFound
        without the segment, FileCorrupt on a short read)."""
        with self._mu:
            self._ensure()
        try:
            fd = os.open(self._seg_path(sid), os.O_RDONLY)
        except FileNotFoundError:
            raise errors.FileNotFound(f"segment {sid}") from None
        try:
            data = os.pread(fd, length, off)
        finally:
            os.close(fd)
        if len(data) < length:
            raise errors.FileCorrupt(
                f"segment {sid}: short read {len(data)} < {length} "
                f"at +{off}")
        return data

    def stat(self, sid: int, off: int, length: int) -> int:
        """The extent's length once its segment is known to hold it
        (FileNotFound without the segment, FileCorrupt when short)."""
        with self._mu:
            self._ensure()
        try:
            size = os.stat(self._seg_path(sid)).st_size
        except FileNotFoundError:
            raise errors.FileNotFound(f"segment {sid}") from None
        if size < off + length:
            raise errors.FileCorrupt(
                f"segment {sid}: {size} < {off + length}")
        return length

    def free(self, sid: int, off: int) -> None:
        """Drop one extent; a sealed segment left with no live extent is
        dropped from the journal and unlinked."""
        unlink = False
        with self._mu:
            self._ensure()
            s = self._segs.get(sid)
            if s is None or off not in s["live"]:
                return
            s["live"].pop(off, None)
            self._journal({"op": "free", "sid": sid, "off": off})
            if s["sealed"] and not s["live"]:
                self._journal({"op": "drop", "sid": sid})
                self._segs.pop(sid, None)
                unlink = True
        if unlink:
            try:
                os.unlink(self._seg_path(sid))
            except OSError:
                pass

    # -- compaction --------------------------------------------------------

    def compact(self, rewrite) -> dict:
        """Reclaim dead space: every live extent of each sealed segment
        whose dead share reached ``COMPACT_DEAD_RATIO`` goes through
        ``rewrite(vol, name, vid, sid, off, length) -> bool`` (the drive
        moves the owner's xl.meta to a fresh extent and returns True, or
        False when the owner no longer references the extent), then is
        freed.  Returns {"segments", "moved", "freed",
        "reclaimed_bytes"}."""
        with self._mu:
            self._ensure()
            candidates = []
            for sid, s in list(self._segs.items()):
                if not s["sealed"] or not s["size"]:
                    continue
                live = sum(ln for ln, *_ in s["live"].values())
                if not s["live"] or \
                        (s["size"] - live) / s["size"] \
                        >= COMPACT_DEAD_RATIO:
                    candidates.append(
                        (sid, dict(s["live"]), s["size"] - live))
        moved = freed = segments = reclaimed = 0
        for sid, live, dead_bytes in candidates:
            for off, (length, vol, name, vid) in live.items():
                try:
                    ok = rewrite(vol, name, vid, sid, off, length)
                except Exception:  # noqa: BLE001 — the next sweep retries
                    continue
                moved += ok
                freed += not ok
                self.free(sid, off)
            segments += 1
            reclaimed += dead_bytes
        return {"segments": segments, "moved": moved, "freed": freed,
                "reclaimed_bytes": reclaimed}

    def stats(self) -> dict:
        with self._mu:
            live = dead = 0
            for s in self._segs.values():
                lb = sum(ln for ln, *_ in s["live"].values())
                live += lb
                dead += s["size"] - lb
            return {"segments": len(self._segs), "live_bytes": live,
                    "dead_bytes": dead}

    def close(self) -> None:
        with self._mu:
            for fd in (self._cur_fd, self._jfd):
                if fd >= 0:
                    os.close(fd)
            self._cur_fd = self._jfd = -1
            self._loaded = False
            self._segs.clear()
