"""The node memory governor (``minio_tpu/utils/memgov.py``): admission by
bytes for request paths whose working set is bounded but large.

A path charges its working-set estimate before it holds the memory; a
charge that would take the node past ``limit_bytes`` is refused with
:class:`MemoryPressure`, which the S3 front answers 503 ``SlowDown``
with ``Retry-After`` (cmd/handler-api.go's maxClients role, in bytes).
``limit_bytes == 0`` admits everything; charges are still counted, so
the ``mt_mem_*`` families stay observable once touched.  The port
charges ``commit`` (the framed shards of a one-batch PUT while the
drives write them) and ``multipart`` (the largest part of a
CompleteMultipartUpload).

A charge is released exactly once: explicitly, by its context manager
or, when a request abandons it, by ``Charge.__del__``, which a GC
finalizer may run on any thread, also inside a locked section of this
governor on the same thread.  So a release takes no lock: it appends to
a queue that every locked reader folds in first.  The knobs are the
``api`` kvconfig subsystem's ``mem_limit`` and ``mem_retry_after``,
pushed live by ``S3Server.reload_api_config``.
"""

from __future__ import annotations

import collections
import threading

from ..admin import metrics as _metrics
from .kvconfig import parse_duration

# kinds that legitimately stay charged between requests (the reference's
# hot-object cache); every other kind settles to zero at idle
RESIDENT_KINDS = frozenset({"cache"})


class MemoryPressure(Exception):
    """A charge past the watermark; the S3 front answers 503 SlowDown
    with Retry-After."""

    def __init__(self, kind: str, want: int, inuse: int, limit: int,
                 retry_after_s: float = 1.0):
        super().__init__(
            f"memory governor: {kind} charge of {want} B refused "
            f"({inuse} B in use, limit {limit} B)")
        self.kind = kind
        self.want = want
        self.inuse = inuse
        self.limit = limit
        self.retry_after_s = retry_after_s


def parse_size(s: str, default: int = 0) -> int:
    """'268435456' / '256MiB' / '1GiB' -> bytes (config size keys)."""
    s = (s or "").strip()
    mult = 1
    for suffix, m in (("KiB", 1 << 10), ("MiB", 1 << 20),
                      ("GiB", 1 << 30), ("KB", 10 ** 3), ("MB", 10 ** 6),
                      ("GB", 10 ** 9), ("K", 1 << 10), ("M", 1 << 20),
                      ("G", 1 << 30), ("B", 1)):
        if s.endswith(suffix):
            s, mult = s[:-len(suffix)], m
            break
    try:
        return int(float(s) * mult)
    except ValueError:
        return default


class Charge:
    """One request's reservation; ``release`` is idempotent."""

    __slots__ = ("_gov", "kind", "nbytes", "_released")

    def __init__(self, gov: "MemoryGovernor", kind: str, nbytes: int):
        self._gov = gov
        self.kind = kind
        self.nbytes = nbytes
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._gov._release(self.kind, self.nbytes)

    def __enter__(self) -> "Charge":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __del__(self):      # abandoned mid-request: never leak the bytes
        self.release()


class MemoryGovernor:
    """Watermark accounting shared by every charging site."""

    def __init__(self, limit_bytes: int = 0, retry_after_s: float = 1.0):
        self._mu = threading.Lock()
        # releases not yet folded into _inuse: deque.append is atomic, so
        # a finalizer never waits on _mu
        self._released: collections.deque = collections.deque()
        self.limit_bytes = limit_bytes
        self.retry_after_s = retry_after_s
        self._inuse: dict[str, int] = {}
        self._peak = 0
        self._shed: dict[str, int] = {}

    def configure(self, limit_bytes: int,
                  retry_after_s: float | None = None) -> None:
        with self._mu:
            self.limit_bytes = max(0, int(limit_bytes))
            if retry_after_s is not None:
                self.retry_after_s = max(0.0, float(retry_after_s))

    def _fold(self) -> None:
        """Apply the queued releases (under ``_mu``)."""
        while True:
            try:
                kind, nbytes = self._released.popleft()
            except IndexError:
                return
            cur = self._inuse.get(kind, 0) - nbytes
            if cur > 0:
                self._inuse[kind] = cur
            else:
                self._inuse.pop(kind, None)

    def _admit(self, nbytes: int, kind: str, shed: bool) -> Charge | None:
        """The watermark check and the accounting: a refusal with
        ``shed`` counts into ``mt_mem_shed_total`` and raises
        MemoryPressure; without, it returns None."""
        nbytes = max(0, int(nbytes))
        with self._mu:
            self._fold()
            inuse = sum(self._inuse.values())
            if self.limit_bytes and inuse + nbytes > self.limit_bytes:
                if not shed:
                    return None
                self._shed[kind] = self._shed.get(kind, 0) + 1
                _metrics.GLOBAL.inc("mt_mem_shed_total", {"kind": kind})
                raise MemoryPressure(kind, nbytes, inuse, self.limit_bytes,
                                     self.retry_after_s)
            self._inuse[kind] = self._inuse.get(kind, 0) + nbytes
            self._peak = max(self._peak, inuse + nbytes)
        return Charge(self, kind, nbytes)

    def charge(self, nbytes: int, kind: str = "other") -> Charge:
        """Reserve ``nbytes`` for one request; MemoryPressure past the
        watermark (shed, do not allocate)."""
        return self._admit(nbytes, kind, shed=True)

    def try_charge(self, nbytes: int, kind: str = "other") -> Charge | None:
        """Admission for an optional allocation: None past the watermark,
        and no shed counted."""
        return self._admit(nbytes, kind, shed=False)

    def _release(self, kind: str, nbytes: int) -> None:
        self._released.append((kind, nbytes))

    # -- observability -----------------------------------------------------

    def inuse_bytes(self, kind: str | None = None) -> int:
        with self._mu:
            self._fold()
            if kind is not None:
                return self._inuse.get(kind, 0)
            return sum(self._inuse.values())

    def transient_bytes(self) -> int:
        """Request-scoped bytes outstanding (every kind but the resident
        ones): zero at idle, or a request leaked its charge."""
        with self._mu:
            self._fold()
            return sum(v for k, v in self._inuse.items()
                       if k not in RESIDENT_KINDS)

    def stats(self) -> dict:
        with self._mu:
            self._fold()
            return {"limit_bytes": self.limit_bytes,
                    "inuse": dict(self._inuse),
                    "peak_bytes": self._peak,
                    "shed": dict(self._shed)}

    @property
    def touched(self) -> bool:
        """Whether the scrape has anything to show: an unconfigured
        governor that never took a charge nor shed emits nothing."""
        with self._mu:
            return bool(self.limit_bytes or self._peak or self._shed)

    def load(self, config) -> None:
        """Take ``api mem_limit`` and ``mem_retry_after`` from the
        kvconfig (``S3Server.reload_api_config``)."""
        limit = parse_size(config.get("api", "mem_limit"), 0)
        retry = parse_duration(config.get("api", "mem_retry_after") or "1s",
                               1.0)
        self.configure(limit, retry)


# one node, one memory budget: shared by every server and layer of the
# process
GOVERNOR = MemoryGovernor()
