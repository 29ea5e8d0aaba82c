"""Shared set-up of the object-feature tests (``test_torch_copy.py``,
``test_torch_tagging.py``, ``test_torch_objectlock.py``,
``test_torch_bucket_configs.py``, ``test_torch_events.py``,
``test_torch_replication.py``): the same
request to ``minio_tpu``'s server and the port's (``_torch_control``),
their answers compared whole; the drives of the two compared byte for
byte; one wall clock for both packages' object-lock modules, so a
bucket's default retention stamps the same retain-until date on each;
and the checks that no event or replication thread outlives its
servers."""

import datetime
import os
import re
import threading
import time
import types

import minio_tpu.bucket.objectlock as ref_olock
import minio_tpu_torch.bucket.objectlock as port_olock

from ._torch_control import client

VOLATILE_HEADERS = ("date", "server", "x-amz-request-id")
VOLATILE_XML = re.compile(rb"<(RequestId|Location)>[^<]*</\1>")
S3NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def wire(resp) -> tuple:
    """What must match: status, headers in order (volatile values
    masked), body (volatile XML values masked)."""
    return (resp.status,
            [(k, "*" if k.lower() in VOLATILE_HEADERS else v)
             for k, v in resp.headers.items()],
            VOLATILE_XML.sub(rb"<\1>*</\1>", resp.body))


def code(resp) -> str | None:
    return resp.xml().findtext("Code") if resp.body else None


class Pair:
    """The reference's server and the port's behind one request call."""

    def __init__(self, ref, port, root):
        self.ref, self.port, self.root = ref, port, root

    def both(self, method, path, query="", body=b"", headers=None):
        return tuple(client(s).request(method, path, query, body,
                                       headers=headers, expect=())
                     for s in (self.ref, self.port))

    def same(self, method, path, query="", body=b"", headers=None,
             status=None, err=None):
        """The port's answer, after checking it equals the reference's;
        ``status`` and ``err`` (an S3 error code) are checked too."""
        r, p = self.both(method, path, query, body, headers)
        assert wire(p) == wire(r), (method, path, query, headers)
        if status is not None:
            assert p.status == status, p.body
        if err is not None:
            assert code(p) == err, p.body
        return p


def tree(root) -> dict:
    """{path: bytes} of a drive but its staging area, the listing caches
    and the sealed config and IAM (random salts)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith((".mt.sys/tmp", ".mt.sys/metacache",
                           ".mt.sys/buckets/.metacache", ".mt.sys/config")):
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def assert_drives_equal(root, n: int, skip=(), pool: str = "") -> None:
    """Every drive of ``root/port`` (of its ``pool`` dir, ``p0/`` say)
    equal to ``root/ref``'s but the paths under a ``skip`` prefix."""
    for i in range(n):
        got, want = (
            {p: b for p, b in tree(f"{root}/{tag}/{pool}d{i}").items()
             if not p.startswith(tuple(skip))}
            for tag in ("port", "ref"))
        assert sorted(got) == sorted(want), f"drive {i} files differ"
        for path in want:
            assert got[path] == want[path], f"drive {i}: {path} differs"


class _Clock(datetime.datetime):
    NOW: datetime.datetime

    @classmethod
    def now(cls, tz=None):
        return cls.NOW if tz is None else cls.NOW.astimezone(tz)


def assert_no_replication_threads(before, timeout: float = 5.0) -> None:
    """No replication worker (``mt-repl-worker-*``, either package's)
    outlives its servers; threads in ``before`` aside (the reference's
    own tests leave the workers of the planes they start running)."""
    assert_no_event_threads(timeout, before, names=("mt-repl-worker-",))


def pin_lock_clock(mp, now: datetime.datetime | None = None
                   ) -> datetime.datetime:
    """Both object-lock modules read ``now`` (the present second, UTC, by
    default) as their wall clock; returns it."""
    now = now or datetime.datetime.now(datetime.timezone.utc).replace(
        microsecond=0)
    clock = type("Clock", (_Clock,), {"NOW": now})
    fake = types.SimpleNamespace(datetime=clock,
                                 timedelta=datetime.timedelta,
                                 timezone=datetime.timezone)
    for mod in (ref_olock, port_olock):
        mp.setattr(mod, "datetime", fake)
    return now


def assert_no_event_threads(timeout: float = 5.0, before=(),
                            names=("mt-event-send", "mt-egress-",
                                   "event-send")) -> None:
    """No event worker (``mt-event-send``), delivery sender
    (``mt-egress-*``) or pool worker of the reference's notifier
    (``event-send``) outlives its servers and targets; threads in
    ``before`` (alive before the servers were built) aside.  ``names``:
    the thread name prefixes checked."""
    deadline = time.monotonic() + timeout
    while True:
        left = [t.name for t in threading.enumerate()
                if t.name.startswith(names) and t.is_alive()
                and t not in before]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert not left, left
