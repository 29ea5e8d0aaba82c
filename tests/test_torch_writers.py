"""The port's writer plane (``minio_tpu_torch/storage/writers.py``) and
the pipeline pieces around it (body readahead, the framed-buffer pool,
namespace locks), on the CPU.

* per-drive FIFO order across streams, errors latched per (stream,
  drive), a PUT that loses quorum mid-stream aborts and leaves no staging
  files, and ``close()`` joins every writer thread and wakes a blocked
  enqueuer;
* concurrent streams' commits coalesce: eight PUTs in the packed band,
  from eight threads, form group commits of more than one op, whose
  fsyncs are shared.
"""

import os
import threading
import time

import numpy as np
import pytest

from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.parallel.dsync import LockTimeout, NamespaceLock
from minio_tpu_torch.storage import commit, writers
from minio_tpu_torch.storage.xl_storage import XLStorage
from minio_tpu_torch.utils import bufpool
from minio_tpu_torch.utils.readahead import readahead


class _Disk:
    """A drive stand-in for the plane: it only needs an endpoint."""

    def __init__(self, name):
        self.name = name

    def endpoint(self):
        return self.name


def test_per_drive_fifo_across_streams():
    plane = writers.WriterPlane()
    disks = [_Disk(f"d{i}") for i in range(4)]
    seen = {d.name: [] for d in disks}
    try:
        streams = [plane.stream(disks) for _ in range(3)]
        for seq in range(20):
            for s, sw in enumerate(streams):
                sw.submit_batch(lambda idx, disk, s=s, seq=seq:
                                seen[disk.name].append((s, seq)))
        for sw in streams:
            assert sw.drain(10.0)
        for name, ops in seen.items():
            for s in range(3):
                assert [q for t, q in ops if t == s] == list(range(20)), name
    finally:
        plane.close()


def test_errors_latch_per_stream_and_drive():
    plane = writers.WriterPlane()
    disks = [_Disk(f"d{i}") for i in range(4)]
    ran = []
    try:
        sw, other = plane.stream(disks), plane.stream(disks)

        def op(idx, disk, seq):
            if idx == 1 and seq == 2:
                raise OSError("drive 1 failed")
            ran.append((idx, seq))

        for seq in range(5):
            sw.submit_batch(lambda i, d, seq=seq: op(i, d, seq))
            other.submit_batch(lambda i, d, seq=seq:
                               ran.append(("other", i, seq)))
        sw.drain(10.0)
        other.drain(10.0)
        assert isinstance(sw.errs[1], OSError)
        assert sw.alive() == 3 and other.alive() == 4
        mine = [r for r in ran if len(r) == 2]
        assert [s for i, s in mine if i == 1] == [0, 1]   # 3, 4 skipped
        assert [s for i, s in mine if i == 0] == list(range(5))
        assert len([r for r in ran if r[0] == "other"]) == 20
        # a dead drive settles at once and is not queued again
        batch = sw.submit_batch(lambda i, d: ran.append(("late", i)))
        assert batch.done.wait(10.0)
        assert ("late", 1) not in ran
    finally:
        plane.close()


def test_close_joins_threads_and_wakes_a_blocked_enqueuer(monkeypatch):
    monkeypatch.setattr(writers, "QUEUE_DEPTH", 1)
    plane = writers.WriterPlane()
    disk = _Disk("d0")
    gate, started = threading.Event(), threading.Event()
    sw, idle = plane.stream([disk]), plane.stream([disk])
    sw.submit(0, lambda i, d: (started.set(), gate.wait(10.0)))
    assert started.wait(10.0)
    sw.submit(0, lambda i, d: None)              # queued: the bound is full
    got = []

    def blocked():
        try:
            sw.submit(0, lambda i, d: None)
        except writers.PlaneClosed as e:
            got.append(e)

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.1)
    assert t.is_alive(), "enqueue did not wait at the queue bound"
    threads = plane.threads()
    closer = threading.Thread(target=plane.close, args=(5.0,))
    closer.start()
    t.join(5.0)
    assert got and isinstance(got[0], writers.PlaneClosed)
    gate.set()
    closer.join(10.0)
    assert not any(th.is_alive() for th in threads)
    assert sw.drain(5.0)
    # a stream born before the close gets PlaneClosed; a new one works
    assert isinstance(sw.errs[0], writers.PlaneClosed)   # its queued op
    with pytest.raises(writers.PlaneClosed):
        idle.submit(0, lambda i, d: None)
    fresh = plane.stream([disk])
    fresh.submit_batch(lambda i, d: got.append("ran"))
    assert fresh.drain(5.0) and got[-1] == "ran"
    plane.close()


class _FailingCreates(XLStorage):
    def create_file(self, volume, path, data):
        raise OSError(5, "EIO")


def test_quorum_loss_aborts_the_stream(tmp_path, monkeypatch):
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", 16 * 4096)
    disks = []
    for i in range(8):
        os.makedirs(f"{tmp_path}/d{i}")
        disks.append((_FailingCreates if i < 3 else XLStorage)(
            f"{tmp_path}/d{i}"))
    lay = port_eo.ErasureObjects(disks, parity=2, block_size=4096,
                                 device="cpu")
    body = np.random.default_rng(1).integers(
        0, 256, 5 * 16 * 4096, dtype=np.uint8).tobytes()
    try:
        lay.make_bucket("bkt")
        with pytest.raises(port_eo.WriteQuorumError):
            lay.put_object("bkt", "o", body)
        for i in range(8):
            assert os.listdir(f"{tmp_path}/d{i}/.mt.sys/tmp") == []
            assert not os.path.exists(f"{tmp_path}/d{i}/bkt/o")
    finally:
        lay.close()


class _GatedPacked(XLStorage):
    """Drive 0 holds its first packed write until released, so the other
    streams' writes queue up behind it."""

    gate = None

    def write_packed(self, *a, **kw):
        if self.gate is not None:
            gate, self.gate = self.gate, None
            gate.wait(60.0)
        super().write_packed(*a, **kw)


def _queued(plane, disk) -> int:
    """Ops waiting in the drive's writer queue."""
    with plane._mu:
        w = plane._writers.get(id(disk))
    return 0 if w is None else len(w._q)


def test_concurrent_packed_puts_share_group_commits(tmp_path):
    n_threads, size = 8, 200 * 1024
    disks = []
    for i in range(8):
        os.makedirs(f"{tmp_path}/d{i}")
        disks.append((_GatedPacked if i == 0 else XLStorage)(
            f"{tmp_path}/d{i}"))
    gate = threading.Event()
    disks[0].gate = gate
    lay = port_eo.ErasureObjects(disks, parity=2, block_size=4096,
                                 device="cpu")
    bodies = [np.random.default_rng(t).integers(
        0, 256, size, dtype=np.uint8).tobytes() for t in range(n_threads)]
    try:
        lay.make_bucket("bkt")
        commit.COUNTS.reset()
        errs = []

        def put(t):
            try:
                lay.put_object("bkt", f"o{t}", bodies[t])
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(e)

        threads = [threading.Thread(target=put, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if _queued(lay._write_plane, disks[0]) >= n_threads - 1:
                break
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(60)
        assert not errs
        assert commit.COUNTS.largest >= n_threads - 1
        assert commit.COUNTS.grouped >= 1
        assert commit.COUNTS.fsyncs < commit.COUNTS.deferred
        for t in range(n_threads):
            assert lay.get_object("bkt", f"o{t}")[1] == bodies[t]
        # one segment per drive holds all eight objects
        assert len(os.listdir(f"{tmp_path}/d3/.mt.sys/seg")) == 2
    finally:
        lay.close()


# -- pipeline pieces ----------------------------------------------------------


def test_readahead_keeps_order_and_raises_in_place():
    assert list(readahead(iter(range(50)), depth=3)) == list(range(50))

    def gen():
        yield 1
        yield 2
        raise ValueError("source failed")

    ra = readahead(gen(), depth=1)
    assert next(ra) == 1 and next(ra) == 2
    with pytest.raises(ValueError, match="source failed"):
        next(ra)
    ra.close()


def test_readahead_close_stops_and_joins_the_producer():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    ra = readahead(gen(), depth=2)
    assert next(ra) == 0
    ra.close()
    assert not ra._thread.is_alive()
    assert len(produced) < 10
    with pytest.raises(StopIteration):
        next(ra)


def test_bufpool_recycles_by_shape_within_its_bound():
    pool = bufpool.BufPool(max_bytes=100)
    a = pool.acquire((4, 20), pinned=False)
    assert a.shape == (4, 20) and pool.misses == 1
    pool.release(a)
    assert pool.acquire((4, 20), pinned=False) is a and pool.hits == 1
    b = pool.acquire((4, 20), pinned=False)
    assert b is not a
    pool.release(a)
    pool.release(b)                      # over the bound: dropped
    assert pool._held == 80
    assert pool.acquire((2, 40), pinned=False) is not a   # other shape


def test_namespace_lock_excludes_writers_and_shares_readers():
    ns = NamespaceLock()
    w = ns.new_lock("bkt", "o")
    w.lock(write=True)
    with pytest.raises(LockTimeout):
        ns.new_lock("bkt", "o").lock(write=False, timeout=0.05)
    other = ns.new_lock("bkt", "p")
    other.lock(write=True)               # another object: no wait
    other.unlock()
    w.unlock()
    r1, r2 = ns.new_lock("bkt", "o"), ns.new_lock("bkt", "o")
    r1.lock(write=False)
    r2.lock(write=False)
    with pytest.raises(LockTimeout):
        ns.new_lock("bkt", "o").lock(write=True, timeout=0.05)
    # a writer waited: new readers yield to it for a while
    with pytest.raises(LockTimeout):
        ns.new_lock("bkt", "o").lock(write=False, timeout=0.05)
    r1.unlock()
    r2.unlock()
    w2 = ns.new_lock("bkt", "o")
    w2.lock(write=True, timeout=1.0)
    w2.unlock()
    assert not ns.locker._map                    # the table is empty
