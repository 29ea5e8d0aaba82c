"""dsync quorum locks over several lock tables (``parallel/dsync.py``)
against ``minio_tpu``'s: exclusion, read sharing and quorum with a dead
locker in both packages; TTL expiry of a crashed holder, refresh of a
long holder, ``LockLost`` and the expiry sweep under a pinned clock
(the reference's own tests sleep for them, ``tests/test_cluster.py:
155-296``); the ``lock`` service on the wire both ways; the refresher
stopped and joined."""

import threading

import pytest

from minio_tpu.parallel import dsync as ref_dsync
from minio_tpu.parallel import rpc as ref_rpc
from minio_tpu_torch.parallel import dsync as port_dsync
from minio_tpu_torch.parallel import rpc as port_rpc

from ._torch_cluster import Clients, cluster_state_left

PKG = {"ref": (ref_dsync, ref_rpc), "port": (port_dsync, port_rpc)}


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with cluster_state_left():
        yield


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class Dead:
    def lock(self, *a, **kw):
        raise ConnectionError("down")

    unlock = refresh = lock


def _outcome(m, write: bool, timeout: float) -> str:
    try:
        m.lock(write=write, timeout=timeout)
        return "granted"
    except Exception as e:  # noqa: BLE001
        return type(e).__name__


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_exclusion_sharing_and_quorum(pkg):
    ds = PKG[pkg][0]
    lockers = [ds.LocalLocker() for _ in range(3)]
    a, b = ds.DRWMutex(lockers, "res"), ds.DRWMutex(lockers, "res")
    got = [_outcome(a, True, 1.0), _outcome(b, True, 0.05)]
    a.unlock()
    got.append(_outcome(b, True, 1.0))
    b.unlock()
    r1, r2, w = (ds.DRWMutex(lockers, "res") for _ in range(3))
    got += [_outcome(r1, False, 1.0), _outcome(r2, False, 0.5),
            _outcome(w, True, 0.05)]
    r1.unlock()
    r2.unlock()
    got.append(_outcome(w, True, 1.0))
    w.unlock()
    # 2 of 3 hold a write, 1 of 3 does not
    for dead in (1, 2):
        lk = [ds.LocalLocker() for _ in range(3 - dead)] + [Dead()] * dead
        m = ds.DRWMutex(lk, "res")
        got.append(_outcome(m, True, 0.05))
        m.unlock()
    assert got == ["granted", "LockTimeout", "granted", "granted", "granted",
                   "LockTimeout", "granted", "granted", "LockTimeout"]
    assert not any(lk._map for lk in lockers)


def _pinned(n: int = 3, ttl: float = 0.3):
    clk = Clock()
    return clk, [port_dsync.LocalLocker(default_ttl_s=ttl, clock=clk)
                 for _ in range(n)]


def test_a_crashed_holders_grants_expire_after_one_ttl():
    clk, lockers = _pinned()
    crashed = port_dsync.DRWMutex(lockers, "res", ttl_s=0.3)
    crashed.lock(write=True)
    port_dsync._REFRESHER.remove(crashed)      # a kill -9
    waiter = port_dsync.DRWMutex(lockers, "res", ttl_s=0.3)
    assert _outcome(waiter, True, 0.05) == "LockTimeout"
    clk.t += 0.31
    assert _outcome(waiter, True, 0.05) == "granted"
    waiter.unlock()


def test_refresh_keeps_a_long_holder_and_a_lapse_is_lost():
    clk, lockers = _pinned()
    holder = port_dsync.DRWMutex(lockers, "res", ttl_s=0.3)
    holder.lock(write=True)
    port_dsync._REFRESHER.remove(holder)
    for _ in range(6):          # several TTLs, refreshed every ttl/3
        clk.t += 0.1
        holder._do_refresh()
    thief = port_dsync.DRWMutex(lockers, "res", ttl_s=0.3)
    assert _outcome(thief, True, 0.05) == "LockTimeout"
    holder.ensure_valid()
    # a pause past the TTL: the thief takes it, the holder sees it lost
    clk.t += 0.31
    assert _outcome(thief, True, 0.05) == "granted"
    holder._do_refresh()
    with pytest.raises(port_dsync.LockLost):
        holder.ensure_valid()
    thief.unlock()
    holder.unlock()


def test_the_expiry_sweep_and_force_unlock():
    clk, (lk,) = _pinned(1, ttl=0.1)
    assert lk.lock("a", "uid1", True) and lk.lock("b", "uid2", False)
    assert lk.lock("b", "uid3", False, ttl_s=5.0)
    clk.t += 0.15
    assert lk.expire_old_locks() == 2
    assert not lk.is_locked("a") and lk.is_locked("b")
    assert lk.force_unlock("b") and not lk.force_unlock("b")


def _wire(remote_cls, client) -> list:
    r = remote_cls(client)
    return [r.lock("res", "u1", True), r.lock("res", "u2", True),
            r.lock("res", "u2", False), r.refresh("res", "u1"),
            r.refresh("res", "u2"), r.unlock("res", "u2"),
            r.unlock("res", "u1"), r.lock("res", "u2", True, 5.0),
            r.lock("res", "u3", False), r.force_unlock("res"),
            r.force_unlock("res"), r.unlock("res", "u3")]


@pytest.mark.parametrize("cpkg,spkg", [("ref", "ref"), ("port", "ref"),
                                       ("ref", "port"), ("port", "port")])
def test_the_lock_service_on_the_wire_both_ways(cpkg, spkg):
    sds, srpc = PKG[spkg]
    cds, _ = PKG[cpkg]
    srv = srpc.RPCServer("lk")
    table = sds.LocalLocker()
    sds.register_lock_service(srv, table)
    srv.start()
    clients = Clients()
    try:
        got = _wire(cds.RemoteLocker, clients(cpkg, srv.endpoint, "lk"))
        assert got == [True, False, False, True, False, False, True, True,
                       False, True, False, False]
        # a quorum lock over this node's table and two remote ones
        lockers = [cds.LocalLocker(),
                   cds.RemoteLocker(clients(cpkg, srv.endpoint, "lk")),
                   cds.RemoteLocker(clients(cpkg, srv.endpoint, "lk"))]
        a, b = cds.DRWMutex(lockers, "obj"), cds.DRWMutex(lockers, "obj")
        assert _outcome(a, True, 1.0) == "granted" and table.is_locked("obj")
        assert _outcome(b, False, 0.05) == "LockTimeout"
        a.unlock()
        assert not table.is_locked("obj")
    finally:
        clients.close()
        srv.stop()
    assert cds.RemoteLocker(clients(cpkg, srv.endpoint, "lk")).lock(
        "x", "u", True) is False          # the peer is gone: not granted


def test_the_refresher_starts_with_a_lock_and_stops_joined():
    def running():
        return [t for t in threading.enumerate()
                if t.name.startswith(("mt-lock-refresh", "mt-lock-renew"))]
    port_dsync.stop_refresher()
    single = port_dsync.NamespaceLock().new_lock("b", "o")
    single.lock()
    # one node: grants never expire and nothing refreshes them
    assert not running() and single.ttl_s == port_dsync.NO_TTL
    single.unlock()
    for _ in range(2):
        m = port_dsync.DRWMutex([port_dsync.LocalLocker()], "res")
        m.lock()
        assert running()
        m.unlock()
        port_dsync.stop_refresher()
        assert not running()


def test_the_fan_out_asks_every_locker_at_once():
    """Two lockers that each grant only once the other was asked: a
    serial fan-out would break the barrier and miss the quorum."""
    meet = threading.Barrier(2, timeout=2.0)

    class Meeting(port_dsync.LocalLocker):
        def lock(self, *a, **kw):
            meet.wait()
            return super().lock(*a, **kw)

    m = port_dsync.DRWMutex([Meeting(), Meeting(), port_dsync.LocalLocker()],
                            "res", ttl_s=port_dsync.NO_TTL)
    m.lock(write=True, timeout=5.0)
    assert m._granted == [True, True, True]
    m.unlock()


@pytest.mark.parametrize("pipeline", ["pipelined", "serial"])
def test_a_lost_lock_commits_no_streamed_put(tmp_path, monkeypatch,
                                              pipeline):
    """A holder whose grants fell below quorum while the body streamed
    (``lost`` set once the lock was taken) raises LockLost at the commit
    point: no version becomes visible."""
    from minio_tpu_torch.objectlayer import erasure_object as eo
    from minio_tpu_torch.objectlayer.interface import ObjectNotFound
    from minio_tpu_torch.storage.xl_storage import XLStorage

    class LosingLocks(port_dsync.NamespaceLock):
        def new_lock(self, bucket, *objects):
            m = super().new_lock(bucket, *objects)
            take = m.lock

            def lock(*a, **kw):
                take(*a, **kw)
                m.lost.set()
            m.lock = lock
            return m

    monkeypatch.setattr(eo, "STREAM_BATCH_BYTES", 8 * 4096)
    if pipeline == "serial":
        monkeypatch.setattr(eo.ErasureObjects, "_pipeline_on",
                            lambda self: False)
    disks = []
    for i in range(4):
        (tmp_path / f"d{i}").mkdir()
        disks.append(XLStorage(str(tmp_path / f"d{i}")))
    er = eo.ErasureObjects(disks, parity=2, block_size=4096, device="cpu",
                           ns_lock=LosingLocks())
    try:
        er.make_bucket("bkt")
        with pytest.raises(port_dsync.LockLost):
            er.put_object("bkt", "obj", bytes(range(256)) * 200)
        with pytest.raises(ObjectNotFound):
            er.get_object_info("bkt", "obj")
    finally:
        er.close()
