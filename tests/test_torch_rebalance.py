"""The port's rebalancer (``minio_tpu_torch/background/rebalance.py``)
against ``minio_tpu``'s, on the CPU, over pools of one set of four
drives (``_torch_pools``): a decommission drain, paged in pages smaller
than a key's versions, leaves the reference's drives; a delete marker
and a multipart version move with their identity; a drain that fails
half way resumes from the journal with no version lost or repeated;
``pick_source`` follows the threshold over patched ``disk_info``;
``finish_decommission`` waits for every version and upload.  Then what
only the port does: paging more than a thousand versions skips none, a
null version under newer versions moves with its own body (the
reference copies the latest's), moves beside foreground PUTs with
several workers lose no byte, and a decommission drains with
``rebalance.enable`` off."""

import threading
import time

import pytest

from minio_tpu_torch.background import rebalance as port_rb
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.storage.xl_storage import DiskInfo

from ._torch_pools import (GIB, Deployment, assert_pools_equal, is_port,
                           names_on, ol, pin_all, rb_mod)
from ._torch_versions import body

FREES = [2 * GIB, 6 * GIB, 3 * GIB]


def identities(lay, bucket: str) -> list[tuple]:
    out = lay.list_object_versions(bucket)
    return [(o.name, o.version_id, o.etag, o.mod_time, o.delete_marker,
             o.size, tuple(o.parts), o.is_latest)
            for o in getattr(out, "objects", out)]


def fill_pool_1(dep: Deployment) -> dict:
    """Pools 0 to 2; on pool 1 plain objects, a key of five versions
    under a delete marker, and a two-part upload; bodies by name."""
    lay, o = dep.layer, ol(dep.layer)
    lay.make_bucket("bkt")
    dep.attach(1)
    dep.attach(2)
    p1 = lay.pools[1]
    bodies = {}
    for i in range(6):
        bodies[f"obj-{i}"] = body(900 + 97 * i, i)
        p1.put_object("bkt", f"obj-{i}", bodies[f"obj-{i}"])
    bodies["big"] = body(1_050_000, 7)
    p1.put_object("bkt", "big", bodies["big"])
    vput = o.PutObjectOptions(versioned=True)
    for i in range(5):
        p1.put_object("bkt", "many", body(300 + i, i), vput)
    p1.delete_object("bkt", "many", o.ObjectOptions(versioned=True))
    uid = p1.new_multipart_upload("bkt", "mp")
    parts = [(n, p1.put_object_part("bkt", "mp", uid, n,
                                    body(size, n)).etag)
             for n, size in ((1, 60_000), (2, 5_000))]
    p1.complete_multipart_upload("bkt", "mp", uid, parts)
    bodies["mp"] = body(60_000, 1) + body(5_000, 2)
    return bodies


@pytest.fixture
def pair(tmp_path, monkeypatch):
    pin_all(monkeypatch)
    deps = [Deployment(tmp_path / "ref", False, FREES, monkeypatch),
            Deployment(tmp_path / "port", True, FREES, monkeypatch)]
    yield deps
    for dep in deps:
        dep.close()


def test_a_paged_drain_leaves_the_references_drives(pair, tmp_path,
                                                    monkeypatch):
    """Pages of 4 versions, so the six versions of ``many`` straddle
    two pages."""
    monkeypatch.setattr(port_rb, "_PAGE", 4)
    out = []
    for dep in pair:
        bodies = fill_pool_1(dep)
        before = identities(dep.layer, "bkt")
        dep.layer.start_decommission(1)
        rb = dep.rebalancer()
        assert rb.run_once()
        assert len(dep.layer.pools) == 2
        after = identities(dep.layer, "bkt")
        for name, data in bodies.items():
            assert dep.layer.get_object("bkt", name)[1] == data
        st = rb.stats.to_dict()
        st.pop("lastCycle")
        out.append((before, after, st, rb.load_journal()))
    assert out[1] == out[0]
    before, after, st, journal = out[1]
    assert after == before and st["movedObjects"] == 13
    assert journal["state"] == "done"
    assert_pools_equal(tmp_path / "port", tmp_path / "ref", 3)


def test_a_marker_and_a_multipart_version_keep_their_identity(pair,
                                                              tmp_path):
    out = []
    for dep in pair:
        lay, o = dep.layer, ol(dep.layer)
        lay.make_bucket("bkt")
        dep.attach(1)
        src, dst = lay.pools[1], lay.pools[0]
        v1 = src.put_object("bkt", "ver", b"A" * 100, o.PutObjectOptions(
            versioned=True, user_defined={"x-amz-meta-k": "v"}))
        src.delete_object("bkt", "ver", o.ObjectOptions(versioned=True))
        uid = src.new_multipart_upload("bkt", "multi")
        e1 = src.put_object_part("bkt", "multi", uid, 1, b"B" * 1000)
        e2 = src.put_object_part("bkt", "multi", uid, 2, b"C" * 10)
        moi = src.complete_multipart_upload("bkt", "multi", uid,
                                            [(1, e1.etag), (2, e2.etag)])
        before = identities(lay, "bkt")
        for oi in list(getattr(src.list_object_versions("bkt"), "objects",
                               None) or src.list_object_versions("bkt")):
            rb_mod(lay).move_version(lay, 1, 0, "bkt", oi)
        assert names_on(src, "bkt") == []
        got = dst.get_object_info("bkt", "ver",
                                  o.ObjectOptions(version_id=v1.version_id))
        assert got.user_defined.get("x-amz-meta-k") == "v"
        mgot = dst.get_object_info("bkt", "multi")
        assert mgot.etag == moi.etag and mgot.etag.endswith("-2")
        assert dst.get_object("bkt", "multi")[1] == b"B" * 1000 + b"C" * 10
        out.append((before, identities(lay, "bkt")))
    assert out[1] == out[0] and out[1][0] == out[1][1]
    assert_pools_equal(tmp_path / "port", tmp_path / "ref", 2)


def test_a_drain_cut_half_way_resumes_from_the_journal(pair, tmp_path,
                                                       monkeypatch):
    """The third move fails; a new rebalancer resumes from the journal's
    cursor; no version is lost or repeated, and the drives are the
    reference's after the same cut."""
    out = []
    for dep in pair:
        mod = rb_mod(dep.layer)
        bodies = fill_pool_1(dep)
        before = identities(dep.layer, "bkt")
        dep.layer.start_decommission(1)
        real, moves = mod.move_version, []

        def dying(*a, **kw):
            if len(moves) >= 3:
                raise RuntimeError("cut mid-drain")
            moves.append(a[-1].name)
            return real(*a, **kw)

        monkeypatch.setattr(mod, "move_version", dying)
        with pytest.raises(RuntimeError):
            dep.rebalancer().rebalance_pool(1)
        monkeypatch.setattr(mod, "move_version", real)
        journal = dep.rebalancer().load_journal()
        assert journal["state"] == "running" and journal["cursor"]
        rb = dep.rebalancer()
        assert rb.run_once() and len(dep.layer.pools) == 2
        vers = [(o[0], o[1]) for o in identities(dep.layer, "bkt")]
        assert len(vers) == len(set(vers))
        for name, data in bodies.items():
            assert dep.layer.get_object("bkt", name)[1] == data
        out.append((journal, before, identities(dep.layer, "bkt")))
    assert out[1] == out[0] and out[1][1] == out[1][2]
    assert_pools_equal(tmp_path / "port", tmp_path / "ref", 3)


@pytest.mark.parametrize("fracs,draining,want", [
    ([0.5, 0.5, 0.5], None, None),          # even: nothing to do
    ([0.5, 0.45, 0.5], None, None),         # within the threshold
    ([0.5, 0.2, 0.9], None, 1),             # spread: the fullest
    ([0.1, 0.5, 0.5], None, 0),
    ([0.5, 0.5, 0.5], 2, 2),                # draining comes first
    ([0.9, 0.1, 0.5], 2, 2)])
def test_pick_source_follows_the_threshold(pair, monkeypatch, fracs,
                                           draining, want):
    from minio_tpu.storage.api import DiskInfo as RefDiskInfo
    got = []
    for dep in pair:
        dep.layer.make_bucket("bkt")
        dep.attach(1)
        dep.attach(2)
        info = DiskInfo if is_port(dep.layer) else RefDiskInfo
        for p, frac in zip(dep.layer.pools, fracs):
            for d in (d for s in p.sets for d in s.disks):
                di = info(total=1000, free=int(1000 * frac), used=0,
                          free_inodes=0, endpoint="", mount_path="")
                monkeypatch.setattr(d, "disk_info", lambda di=di: di)
        if draining is not None:
            dep.layer.start_decommission(draining)
        got.append(dep.rebalancer(threshold=0.1).pick_source())
    assert got == [want, want]


def test_finish_decommission_waits_for_every_version_and_upload(pair):
    for dep in pair:
        lay = dep.layer
        lay.make_bucket("bkt")
        dep.attach(1)
        dep.attach(2)
        p1 = lay.pools[1]
        p1.put_object("bkt", "left", b"x" * 10)
        uid = p1.new_multipart_upload("bkt", "up")
        with pytest.raises(ValueError, match="not draining"):
            lay.finish_decommission(1)
        lay.start_decommission(1)
        assert lay.decommission_pending(1) == (1, 1)
        with pytest.raises(ValueError, match="1 versions, 1 uploads"):
            lay.finish_decommission(1)
        lay.delete_object("bkt", "left")
        with pytest.raises(ValueError, match="0 versions, 1 uploads"):
            lay.finish_decommission(1)
        p1.abort_multipart_upload("bkt", "up", uid)
        lay.finish_decommission(1)
        assert len(lay.pools) == 2
        with pytest.raises(ValueError, match="cannot be decommissioned"):
            lay.start_decommission(0)
        lay.start_decommission(1)       # the former pool 2
        assert lay.abort_decommission(1) == 1
        with pytest.raises(ValueError, match="is not draining"):
            lay.abort_decommission(1)


def test_paging_over_a_thousand_versions_skips_none(tmp_path):
    """1,050 names walked in pages of 1,000 while each is deleted once
    it was handed out, as a drain deletes what it moved."""
    dep = Deployment(tmp_path, True)
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        pool = lay.pools[0]
        names = [f"n{i:05d}" for i in range(1050)]
        for n in names:
            pool.put_object("bkt", n, b"")
        assert lay.decommission_pending(0) == (1050, 0)
        seen = []
        for name, versions in port_rb._names_from(pool, "bkt", "",
                                                  threading.Event()):
            assert [v.name for v in versions] == [name]
            seen.append(name)
            pool.delete_object("bkt", name)
        assert seen == names
        assert list(port_rb._names_from(pool, "bkt", "", threading.Event())
                    ) == []
    finally:
        dep.close()


@pytest.mark.parametrize("package", ["ref", "port"])
def test_a_null_version_under_newer_versions_moves_its_own_body(
        tmp_path, monkeypatch, package):
    """A null version, then a versioned one, on a draining pool.  The
    reference reads the null version as the latest: the copy's
    Content-MD5 check refuses the newer body at every try, and the pool
    never retires (Queue 3).  The port reads it by its id and drains."""
    pin_all(monkeypatch)
    dep = Deployment(tmp_path, package == "port", FREES, monkeypatch)
    try:
        lay, o = dep.layer, ol(dep.layer)
        lay.make_bucket("bkt")
        dep.attach(1)
        p1 = lay.pools[1]
        p1.put_object("bkt", "k", b"null body")
        p1.put_object("bkt", "k", b"versioned body",
                      o.PutObjectOptions(versioned=True))
        lay.start_decommission(1)
        null = o.ObjectOptions(version_id="")
        if is_port(lay):
            assert dep.rebalancer().run_once()
            assert len(lay.pools) == 1
            assert lay.get_object("bkt", "k", opts=null)[1] == b"null body"
            assert lay.get_object("bkt", "k")[1] == b"versioned body"
        else:
            for _ in range(2):
                with pytest.raises(Exception, match="BadDigest"):
                    dep.rebalancer().run_once()
            assert len(lay.pools) == 2         # the reference's fault
            assert p1.get_object("bkt", "k", opts=null)[1] == b"null body"
    finally:
        dep.close()


def test_moves_beside_foreground_puts_lose_no_byte(tmp_path, monkeypatch):
    """Three workers drain pool 1 while two threads PUT new names and
    overwrite drained ones; every acknowledged write reads back."""
    dep = Deployment(tmp_path, True, FREES, monkeypatch)
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        dep.attach(1)
        dep.attach(2)
        bodies = {}
        for i in range(24):
            bodies[f"k{i:02d}"] = body(700 + i, i)
            lay.pools[1].put_object("bkt", f"k{i:02d}", bodies[f"k{i:02d}"])
        lay.start_decommission(1)
        rb = dep.rebalancer(max_workers=3)
        mu = threading.Lock()

        def writer(t):
            for i in range(12):
                name = f"k{(i * 2 + t):02d}" if i % 2 else f"w{t}-{i}"
                data = body(500 + i, 100 * t + i)
                lay.put_object("bkt", name, data)
                with mu:
                    bodies[name] = data

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(2)]
        for t in threads:
            t.start()
        while rb.run_once() and len(lay.pools) == 3:
            pass
        for t in threads:
            t.join()
        while len(lay.pools) == 3:
            assert rb.run_once()
        for name, data in bodies.items():
            assert lay.get_object("bkt", name)[1] == data, name
        listed = [o.name for o in lay.list_objects("bkt").objects]
        assert listed == sorted(bodies)
    finally:
        dep.close()


@pytest.mark.parametrize("what", ["put", "delete"])
def test_a_write_during_a_move_is_not_undone(tmp_path, monkeypatch, what):
    """A PUT or a DELETE of the name the mover is copying, sent between
    the mover's read of the source and its commit on the destination
    (pool 0, the one active pool, where the PUT lands too): it waits
    for the move, and the write the client was told of stands."""
    dep = Deployment(tmp_path, True, FREES, monkeypatch)
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        dep.attach(1)
        old, new = body(5000, 1), body(6000, 2)
        src = lay.pools[1]
        src.put_object("bkt", "k", old)
        lay.start_decommission(1)
        real_get = src.get_object
        fore: list[threading.Thread] = []

        def write():
            if what == "put":
                lay.put_object("bkt", "k", new)
            else:
                lay.delete_object("bkt", "k")

        def get_then_write(*a, **kw):
            got = real_get(*a, **kw)
            t = threading.Thread(target=write)
            t.start()
            t.join(timeout=1.0)     # done here unless the move holds it off
            fore.append(t)
            return got

        monkeypatch.setattr(src, "get_object", get_then_write)
        assert dep.rebalancer().run_once()
        fore[0].join()
        monkeypatch.setattr(src, "get_object", real_get)
        assert len(lay.pools) == 1
        if what == "put":
            assert lay.get_object("bkt", "k")[1] == new
        else:
            with pytest.raises(port_ol.ObjectNotFound):
                lay.get_object("bkt", "k")
    finally:
        dep.close()


def test_a_decommission_drains_with_the_rebalance_off(tmp_path, monkeypatch):
    """``enable`` off stops the threshold rebalance, not a drain an
    operator asked for: the loop, woken, drains and retires the pool;
    ``stop`` joins it."""
    dep = Deployment(tmp_path, True, FREES, monkeypatch)
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        dep.attach(1)
        lay.pools[1].put_object("bkt", "k", b"abc")
        rb = dep.rebalancer(enabled=False)
        rb.start()
        lay.start_decommission(1)
        rb.kick()
        deadline = time.monotonic() + 30
        while len(lay.pools) == 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        rb.stop()
        assert len(lay.pools) == 1
        assert lay.get_object("bkt", "k")[1] == b"abc"
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("mt-rebalance")]
    finally:
        dep.close()
