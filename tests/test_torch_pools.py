"""The port's server pools (``minio_tpu_torch/objectlayer/pools.py``)
against ``minio_tpu``'s, on the CPU: pools of one set of four drives,
parity 2, 4 KiB blocks, clocks, uuid draws and free space pinned
(``_torch_pools``).

The same call sequence through both (PUT of every size band, multipart,
versions, a delete marker, delete, heal, ``attach_pool``, decommission
started, aborted and drained) leaves byte-equal drives and the same
manifest; placement is the same for many names; each package opens the
other's manifest and upload records; listings equal those of one set
holding every key.  Two reference faults are shown, and not carried
(ROADMAP Queue 3): a GET after an overwrite placed beside a draining
pool's copy returns the old body, and paging several pools from one
marker drops a prefix."""

import shutil
import time

import pytest

from minio_tpu_torch.background import crawler as port_cr
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.objectlayer.bucket_meta import BucketMetadataSys
from minio_tpu_torch.objectlayer.pools import STATUS_DRAINING
from minio_tpu_torch.objectlayer.sets import ErasureSets

from ._torch_pools import (GIB, PER, Deployment, assert_pools_equal, is_port,
                           manifest_doc, names_on, ol, pin_all)
from ._torch_versions import body

SIZES = {"inline": 1000, "packed": 300_000, "part": 1_050_000}
# free bytes per pool: most new names land on pool 1
FREES = [1 * GIB, 6 * GIB, 2 * GIB]


def sequence(dep: Deployment) -> dict:
    """Every kind of call, in one order; what each answered."""
    lay, o = dep.layer, ol(dep.layer)
    out = {}
    for b in ("bkt", "ver", "spare"):
        lay.make_bucket(b)
    for band, size in SIZES.items():
        out[f"put {band}/0"] = lay.put_object("bkt", f"{band}/0",
                                              body(size, 0)).etag
    out["attach 1"] = dep.attach(1)
    for band, size in SIZES.items():
        for i in (1, 2):
            info = lay.put_object("bkt", f"{band}/{i}", body(size, i))
            out[f"put {band}/{i}"] = (info.etag, lay.get_pool_idx(
                "bkt", f"{band}/{i}"))
    lay.put_object("bkt", "inline/0", body(SIZES["packed"], 9))
    uid = lay.new_multipart_upload("bkt", "mp/obj")
    parts = [(n, lay.put_object_part("bkt", "mp/obj", uid, n,
                                     body(size, n)).etag)
             for n, size in ((1, 70_000), (2, 30_000))]
    out["mp"] = lay.complete_multipart_upload("bkt", "mp/obj", uid,
                                              parts).etag
    vput = o.PutObjectOptions(versioned=True)
    for i, size in enumerate((500, SIZES["packed"], 900)):
        for key in ("v/a", "v/b"):
            lay.put_object("ver", key, body(size, i), vput)
    out["marker"] = lay.delete_object(
        "ver", "v/b", o.ObjectOptions(versioned=True)).version_id
    lay.delete_object("bkt", "packed/2")
    # heal: a bucket gone from pool 1, an object gone from one drive
    for i in range(PER):
        shutil.rmtree(f"{dep.root}/p1/d{i}/spare")
    out["heal bucket"] = lay.heal_bucket("spare")
    victim = next(f"{band}/1" for band in ("part", "inline", "packed")
                  if lay.get_pool_idx("bkt", f"{band}/1") == 1)
    shutil.rmtree(f"{dep.root}/p1/d2/bkt/{victim}", ignore_errors=True)
    r = lay.heal_object("bkt", victim)
    out["heal object"] = (victim, len(r.healed_disks), r.before_ok)
    out["attach 2"] = dep.attach(2)
    out["held by 1"] = names_on(lay.pools[1], "bkt") + \
        names_on(lay.pools[1], "ver")
    lay.start_decommission(1)
    lay.abort_decommission(1)
    lay.start_decommission(1)
    rb = dep.rebalancer()
    out["drained"] = rb.run_once()
    out["stats"] = {k: v for k, v in rb.stats.to_dict().items()
                    if k != "lastCycle"}       # the wall clock
    out["status"] = [(sp.pool_id, sp.status) for sp in lay.specs]
    out["bodies"] = {n: lay.get_object("bkt", n)[1]
                     for n, _ in names_on(lay, "bkt")}
    return out


def test_same_calls_leave_the_same_drives(tmp_path, monkeypatch):
    pin_all(monkeypatch)
    ref = Deployment(tmp_path / "ref", False, FREES, monkeypatch)
    port = Deployment(tmp_path / "port", True, FREES, monkeypatch)
    try:
        want, got = sequence(ref), sequence(port)
        assert got == want
        assert len(got["held by 1"]) >= 6, "pool 1 held too little"
        assert got["drained"] and len(port.layer.pools) == 2
        assert got["stats"]["movedObjects"] > 0
        assert_pools_equal(tmp_path / "port", tmp_path / "ref", 3)
        assert manifest_doc(tmp_path / "port") == \
            manifest_doc(tmp_path / "ref")
    finally:
        ref.close()
        port.close()


def test_placement_is_the_references(tmp_path, monkeypatch):
    """Names over three pools, one draining, at pinned free space; the
    names already held go to their pool."""
    pin_all(monkeypatch)
    deps = [Deployment(tmp_path / t, p, [3 * GIB, 5 * GIB, 7 * GIB],
                       monkeypatch) for t, p in (("ref", False),
                                                 ("port", True))]
    try:
        for dep in deps:
            dep.layer.make_bucket("bkt")
            dep.layer.put_object("bkt", "held", b"x")
            dep.attach(1)
            dep.attach(2)
        placed = []
        for dep in deps:
            idx = [dep.layer.get_pool_idx("bkt", f"k{i}/{i * 7}")
                   for i in range(400)]
            dep.layer.start_decommission(1)
            idx += [dep.layer.get_pool_idx("bkt", f"k{i}") for i in
                    range(200)] + [dep.layer.get_pool_idx("bkt", "held")]
            placed.append(idx)
        assert placed[1] == placed[0]
        assert set(placed[1][:400]) == {0, 1, 2}
        assert 1 not in placed[1][400:] and placed[1][-1] == 0
    finally:
        for dep in deps:
            dep.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_opens_the_others_manifest_and_upload_records(
        tmp_path, monkeypatch, writer):
    """One package grows pool 0 by two pools, drains one, starts an
    upload on the other; the other package, given pool 0 alone, loads
    the manifest (pool 2 back, draining) and finds the upload's pool."""
    pin_all(monkeypatch)
    w = Deployment(tmp_path, writer == "port", [GIB, GIB, 9 * GIB],
                   monkeypatch)
    try:
        w.layer.make_bucket("bkt")
        w.attach(1)
        w.attach(2)
        w.layer.start_decommission(1)
        w.layer.start_decommission(2)
        w.layer.abort_decommission(1)
        uid = w.layer.new_multipart_upload("bkt", "up")
        assert w.layer.get_pool_idx("bkt", "up") == 1
        ids = [sp.pool_id for sp in w.layer.specs]
    finally:
        w.close()
    r = Deployment(tmp_path, writer != "port")      # pool 0 alone
    try:
        assert r.layer.load_manifest()
        r.held = list(r.layer.pools)
        assert [sp.pool_id for sp in r.layer.specs] == ids
        assert [sp.status for sp in r.layer.specs] == \
            ["active", "active", STATUS_DRAINING]
        assert r.layer._upload_pool("bkt", "up", uid) is r.layer.pools[1]
        r.layer.abort_multipart_upload("bkt", "up", uid)
    finally:
        r.close()


def _oracle(root):
    return ErasureSets.from_dirs(
        [str(p) for p in _dirs(root)], 1, PER, parity=2, block_size=4096,
        device="cpu", enforce_min_part_size=False)


def _dirs(root):
    out = [root / f"o{i}" for i in range(PER)]
    for d in out:
        d.mkdir(parents=True, exist_ok=True)
    return out


def _pages(lay, prefix, delimiter, max_keys) -> list:
    out, marker = [], ""
    while True:
        page = lay.list_objects("bkt", prefix, marker, delimiter, max_keys)
        out.append(([(o.name, o.size, o.etag) for o in page.objects],
                    page.prefixes, page.is_truncated, page.next_marker))
        if not page.is_truncated:
            return out
        marker = page.next_marker


KEYS = [f"{d}/{i}" for d in ("a", "b", "c", "d/e") for i in range(4)] + \
    ["top", "zz"]


@pytest.fixture(scope="module")
def spread(tmp_path_factory):
    """KEYS over three pools (each written to the pool its index names),
    and one set holding every key."""
    root = tmp_path_factory.mktemp("spread")
    dep = Deployment(root, True)
    oracle = _oracle(root)
    try:
        dep.layer.make_bucket("bkt")
        oracle.make_bucket("bkt")
        dep.attach(1)
        dep.attach(2)
        for i, key in enumerate(KEYS):
            data = body(100 + i, i)
            dep.layer.pools[i * 7 % 3].put_object("bkt", key, data)
            oracle.put_object("bkt", key, data)
        yield dep.layer, oracle
    finally:
        dep.close()
        oracle.close()


@pytest.mark.parametrize("prefix,delimiter,max_keys", [
    ("", "", 1000), ("", "", 3), ("", "/", 2), ("", "/", 1), ("b/", "", 2),
    ("d/", "/", 1), ("a", "/", 5)])
def test_listings_equal_one_set_holding_every_key(spread, prefix, delimiter,
                                                  max_keys):
    lay, oracle = spread
    assert _pages(lay, prefix, delimiter, max_keys) == \
        _pages(oracle, prefix, delimiter, max_keys)
    got = [(o.name, o.version_id, o.is_latest)
           for o in lay.list_object_versions("bkt", prefix).objects]
    want = [(o.name, o.version_id, o.is_latest)
            for o in oracle.list_object_versions("bkt", prefix).objects]
    assert got == want


def test_a_key_versioned_across_pools_lists_newest_first(tmp_path):
    """Versions of one key in two pools (older ones left on a drained
    pool's successor, a newer one placed elsewhere): one latest, newest
    first, each version once, as one set holding them lists them."""
    dep = Deployment(tmp_path, True)
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        dep.attach(1)
        vput = port_ol.PutObjectOptions(versioned=True)
        made = [lay.pools[j].put_object("bkt", "k", body(50, j), vput)
                for j in (0, 1, 0, 1)]
        # a version mid-move: the same version in both pools
        oi = made[0]
        lay.pools[1].put_object("bkt", "k", body(50, 0), port_ol.
                                PutObjectOptions(versioned=True,
                                                 version_id=oi.version_id,
                                                 mod_time=oi.mod_time))
        vers = lay.list_object_versions("bkt").objects
        assert [v.version_id for v in vers] == \
            [m.version_id for m in reversed(made)]
        assert [v.is_latest for v in vers] == [True, False, False, False]
        assert {v.num_versions for v in vers} == {4}
        page = lay.list_object_versions("bkt", max_keys=2)
        rest = lay.list_object_versions("bkt", key_marker=page.
                                        next_key_marker,
                                        version_id_marker=page.
                                        next_version_id_marker)
        assert [v.version_id for v in page.objects + rest.objects] == \
            [v.version_id for v in vers]
        assert lay.get_object("bkt", "k")[1] == body(50, 1)
    finally:
        dep.close()


EXPIRE_ALL = ('<LifecycleConfiguration><Rule><ID>all</ID><Status>Enabled'
              '</Status><Filter><Prefix></Prefix></Filter><Expiration>'
              '<Days>1</Days></Expiration></Rule></LifecycleConfiguration>')


@pytest.mark.parametrize("package", ["ref", "port"])
def test_an_overwrite_beside_a_draining_copy_is_what_a_get_returns(
        tmp_path, monkeypatch, package):
    """Three pools; ``k0`` on pool 1, pool 1 draining, ``k0`` overwritten
    now (pool 0 has no free space, so the overwrite lands on pool 2,
    after the old copy in pool order).  The reference's GET serves pool
    1's old body (Queue 3); the port's the new one, its object and
    version listings show the new size once, and a crawler cycle whose
    Expiration rule only the old copy's pinned date meets expires
    nothing."""
    pin_all(monkeypatch)
    dep = Deployment(tmp_path, package == "port", [0, GIB, GIB],
                     monkeypatch)
    try:
        lay, o = dep.layer, ol(dep.layer)
        lay.make_bucket("bucket")
        dep.attach(1)
        dep.attach(2)
        old, new = body(4000, 1), body(3000, 2)
        lay.pools[1].put_object("bucket", "k0", old)
        lay.start_decommission(1)
        lay.put_object("bucket", "k0", new,
                       o.PutObjectOptions(mod_time=time.time_ns()))
        held = [j for j, p in enumerate(lay.pools)
                if names_on(p, "bucket")]
        assert held == [1, 2]
        got = lay.get_object("bucket", "k0")[1]
        info = lay.get_object_info("bucket", "k0")
        if is_port(lay):
            assert got == new and info.size == len(new)
            listed = lay.list_objects("bucket").objects
            assert [(o.name, o.size) for o in listed] == [("k0", len(new))]
            vers = lay.list_object_versions("bucket").objects
            assert [(v.name, v.version_id, v.size, v.is_latest)
                    for v in vers] == [("k0", "", len(new), True)]
            assert vers[0].etag == info.etag
            meta = BucketMetadataSys(lay)
            meta.set_config("bucket", "lifecycle", EXPIRE_ALL)
            assert port_cr.scan_usage(lay, meta).expired == []
            assert lay.get_object("bucket", "k0")[1] == new
        else:
            assert got == old          # the reference's fault
    finally:
        dep.close()


def test_a_pool_below_read_quorum_is_not_read_past(tmp_path, monkeypatch):
    """``k`` on pool 0, then a later copy on pool 1; pool 1 answering
    ReadQuorumError makes a GET, HEAD and DELETE raise it, not serve or
    leave pool 0's older copy; a GET by version id that pool 0 holds
    reads all the same."""
    dep = Deployment(tmp_path, True)
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        dep.attach(1)
        lay.pools[0].put_object("bkt", "k", b"old")
        lay.pools[1].put_object("bkt", "k", b"new")
        vid = lay.pools[0].put_object(
            "bkt", "v", b"kept", port_ol.PutObjectOptions(versioned=True)
        ).version_id

        def below_quorum(*a, **kw):
            raise port_ol.ReadQuorumError("bkt/k")

        monkeypatch.setattr(lay.pools[1], "get_object_info", below_quorum)
        for call in (lambda: lay.get_object("bkt", "k"),
                     lambda: lay.get_object_info("bkt", "k"),
                     lambda: lay.delete_object("bkt", "k")):
            with pytest.raises(port_ol.ReadQuorumError):
                call()
        by_id = port_ol.ObjectOptions(version_id=vid)
        assert lay.get_object("bkt", "v", opts=by_id)[1] == b"kept"
        monkeypatch.undo()
        assert lay.get_object("bkt", "k")[1] == b"new"
    finally:
        dep.close()


@pytest.mark.parametrize("package", ["ref", "port"])
def test_paging_two_pools_from_one_marker(tmp_path, package):
    """Pool 0 holds a/, b/, c/, pool 1 a/ and d/; with ``/`` and 2 keys
    a page.  The reference pages each pool from the marker and unions
    the prefixes: its first page holds three and is not truncated, so
    c/ is never listed (Queue 3).  The port lists a/ b/, then c/ d/."""
    dep = Deployment(tmp_path, package == "port")
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        dep.attach(1)
        for j, key in ((0, "a/1"), (0, "b/1"), (0, "c/1"), (1, "a/2"),
                       (1, "d/1")):
            lay.pools[j].put_object("bkt", key, b"x")
        listed, marker = [], ""
        for _ in range(4):
            page = lay.list_objects("bkt", "", marker, "/", 2)
            listed += page.prefixes
            if not page.is_truncated:
                break
            marker = page.next_marker
        if is_port(lay):
            assert listed == ["a/", "b/", "c/", "d/"]
        else:
            assert listed == ["a/", "b/", "d/"]     # the reference's fault
    finally:
        dep.close()


def test_one_pool_probes_nothing(tmp_path, monkeypatch):
    """With one pool a PUT, GET and DELETE cost what the set's cost: no
    existence probe of the pool."""
    dep = Deployment(tmp_path, True)
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        calls = []
        pool = lay.pools[0]
        real = pool.get_object_info
        monkeypatch.setattr(pool, "get_object_info",
                            lambda *a, **k: calls.append(a) or real(*a, **k))
        lay.put_object("bkt", "k", b"abc")
        assert lay.get_object("bkt", "k")[1] == b"abc"
        lay.delete_object("bkt", "k")
        assert calls == []
    finally:
        dep.close()


def test_the_heal_sweep_and_the_topology_walks_reach_every_pool(tmp_path):
    """A shard file removed from a drive of pool 1 comes back byte for
    byte from one sweep over the pools layer; the metacache, health and
    pipeline walks see every pool's sets."""
    from minio_tpu_torch.background.heal import BackgroundHealer
    from minio_tpu_torch.objectlayer.metacache import leaf_layers_of
    from minio_tpu_torch.storage.health import disks_by_set
    dep = Deployment(tmp_path, True)
    try:
        lay = dep.layer
        lay.make_bucket("bkt")
        dep.attach(1)
        data = body(1_050_000, 3)
        lay.pools[1].put_object("bkt", "k", data)
        lay.pools[0].put_object("bkt", "z", b"small")
        fi, _ = lay.pools[1].sets[0]._read_quorum_fileinfo("bkt", "k")
        part = tmp_path / "p1" / "d1" / "bkt" / "k" / fi.data_dir / "part.1"
        want = part.read_bytes()
        part.unlink()
        assert BackgroundHealer(lay).sweep().objects_healed == 1
        assert part.read_bytes() == want
        assert lay.get_object("bkt", "k")[1] == data
        leaves = [s for p in lay.pools for s in p.sets]
        assert leaf_layers_of(lay) == leaves
        assert disks_by_set(lay) == [list(s.disks) for s in leaves]
        assert lay.disks == [d for s in leaves for d in s.disks]
        assert lay.health()["online_drives"] == 2 * PER
    finally:
        dep.close()
