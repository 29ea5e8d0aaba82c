"""The port's ErasureSets (``minio_tpu_torch/objectlayer/sets.py``)
against ``minio_tpu``'s, on the CPU: two or three sets of four drives,
parity 2, 4 KiB blocks, every drive behind a HealthDisk, both packages'
clocks and uuid draws (the format's too) pinned to counters.

The same call sequence through both leaves byte-equal drive trees,
format.json included; placement is the same; listings equal those of
one set holding every key (the oracle), and the reference's where it
gives that answer; health aggregates as the reference's; each package
serves a deployment the other formatted."""

import os
import shutil

import numpy as np
import pytest
import torch

from minio_tpu.objectlayer import interface as ref_ol
from minio_tpu.objectlayer.sets import ErasureSets as RefSets
from minio_tpu.storage.writers import close_write_planes
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.objectlayer.erasure_object import ErasureObjects
from minio_tpu_torch.objectlayer.sets import (DISTRIBUTION_ALGO_CRC,
                                              ErasureSets)
from minio_tpu_torch.parallel.mesh import make_mesh
from minio_tpu_torch.storage.health import HealthDisk
from minio_tpu_torch.storage.xl_storage import XLStorage

from ._torch_versions import BS, ENGINES, assert_trees_equal, body, pin

PER, PARITY = 4, 2
BATCH = 260 * BS                # a 1.2 MB body streams in two batches
SIZES = {"inline": 1000, "packed": 300_000, "part": 1_050_000,
         "batches": 1_200_000}


def dirs(root, n: int) -> list[str]:
    out = [f"{root}/d{i}" for i in range(n)]
    for d in out:
        os.makedirs(d, exist_ok=True)
    return out


def port_sets(root, sets: int = 2, engine: str = "device",
              health: bool = True) -> ErasureSets:
    where = ({"mesh": make_mesh([torch.device("cpu")])} if engine == "mesh"
             else {"device": "cpu"})
    return ErasureSets.from_dirs(dirs(root, sets * PER), sets, PER,
                                 health=health, parity=PARITY, block_size=BS,
                                 enforce_min_part_size=False, **where)


def ref_sets(root, sets: int = 2, health: bool = True) -> RefSets:
    return RefSets.from_dirs(dirs(root, sets * PER), sets, PER,
                             health=health, backend="numpy", parity=PARITY,
                             block_size=BS, enforce_min_part_size=False)


def close(*layers) -> None:
    for lay in layers:
        if isinstance(lay, ErasureSets):
            lay.close()
        else:
            close_write_planes(lay)


def ol(lay):
    return port_ol if isinstance(lay, ErasureSets) else ref_ol


def key_in(lay, set_index: int, stem: str) -> str:
    """The first ``stem<i>`` that the layer places in ``set_index``."""
    return next(f"{stem}{i}" for i in range(1000)
                if lay.get_hashed_set_index(f"{stem}{i}") == set_index)


def sequence(lay) -> dict:
    """Every kind of call, in one order; what each answered."""
    o = ol(lay)
    out = {}
    lay.make_bucket("bkt")
    for band, size in SIZES.items():
        for i in range(3):
            info = lay.put_object("bkt", f"{band}/{i}", body(size, i))
            out[f"put {band}/{i}"] = (info.etag, info.size)
    # overwrites across layouts, and a delete
    lay.put_object("bkt", "inline/0", body(SIZES["packed"], 9))
    lay.put_object("bkt", "packed/0", body(SIZES["inline"], 9))
    lay.put_object("bkt", "part/1", body(SIZES["part"], 8))
    lay.delete_object("bkt", "inline/2")
    # multipart
    uid = lay.new_multipart_upload("bkt", "mp/obj")
    parts = [(n, lay.put_object_part("bkt", "mp/obj", uid, n,
                                     body(size, n)).etag)
             for n, size in ((1, 70_000), (2, 1_100_000), (3, 30_000))]
    out["mp uploads"] = [(m.object_name, m.upload_id)
                         for m in lay.list_multipart_uploads("bkt")]
    out["mp complete"] = lay.complete_multipart_upload(
        "bkt", "mp/obj", uid, parts).etag
    # a versioned bucket, and an empty one
    lay.make_bucket("spare")
    lay.make_bucket("ver")
    vput = o.PutObjectOptions(versioned=True)
    for i, size in enumerate((500, SIZES["packed"], SIZES["part"])):
        for key in ("v/a", "v/b", "v/c"):
            lay.put_object("ver", key, body(size, i), vput)
    lay.delete_object("ver", "v/b", o.ObjectOptions(versioned=True))
    vers = lay.list_object_versions("ver")
    vers = getattr(vers, "objects", vers)
    out["versions"] = [(v.name, v.version_id, v.is_latest, v.delete_marker)
                       for v in vers]
    return out


def damage(root, lay, n_sets: int) -> None:
    """The same damage in both trees: object dirs removed from one drive
    of each set, an empty bucket removed from every drive of the last
    set."""
    for s in range(n_sets):
        for band in SIZES:
            for i in range(2):
                if lay.get_hashed_set_index(f"{band}/{i}") == s:
                    shutil.rmtree(f"{root}/d{s * PER + 1}/bkt/{band}/{i}",
                                  ignore_errors=True)
    for d in range((n_sets - 1) * PER, n_sets * PER):
        shutil.rmtree(f"{root}/d{d}/spare")
    s = lay.get_hashed_set_index("v/a")
    shutil.rmtree(f"{root}/d{s * PER + 2}/ver/v/a")


def heal(lay) -> dict:
    out = {"bucket": lay.heal_bucket("spare")}
    for band in SIZES:
        for i in range(2):
            r = lay.heal_object("bkt", f"{band}/{i}")
            out[f"{band}/{i}"] = (len(r.healed_disks), r.before_ok,
                                  r.after_ok)
    for key in ("v/a", "v/c"):
        r = lay.heal_object("ver", key)
        out[key] = len(r.healed_disks)
    return out


def undo_delete_bucket(lay) -> str:
    """A bucket whose one object lives in the last set: every set but
    that one deletes it, that one refuses, the others get it back."""
    lay.make_bucket("undo")
    key = key_in(lay, len(lay.sets) - 1, "only")
    lay.put_object("undo", key, b"x" * 100)
    with pytest.raises(Exception, match="undo"):
        lay.delete_bucket("undo")
    for s in lay.sets:
        s.get_bucket_info("undo")
    return key


@pytest.mark.parametrize("engine", ENGINES)
def test_sequence_leaves_the_references_drives(tmp_path, monkeypatch,
                                               engine):
    pin(monkeypatch, batch=BATCH)
    port = port_sets(tmp_path / "port", 2, engine)
    ref = ref_sets(tmp_path / "ref", 2)
    try:
        assert port.deployment_id == ref.deployment_id
        assert sequence(port) == sequence(ref)
        for lay, root in ((port, tmp_path / "port"), (ref, tmp_path / "ref")):
            damage(root, lay, 2)
        assert heal(port) == heal(ref)
        assert undo_delete_bucket(port) == undo_delete_bucket(ref)
        for key in ("packed/1", "part/0", "batches/1", "mp/obj"):
            assert port.get_object("bkt", key)[1] == \
                ref.get_object("bkt", key)[1]
    finally:
        close(port, ref)
    assert_trees_equal(tmp_path / "port", tmp_path / "ref", 2 * PER)
    # every object on the drives of the set its name hashes to
    for key in [f"{b}/{i}" for b in SIZES for i in range(3)] + ["mp/obj"]:
        s = port.get_hashed_set_index(key)
        holders = {d // PER for d in range(2 * PER)
                   if (tmp_path / "port" / f"d{d}" / "bkt" / key /
                       "xl.meta").exists()}
        assert holders in ({s}, set()), key


@pytest.mark.parametrize("algo", ["", DISTRIBUTION_ALGO_CRC])
@pytest.mark.parametrize("n_sets", [2, 3, 5])
def test_placement_matches_reference(tmp_path, monkeypatch, algo, n_sets):
    pin(monkeypatch)
    port = port_sets(tmp_path / "port", n_sets)
    ref = ref_sets(tmp_path / "ref", n_sets)
    try:
        if algo:
            port.distribution_algo = ref.distribution_algo = algo
        rng = np.random.default_rng(n_sets)
        names = [f"obj-{i}/{rng.integers(1 << 30)}" for i in range(300)] + \
            ["é/ß", "日本/語", "😀", ""]
        got = [port.get_hashed_set_index(n) for n in names]
        assert got == [ref.get_hashed_set_index(n) for n in names]
        assert set(got) == set(range(n_sets))
    finally:
        close(port, ref)


KEYS = ["a/1", "a/2", "a/b/1", "a/b/2", "ab", "b/1", "b/2", "b/3", "c",
        "c-x/y", "d-1", "d/1", "e", "f/1", "f/2", "g", "h/i/j", "h/k"]


def _pages(lay, prefix: str, delimiter: str, max_keys: int) -> list:
    out, marker = [], ""
    while len(out) < 100:
        r = lay.list_objects("bkt", prefix, marker, delimiter, max_keys)
        out.append(([o.name for o in r.objects], list(r.prefixes),
                    r.is_truncated, r.next_marker))
        if not r.is_truncated:
            return out
        marker = r.next_marker
    raise AssertionError("listing never ended")


@pytest.fixture(scope="module")
def listed(tmp_path_factory):
    """The keys in three port sets, three reference sets and one port set
    (the oracle)."""
    root = tmp_path_factory.mktemp("listing")
    mp = pytest.MonkeyPatch()
    pin(mp)
    port = port_sets(root / "port", 3, health=False)
    ref = ref_sets(root / "ref", 3, health=False)
    oracle = ErasureObjects([XLStorage(d) for d in dirs(root / "one", PER)],
                            parity=PARITY, block_size=BS, device="cpu")
    for lay in (port, ref, oracle):
        lay.make_bucket("bkt")
        for k in KEYS:
            lay.put_object("bkt", k, k.encode())
    yield port, ref, oracle
    close(port, ref)
    oracle.close()
    mp.undo()


@pytest.mark.parametrize("max_keys", [1, 2, 3, 5, 1000])
@pytest.mark.parametrize("delimiter", ["", "/"])
@pytest.mark.parametrize("prefix", ["", "a", "a/", "b/", "h/"])
def test_listing_pages_equal_the_single_set(listed, prefix, delimiter,
                                            max_keys):
    port, ref, oracle = listed
    assert {port.get_hashed_set_index(k) for k in KEYS} == {0, 1, 2}
    got = _pages(port, prefix, delimiter, max_keys)
    assert got == _pages(oracle, prefix, delimiter, max_keys)
    want = _pages(ref, prefix, delimiter, max_keys)
    if not delimiter:
        # the reference's pages hold the same keys in the same order;
        # where they differ it is only on a page that ends on the last
        # key (ROADMAP Queue 3 item 12)
        assert [k for p in got for k in p[0]] == \
            [k for p in want for k in p[0]]
        if got[-1] != ([], [], False, ""):
            assert got == want


def test_reference_sets_drop_and_repeat_prefixes(listed):
    """ROADMAP Queue 3 item 11: with a delimiter the reference counts
    every set's prefixes against max-keys and pages by objects only, so
    a page can end early and drop the rest, or repeat prefixes; the
    port pages the merged stream."""
    port, ref, _ = listed
    want = [([], ["a/"], True, "a/"), (["ab"], [], True, "ab"),
            ([], ["b/"], True, "b/"), (["c"], [], True, "c"),
            ([], ["c-x/"], True, "c-x/"), (["d-1"], [], True, "d-1"),
            ([], ["d/"], True, "d/"), (["e"], [], True, "e"),
            ([], ["f/"], True, "f/"), (["g"], [], True, "g"),
            ([], ["h/"], True, "h/"), ([], [], False, "")]
    assert _pages(port, "", "/", 1) == want
    # one page of two prefixes against max-keys 1, and the rest dropped
    assert _pages(ref, "", "/", 1) == [([], ["a/"], False, "")]
    got = _pages(ref, "", "/", 2)
    assert sum(len(p[1]) for p in got) > len({x for p in got for x in p[1]})


def test_overwrite_of_a_part_file_by_inline_leaves_no_data_dir(
        tmp_path, monkeypatch):
    """ROADMAP Queue 3 item 13: ``minio_tpu`` keeps the replaced
    version's data dir when an unversioned part-file object is
    overwritten by an inline one; the port removes it.  Both read the
    new body."""
    pin(monkeypatch, batch=BATCH)
    port = port_sets(tmp_path / "port", 1)
    ref = ref_sets(tmp_path / "ref", 1)
    try:
        for lay in (port, ref):
            lay.make_bucket("bkt")
            lay.put_object("bkt", "p", body(SIZES["part"]))
            lay.put_object("bkt", "p", body(SIZES["inline"]))
            assert lay.get_object("bkt", "p")[1] == body(SIZES["inline"])
    finally:
        close(port, ref)
    for d in range(PER):
        assert os.listdir(tmp_path / "port" / f"d{d}" / "bkt" / "p") == \
            ["xl.meta"]
        assert len(os.listdir(tmp_path / "ref" / f"d{d}" / "bkt" / "p")) == 2


def test_versions_and_uploads_merge_across_sets(tmp_path, monkeypatch):
    pin(monkeypatch)
    port = port_sets(tmp_path / "port", 3)
    ref = ref_sets(tmp_path / "ref", 3)
    oracle = ErasureObjects([XLStorage(d) for d in dirs(tmp_path / "one",
                                                        PER)],
                            parity=PARITY, block_size=BS, device="cpu")
    try:
        rows = {}
        for lay in (port, ref, oracle):
            o = ol(lay)
            lay.make_bucket("bkt")
            for i in range(12):
                for v in range(1 + i % 3):
                    lay.put_object("bkt", f"k/{i:02d}", body(100, v),
                                   o.PutObjectOptions(versioned=True))
            for i in range(0, 12, 5):
                lay.new_multipart_upload("bkt", f"up/{i}")
            vers = lay.list_object_versions("bkt")
            rows[lay] = ([(v.name, v.is_latest, v.size)
                          for v in getattr(vers, "objects", vers)],
                         [m.object_name
                          for m in lay.list_multipart_uploads("bkt")])
        assert rows[port] == rows[oracle] == rows[ref]
        assert len({port.get_hashed_set_index(f"k/{i:02d}")
                    for i in range(12)}) == 3
        page = port.list_object_versions("bkt", max_keys=5)
        nxt = port.list_object_versions(
            "bkt", key_marker=page.next_key_marker,
            version_id_marker=page.next_version_id_marker, max_keys=100)
        full = port.list_object_versions("bkt").objects
        assert page.is_truncated and not nxt.is_truncated
        assert [v.version_id for v in page.objects + nxt.objects] == \
            [v.version_id for v in full]
    finally:
        close(port, ref)
        oracle.close()


def _take_offline(lay, root, drive_numbers) -> None:
    for d in drive_numbers:
        shutil.rmtree(f"{root}/d{d}")
        disk = lay.sets[d // PER].disks[d % PER]
        with pytest.raises(OSError):
            disk.stat_vol("bkt")


def test_health_aggregates_as_the_reference(tmp_path, monkeypatch):
    pin(monkeypatch)
    port = port_sets(tmp_path / "port", 2)
    ref = ref_sets(tmp_path / "ref", 2)
    try:
        answers = []
        for lay, root in ((port, tmp_path / "port"), (ref, tmp_path / "ref")):
            lay.make_bucket("bkt")
            a = [lay.health(), lay.health(maintenance=True)]
            _take_offline(lay, root, [0])
            a.append(lay.health())
            _take_offline(lay, root, [1, 5])
            a += [lay.health(), lay.health(maintenance=True)]
            answers.append(a)
        assert answers[0] == answers[1]
        assert [h["healthy"] for h in answers[0]] == \
            [True, False, True, False, False]
        assert answers[0][3] == {"healthy": False, "write_quorum": 3,
                                 "healing_drives": 0, "online_drives": 5}
    finally:
        close(port, ref)


def test_each_package_serves_the_others_deployment(tmp_path, monkeypatch):
    pin(monkeypatch, shared=True)
    bodies = {f"{band}/{i}": body(size, i) for band, size in SIZES.items()
              for i in range(2)}
    ref = ref_sets(tmp_path / "a", 2)
    for key, data in bodies.items():
        if key == next(iter(bodies)):
            ref.make_bucket("bkt")
        ref.put_object("bkt", key, data)
    close(ref)
    port = port_sets(tmp_path / "a", 2)
    try:
        assert port.deployment_id == ref.deployment_id
        for key, data in bodies.items():
            assert port.get_object("bkt", key)[1] == data
        assert [o.name for o in port.list_objects("bkt").objects] == \
            sorted(bodies)
    finally:
        close(port)

    port = port_sets(tmp_path / "b", 2)
    port.make_bucket("bkt")
    for key, data in bodies.items():
        port.put_object("bkt", key, data)
    close(port)
    ref = ref_sets(tmp_path / "b", 2)
    try:
        for key, data in bodies.items():
            assert ref.get_object("bkt", key)[1] == data
    finally:
        close(ref)


def test_drives_are_wrapped_and_sets_own_them(tmp_path):
    port = port_sets(tmp_path, 2)
    try:
        for s in port.sets:
            assert all(isinstance(d, HealthDisk) for d in s.disks)
            for d in s.disks:
                assert port.set_for_disk(d) is s
                assert d.get_disk_id() == d.expected_format.this
        assert port.set_for_disk(port.sets[0].disks[0].inner) is None
        monitor = port.start_drive_monitor(interval_s=60)
        assert len(monitor.disks) == 2 * PER
    finally:
        port.close()
    assert not monitor._thread.is_alive()
