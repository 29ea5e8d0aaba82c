"""Drive lifecycle and the heal sweep in the port
(``minio_tpu_torch/storage/health.py``, ``background/heal.py``) on the
CPU: the circuit breaker and its half-open probe on a fake clock,
reconnect, a wiped drive formatted with its own identity and its set
healed shard for shard, a swapped drive that stays offline and is never
written, identity revalidation, and ``BackgroundHealer.sweep`` (what it
heals, its counts, stop between objects, compaction), whose result on the
same damaged drives equals ``minio_tpu``'s.  The heal that a returning
drive starts runs on a thread; the tests wait for it."""

import hashlib
import os
import shutil
import threading

import pytest

from minio_tpu.background.heal import BackgroundHealer as RefHealer
from minio_tpu_torch.background.heal import BackgroundHealer, iter_versions
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.storage import errors as serrors
from minio_tpu_torch.storage.format import (FORMAT_FILE, FormatErasure,
                                            init_format_erasure)
from minio_tpu_torch.storage.health import DriveMonitor, HealthDisk
from minio_tpu_torch.storage.xl_storage import SYS_DIR, XLStorage

from ._torch_versions import assert_trees_equal, body, pin, tree
from .test_torch_sets import (BATCH, PER, SIZES, close, damage, port_sets,
                              ref_sets, sequence)


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


class Counting:
    """A drive that counts the calls that reach it."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if callable(attr) and name not in ("is_online", "endpoint"):
            def counted(*a, **kw):
                self.calls += 1
                return attr(*a, **kw)
            return counted
        return attr


def wait_heals() -> None:
    for t in threading.enumerate():
        if t.name == "mt-drive-heal-kick":
            t.join(120)


def files(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def shard(disk, bucket: str, key: str) -> bytes:
    """A drive's framed shard of the object: inline, packed or part
    files (every part)."""
    fi = disk.read_version(bucket, key)
    if fi.inline_data is not None:
        return fi.inline_data
    if fi.seg is not None:
        return disk.read_segment(fi.seg["sid"], fi.seg["off"],
                                 fi.seg["len"])
    return b"".join(disk.read_all(bucket, f"{key}/{fi.data_dir}/part.{p.number}")
                    for p in fi.parts)


def test_breaker_and_half_open_probe(tmp_path):
    os.makedirs(tmp_path / "d")
    disk = XLStorage(str(tmp_path / "d"))
    disk.make_vol("bkt")
    clock = Clock()
    inner = Counting(disk)
    hd = HealthDisk(inner, cooldown_s=2.0, clock=clock)
    hd.stat_vol("bkt")
    with pytest.raises(serrors.FileNotFound):
        hd.read_all("bkt", "missing")        # a missing file: still online
    assert not hd.offline
    os.rename(tmp_path / "d", tmp_path / "away")
    with pytest.raises(serrors.VolumeNotFound):
        hd.stat_vol("bkt")
    assert hd.offline and not hd.is_online()
    calls = inner.calls
    clock.t += 1.9
    with pytest.raises(serrors.DiskNotFound):
        hd.stat_vol("bkt")                  # open: fails fast
    assert inner.calls == calls
    clock.t += 0.2                          # half-open: one probe
    with pytest.raises(serrors.DiskNotFound):
        hd.stat_vol("bkt")
    assert hd.offline
    os.rename(tmp_path / "away", tmp_path / "d")
    clock.t += 1.0
    with pytest.raises(serrors.DiskNotFound):
        hd.stat_vol("bkt")                  # the next window opens later
    clock.t += 1.1
    assert hd.stat_vol("bkt").name == "bkt"  # probed, admitted, served
    assert not hd.offline and hd.is_online()


def test_reconnect_keeps_identity(tmp_path):
    os.makedirs(tmp_path / "d")
    disk = XLStorage(str(tmp_path / "d"))
    fmt = init_format_erasure([disk], 1, 1)
    returned = []
    hd = HealthDisk(disk, expected_format=fmt.for_drive(0, 1),
                    on_return=lambda d, how: returned.append(how))
    os.rename(tmp_path / "d", tmp_path / "away")
    assert hd.probe() is None and hd.offline
    os.rename(tmp_path / "away", tmp_path / "d")
    disk.set_disk_id("")
    assert hd.probe() == "reconnected"
    assert hd.get_disk_id() == fmt.sets[0][0]
    wait_heals()
    assert returned == ["reconnected"]


def test_returning_drives_share_one_sweep_per_set(monkeypatch):
    """Drives of a set that return while it is swept start no sweep beside
    the running one: they ask for one more, made after it; a drive of
    another set is swept at once."""
    from minio_tpu_torch.background import heal as heal_mod
    from minio_tpu_torch.storage.health import heal_on_return
    gate = threading.Event()
    started = {"set0": threading.Event(), "set1": threading.Event()}
    mu = threading.Lock()
    running, peak, sweeps = {}, {}, []

    def sweep(self):
        with mu:
            running[self.layer] = running.get(self.layer, 0) + 1
            peak[self.layer] = max(peak.get(self.layer, 0),
                                   running[self.layer])
            sweeps.append(self.layer)
        started[self.layer].set()
        gate.wait(30)
        with mu:
            running[self.layer] -= 1
        return self.stats
    monkeypatch.setattr(heal_mod.BackgroundHealer, "sweep", sweep)
    owner = {"a0": "set0", "a1": "set0", "a2": "set0", "a3": "set0",
             "b0": "set1"}
    cb = heal_on_return(owner.get)

    def kick(disk):
        t = threading.Thread(target=cb, args=(disk, "reconnected"))
        t.start()
        return t
    first = kick("a0")
    assert started["set0"].wait(30)
    later = [kick(d) for d in ("a1", "a2", "a3")]
    for t in later:
        t.join(10)
        assert not t.is_alive()             # asked, did not sweep
    other = kick("b0")
    assert started["set1"].wait(30)
    gate.set()
    first.join(30)
    other.join(30)
    assert sorted(sweeps) == ["set0", "set0", "set1"]
    assert peak == {"set0": 1, "set1": 1}
    cb("a1", "reconnected")                 # idle again: sweeps at once
    assert sorted(sweeps) == ["set0", "set0", "set0", "set1"]


@pytest.fixture()
def deployment(tmp_path, monkeypatch):
    """Two port sets with every size band in both, pinned."""
    pin(monkeypatch, batch=BATCH)
    lay = port_sets(tmp_path, 2)
    lay.make_bucket("bkt")
    keys = []
    for band, size in SIZES.items():
        for i in range(4):
            key = f"{band}/{i}"
            lay.put_object("bkt", key, body(size, i))
            keys.append(key)
    assert {lay.get_hashed_set_index(k) for k in keys} == {0, 1}
    healed = {0: [], 1: []}
    for i, s in enumerate(lay.sets):
        heal = s.heal_object

        def counted(*a, _heal=heal, _i=i, **kw):
            healed[_i].append(a[1])
            return _heal(*a, **kw)
        s.heal_object = counted
    yield lay, keys, healed
    lay.close()


def test_wiped_drive_is_reformatted_and_healed_shard_for_shard(
        tmp_path, deployment):
    """ROADMAP Queue 3 item 10: the drive returns empty, is formatted with
    its own identity, and the sweep of its set (only) puts back every
    shard it held, packed and part-file ones too."""
    lay, keys, healed = deployment
    victim = 1
    hd = lay.sets[0].disks[victim]
    mine = [k for k in keys if lay.get_hashed_set_index(k) == 0]
    before = {k: hashlib.sha256(shard(hd, "bkt", k)).digest() for k in mine}
    others = {d: files(tmp_path / f"d{d}") for d in range(2 * PER)
              if d != victim}
    shutil.rmtree(tmp_path / f"d{victim}")
    for k in mine:
        assert lay.get_object("bkt", k)[1] == \
            body(SIZES[k.split("/")[0]], int(k[-1]))
    assert hd.offline
    os.makedirs(tmp_path / f"d{victim}")
    DriveMonitor([d for s in lay.sets for d in s.disks]).poll_once()
    wait_heals()
    assert not hd.offline
    fmt = FormatErasure.from_json(
        (tmp_path / f"d{victim}" / SYS_DIR / FORMAT_FILE).read_bytes())
    assert fmt.this == hd.expected_format.this == lay.sets[0].disks[
        victim].get_disk_id()
    assert fmt.to_json() == hd.expected_format.to_json()
    assert sorted(healed[0]) == sorted(mine) and healed[1] == []
    for k in mine:
        assert hashlib.sha256(shard(hd, "bkt", k)).digest() == before[k], k
    for d, tree in others.items():
        assert files(tmp_path / f"d{d}") == tree, f"drive {d} was written"


def test_swapped_drive_stays_offline_and_is_never_written(
        tmp_path, deployment):
    lay, keys, healed = deployment
    victim = PER + 2                        # a drive of set 1
    hd = lay.sets[1].disks[2]
    shutil.rmtree(tmp_path / f"d{victim}")
    with pytest.raises(OSError):
        hd.stat_vol("bkt")
    assert hd.offline
    # a drive of another deployment, with objects and segments of its own
    foreign = port_sets(tmp_path / "foreign", 1)
    foreign.make_bucket("bkt")
    foreign.put_object("bkt", "theirs", body(SIZES["packed"]))
    foreign.put_object("bkt", "inline/0", body(10))
    foreign.close()
    os.rename(tmp_path / "foreign" / "d0", tmp_path / f"d{victim}")
    snap = files(tmp_path / f"d{victim}")
    monitor = DriveMonitor([d for s in lay.sets for d in s.disks],
                           verify_every=1)
    monitor.poll_once()
    assert hd.probe() is None and hd.offline
    wait_heals()
    for k in keys:
        lay.put_object("bkt", k, body(SIZES["packed"], 5))
        assert lay.get_object("bkt", k)[1] == body(SIZES["packed"], 5)
    BackgroundHealer(lay, deep_every=1).sweep()
    monitor.poll_once()
    assert hd.offline
    assert healed[1] == [k for k in sorted(keys)
                         if lay.get_hashed_set_index(k) == 1]
    assert files(tmp_path / f"d{victim}") == snap


def test_poll_once_revalidates_identity(tmp_path, deployment):
    lay, _, _ = deployment
    hd = lay.sets[0].disks[3]
    monitor = DriveMonitor([d for s in lay.sets for d in s.disks],
                           verify_every=2)
    other = FormatErasure.from_json(hd.expected_format.to_json())
    other.this = lay.sets[0].disks[2].expected_format.this
    hd.inner.write_all(SYS_DIR, FORMAT_FILE, other.to_json().encode())
    monitor.poll_once()
    assert not hd.offline                   # checked every second cycle
    monitor.poll_once()
    assert hd.offline
    assert hd.probe() is None
    hd.inner.write_all(SYS_DIR, FORMAT_FILE,
                       hd.expected_format.to_json().encode())
    assert hd.probe() == "reconnected"
    wait_heals()


def test_sweep_heals_counts_and_stops(tmp_path, deployment):
    lay, keys, healed = deployment
    healer = BackgroundHealer(lay)
    stats = healer.sweep()
    assert (stats.objects_scanned, stats.objects_healed,
            stats.objects_failed, stats.cycles) == (len(keys), 0, 0, 1)
    # lose object dirs on one drive per set, corrupt a part file
    for k in keys[:6]:
        s = lay.get_hashed_set_index(k)
        shutil.rmtree(tmp_path / f"d{s * PER}" / "bkt" / k)
    key = "batches/2"
    s = lay.get_hashed_set_index(key)
    fi = lay.sets[s].disks[1].read_version("bkt", key)
    part = tmp_path / f"d{s * PER + 1}" / "bkt" / key / fi.data_dir / \
        "part.1"
    raw = bytearray(part.read_bytes())
    raw[100] ^= 0xFF
    part.write_bytes(bytes(raw))
    stats = healer.sweep()
    assert (stats.objects_scanned, stats.objects_healed,
            stats.cycles) == (2 * len(keys), 6, 2)
    assert part.read_bytes() == bytes(raw)  # a shallow sweep verifies none
    deep = BackgroundHealer(lay, deep_every=1)
    assert deep.sweep().objects_healed == 1
    assert part.read_bytes() != bytes(raw)
    assert (deep.stats.objects_scanned, deep.stats.cycles) == (len(keys), 1)
    # stop between objects: the cycle keeps its counts, is not counted
    stopper = BackgroundHealer(lay)
    first = lay.sets[0].heal_object

    def stop_after(*a, **kw):
        stopper._stop.set()
        return first(*a, **kw)
    lay.sets[0].heal_object = stop_after
    lay.sets[1].heal_object = stop_after
    stats = stopper.sweep()
    assert (stats.objects_scanned, stats.cycles) == (1, 0)
    assert stopper.stats.last_cycle_ns == 0


def test_sweep_compacts_segments(tmp_path, deployment):
    lay, keys, _ = deployment
    for s in lay.sets:
        for d in s.disks:
            d.inner.segments.segment_max_bytes = 400_000
    # two extents a segment: overwriting one packed object of each set
    # seals its drives' segment of two and frees one of the two
    packed = [next(k for k in keys if k.startswith("packed/")
                   and lay.get_hashed_set_index(k) == i) for i in (0, 1)]
    for k in packed:
        lay.put_object("bkt", k, body(SIZES["packed"], 40))

    def dead():
        return sum(d.inner.segments.stats()["dead_bytes"]
                   for s in lay.sets for d in s.disks)
    before = dead()
    assert before > 0
    BackgroundHealer(lay).sweep()
    assert dead() < before
    for k in keys:
        assert lay.get_object("bkt", k)[1] == (
            body(SIZES["packed"], 40) if k in packed else
            body(SIZES[k.split("/")[0]], int(k[-1])))


def test_swept_drives_match_reference(tmp_path, monkeypatch):
    """The same damage, then one sweep in each package: the same drive
    bytes, but for the older versions of ``ver/v/a``.  The port's sweep
    heals every version (ROADMAP Queue 3 item 16); ``minio_tpu``'s heals
    only the latest and leaves the two older ones missing on the damaged
    drive (a ``minio_tpu`` fault not carried over, Queue 3 item 17), so
    those versions take their bodies and the set's version list as the
    oracle."""
    pin(monkeypatch, batch=BATCH)
    port = port_sets(tmp_path / "port", 2)
    ref = ref_sets(tmp_path / "ref", 2)
    try:
        assert sequence(port) == sequence(ref)
        for lay, root in ((port, tmp_path / "port"), (ref, tmp_path / "ref")):
            damage(root, lay, 2)
        got = BackgroundHealer(port).sweep()
        want = RefHealer(ref).sweep()
        versions = sum(1 for b in port.list_buckets()
                       for _ in iter_versions(port, b.name))
        live = sum(len(ref.list_objects(b.name).objects)
                   for b in ref.list_buckets())
        assert (got.objects_scanned, want.objects_scanned) == (versions, live)
        assert got.objects_healed == want.objects_healed + 2
        assert got.objects_failed == want.objects_failed == 0
        assert got.objects_healed > 2
        s = port.get_hashed_set_index("v/a")
        vers = [fi.version_id for fi in
                port.sets[s].disks[2].list_versions("ver", "v/a")]
        assert vers == [fi.version_id for fi in
                        port.sets[s].disks[0].list_versions("ver", "v/a")]
        assert len(vers) == 3
        for vid, (i, size) in zip(vers[::-1], enumerate(
                (500, SIZES["packed"], SIZES["part"]))):
            assert port.get_object("ver", "v/a", opts=port_ol.ObjectOptions(
                version_id=vid))[1] == body(size, i)
    finally:
        close(port, ref)
    # the damaged drive's segment files hold the healed older versions
    # past what the reference's hold
    victim = port.get_hashed_set_index("v/a") * PER + 2
    seg = ".mt.sys/seg/"
    got, want = (tree(root / f"d{victim}") for root in
                 (tmp_path / "port", tmp_path / "ref"))
    assert sorted(p for p in got if p.startswith(seg)) == \
        sorted(p for p in want if p.startswith(seg))
    for p in want:
        if p.startswith(seg):
            assert got[p].startswith(want[p]), p
    assert_trees_equal(tmp_path / "port", tmp_path / "ref", 2 * PER,
                       skip={victim: ("ver/v/a", seg)})
