"""The port's commit plane (``minio_tpu_torch/storage/commit.py``) against
``minio_tpu``'s, on the CPU.

* The journal's msgpack records: byte-equal to ``msgpack.packb`` for every
  record kind, and the port's stream decoder finds the same records and
  end offsets as ``msgpack.Unpacker``.
* ``SegmentStore``: one numpy-seeded sequence of appends, frees,
  rotations at a small segment size, seals, drops, compactions, a torn
  journal tail and a replay goes through both stores; the journal and
  every segment file must be equal byte for byte after each phase.
* ``GroupCollector`` ordering: through a drive writer's group commit, a
  version's xl.meta is replaced only after its segment or part bytes, the
  journal and its own tmp file are fsynced, and its directory is fsynced
  after the replace (a recorded sequence of ``os.fsync`` and
  ``os.replace`` calls).
"""

import io
import os
import threading

import msgpack
import numpy as np
import pytest

from minio_tpu.storage import commit as ref_commit
from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.storage import commit, errors, msgpack_codec
from minio_tpu_torch.storage.xl_storage import XLStorage

RECORDS = [
    {"op": "add", "sid": 1, "off": 0, "len": 17, "vol": "bkt",
     "name": "a/b", "vid": ""},
    {"op": "add", "sid": 0x1234567, "off": 2**32 + 5, "len": 70000,
     "vol": "v" * 40, "name": "é" * 30, "vid": "v" * 36},
    {"op": "free", "sid": 1, "off": 0},
    {"op": "free", "sid": 300, "off": 65536},
    {"op": "seal", "sid": 1},
    {"op": "seal", "sid": 255},
    {"op": "drop", "sid": 1},
    {"op": "drop", "sid": 2**16},
]


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["op"])
def test_journal_record_bytes_match_msgpack(rec):
    want = msgpack.packb(rec, use_bin_type=True)
    assert msgpack_codec.packb(rec) == want
    ((got, end),) = msgpack_codec.unpack_stream(want)
    assert got == rec and end == len(want)


def test_stream_decoder_matches_unpacker():
    buf = b"".join(msgpack.packb(r, use_bin_type=True) for r in RECORDS)
    unp = msgpack.Unpacker(io.BytesIO(buf), raw=False, strict_map_key=False)
    want = []
    for rec in unp:
        want.append((rec, unp.tell()))
    assert list(msgpack_codec.unpack_stream(buf)) == want
    # a torn tail: the whole records before it, then a quiet stop
    for cut in (1, 3, 9):
        got = list(msgpack_codec.unpack_stream(buf[:-cut]))
        assert got == want[:-1]
    with pytest.raises(ValueError):
        list(msgpack_codec.unpack_stream(buf + b"\xc1\x00"))


SEG_MAX = 3000
DEAD_RATIO = 0.3                    # compacts more often than the default


@pytest.fixture
def ref_seg_max(monkeypatch):
    ref_commit.CONFIG.on()          # its settings load first, then ours
    monkeypatch.setattr(ref_commit.CONFIG, "segment_max_bytes", SEG_MAX)
    monkeypatch.setattr(commit, "COMPACT_DEAD_RATIO", DEAD_RATIO)


def _files(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _run_ops(store, rng_seed: int, steps: int, live: list) -> None:
    """The seeded op sequence: mostly appends of 1..900 bytes, frees of a
    random live extent, and a compaction now and then."""
    rng = np.random.default_rng(rng_seed)
    for step in range(steps):
        r = rng.random()
        if r < 0.6 or not live:
            n = int(rng.integers(1, 900))
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            name = f"o{int(rng.integers(0, 50))}"
            sid, off = store.append(data, "bkt", name, f"v{step}")
            live.append((sid, off, n, name, f"v{step}"))
        elif r < 0.95:
            sid, off, *_ = live.pop(int(rng.integers(0, len(live))))
            store.free(sid, off)
        else:
            keep = {(s, o) for s, o, *_ in live[::2]}

            def rewrite(vol, name, vid, sid, off, length):
                if (sid, off) not in keep:
                    return False
                data = store.read(sid, off, length)
                nsid, noff = store.append(data, vol, name, vid)
                live.append((nsid, noff, length, name, vid))
                return True

            if isinstance(store, commit.SegmentStore):
                store.compact(rewrite)          # at COMPACT_DEAD_RATIO
            else:
                store.compact(rewrite, min_dead_ratio=DEAD_RATIO)
            # the compacted segments' extents were freed (both stores
            # keep the same table)
            live[:] = [x for x in live
                       if x[1] in store._segs.get(x[0], {}).get("live", {})]


def test_segment_store_matches_reference(tmp_path, ref_seg_max):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port = commit.SegmentStore(str(port_dir), segment_max_bytes=SEG_MAX)
    ref = ref_commit.SegmentStore(str(ref_dir))
    lives = {"port": [], "ref": []}
    for phase in range(3):
        for name, store in (("port", port), ("ref", ref)):
            _run_ops(store, phase, 120, lives[name])
        assert _files(port_dir) == _files(ref_dir), f"phase {phase}"
        assert port.stats() == ref.stats()
        for sid, off, n, *_ in lives["port"][:20]:
            assert port.read(sid, off, n) == ref.read(sid, off, n)
    files = _files(port_dir)
    journal = files["journal"]
    for op in (b"add", b"free", b"seal", b"drop"):
        assert b"\xa2op\xa3" + op in journal or \
            b"\xa2op\xa4" + op in journal, op
    # a torn tail: both stores closed and the journal cut inside its last
    # record; the replay truncates the torn record away
    port.close()
    ref.close()
    for d in (port_dir, ref_dir):
        with open(d / "journal", "r+b") as f:
            f.truncate(len(journal) - 5)
    *_, (_, good) = msgpack_codec.unpack_stream(journal[:-5])
    port = commit.SegmentStore(str(port_dir), segment_max_bytes=SEG_MAX)
    ref = ref_commit.SegmentStore(str(ref_dir))
    sid, off, n, *_ = lives["port"][0]
    assert port.read(sid, off, n) == ref.read(sid, off, n)   # replays
    assert os.path.getsize(port_dir / "journal") == good \
        == os.path.getsize(ref_dir / "journal")
    for name, store in (("port", port), ("ref", ref)):
        _run_ops(store, 7, 60, lives[name])
    got, want = _files(port_dir), _files(ref_dir)
    assert got == want
    assert len(got["journal"]) > good
    port.close()
    ref.close()


def test_segment_store_errors(tmp_path):
    store = commit.SegmentStore(str(tmp_path / "seg"))
    sid, off = store.append(b"x" * 100, "bkt", "o", "")
    assert store.read(sid, off, 100) == b"x" * 100
    assert store.stat(sid, off, 100) == 100
    with pytest.raises(errors.FileNotFound):
        store.read(sid + 5, 0, 1)
    with pytest.raises(errors.FileCorrupt):
        store.read(sid, off, 101)
    with pytest.raises(errors.FileCorrupt):
        store.stat(sid, off + 1, 100)
    store.free(sid, off)
    store.free(sid, off)                        # idempotent
    assert store.stats() == {"segments": 1, "live_bytes": 0,
                             "dead_bytes": 100}
    store.close()


def test_lost_open_segment_is_sealed(tmp_path):
    """An open segment removed under the store: the next append goes to a
    fresh segment at offset 0, not to a journaled offset past its end."""
    store = commit.SegmentStore(str(tmp_path / "seg"))
    store.append(b"a" * 50, "bkt", "o", "")
    os.remove(tmp_path / "seg" / commit.seg_name(1))
    assert store.append(b"b" * 20, "bkt", "p", "") == (2, 0)
    assert store.read(2, 0, 20) == b"b" * 20
    store.close()
    store = commit.SegmentStore(str(tmp_path / "seg"))
    os.remove(tmp_path / "seg" / commit.seg_name(2))
    assert store.append(b"c" * 5, "bkt", "q", "") == (3, 0)
    store.close()


# -- ordering -----------------------------------------------------------------


class _Recorder:
    """Records every os.fsync (by the file's path) and os.replace."""

    def __init__(self, monkeypatch):
        self.events = []
        self._mu = threading.Lock()
        real_fsync, real_replace = os.fsync, os.replace

        def fsync(fd):
            path = os.readlink(f"/proc/self/fd/{fd}")
            real_fsync(fd)
            with self._mu:
                self.events.append(("fsync", path))

        def replace(src, dst):
            real_replace(src, dst)
            with self._mu:
                self.events.append(("replace", os.fspath(src),
                                    os.fspath(dst)))

        monkeypatch.setattr(os, "fsync", fsync)
        monkeypatch.setattr(os, "replace", replace)


def _check_meta_order(events, drive_root: str, obj: str,
                      payload_prefixes: list[str]) -> None:
    """The object's xl.meta replace on one drive comes after the fsyncs of
    its payload files and of its own tmp file, and before the fsync of its
    directory."""
    meta = os.path.join(drive_root, obj, "xl.meta")
    (at,) = [i for i, e in enumerate(events)
             if e[0] == "replace" and e[2] == meta]
    tmp = events[at][1]
    before = [e[1] for e in events[:at] if e[0] == "fsync"]
    assert tmp in before, "xl.meta's tmp file not fsynced first"
    for prefix in payload_prefixes:
        assert any(p.startswith(prefix) for p in before), \
            f"{prefix} not fsynced before the xl.meta replace"
    after = [e[1] for e in events[at + 1:] if e[0] == "fsync"]
    assert os.path.dirname(meta) in after


@pytest.mark.parametrize("size, layout", [(200 * 1024, "packed"),
                                          (1 << 20, "part")])
def test_group_commit_fsyncs_before_the_meta_replace(tmp_path, monkeypatch,
                                                    size, layout):
    n = 6
    disks = []
    for i in range(n):
        os.makedirs(tmp_path / f"d{i}")
        disks.append(XLStorage(str(tmp_path / f"d{i}")))
    lay = port_eo.ErasureObjects(disks, parity=2, block_size=4096,
                                 device="cpu")
    try:
        assert lay._pipeline_on()
        lay.make_bucket("bkt")
        rec = _Recorder(monkeypatch)
        body = np.random.default_rng(size).integers(
            0, 256, size, dtype=np.uint8).tobytes()
        lay.put_object("bkt", "o", body)
        monkeypatch.undo()
        for d in disks:
            if layout == "packed":
                seg = os.path.join(d.root, ".mt.sys", "seg")
                prefixes = [os.path.join(seg, "seg."),
                            os.path.join(seg, "journal")]
            else:
                fi = d.read_version("bkt", "o")
                prefixes = [os.path.join(d.root, "bkt", "o", fi.data_dir,
                                         "part.1")]
            _check_meta_order(rec.events, os.path.join(d.root, "bkt"), "o",
                              prefixes)
        assert lay.get_object("bkt", "o")[1] == body
    finally:
        lay.close()


def test_eager_packed_write_fsyncs_before_the_meta_replace(tmp_path,
                                                         monkeypatch):
    """Without a collector (a heal or a direct call), the same order."""
    from minio_tpu_torch.storage.datatypes import ErasureInfo, FileInfo
    d = XLStorage(str(tmp_path))
    d.make_vol("bkt")
    rec = _Recorder(monkeypatch)
    fi = FileInfo(volume="bkt", name="o", mod_time=5,
                  erasure=ErasureInfo(data_blocks=2, parity_blocks=2,
                                      block_size=4096, index=1))
    d.write_packed("bkt", "o", fi, b"framed" * 10)
    d.write_packed("bkt", "o", fi, b"second" * 10)   # frees the first
    monkeypatch.undo()
    seg = os.path.join(d.root, ".mt.sys", "seg")
    meta = os.path.join(d.root, "bkt", "o", "xl.meta")
    replaces = [i for i, e in enumerate(rec.events)
                if e[0] == "replace" and e[2] == meta]
    assert len(replaces) == 2
    for at in replaces:
        before = [e[1] for e in rec.events[:at] if e[0] == "fsync"]
        assert os.path.join(seg, "journal") in before
        assert os.path.join(seg, commit.seg_name(1)) in before
    assert d.read_segment(1, 60, 60) == b"second" * 10
    assert d.segments.stats()["live_bytes"] == 60
    with open(os.path.join(seg, "journal"), "rb") as f:
        ops = [r["op"] for r, _ in msgpack_codec.unpack_stream(f.read())]
    assert ops == ["add", "add", "free"]
    d.close()


def test_collector_latches_a_failed_fsync_on_its_ops(tmp_path, monkeypatch):
    """A flush-time fsync failure latches on exactly the ops that
    registered the file, and continuations still run in order."""
    class Stream:
        def __init__(self):
            self.errs = {}

        def _latch_err(self, idx, err):
            self.errs.setdefault(idx, err)

    class Op:
        def __init__(self, stream, idx):
            self.stream, self.idx = stream, idx

    a, b = Stream(), Stream()
    col = commit.GroupCollector()
    paths = []
    for i, (st, name) in enumerate(((a, "x"), (b, "y"))):
        p = tmp_path / name
        p.write_bytes(b"1")
        col.current_op = Op(st, i)
        fd = os.open(p, os.O_RDONLY)
        col.defer_fd(os.dup(fd))
        os.close(fd)
        col.defer_dir(str(tmp_path))
        col.after_flush(lambda n=name: paths.append(n))
        paths.append(f"registered {name}")
    col.current_op = None
    bad = os.readlink
    real = os.fsync

    def fsync(fd):
        if bad(f"/proc/self/fd/{fd}").endswith("/y"):
            raise OSError(5, "EIO")
        real(fd)

    monkeypatch.setattr(os, "fsync", fsync)
    col.flush()
    assert not a.errs and isinstance(b.errs[1], errors.FaultyDisk)
    assert paths == ["registered x", "registered y", "x", "y"]
    assert col.deferred == 4 and col.synced == 3     # one dir for both


def test_compact_segments_matches_reference(tmp_path, monkeypatch):
    """Overwrites and deletes leave dead space in sealed segments; each
    drive's compaction moves the live extents and repoints their xl.meta
    as the reference's does, byte for byte, and every object still reads
    back."""
    import minio_tpu.objectlayer.erasure_object as ref_eo
    from minio_tpu.objectlayer.interface import \
        PutObjectOptions as RefPutOptions
    from minio_tpu.storage.writers import close_write_planes
    from minio_tpu.storage.xl_storage import XLStorage as RefStorage
    from minio_tpu_torch.objectlayer.interface import PutObjectOptions
    n, seg_max = 6, 200 * 1024      # about three extents per segment
    ref_commit.CONFIG.on()
    monkeypatch.setattr(ref_commit.CONFIG, "segment_max_bytes", seg_max)
    monkeypatch.setattr(commit, "COMPACT_DEAD_RATIO", DEAD_RATIO)
    lays = {}
    for name, storage, make in (
            ("port", XLStorage, lambda d: port_eo.ErasureObjects(
                d, parity=2, block_size=4096, device="cpu")),
            ("ref", RefStorage, lambda d: ref_eo.ErasureObjects(
                d, parity=2, block_size=4096, backend="numpy"))):
        disks = []
        for i in range(n):
            os.makedirs(tmp_path / name / f"d{i}")
            disks.append(storage(str(tmp_path / name / f"d{i}")))
        if name == "port":
            for d in disks:
                d.segments.segment_max_bytes = seg_max
        lays[name] = (make(disks), disks)
    bodies = {}
    rng = np.random.default_rng(3)
    steps = [("put", f"o{i}", int(rng.integers(130, 300)) * 1024)
             for i in range(12)]
    steps += [("delete", "o1", 0), ("put", "o2", 150 * 1024),
              ("delete", "o4", 0), ("put", "o5", 140 * 1024),
              ("delete", "o7", 0), ("put", "o12", 300 * 1024)]
    try:
        for lay, _ in lays.values():
            lay.make_bucket("bkt")
        for op, obj, size in steps:
            body = np.random.default_rng(size).integers(
                0, 256, size, dtype=np.uint8).tobytes()
            for name, (lay, _) in lays.items():
                if name == "port":
                    opts = PutObjectOptions(mod_time=7)
                else:
                    opts = RefPutOptions(mod_time=7)
                if op == "put":
                    lay.put_object("bkt", obj, body, opts)
                else:
                    lay.delete_object("bkt", obj)
            if op == "put":
                bodies[obj] = body
            else:
                bodies.pop(obj)
        moved = 0
        for i in range(n):
            got = lays["port"][1][i].compact_segments()
            want = lays["ref"][1][i].compact_segments(DEAD_RATIO)
            assert got == want
            moved += got["moved"]
        assert moved > 0
        for i in range(n):
            assert _tree_files(tmp_path / "port" / f"d{i}") == \
                _tree_files(tmp_path / "ref" / f"d{i}"), f"drive {i}"
        for obj, body in bodies.items():
            assert lays["port"][0].get_object("bkt", obj)[1] == body
    finally:
        lays["port"][0].close()
        close_write_planes(lays["ref"][0])


def _tree_files(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith(".mt.sys/tmp"):
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out
