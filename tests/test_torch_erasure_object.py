"""The port's erasure set as a whole against minio_tpu's, on the CPU.

Sixteen drives, parity 4, 4 KiB blocks and 1040 KiB stream batches, so
objects span several blocks and batches and every size band is reached:
inline (up to 128 KiB), packed into segment files (up to 1 MiB - 1),
part files committed beside the MD5 (1 MiB up to one batch), and
streamed part files (several batches).  The same bodies, with the same
mod time, go through ``minio_tpu_torch``'s ``ErasureObjects(device=
"cpu")`` and ``minio_tpu``'s ``ErasureObjects(backend="numpy")`` in its
default configuration (writer plane, group commit and packing on): every
drive must hold the same files with the same bytes (xl.meta, part files,
segment files and the segment journal; data-dir names are random and
are compared as placeholders), each layer must read the other's
objects, a GET with four drives wiped must return the body, and heal
must restore the wiped shards byte for byte.

The same checks run with both packages in their single-core mode (no
pipeline, no packing), and on the port's mesh engine in
``test_torch_erasure_object_mesh.py``.
"""

import glob
import hashlib
import os
import re
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import minio_tpu.objectlayer.erasure_object as ref_eo
from minio_tpu.objectlayer.interface import \
    PutObjectOptions as RefPutOptions
from minio_tpu.storage import commit as ref_commit
from minio_tpu.storage.writers import close_write_planes
from minio_tpu.storage.xl_meta import XLMeta as RefXLMeta
from minio_tpu.storage.xl_storage import XLStorage as RefStorage
from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.objectlayer.interface import PutObjectOptions
from minio_tpu_torch.ops import hh, rs_kernels
from minio_tpu_torch.parallel.mesh import make_mesh
from minio_tpu_torch.storage import commit
from minio_tpu_torch.storage.xl_storage import XLStorage
from minio_tpu_torch.utils import bufpool

N, M, BS = 16, 4, 4096
BATCH = 260 * BS            # one batch holds a 1 MiB body
INLINE = port_eo.INLINE_THRESHOLD
MIB = 1 << 20
SIZES = [0, 1, INLINE - 1, INLINE, INLINE + 1, BS - 1, BS, BS + 1,
         3 * BS + 777, 130 * 1024, 99 * BS + 5, MIB - 1, MIB, BATCH,
         2 * BATCH + 3 * BS + 5]
BUCKET = "tbkt"
MOD_TIME = 1_760_000_000_000_000_000
UUID = re.compile(rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  rb"[0-9a-f]{12}")


def _body(size: int) -> bytes:
    return np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _name(size: int) -> str:
    return f"obj-{size}"


def _engine(mesh: bool) -> dict:
    """The port's engine: the CPU device, or a 1 x 1 CPU mesh."""
    return ({"mesh": make_mesh([torch.device("cpu")])} if mesh
            else {"device": "cpu"})


def _port_layer(root, mesh: bool = False) -> port_eo.ErasureObjects:
    disks = []
    for i in range(N):
        os.makedirs(f"{root}/d{i}", exist_ok=True)
        disks.append(XLStorage(f"{root}/d{i}"))
    return port_eo.ErasureObjects(disks, parity=M, block_size=BS,
                                  **_engine(mesh))


def _ref_layer(root) -> ref_eo.ErasureObjects:
    disks = []
    for i in range(N):
        os.makedirs(f"{root}/d{i}", exist_ok=True)
        disks.append(RefStorage(f"{root}/d{i}"))
    return ref_eo.ErasureObjects(disks, parity=M, block_size=BS,
                                 backend="numpy")


def _put(lay, name: str, body: bytes) -> None:
    opts = (PutObjectOptions if isinstance(lay, port_eo.ErasureObjects)
            else RefPutOptions)(mod_time=MOD_TIME)
    lay.put_object(BUCKET, name, body, opts)


def drive_tree(root) -> dict:
    """{relative path: bytes} of every file of a drive outside the
    staging area, data-dir names (uuids) replaced by zeros in paths and
    bytes alike (same length, so xl.meta stays well formed)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel == ".mt.sys/tmp" or rel.startswith(".mt.sys/tmp/"):
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                data = UUID.sub(b"0" * 36, fh.read())
            path = UUID.sub(b"0" * 36, os.path.join(rel, f).encode())
            out[path.decode()] = data
    return out


def assert_drives_equal(got_root, want_root, n: int = N) -> None:
    for i in range(n):
        got, want = drive_tree(f"{got_root}/d{i}"), \
            drive_tree(f"{want_root}/d{i}")
        assert sorted(got) == sorted(want), f"drive {i} files differ"
        for path in want:
            assert got[path] == want[path], f"drive {i}: {path} differs"


def _build_layers(tmp_path_factory, mesh: bool):
    mp = pytest.MonkeyPatch()
    mp.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    mp.setattr(ref_eo, "STREAM_BATCH_BYTES", BATCH)
    root = tmp_path_factory.mktemp("eo")
    port, ref = _port_layer(root / "port", mesh), _ref_layer(root / "ref")
    try:
        for lay in (port, ref):
            lay.make_bucket(BUCKET)
            for size in SIZES:
                _put(lay, _name(size), _body(size))
        yield root, port, ref, mesh
    finally:
        port.close()
        close_write_planes(ref)
        mp.undo()


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    yield from _build_layers(tmp_path_factory, mesh=False)


def _shard_bytes(root, size: int, i: int) -> bytes:
    """Drive i's shard of the object: its part file, its packed extent,
    or its inline data."""
    parts = glob.glob(f"{root}/d{i}/{BUCKET}/{_name(size)}/*/part.*")
    if parts:
        assert len(parts) == 1
        with open(parts[0], "rb") as f:
            return f.read()
    with open(f"{root}/d{i}/{BUCKET}/{_name(size)}/xl.meta", "rb") as f:
        v = RefXLMeta.load(f.read()).versions[0]
    if "seg" in v:
        seg = v["seg"]
        with open(f"{root}/d{i}/.mt.sys/seg/seg.{seg['sid']:08x}.dat",
                  "rb") as f:
            f.seek(seg["off"])
            return f.read(seg["len"])
    return v["inline"]


def _layout(root, size: int, i: int) -> str:
    if glob.glob(f"{root}/d{i}/{BUCKET}/{_name(size)}/*/part.1"):
        return "part"
    with open(f"{root}/d{i}/{BUCKET}/{_name(size)}/xl.meta", "rb") as f:
        return "packed" if "seg" in RefXLMeta.load(f.read()).versions[0] \
            else "inline"


def _check_shard_files(layers, size):
    root = layers[0]
    want_layout = ("inline" if size <= INLINE else
                   "packed" if size < MIB else "part")
    for i in range(N):
        got = _shard_bytes(root / "port", size, i)
        want = _shard_bytes(root / "ref", size, i)
        assert got == want, f"drive {i} differs (size {size})"
        assert _layout(root / "port", size, i) == want_layout
        assert _layout(root / "ref", size, i) == want_layout


@pytest.mark.parametrize("size", SIZES)
def test_shard_files_match_reference(layers, size):
    _check_shard_files(layers, size)


@pytest.mark.parametrize("engine", ["device"])
def test_drives_match_reference(layers, engine):
    """Every file of every drive: xl.meta, part files, segments and the
    segment journal."""
    root = layers[0]
    assert_drives_equal(root / "port", root / "ref")
    assert len(glob.glob(f"{root}/port/d*/.mt.sys/seg/journal")) == N


def _check_reads(layers, size):
    root, port, ref, mesh = layers
    body = _body(size)
    info, got = port.get_object(BUCKET, _name(size))
    assert got == body
    assert info.etag == hashlib.md5(body).hexdigest()
    assert ref.get_object(BUCKET, _name(size))[1] == body
    # swap: each layer over the other's drives
    port_on_ref = port_eo.ErasureObjects(
        [XLStorage(f"{root}/ref/d{i}") for i in range(N)], parity=M,
        block_size=BS, **_engine(mesh))
    ref_on_port = ref_eo.ErasureObjects(
        [RefStorage(f"{root}/port/d{i}") for i in range(N)], parity=M,
        block_size=BS, backend="numpy")
    try:
        assert port_on_ref.get_object(BUCKET, _name(size))[1] == body
        assert ref_on_port.get_object(BUCKET, _name(size))[1] == body
        if size > 2:
            lo, ln = size // 3, size // 2
            assert port_on_ref.get_object(BUCKET, _name(size), lo, ln)[1] \
                == body[lo:lo + ln]
            assert port.get_object(BUCKET, _name(size), -7)[1] == body[-7:]
    finally:
        port_on_ref.close()
        close_write_planes(ref_on_port)


@pytest.mark.parametrize("size", SIZES)
def test_each_layer_reads_the_other(layers, size):
    _check_reads(layers, size)


def _wipe_data_drives(root, layer, name: str, count: int) -> list[int]:
    """Remove the object from the drives holding its first ``count`` data
    shards; returns their drive numbers."""
    fi, _ = layer._read_quorum_fileinfo(BUCKET, name)
    victims = [d for d, shard in enumerate(fi.erasure.distribution)
               if shard <= count]
    for d in victims:
        shutil.rmtree(f"{root}/d{d}/{BUCKET}/{name}")
    return victims


def _meta_without_seg(raw: bytes) -> list:
    """The object's versions as stored, without the per-drive extent."""
    return [{k: v for k, v in vd.items() if k != "seg"}
            for vd in RefXLMeta.load(raw).versions]


def _xl_meta(root, d: int, name: str) -> bytes:
    with open(f"{root}/d{d}/{BUCKET}/{name}/xl.meta", "rb") as f:
        return f.read()


HEAL_SIZES = [INLINE - 1, 3 * BS + 777, 99 * BS + 5,
              2 * BATCH + 3 * BS + 5]


def _check_degraded_get_and_heal(tmp_path, monkeypatch, size, mesh):
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    lay = _port_layer(tmp_path, mesh)
    try:
        lay.make_bucket(BUCKET)
        body, name = _body(size), _name(size)
        lay.put_object(BUCKET, name, body)
        before = {d: _shard_bytes(tmp_path, size, d) for d in range(N)}
        metas = {d: _xl_meta(tmp_path, d, name) for d in range(N)}
        layout = _layout(tmp_path, size, 0)
        victims = _wipe_data_drives(tmp_path, lay, name, M)
        assert len(victims) == M
        launches = rs_kernels.COUNTS.plain
        assert lay.get_object(BUCKET, name)[1] == body
        assert rs_kernels.COUNTS.plain > launches, "no reconstruction ran"
        lo = size // 2
        assert lay.get_object(BUCKET, name, lo, 100)[1] == body[lo:lo + 100]

        res = lay.heal_object(BUCKET, name)
        assert sorted(res.healed_disks) == sorted(
            lay.disks[d].endpoint() for d in victims)
        for d in victims:
            assert _layout(tmp_path, size, d) == layout
            # a packed shard is read through the healed xl.meta's extent
            assert _shard_bytes(tmp_path, size, d) == before[d]
            healed = _xl_meta(tmp_path, d, name)
            if layout == "packed":
                # the extent is where the drive's own segment put it;
                # the rest of the version is as before
                assert _meta_without_seg(healed) == \
                    _meta_without_seg(metas[d])
            else:
                assert healed == metas[d]
        # the healed shards alone (with the other data drives) must decode
        others = [d for d in range(N) if d not in victims]
        for d in others[:M]:
            shutil.rmtree(f"{tmp_path}/d{d}/{BUCKET}/{name}")
        assert lay.get_object(BUCKET, name)[1] == body
    finally:
        lay.close()


@pytest.mark.parametrize("size", HEAL_SIZES)
def test_degraded_get_and_heal(tmp_path, monkeypatch, size):
    _check_degraded_get_and_heal(tmp_path, monkeypatch, size, mesh=False)


def test_delete_and_missing(tmp_path):
    lay = _port_layer(tmp_path)
    try:
        lay.make_bucket(BUCKET)
        lay.put_object(BUCKET, "gone", b"x" * 5000)
        assert lay.get_object_info(BUCKET, "gone").size == 5000
        lay.delete_object(BUCKET, "gone")
        with pytest.raises(port_eo.ObjectNotFound):
            lay.get_object(BUCKET, "gone")
        lay.delete_object(BUCKET, "gone")           # idempotent
        with pytest.raises(port_eo.BucketNotFound):
            lay.put_object("nobkt", "o", b"1")
    finally:
        lay.close()


@pytest.mark.parametrize("engine", ["device", "mesh"])
def test_overwrite_and_delete_match_reference(tmp_path, monkeypatch,
                                              engine):
    """Overwrites and deletes of packed objects free their extents as the
    reference does: the journals, segments and xl.meta stay equal after
    every step, and a sealed segment with no live extent is dropped."""
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    monkeypatch.setattr(ref_eo, "STREAM_BATCH_BYTES", BATCH)
    port = _port_layer(tmp_path / "port", engine == "mesh")
    ref = _ref_layer(tmp_path / "ref")
    # small segments (a drive's extent of a 200 KiB object is ~18 KB),
    # so the steps seal and drop some
    for d in port.disks:
        d.segments.segment_max_bytes = 40 * 1024
    ref_commit.CONFIG.on()              # loads its settings first
    monkeypatch.setattr(ref_commit.CONFIG, "segment_max_bytes", 40 * 1024)
    steps = [("put", "a", 200 * 1024), ("put", "b", 300 * 1024),
             ("put", "a", 150 * 1024), ("put", "c", 140 * 1024),
             ("delete", "b", 0), ("put", "c", 2 * BATCH + 1),
             ("put", "d", 5000), ("delete", "a", 0), ("put", "b", MIB - 1),
             ("delete", "c", 0), ("delete", "zz", 0)]
    try:
        for lay in (port, ref):
            lay.make_bucket(BUCKET)
        for op, name, size in steps:
            for lay in (port, ref):
                if op == "put":
                    _put(lay, name, _body(size))
                else:
                    lay.delete_object(BUCKET, name)
            assert_drives_equal(tmp_path / "port", tmp_path / "ref")
        journal = open(f"{tmp_path}/port/d0/.mt.sys/seg/journal",
                       "rb").read()
        assert b"free" in journal and b"drop" in journal
        for name, size in (("b", MIB - 1), ("d", 5000)):
            assert port.get_object(BUCKET, name)[1] == _body(size)
        with pytest.raises(port_eo.ObjectNotFound):
            port.get_object(BUCKET, "a")
    finally:
        port.close()
        close_write_planes(ref)


def test_single_core_layout_matches_reference(tmp_path, monkeypatch):
    """With one core both packages run the fan-out in line and neither
    pipelines nor packs: part files from just past the inline threshold,
    and the drives still equal."""
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    monkeypatch.setattr(ref_eo, "STREAM_BATCH_BYTES", BATCH)
    monkeypatch.setattr(port_eo, "SERIAL_FANOUT", True)
    monkeypatch.setattr(ref_eo, "_SINGLE_CORE", True)
    port, ref = _port_layer(tmp_path / "port"), _ref_layer(tmp_path / "ref")
    try:
        assert not port._pipeline_on() and not ref._pipeline_on()
        for lay in (port, ref):
            lay.make_bucket(BUCKET)
            for size in (INLINE + 1, MIB - 1, MIB, 2 * BATCH + 3):
                _put(lay, _name(size), _body(size))
        assert_drives_equal(tmp_path / "port", tmp_path / "ref")
        assert not glob.glob(f"{tmp_path}/port/d*/.mt.sys/seg")
        assert not port._write_plane.threads()
        for size in (INLINE + 1, 2 * BATCH + 3):
            assert _layout(tmp_path / "port", size, 0) == "part"
            assert port.get_object(BUCKET, _name(size))[1] == _body(size)
    finally:
        port.close()
        close_write_planes(ref)


class _SlowAppends(XLStorage):
    """A drive whose appends take a while: a framed buffer recycled
    before its batch's writes finished would be overwritten meanwhile."""

    def append_file(self, volume, path, data):
        time.sleep(0.3)
        super().append_file(volume, path, data)


def test_pool_of_one_buffer_is_recycled_only_after_the_writes(
        tmp_path, monkeypatch):
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    monkeypatch.setattr(ref_eo, "STREAM_BATCH_BYTES", BATCH)
    framed_bytes = N * (BATCH // BS) * (32 + -(-BS // (N - M)))
    pool = bufpool.BufPool(max_bytes=framed_bytes)     # one batch's buffer
    monkeypatch.setattr(bufpool, "GLOBAL", pool)
    disks = []
    for i in range(N):
        os.makedirs(f"{tmp_path}/port/d{i}")
        disks.append((_SlowAppends if i % 3 == 0 else XLStorage)(
            f"{tmp_path}/port/d{i}"))
    port = port_eo.ErasureObjects(disks, parity=M, block_size=BS,
                                  device="cpu")
    ref = _ref_layer(tmp_path / "ref")
    size = 5 * BATCH + 3 * BS + 11                    # six batches
    try:
        for lay in (port, ref):
            lay.make_bucket(BUCKET)
            _put(lay, "o", _body(size))
        assert pool.hits >= 2, (pool.hits, pool.misses)
        assert_drives_equal(tmp_path / "port", tmp_path / "ref")
        assert port.get_object(BUCKET, "o")[1] == _body(size)
        assert port.pipe_stats["batches"] == 6
    finally:
        port.close()
        close_write_planes(ref)


class _SlowShardWrites(XLStorage):
    """While ``state["on"]`` is set, a drive whose shard writes (a PUT's
    ``write_data_commit``, a heal's ``create_file``) take a second and
    record whether the bytes they were handed changed meanwhile."""

    state: dict = {}

    def _slow(self, data) -> None:
        st = self.state
        if not st.get("on"):
            return
        snap = bytes(np.asarray(data))
        with st["mu"]:
            st["started"] += 1
        time.sleep(1.0)
        with st["mu"]:
            st["changed"] += bytes(np.asarray(data)) != snap
            st["ended"] += 1

    def write_data_commit(self, volume, path, fi, data, **kw):
        self._slow(data)
        super().write_data_commit(volume, path, fi, data, **kw)

    def create_file(self, volume, path, data):
        self._slow(data)
        super().create_file(volume, path, data)


@pytest.mark.parametrize("op", ["put", "heal"])
def test_failed_commit_keeps_its_buffer_until_the_writes_end(
        tmp_path, monkeypatch, op):
    """A one-batch commit (PUT) or a heal fails while drives are still
    writing its pooled buffer: the plane closes while one drive's queue is
    full.  The buffer must not go back to the pool (a pool of one) before
    those writes end, and goes back once they have."""
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    monkeypatch.setattr(port_eo, "ABORT_DRAIN_S", 0.05)
    st = {"on": False, "mu": threading.Lock(), "started": 0, "ended": 0,
          "changed": 0}
    monkeypatch.setattr(_SlowShardWrites, "state", st)
    disks = []
    for i in range(N):
        os.makedirs(f"{tmp_path}/d{i}")
        disks.append(_SlowShardWrites(f"{tmp_path}/d{i}"))
    lay = port_eo.ErasureObjects(disks, parity=M, block_size=BS,
                                 device="cpu")
    body = _body(MIB)                   # a part file, one batch
    plane = lay._write_plane
    release_gate = threading.Event()
    try:
        lay.make_bucket(BUCKET)
        shuffled = port_eo.meta.shuffle_disks(
            disks, port_eo.meta.hash_order(f"{BUCKET}/o", N))
        if op == "put":
            shape = tuple(lay._frame(memoryview(body)).shape)
            targets, slow = shuffled, N // 2
        else:
            lay.put_object(BUCKET, "o", body)
            victims = _wipe_data_drives(tmp_path, lay, "o", M)
            targets = [d for d in shuffled if disks.index(d) in victims]
            shape = (M, tuple(lay._frame(memoryview(body)).shape)[1])
            slow = 2
            plane.close()               # the blocked writer comes first
        pool = bufpool.BufPool(max_bytes=int(np.prod(shape)))
        monkeypatch.setattr(bufpool, "GLOBAL", pool)
        # fill the queue of the drive after the slow ones: the commit's
        # submit waits there until the plane closes
        blocked = targets[slow]
        pre = plane.stream([blocked])
        busy = threading.Event()
        pre.submit(0, lambda i, d: (busy.set(), release_gate.wait(30)))
        assert busy.wait(10)
        bound = max(port_eo.QUEUE_DEPTH, commit.CONFIG.max_batch)
        for _ in range(bound):
            pre.submit(0, lambda i, d: None, bound=bound + 1)
        st["on"] = True
        errs = []

        def run():
            try:
                if op == "put":
                    lay.put_object(BUCKET, "o", body)
                else:
                    lay.heal_object(BUCKET, "o")
            except Exception as e:  # noqa: BLE001 — checked below
                errs.append(e)

        t = threading.Thread(target=run)
        t.start()
        deadline = time.monotonic() + 30
        while st["started"] < slow and time.monotonic() < deadline:
            time.sleep(0.01)
        assert st["started"] == slow
        closer = threading.Thread(target=plane.close)
        closer.start()
        t.join(30)
        assert errs and st["ended"] == 0, (errs, st)
        # the buffer is still being written: the pool must not hand it out
        reused = pool.acquire(shape, pinned=False)
        reused.fill_(0xAA)
        assert pool.hits == 0
        release_gate.set()
        closer.join(30)
        deadline = time.monotonic() + 30
        while st["ended"] < slow and time.monotonic() < deadline:
            time.sleep(0.01)
        assert st["ended"] == slow and st["changed"] == 0
        # and once the last write settled, it went back
        assert pool.acquire(shape, pinned=False) is not reused
        assert pool.hits == 1
    finally:
        st["on"] = False
        release_gate.set()
        lay.close()


def test_put_rides_the_writer_plane(tmp_path):
    """PUTs go through one writer thread per drive, whose batches group
    their fsyncs; close() joins the threads."""
    lay = _port_layer(tmp_path)
    try:
        lay.make_bucket(BUCKET)
        commit.COUNTS.reset()
        lay.put_object(BUCKET, "p", _body(200 * 1024))
        threads = lay._write_plane.threads()
        assert len(threads) == N and all(t.is_alive() for t in threads)
        assert commit.COUNTS.batches >= N
        assert commit.COUNTS.seg_bytes > 200 * 1024
    finally:
        lay.close()
    assert not any(t.is_alive() for t in threads)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mt-putw-") and t in threads]


def test_path_uses_plain_versions_on_cpu(tmp_path):
    """On CPU tensors the wrappers run the plain versions and launch no
    kernel."""
    lay = _port_layer(tmp_path)
    try:
        rs_kernels.COUNTS.reset()
        hh.COUNTS.reset()
        lay.make_bucket(BUCKET)
        lay.put_object(BUCKET, "o", _body(3 * BS))
        assert lay.get_object(BUCKET, "o")[1] == _body(3 * BS)
        assert rs_kernels.COUNTS.launches == hh.COUNTS.launches == 0
        assert rs_kernels.COUNTS.plain > 0 and hh.COUNTS.plain > 0
    finally:
        lay.close()
