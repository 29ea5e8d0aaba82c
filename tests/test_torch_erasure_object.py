"""The port's erasure set as a whole against minio_tpu's, on the CPU.

Sixteen drives, parity 4, 4 KiB blocks and 192 KiB stream batches, so
objects span several blocks and batches.  The same bodies go through
``minio_tpu_torch``'s ``ErasureObjects(device="cpu")`` and ``minio_tpu``'s
``ErasureObjects(backend="numpy")``: the shard files must be identical
drive by drive, each layer must read the other's objects, a GET with four
drives wiped must return the body, and heal must restore the wiped files
byte for byte.

The same checks run on the port's mesh engine (``ErasureObjects(mesh=
<1 x 1 CPU mesh>)``, the counterpart of ``backend="mesh"``), whose PUT
goes through Kernel C's plain version instead of Kernels A and B.

The reference layer runs with its writer plane off (``_pipe_depth = 0``):
with it on, objects just past the inline threshold go to packed segment
files, which the port reads but does not write, so the drives would
differ (``tests/test_torch_quorum.py`` reads such objects).
"""

import glob
import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

import minio_tpu.objectlayer.erasure_object as ref_eo
from minio_tpu.storage.xl_meta import XLMeta as RefXLMeta
from minio_tpu.storage.xl_storage import XLStorage as RefStorage
from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.ops import hh, rs_fused, rs_kernels
from minio_tpu_torch.parallel.mesh import make_mesh
from minio_tpu_torch.storage.xl_storage import XLStorage

N, M, BS = 16, 4, 4096
BATCH = 48 * BS             # above the inline threshold, as in production
INLINE = port_eo.INLINE_THRESHOLD
SIZES = [0, 1, INLINE - 1, INLINE, INLINE + 1, BS - 1, BS, BS + 1,
         3 * BS + 777, 2 * BATCH + 3 * BS + 5]
BUCKET = "tbkt"


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
    lay = ref_eo.ErasureObjects(disks, parity=M, block_size=BS,
                                backend="numpy")
    lay._pipe_depth = 0
    return lay


def _build_layers(tmp_path_factory, mesh: bool):
    mp = pytest.MonkeyPatch()
    mp.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    mp.setattr(ref_eo, "STREAM_BATCH_BYTES", BATCH)
    root = tmp_path_factory.mktemp("eo")
    port, ref = _port_layer(root / "port", mesh), _ref_layer(root / "ref")
    for lay in (port, ref):
        lay.make_bucket(BUCKET)
        for size in SIZES:
            lay.put_object(BUCKET, _name(size), _body(size))
    yield root, port, ref, mesh
    port.close()
    mp.undo()


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    yield from _build_layers(tmp_path_factory, mesh=False)


@pytest.fixture(scope="module")
def mesh_layers(tmp_path_factory):
    yield from _build_layers(tmp_path_factory, mesh=True)


def _shard_bytes(root, size: int, i: int) -> bytes:
    """Drive i's shard of the object: its part file, or its inline data."""
    parts = glob.glob(f"{root}/d{i}/{BUCKET}/{_name(size)}/*/part.*")
    if parts:
        assert len(parts) == 1
        with open(parts[0], "rb") as f:
            return f.read()
    with open(f"{root}/d{i}/{BUCKET}/{_name(size)}/xl.meta", "rb") as f:
        return RefXLMeta.load(f.read()).versions[0]["inline"]


def _check_shard_files(layers, size):
    root = layers[0]
    inline = size <= INLINE
    for i in range(N):
        got = _shard_bytes(root / "port", size, i)
        want = _shard_bytes(root / "ref", size, i)
        assert got == want, f"drive {i} differs (size {size})"
        has_part = bool(glob.glob(
            f"{root}/port/d{i}/{BUCKET}/{_name(size)}/*/part.1"))
        assert has_part == (not inline)


@pytest.mark.parametrize("size", SIZES)
def test_shard_files_match_reference(layers, size):
    _check_shard_files(layers, size)


@pytest.mark.parametrize("size", SIZES)
def test_mesh_shard_files_match_reference(mesh_layers, size):
    _check_shard_files(mesh_layers, size)


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


@pytest.mark.parametrize("size", SIZES)
def test_each_layer_reads_the_other(layers, size):
    _check_reads(layers, size)


@pytest.mark.parametrize("size", SIZES)
def test_mesh_each_layer_reads_the_other(mesh_layers, size):
    _check_reads(mesh_layers, size)


def _wipe_data_drives(root, layer, name: str, count: int) -> list[int]:
    """Remove the object from the drives holding its first ``count`` data
    shards; returns their drive numbers."""
    fi, _ = layer._read_quorum_fileinfo(BUCKET, name)
    victims = [d for d, shard in enumerate(fi.erasure.distribution)
               if shard <= count]
    for d in victims:
        shutil.rmtree(f"{root}/d{d}/{BUCKET}/{name}")
    return victims


HEAL_SIZES = [INLINE - 1, 3 * BS + 777, 2 * BATCH + 3 * BS + 5]


def _check_degraded_get_and_heal(tmp_path, monkeypatch, size, mesh):
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    lay = _port_layer(tmp_path, mesh)
    try:
        lay.make_bucket(BUCKET)
        body, name = _body(size), _name(size)
        lay.put_object(BUCKET, name, body)
        before = {d: _shard_bytes(tmp_path, size, d) for d in range(N)}
        metas = {d: open(f"{tmp_path}/d{d}/{BUCKET}/{name}/xl.meta",
                         "rb").read() for d in range(N)}
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
            assert _shard_bytes(tmp_path, size, d) == before[d]
            with open(f"{tmp_path}/d{d}/{BUCKET}/{name}/xl.meta", "rb") as f:
                assert f.read() == metas[d]
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


@pytest.mark.parametrize("size", HEAL_SIZES)
def test_mesh_degraded_get_and_heal(tmp_path, monkeypatch, size):
    _check_degraded_get_and_heal(tmp_path, monkeypatch, size, mesh=True)


def test_delete_and_missing(tmp_path):
    lay = _port_layer(tmp_path)
    try:
        lay.make_bucket(BUCKET)
        lay.put_object(BUCKET, "gone", b"x" * 5000)
        assert lay.get_object_info(BUCKET, "gone").size == 5000
        lay.delete_object(BUCKET, "gone")
        with pytest.raises(port_eo.ObjectNotFound):
            lay.get_object(BUCKET, "gone")
        with pytest.raises(port_eo.BucketNotFound):
            lay.put_object("nobkt", "o", b"1")
    finally:
        lay.close()


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


def test_mesh_put_runs_kernel_c_plain_version(tmp_path, monkeypatch):
    """On the mesh engine PUT runs Kernel C's plain version (one pass per
    batch's full blocks and one per short last block), never Kernel A's or
    Kernel B's; degraded GET and heal still run A and B."""
    monkeypatch.setattr(port_eo, "STREAM_BATCH_BYTES", BATCH)
    lay = _port_layer(tmp_path, mesh=True)
    try:
        lay.make_bucket(BUCKET)
        for c in (rs_fused.COUNTS, rs_kernels.COUNTS, hh.COUNTS):
            c.reset()
        size = 2 * BATCH + 3 * BS + 5          # 3 batches, a short tail
        body = _body(size)
        lay.put_object(BUCKET, "o", body)
        assert rs_fused.COUNTS.plain == 4
        assert rs_kernels.COUNTS.plain == hh.COUNTS.plain == 0
        assert rs_fused.COUNTS.launches == rs_kernels.COUNTS.launches == \
            hh.COUNTS.launches == 0
        _wipe_data_drives(tmp_path, lay, "o", M)
        assert lay.get_object(BUCKET, "o")[1] == body
        lay.heal_object(BUCKET, "o")
        assert rs_kernels.COUNTS.plain > 0 and hh.COUNTS.plain > 0
        assert rs_fused.COUNTS.plain == 4
    finally:
        lay.close()
