"""The port's erasure set trusts only drives that hold the quorum version,
and reads what ``minio_tpu`` writes in its default configuration.

* A drive that was offline during an overwrite comes back holding the old
  version.  Its old inline shard is self-consistent, so its bitrot digests
  verify; GET must still not read it (MinIO reads only drives whose
  version matches the quorum's, listOnlineDisks).
* Heal must lay a part-file object out as part files on a drive whose
  stale version was inline, or the healed drives fail the quorum hash.
* With its writer plane on (its default), ``minio_tpu`` packs objects
  just above the inline threshold into per-drive segment files.  The port
  reads them, degraded too, classifies the drives, and heals them into
  each target drive's own segment: to the same bytes as ``minio_tpu``'s
  heal of the same drives, and, where a drive lost its open segment file
  (which ``minio_tpu`` would append to at a wrong offset), into a fresh
  segment that reads back.

The oracle is the body and the set's quorum, not ``minio_tpu``, which
shares the first two faults.  Every case runs on the CPU device and on a
1 x 1 CPU mesh.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

import minio_tpu.objectlayer.erasure_object as ref_eo
from minio_tpu.storage.writers import close_write_planes
from minio_tpu.storage.xl_storage import XLStorage as RefStorage
from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.objectlayer import healing
from minio_tpu_torch.parallel.mesh import make_mesh
from minio_tpu_torch.storage.xl_storage import XLStorage

BS = 4096
BUCKET = "qbkt"
ENGINES = {"device": lambda: {"device": "cpu"},
           "mesh": lambda: {"mesh": make_mesh([torch.device("cpu")])}}


def _body(size: int, seed: int) -> bytes:
    return np.random.default_rng([size, seed]).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _drives(root, n: int) -> list:
    out = []
    for i in range(n):
        os.makedirs(f"{root}/d{i}", exist_ok=True)
        out.append(XLStorage(f"{root}/d{i}"))
    return out


def _port(root, n: int, parity: int, engine: str,
          block_size: int = BS) -> port_eo.ErasureObjects:
    return port_eo.ErasureObjects(_drives(root, n), parity=parity,
                                  block_size=block_size, **ENGINES[engine]())


def _drives_of_shards(lay, name: str, shards) -> list[int]:
    """Drive numbers holding the given (1-based) shard numbers."""
    fi, _ = lay._read_quorum_fileinfo(BUCKET, name)
    return [d for d, s in enumerate(fi.erasure.distribution) if s in shards]


def _offline(lay, drives):
    saved = {d: lay.disks[d] for d in drives}
    for d in drives:
        lay.disks[d] = None
    return saved


def _online(lay, saved):
    for d, disk in saved.items():
        lay.disks[d] = disk


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("n, parity, size", [(6, 2, 1), (8, 2, 5000)])
def test_get_skips_drive_that_missed_an_overwrite(tmp_path, engine, n,
                                                  parity, size):
    lay = _port(tmp_path, n, parity, engine)
    try:
        lay.make_bucket(BUCKET)
        first, second = _body(size, 1), _body(size, 2)
        assert first != second
        lay.put_object(BUCKET, "o", first)
        saved = _offline(lay, _drives_of_shards(lay, "o", {1}))
        lay.put_object(BUCKET, "o", second)
        _online(lay, saved)
        assert lay.get_object(BUCKET, "o")[1] == second
        lo = size // 2
        assert lay.get_object(BUCKET, "o", lo, 1)[1] == second[lo:lo + 1]
    finally:
        lay.close()


def _inline(root, d: int, name: str) -> bool:
    fi = XLStorage(f"{root}/d{d}").read_version(BUCKET, name)
    return fi.inline_data is not None


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_heal_lays_out_part_files_over_stale_inline(tmp_path, engine):
    n, parity = 8, 3
    lay = _port(tmp_path, n, parity, engine)
    try:
        lay.make_bucket(BUCKET)
        lay.put_object(BUCKET, "o", _body(5000, 1))          # inline
        saved = _offline(lay, [0, 1])
        body = _body(1 << 20, 2)                             # part files
        lay.put_object(BUCKET, "o", body)
        _online(lay, saved)
        assert _inline(tmp_path, 0, "o") and _inline(tmp_path, 1, "o")

        res = lay.heal_object(BUCKET, "o")
        assert sorted(res.healed_disks) == sorted(
            lay.disks[d].endpoint() for d in (0, 1))
        fi, _ = lay._read_quorum_fileinfo(BUCKET, "o")
        for d in (0, 1):
            assert not _inline(tmp_path, d, "o")
            assert os.path.isfile(
                f"{tmp_path}/d{d}/{BUCKET}/o/{fi.data_dir}/part.1")
        _offline(lay, [2, 3, 4])        # k = 5 left, drives 0 and 1 among them
        assert lay.get_object(BUCKET, "o")[1] == body
    finally:
        lay.close()


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_heal_packs_over_stale_inline(tmp_path, engine):
    n, parity = 8, 3
    lay = _port(tmp_path, n, parity, engine)
    try:
        lay.make_bucket(BUCKET)
        lay.put_object(BUCKET, "o", _body(5000, 1))          # inline
        saved = _offline(lay, [0, 1])
        body = _body(port_eo.INLINE_THRESHOLD + 1, 2)        # packed
        lay.put_object(BUCKET, "o", body)
        _online(lay, saved)
        res = lay.heal_object(BUCKET, "o")
        assert sorted(res.healed_disks) == sorted(
            lay.disks[d].endpoint() for d in (0, 1))
        for d in (0, 1):
            fi = XLStorage(f"{tmp_path}/d{d}").read_version(BUCKET, "o")
            assert fi.inline_data is None and fi.seg is not None
        _offline(lay, [2, 3, 4])
        assert lay.get_object(BUCKET, "o")[1] == body
    finally:
        lay.close()


PACKED_SIZE = 200 * 1024     # in minio_tpu's packed band (128 KiB, 1 MiB)


def _tree(root) -> dict:
    """{path: bytes or None for a directory} of everything under root."""
    out = {}
    for dirpath, dirs, files in os.walk(root):
        for d in dirs:
            out[os.path.join(dirpath, d)] = None
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.join(dirpath, f)] = fh.read()
    return out


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_reads_packed_objects_of_the_default_reference(tmp_path, engine):
    n, parity = 16, 4
    refs = []
    for i in range(n):
        os.makedirs(f"{tmp_path}/d{i}")
        refs.append(RefStorage(f"{tmp_path}/d{i}"))
    ref = ref_eo.ErasureObjects(refs, parity=parity, backend="numpy")
    body = _body(PACKED_SIZE, 1)
    try:
        assert ref._pipe_depth > 0, "the reference's writer plane is off"
        ref.make_bucket(BUCKET)
        ref.put_object(BUCKET, "o", body)
    finally:
        close_write_planes(ref)
    assert not glob.glob(f"{tmp_path}/d*/{BUCKET}/o/*/part.*")
    assert len(glob.glob(f"{tmp_path}/d*/.mt.sys/seg/seg.*.dat")) == n

    lay = _port(tmp_path, n, parity, engine,
                block_size=port_eo.DEFAULT_BLOCK_SIZE)
    try:
        assert lay.get_object(BUCKET, "o")[1] == body
        lo = PACKED_SIZE // 3
        assert lay.get_object(BUCKET, "o", lo, 999)[1] == body[lo:lo + 999]

        def states():
            fis, errs = lay._fanout(
                lambda d: d.read_version(BUCKET, "o"), lay.disks)
            fi, _ = lay._read_quorum_fileinfo(BUCKET, "o")
            assert fi.data_dir == "" and fi.inline_data is None
            return healing.classify_disks(lay, fi, fis, errs)

        assert states() == [healing.OK] * n
        # four data shards lost: two drives lose the object's xl.meta,
        # two keep it and lose their segment file
        victims = _drives_of_shards(lay, "o", {1, 2, 3, 4})
        for d in victims[:2]:
            shutil.rmtree(f"{tmp_path}/d{d}/{BUCKET}/o")
        for d in victims[2:]:
            for seg in glob.glob(f"{tmp_path}/d{d}/.mt.sys/seg/seg.*.dat"):
                os.remove(seg)
        assert lay.get_object(BUCKET, "o")[1] == body
        got = states()                  # in shard order
        dist = lay._read_quorum_fileinfo(BUCKET, "o")[0].erasure.distribution
        for d in range(n):
            want = (healing.MISSING if d in victims[:2]
                    else healing.CORRUPT if d in victims[2:] else healing.OK)
            assert got[dist[d] - 1] == want, d

        res = lay.heal_object(BUCKET, "o")
        assert sorted(res.healed_disks) == sorted(
            lay.disks[d].endpoint() for d in victims)
        assert states() == [healing.OK] * n
        for d in victims[2:]:           # their lost segment is sealed
            fi = lay.disks[d].read_version(BUCKET, "o")
            assert fi.seg["sid"] == 2 and fi.seg["off"] == 0
        # the healed drives serve: drop four others and GET
        for d in [d for d in range(n) if d not in victims][:4]:
            shutil.rmtree(f"{tmp_path}/d{d}/{BUCKET}/o")
        assert lay.get_object(BUCKET, "o")[1] == body
    finally:
        lay.close()


def _copy_drives(src, dst, n: int) -> None:
    for i in range(n):
        shutil.copytree(f"{src}/d{i}", f"{dst}/d{i}")


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_packed_heal_matches_the_reference(tmp_path, engine):
    """The same damaged drives healed by the port and by ``minio_tpu``
    end byte-equal: xl.meta, segment files and journals."""
    n, parity = 16, 4
    refs = []
    for i in range(n):
        os.makedirs(f"{tmp_path}/src/d{i}")
        refs.append(RefStorage(f"{tmp_path}/src/d{i}"))
    ref = ref_eo.ErasureObjects(refs, parity=parity, backend="numpy")
    bodies = {"o": _body(PACKED_SIZE, 1), "p": _body(PACKED_SIZE + 7, 2)}
    try:
        ref.make_bucket(BUCKET)
        for name, body in bodies.items():
            ref.put_object(BUCKET, name, body)
    finally:
        close_write_planes(ref)
    port0 = _port(f"{tmp_path}/src", n, parity, engine,
                  block_size=port_eo.DEFAULT_BLOCK_SIZE)
    victims = _drives_of_shards(port0, "o", {1, 2, 3, 13})
    port0.close()
    # two drives lose the object, one its xl.meta's bytes, one the object
    # and its whole segment store (a replaced drive)
    for d in victims[:2] + victims[3:]:
        shutil.rmtree(f"{tmp_path}/src/d{d}/{BUCKET}/o")
    shutil.rmtree(f"{tmp_path}/src/d{victims[3]}/.mt.sys/seg")
    with open(f"{tmp_path}/src/d{victims[2]}/{BUCKET}/o/xl.meta", "wb") as f:
        f.write(b"MTXL2\x00garbage")
    _copy_drives(f"{tmp_path}/src", f"{tmp_path}/port", n)
    _copy_drives(f"{tmp_path}/src", f"{tmp_path}/ref", n)

    ref = ref_eo.ErasureObjects(
        [RefStorage(f"{tmp_path}/ref/d{i}") for i in range(n)],
        parity=parity, backend="numpy")
    lay = _port(f"{tmp_path}/port", n, parity, engine,
                block_size=port_eo.DEFAULT_BLOCK_SIZE)
    try:
        want = ref.heal_object(BUCKET, "o")
        got = lay.heal_object(BUCKET, "o")
        assert sorted(got.healed_disks) == sorted(
            lay.disks[d].endpoint() for d in victims)
        assert len(want.healed_disks) == len(victims)
        for d in range(n):
            got_tree = {os.path.relpath(p, f"{tmp_path}/port"): b
                        for p, b in _tree(f"{tmp_path}/port/d{d}").items()}
            want_tree = {os.path.relpath(p, f"{tmp_path}/ref"): b
                         for p, b in _tree(f"{tmp_path}/ref/d{d}").items()}
            assert got_tree == want_tree, f"drive {d} differs"
        for name, body in bodies.items():
            assert lay.get_object(BUCKET, name)[1] == body
    finally:
        lay.close()
        close_write_planes(ref)
