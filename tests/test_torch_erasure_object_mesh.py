"""The port's mesh engine against minio_tpu's erasure set, on the CPU: the
checks of ``test_torch_erasure_object.py`` on ``ErasureObjects(mesh=<1 x 1
CPU mesh>)``, the counterpart of ``backend="mesh"``, whose PUT goes
through Kernel C's plain version instead of Kernels A and B.  The same
sixteen drives, bodies and mod time; every drive must hold the same
files as the reference's, each layer must read the other's objects, a
GET with four drives wiped must return the body, and heal must restore
the wiped shards byte for byte.
"""

import glob

import pytest

from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.ops import hh, rs_fused, rs_kernels

from .test_torch_erasure_object import (BATCH, BS, BUCKET, HEAL_SIZES, M, N,
                                        SIZES, _body, _build_layers,
                                        _check_degraded_get_and_heal,
                                        _check_reads, _check_shard_files,
                                        _port_layer, _wipe_data_drives,
                                        assert_drives_equal)


@pytest.fixture(scope="module")
def mesh_layers(tmp_path_factory):
    yield from _build_layers(tmp_path_factory, mesh=True)


@pytest.mark.parametrize("size", SIZES)
def test_mesh_shard_files_match_reference(mesh_layers, size):
    _check_shard_files(mesh_layers, size)


@pytest.mark.parametrize("engine", ["mesh"])
def test_drives_match_reference(mesh_layers, engine):
    """Every file of every drive: xl.meta, part files, segments and the
    segment journal."""
    root = mesh_layers[0]
    assert_drives_equal(root / "port", root / "ref")
    assert len(glob.glob(f"{root}/port/d*/.mt.sys/seg/journal")) == N


@pytest.mark.parametrize("size", SIZES)
def test_mesh_each_layer_reads_the_other(mesh_layers, size):
    _check_reads(mesh_layers, size)


@pytest.mark.parametrize("size", HEAL_SIZES)
def test_mesh_degraded_get_and_heal(tmp_path, monkeypatch, size):
    _check_degraded_get_and_heal(tmp_path, monkeypatch, size, mesh=True)


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
