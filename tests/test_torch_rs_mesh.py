"""The port's mesh data plane (``ops/rs_mesh.py`` on a 1 x 1 CPU mesh)
against minio_tpu: the framed PUT layout of the numpy codec plus
``bitrot.fill_framed``, and ``rs_mesh.encode_object_framed_fused`` on a
one-device JAX mesh (its XLA engine: ``MT_MESH_PALLAS=0``, batcher off).
Byte-exact."""

import jax
import numpy as np
import pytest
import torch

from minio_tpu.hashing import bitrot as ref_bitrot
from minio_tpu.ops import codec as ref_codec
from minio_tpu.ops import rs_mesh as ref_mesh
from minio_tpu.parallel import batcher
from minio_tpu.parallel import mesh as ref_pmesh
from minio_tpu_torch.ops import codec, gf8, rs_fused, rs_kernels, rs_mesh
from minio_tpu_torch.parallel import mesh as pmesh

K, M, BS = 4, 2, 65536
SIZES = [3 * BS + 17, 0, 1000]


def _body(size: int) -> bytes:
    return np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()


@pytest.fixture
def cpu_mesh():
    return pmesh.make_mesh([torch.device("cpu")])


@pytest.fixture
def jax_one_device_mesh(monkeypatch):
    """minio_tpu's mesh data plane on one JAX device, XLA engine, no
    cross-request batcher; restored afterwards."""
    monkeypatch.setenv("MT_MESH_PALLAS", "0")
    monkeypatch.setattr(batcher.CONFIG, "enable", False)
    monkeypatch.setattr(batcher.CONFIG, "_loaded", True)
    prev = ref_pmesh._ACTIVE
    ref_pmesh.set_active_mesh(ref_pmesh.make_mesh(devices=jax.devices()[:1]))
    yield
    ref_pmesh.set_active_mesh(prev)


@pytest.mark.parametrize("size", SIZES)
def test_framed_fused_matches_numpy_codec(cpu_mesh, size):
    body = _body(size)
    got = rs_mesh.encode_object_framed_fused(K, M, BS, body, mesh=cpu_mesh)
    ref = ref_codec.Erasure(K, M, BS, backend="numpy")
    want = ref.encode_object_framed(body)
    assert ref_bitrot.fill_framed(want, ref.shard_size())
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", SIZES)
def test_framed_fused_matches_jax_mesh(cpu_mesh, jax_one_device_mesh, size):
    body = _body(size)
    got = rs_mesh.encode_object_framed_fused(K, M, BS, body, mesh=cpu_mesh)
    want = ref_mesh.encode_object_framed_fused(K, M, BS, body)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_framed_fused_runs_kernel_c_plain_version_only(cpu_mesh):
    """Full blocks take one pass, the short last block one more; Kernels
    A and B do not run."""
    for c in (rs_fused.COUNTS, rs_kernels.COUNTS):
        c.reset()
    rs_mesh.encode_object_framed_fused(K, M, BS, _body(SIZES[0]),
                                       mesh=cpu_mesh)
    assert rs_fused.COUNTS.plain == 2
    assert rs_kernels.COUNTS.plain == 0


def test_reconstruct_batch_matches_jax_mesh(cpu_mesh, jax_one_device_mesh):
    k, m = 12, 4
    present = [0, 1, 3, 4, 5, 6, 8, 9, 10, 11, 12, 15]
    wanted = [2, 7, 13, 14]
    d = np.random.default_rng(5).integers(0, 256, (3, k, 96),
                                          dtype=np.uint8)
    par = rs_kernels.encode_parity(torch.from_numpy(d), m).numpy()
    full = np.concatenate([d, par], axis=1)
    got = rs_mesh.reconstruct_batch(torch.from_numpy(full[:, present]),
                                    present, wanted, k, m, mesh=cpu_mesh)
    want = ref_mesh.reconstruct_batch(full[:, present], present, wanted,
                                      k, m)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), full[:, wanted])


def test_reconstruct_and_encode_parity_on_the_mesh(cpu_mesh):
    k, m = 4, 2
    d = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (k, 77), dtype=np.uint8))
    par = rs_mesh.encode_parity(d, m, mesh=cpu_mesh)
    assert torch.equal(par, rs_kernels.encode_parity(d, m))
    shards = list(d) + list(par)
    lost = [None if i in (1, 4) else s for i, s in enumerate(shards)]
    back = rs_mesh.reconstruct(lost, k, m, mesh=cpu_mesh)
    assert all(torch.equal(a, b) for a, b in zip(back, shards))


def test_active_mesh_is_the_default(cpu_mesh):
    prev = pmesh._ACTIVE
    try:
        pmesh.set_active_mesh(cpu_mesh)
        assert pmesh.get_active_mesh() is cpu_mesh
        d = torch.from_numpy(np.random.default_rng(8).integers(
            0, 256, (1, 4, 50), dtype=np.uint8))
        par, dig = rs_mesh.encode_with_bitrot(4, 2, d)
        want = rs_fused.encode_with_bitrot_fused(4, 2, d)
        assert torch.equal(par, want[0]) and torch.equal(dig, want[1])
    finally:
        pmesh.set_active_mesh(prev)


def test_multi_device_mesh_raises():
    two = pmesh.make_mesh([torch.device("cpu")] * 2, stripe=1)
    assert two.shape == {"stripe": 1, "shard": 2}
    d = torch.zeros((1, 4, 8), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        rs_mesh.encode_with_bitrot(4, 2, d, mesh=two)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        rs_mesh.apply_matrix(gf8.rs_matrix(4, 6)[4:], d, mesh=two)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        codec.Erasure(4, 2, BS, mesh=two)


def test_make_mesh_shapes_and_errors():
    cpu = torch.device("cpu")
    assert pmesh.make_mesh([cpu] * 4).shape == {"stripe": 4, "shard": 1}
    assert pmesh.make_mesh([cpu] * 4, stripe=2).shape == \
        {"stripe": 2, "shard": 2}
    assert pmesh.make_mesh([cpu] * 4, shard=4).shape == \
        {"stripe": 1, "shard": 4}
    with pytest.raises(ValueError):
        pmesh.make_mesh([cpu] * 3, stripe=2)


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        pmesh.make_mesh([torch.device("cuda", 0)])


def test_codec_on_a_mesh_matches_the_device_codec(cpu_mesh):
    """``Erasure(mesh=...)`` takes the mesh's device and gives the same
    shards and reconstructions as ``Erasure(device="cpu")``."""
    body = _body(3 * 4096 + 5)
    on_mesh = codec.Erasure(12, 4, 4096, mesh=cpu_mesh)
    plain = codec.Erasure(12, 4, 4096, device="cpu")
    assert on_mesh.device == torch.device("cpu")
    got = on_mesh.encode_object(body)
    assert torch.equal(got, plain.encode_object(body))
    shards = on_mesh.encode_data(body[:4096])
    lost = [None if i in (0, 5, 12, 13) else s for i, s in enumerate(shards)]
    back = on_mesh.decode_data_and_parity_blocks(lost)
    assert all(torch.equal(a, b) for a, b in zip(back, shards))
