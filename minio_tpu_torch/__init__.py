"""minio_tpu_torch: the PyTorch/CUDA port of minio_tpu's erasure data path.

One erasure set (``objectlayer.erasure_object.ErasureObjects``) doing PUT,
ranged and degraded GET, delete and heal over local drives, its drive
writes on a per-drive writer plane with group commit
(``storage/writers.py``, ``storage/commit.py``), with the device kernels
of that path written by hand for Hopper (``csrc/``):

  * ``gf8_apply.cu``: GF(2^8) matrix apply (encode, decode, heal);
  * ``hh256.cu``: keyed HighwayHash-256 bitrot digests (PUT framing, GET
    verification, heal re-framing);
  * ``rs_fused.cu``: parity and digests in one pass, the PUT of the mesh
    data plane (``parallel.mesh``, ``ops.rs_mesh``) on one device.

The device decides the engine: a CUDA tensor goes to the kernel, a CPU
tensor to the plain PyTorch version beside it.  Entry points default to
``device="cuda"`` and raise when no card is present.  The package imports
neither jax nor anything of ``minio_tpu``; its drives hold the same bytes
as ``minio_tpu``'s (xl.meta, inline data, framed ``part.1`` files, packed
segment files and their journal).
"""
