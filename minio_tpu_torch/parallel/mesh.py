"""The data plane's handle onto the devices: a ("stripe", "shard") grid.

Counterpart of the handle part of ``minio_tpu/parallel/mesh.py``
(``make_mesh``, ``set_active_mesh``, ``get_active_mesh``).  The ``stripe``
axis batches stripes across devices; the ``shard`` axis splits the k data
shards of a stripe across devices.  An ``ErasureObjects`` or ``Erasure``
built with a mesh routes its encode, reconstruct and heal through
``ops/rs_mesh.py``.  A 1-device mesh is the single-card case; the
collectives of larger meshes are not in the port yet (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve

AXES = ("stripe", "shard")


class Mesh:
    """A (stripe, shard) grid of torch devices; ``shape`` is a dict by
    axis name, as ``jax.sharding.Mesh.shape`` is."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D device grid, got "
                             f"shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def make_mesh(devices=None, stripe: int | None = None,
              shard: int | None = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device; raises
    without a card, as ``device.resolve`` does).  With neither axis
    given, all devices go on the stripe axis."""
    if devices is None:
        resolve("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve(d) for d in devices]
    n = len(devs)
    if shard is None:
        shard = 1 if stripe is None else n // stripe
    if stripe is None:
        stripe = n // shard
    if stripe * shard != n or n == 0:
        raise ValueError(f"{n} devices do not fill a {stripe} x {shard} mesh")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(stripe, shard))


_ACTIVE: Mesh | None = None


def set_active_mesh(mesh: Mesh | None) -> None:
    """Install (or with None, reset) the process-wide data-plane mesh."""
    global _ACTIVE
    _ACTIVE = mesh


def get_active_mesh() -> Mesh:
    """The data-plane mesh; by default every visible card on the shard
    axis, as in ``minio_tpu``."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = make_mesh(stripe=1)
    return _ACTIVE
