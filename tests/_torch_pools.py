"""Shared set-up of the server-pool tests (``test_torch_pools.py``,
``test_torch_rebalance.py``, ``test_torch_pools_admin.py``): pools of one
set of four drives (parity 2, 4 KiB blocks), ``minio_tpu``'s on the numpy
backend and the port's on the CPU, under ``<root>/p<j>/d<i>``, with both
packages' clocks and uuid draws pinned (``_torch_versions.pin``, the
rebalance modules' journal ids too) and each layer's free space pinned,
so placement and drains agree."""

import json
import os

import minio_tpu.background.rebalance as ref_rb
from minio_tpu.objectlayer import interface as ref_ol
from minio_tpu.objectlayer.pools import ErasureServerPools as RefPools
from minio_tpu.objectlayer.sets import ErasureSets as RefSets
from minio_tpu.storage.writers import close_write_planes
from minio_tpu_torch.background import rebalance as port_rb
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.objectlayer.pools import (MANIFEST_PATH,
                                               ErasureServerPools)
from minio_tpu_torch.objectlayer.sets import ErasureSets
from minio_tpu_torch.secure import configcrypt

from ._torch_versions import BS, Pins, assert_trees_equal, pin

PER, PARITY = 4, 2
SECRET = "pools-secret"
GIB = 1 << 30


def pool_dirs(root, j: int) -> list[str]:
    out = [f"{root}/p{j}/d{i}" for i in range(PER)]
    for d in out:
        os.makedirs(d, exist_ok=True)
    return out


def is_port(lay) -> bool:
    return isinstance(lay, (ErasureServerPools, ErasureSets))


def ol(lay):
    return port_ol if is_port(lay) else ref_ol


def rb_mod(lay):
    return port_rb if is_port(lay) else ref_rb


def set_kwargs(port: bool) -> dict:
    kw = {"parity": PARITY, "block_size": BS,
          "enforce_min_part_size": False}
    return kw if port else {"backend": "numpy", **kw}


def new_pool(root, j: int, port: bool):
    """Pool ``j`` under ``root``: one set of ``PER`` drives."""
    cls = ErasureSets if port else RefSets
    extra = {"device": "cpu"} if port else {}
    return cls.from_dirs(pool_dirs(root, j), 1, PER, **set_kwargs(port),
                         **extra)


class Deployment:
    """A pools layer of either package with pool 0 under ``root``; every
    pool it ever held, retired ones too, is closed by ``close``."""

    def __init__(self, root, port: bool, frees=None, mp=None):
        self.root, self.port = str(root), port
        cls = ErasureServerPools if port else RefPools
        self.layer = cls([new_pool(root, 0, port)], secret=SECRET)
        self.held = list(self.layer.pools)
        attach = self.layer.attach_pool

        def attach_pool(*a, **kw):      # also through the admin route
            idx = attach(*a, **kw)
            self.held.append(self.layer.pools[idx])
            return idx

        self.layer.attach_pool = attach_pool
        if frees is not None:
            self.pin_frees(frees, mp)

    def pin_frees(self, frees: list[int], mp) -> None:
        """Free bytes per pool index: placement's and the drain's
        ``_free_spaces``."""
        lay = self.layer
        mp.setattr(lay, "_free_spaces", lambda: list(frees[:len(lay.pools)]))

    def attach(self, j: int) -> int:
        return self.layer.attach_pool(pool_dirs(self.root, j), 1, PER,
                                      **set_kwargs(self.port))

    def rebalancer(self, **kw):
        return rb_mod(self.layer).Rebalancer(self.layer, interval_s=3600.0,
                                             **kw)

    def close(self) -> None:
        if self.port:
            self.layer.close()
            for p in self.held:
                if p not in self.layer.pools:
                    p.close()
        else:
            # the reference has no close: its writer threads and its
            # sets' fan-out pools are stopped here
            for p in self.held:
                close_write_planes(p)
                for s in p.sets:
                    s._pool.shutdown(wait=True)


def pin_all(mp, batch: int | None = None) -> None:
    """``_torch_versions.pin`` plus each rebalance module's journal ids
    on a counter of its own."""
    pin(mp, **({} if batch is None else {"batch": batch}))
    for mod in (ref_rb, port_rb):
        mp.setattr(mod, "uuid", Pins().uuid)


def manifest_doc(root) -> dict:
    """The unsealed manifest on pool 0's first drive, drive paths made
    relative to ``root`` and the reference's ``backend`` left out."""
    with open(f"{root}/p0/d0/.mt.sys/{MANIFEST_PATH}", "rb") as f:
        doc = json.loads(configcrypt.maybe_decrypt(SECRET, f.read())[0])
    for ent in doc["pools"]:
        ent["dirs"] = [os.path.relpath(d, str(root)) for d in ent["dirs"]]
        ent["kwargs"].pop("backend", None)
    return doc


def assert_pools_equal(got_root, want_root, pools: int) -> None:
    """Every pool's drives byte-equal but the sealed manifest (random
    salt and nonce), which ``manifest_doc`` compares."""
    skip = {i: [f".mt.sys/{MANIFEST_PATH}"] for i in range(PER)}
    for j in range(pools):
        assert_trees_equal(f"{got_root}/p{j}", f"{want_root}/p{j}", n=PER,
                           skip=skip)


def names_on(pool, bucket: str) -> list[tuple]:
    """(name, version id) of every version a pool holds."""
    out = pool.list_object_versions(bucket)
    return sorted((o.name, o.version_id)
                  for o in getattr(out, "objects", out))
