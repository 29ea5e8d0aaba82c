"""Shared set-up of the multipart and versioning tests: the same sequence
through ``minio_tpu`` (``backend="numpy"``) and the port (``device="cpu"``
or a 1 x 1 CPU mesh), with the clocks and uuid draws of both packages'
object layers pinned to counters, so their drives can be compared byte
for byte, data-dir, version and upload ids included.  The listing
metacache modules draw their manager and snapshot ids from a counter of
their own and read a fixed wall clock, so a listing leaves the same
``.mt.sys/metacache/`` tree in either package without moving the object
layers' counters."""

import hashlib
import itertools
import os
import sys
import types
import uuid

import numpy as np
import torch

import minio_tpu.objectlayer.erasure_object as ref_eo
import minio_tpu.objectlayer.metacache as ref_mc
import minio_tpu.objectlayer.multipart as ref_mp
import minio_tpu.objectlayer.tiering as ref_tier
import minio_tpu.storage.format as ref_fmt
from minio_tpu.objectlayer import interface as ref_ol
from minio_tpu.storage.writers import close_write_planes
from minio_tpu.storage.xl_storage import XLStorage as RefStorage
from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.objectlayer import metacache as port_mc
from minio_tpu_torch.objectlayer import multipart as port_mp
from minio_tpu_torch.objectlayer import tiering as port_tier
from minio_tpu_torch.parallel.mesh import make_mesh
from minio_tpu_torch.storage import format as port_fmt
from minio_tpu_torch.storage.xl_storage import XLStorage

# The CPU tests run in several pytest-xdist workers at once.  The plain
# kernels are many small torch ops, and each worker's OpenMP pool as wide
# as the machine oversubscribes it: one heal test took 5 s alone and 134 s
# beside five other workers.  One intra-op thread per test process; every
# worker collects every test module, so this holds for all of them.
torch.set_num_threads(1)

N, M, BS = 6, 2, 4096
BATCH = 16 * BS                    # a part of 2.5 batches streams in three
T0 = 1_760_000_000_000_000_000
ENGINES = ["device", "mesh"]


class Pins:
    """A clock and a uuid source, each a counter."""

    def __init__(self):
        self._t = itertools.count(T0, 1000)
        self._u = itertools.count(1)
        self.uuid = types.SimpleNamespace(
            uuid4=lambda: uuid.UUID(int=next(self._u)), UUID=uuid.UUID)

    def now_ns(self) -> int:
        return next(self._t)


# the metacache's wall clock under ``pin``: snapshots never expire
PINNED_TIME = types.SimpleNamespace(time=lambda: T0 / 1e9)


class Draws:
    """``os.urandom`` for the SSE draws: a call from a module of
    ``minio_tpu_torch`` takes the port's stream, one from ``minio_tpu``
    the reference's, each a SHA-256 counter of ``seed``; any other
    caller (``uuid4``, the request ids) gets real randomness.  The
    packages draw the object key, the data key and the DARE nonces
    where the reference draws them, in its order, so one sequence of
    calls gives both the same bytes."""

    def __init__(self, seed: int, shared: bool = False):
        self._real = os.urandom
        self._streams = {"minio_tpu": self._stream(seed)}
        self._streams["minio_tpu_torch"] = self._streams["minio_tpu"] \
            if shared else self._stream(seed)

    @staticmethod
    def _stream(seed: int):
        counter = itertools.count()
        buf = bytearray()

        def draw(n: int) -> bytes:
            while len(buf) < n:
                buf.extend(hashlib.sha256(
                    f"{seed}:{next(counter)}".encode()).digest())
            out = bytes(buf[:n])
            del buf[:n]
            return out
        return draw

    def __call__(self, n: int) -> bytes:
        caller = sys._getframe(1).f_globals.get("__name__", "")
        pkg = caller.split(".", 1)[0]
        draw = self._streams.get(pkg)
        return draw(n) if draw is not None else self._real(n)


def pin(monkeypatch, shared: bool = False, batch: int = BATCH,
        draws: int | None = None) -> None:
    """One counter pair per package, or with ``shared`` one for both (a
    sequence that hops between packages); stream batches of ``batch``
    bytes.  The format modules draw the deployment and drive ids, and the
    tiering modules a transition's tier key, from the same uuid counter,
    the metacache modules from one of their own (``PINNED_TIME`` their
    clock).  ``draws``: the seed of each
    package's ``os.urandom`` stream (``Draws``; the SSE keys and
    nonces), real randomness when None."""
    ref, ref_ids = Pins(), Pins()
    port, port_ids = (ref, ref_ids) if shared else (Pins(), Pins())
    for pins, ids, mods, fmt, mc, tier in (
            (ref, ref_ids, (ref_eo, ref_mp), ref_fmt, ref_mc, ref_tier),
            (port, port_ids, (port_eo, port_mp), port_fmt, port_mc,
             port_tier)):
        for mod in mods:
            monkeypatch.setattr(mod, "now_ns", pins.now_ns)
            monkeypatch.setattr(mod, "uuid", pins.uuid)
        # a transition's tier key ends in a uuid4 drawn after its read
        monkeypatch.setattr(tier, "uuid", pins.uuid)
        monkeypatch.setattr(fmt, "uuid", pins.uuid)
        monkeypatch.setattr(mc, "uuid", ids.uuid)
        monkeypatch.setattr(mc, "time", PINNED_TIME)
    for mod in (ref_eo, port_eo):
        monkeypatch.setattr(mod, "STREAM_BATCH_BYTES", batch)
    if draws is not None:
        monkeypatch.setattr(os, "urandom", Draws(draws, shared))


def drives(root, cls, n: int = N) -> list:
    out = []
    for i in range(n):
        os.makedirs(f"{root}/d{i}", exist_ok=True)
        out.append(cls(f"{root}/d{i}"))
    return out


def port_layer(root, engine: str = "device", **kw) -> port_eo.ErasureObjects:
    where = ({"mesh": make_mesh([torch.device("cpu")])} if engine == "mesh"
             else {"device": "cpu"})
    return port_eo.ErasureObjects(drives(root, XLStorage), parity=M,
                                  block_size=BS,
                                  enforce_min_part_size=False, **where, **kw)


def ref_layer(root) -> ref_eo.ErasureObjects:
    return ref_eo.ErasureObjects(drives(root, RefStorage), parity=M,
                                 block_size=BS, backend="numpy",
                                 enforce_min_part_size=False)


def close(*layers) -> None:
    for lay in layers:
        if isinstance(lay, port_eo.ErasureObjects):
            lay.close()
        else:
            close_write_planes(lay)


def is_port(lay) -> bool:
    return isinstance(lay, port_eo.ErasureObjects)


def put_opts(lay, **kw):
    return (port_ol if is_port(lay) else ref_ol).PutObjectOptions(**kw)


def obj_opts(lay, **kw):
    return (port_ol if is_port(lay) else ref_ol).ObjectOptions(**kw)


def body(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed * 7919 + size).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def tree(root) -> dict:
    """{path: bytes} of every file of a drive but the staging area and
    the reference's listing caches."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith((".mt.sys/tmp", ".mt.sys/metacache",
                           ".mt.sys/buckets/.metacache")):
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def assert_trees_equal(got_root, want_root, n: int = N,
                       skip: dict | None = None) -> None:
    """Every drive's files equal; ``skip`` {drive: path prefixes} leaves
    out what a test checks by another oracle."""
    for i in range(n):
        got, want = tree(f"{got_root}/d{i}"), tree(f"{want_root}/d{i}")
        if skip and i in skip:
            got, want = ({p: b for p, b in t.items()
                          if not p.startswith(tuple(skip[i]))}
                         for t in (got, want))
        assert sorted(got) == sorted(want), f"drive {i} files differ"
        for path in want:
            assert got[path] == want[path], f"drive {i}: {path} differs"


def drive_numbers(paths) -> list[int]:
    """Healed drives by number (the two packages' roots differ)."""
    return sorted(int(os.path.basename(p)[1:]) for p in paths)


def version_rows(infos) -> list[tuple]:
    """What a version listing says, comparable across packages."""
    return [(o.name, o.version_id, o.is_latest, o.delete_marker, o.size,
             o.etag, o.mod_time) for o in infos]
