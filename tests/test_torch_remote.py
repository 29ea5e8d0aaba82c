"""Drives over the internode RPC (``storage/remote.py``) against
``minio_tpu``'s, both ways: the port's ``RemoteStorage`` against the
reference's storage service and the reference's client against the
port's, every ``StorageAPI`` call of one sequence (the calls of
``tests/test_cluster.py::test_remote_storage_full_surface`` and
``::test_raw_shard_transfer_roundtrip``, then staged, gated, streamed,
packed and walked ones) answering alike and leaving byte-equal drives;
and the contract itself on both of the port's drives."""

import os
import shutil

import numpy as np
import pytest
import torch

from minio_tpu.parallel import rpc as ref_rpc
from minio_tpu.storage import datatypes as ref_dt
from minio_tpu.storage import remote as ref_remote
from minio_tpu.storage import xl_storage as ref_xl
from minio_tpu_torch.ops.hh import hh256_batch
from minio_tpu_torch.parallel import rpc as port_rpc
from minio_tpu_torch.storage import datatypes as port_dt
from minio_tpu_torch.storage import health as port_health
from minio_tpu_torch.storage import remote as port_remote
from minio_tpu_torch.storage import xl_storage as port_xl
from minio_tpu_torch.storage.api import StorageAPI

from ._torch_cluster import Clients, cluster_state_left
from ._torch_versions import tree

BS = 4096
PKG = {"ref": (ref_rpc, ref_remote, ref_xl, ref_dt),
       "port": (port_rpc, port_remote, port_xl, port_dt)}


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with cluster_state_left():
        yield


@pytest.fixture
def small_stream(monkeypatch):
    """Both packages stream bodies over 4 KiB in frames."""
    for m in (ref_rpc, port_rpc):
        monkeypatch.setattr(m.STREAM, "chunk_bytes", 4096)
        monkeypatch.setattr(m.STREAM, "enable", True)
        monkeypatch.setattr(m.STREAM, "_loaded", True)


def _framed(payload: bytes) -> bytes:
    """A part file of ``payload`` framed as one data shard at ``BS``."""
    out = bytearray()
    for off in range(0, len(payload), BS):
        blk = payload[off:off + BS]
        out += hh256_batch(torch.frombuffer(bytearray(blk), dtype=torch.uint8)
                           .reshape(1, -1))[0].numpy().tobytes() + blk
    return bytes(out)


def _fi(dt, vid: str, ddir: str, size: int, **kw):
    return dt.FileInfo(
        version_id=vid, data_dir=ddir, mod_time=1_700_000_000_000_000_000,
        size=size, metadata={"etag": "e"},
        parts=[dt.ObjectPartInfo(1, size, size, "e", 0)] if size else [],
        erasure=dt.ErasureInfo(
            data_blocks=1, parity_blocks=1, block_size=BS, index=1,
            distribution=[1, 2],
            checksums=[dt.ChecksumInfo(1, "highwayhash256S", b"")]), **kw)


def _surface(remote, dt, sysvol: str) -> list:
    """One sequence of every StorageAPI call; each answer, or the error's
    type, in order."""
    rng = np.random.default_rng(3)
    blob = rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    part = _framed(blob[:5000])
    out = []

    def rec(fn, *a, **kw):
        try:
            r = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — typed over the wire
            out.append(("err", type(e).__name__))
            return None
        if hasattr(r, "to_dict"):
            r = r.to_dict()
        elif isinstance(r, list) and r and hasattr(r[0], "to_dict"):
            r = [x.to_dict() for x in r]
        elif isinstance(r, list) and r and hasattr(r[0], "name"):
            r = [x.name for x in r]
        elif hasattr(r, "created"):
            r = r.name
        out.append(r)
        return r

    rec(remote.make_vol, "bkt")
    rec(remote.make_vol, "bkt")
    rec(remote.make_vol, "rawbkt")
    rec(remote.write_all, "bkt", "a/b", b"hello")
    rec(remote.read_all, "bkt", "a/b")
    rec(remote.read_file_stream, "bkt", "a/b", 1, 3)
    rec(remote.stat_info_file, "bkt", "a/b")
    rec(remote.stat_info_file, "bkt", "a")
    rec(remote.list_vols)
    rec(remote.stat_vol, "bkt")
    rec(remote.stat_vol, "nope")
    rec(remote.read_all, "bkt", "missing")
    rec(remote.list_dir, "bkt", "a")
    rec(remote.list_dir, "bkt", "", 1)
    rec(remote.list_dir, "bkt", "nope")
    # metadata
    rec(remote.write_metadata, "bkt", "obj",
        _fi(dt, "v1", "", 5, inline_data=b"inline"))
    rec(remote.read_version, "bkt", "obj")
    upd = _fi(dt, "v1", "", 5, inline_data=b"inline")
    upd.metadata["x-amz-meta-k"] = "v"
    rec(remote.update_metadata, "bkt", "obj", upd)
    rec(remote.update_metadata, "bkt", "obj", _fi(dt, "v9", "", 5))
    rec(remote.read_version, "bkt", "obj", "v1")
    rec(remote.read_version, "bkt", "obj", "v2")
    rec(remote.list_versions, "bkt", "obj")
    # raw bodies: whole, then streamed in frames, both ways
    rec(remote.create_file, "rawbkt", "big/shard", blob[:3000])
    rec(remote.append_file, "rawbkt", "big/shard", blob)
    rec(remote.read_file_stream, "rawbkt", "big/shard", 0, 3000)
    rec(remote.read_file_stream, "rawbkt", "big/shard", 100, 22000)
    rec(remote.read_file_stream, "rawbkt", "nope", 0, 10)
    rec(remote.read_file_stream, "rawbkt", "big/shard", 22000, 4000)
    rec(remote.create_file, "rawbkt", "sized", b"abc", file_size=99)
    rec(remote.create_file, "rawbkt", "sized2", blob, file_size=20001)
    rec(remote.stat_info_file, "rawbkt", "sized2")
    rec(remote.create_file, "rawbkt", "streamed", blob, file_size=20000)
    # a staged part, renamed into place, checked and verified
    tmp = remote.tmp_dir()
    out.append(tmp.startswith("tmp/"))
    rec(remote.create_file, sysvol, f"{tmp}/part.1", part)
    fi2 = _fi(dt, "v2", "dd2", 5000)
    rec(remote.rename_data, sysvol, tmp, fi2, "bkt", "obj2")
    rec(remote.clean_tmp, tmp)
    rec(remote.check_parts, "bkt", "obj2", fi2)
    rec(remote.verify_file, "bkt", "obj2", fi2)
    rec(remote.check_parts, "bkt", "obj2", _fi(dt, "v2", "dd2", 4000))
    rec(remote.rename_file, "bkt", "a/b", "bkt", "a/c")
    rec(remote.read_all, "bkt", "a/c")
    # single-part commits: whole, streamed with a gated trailer, aborted
    rec(remote.write_data_commit, "bkt", "obj3", _fi(dt, "v3", "dd3", 5000),
        part, shard_index=2)
    gated = _fi(dt, "v4", "dd4", 20000)
    vd = dict(gated.to_dict(), meta={"etag": "gated"})
    rec(remote.write_data_commit, "bkt", "obj4", gated, blob,
        meta_gate=lambda: vd)
    rec(remote.read_version, "bkt", "obj4")

    def abort():
        raise ValueError("BadDigest")
    rec(remote.write_data_commit, "bkt", "obj5", _fi(dt, "v5", "dd5", 20000),
        blob, meta_gate=abort)
    rec(remote.read_version, "bkt", "obj5")
    # packed
    small = _framed(blob[:3000])
    rec(remote.write_packed, "bkt", "obj6", _fi(dt, "v6", "", 3000), small,
        shard_index=1)
    seg = (rec(remote.read_version, "bkt", "obj6") or {}).get("seg")
    out.append(seg is not None and remote.read_segment(
        seg["sid"], seg["off"], seg["len"]) == small)
    # walks
    rec(lambda: list(remote.walk_dir("bkt")))
    rec(lambda: list(remote.walk_dir("bkt", "obj2", recursive=False)))
    for versions in (False, True):
        got = list(remote.walk_entries("bkt", "", versions=versions)
                   if isinstance(remote, port_remote.RemoteStorage)
                   else remote.walk_entries("bkt", "", True, versions))
        out.append([(e["name"], e["fis"]) if isinstance(e, dict) else
                    (e[0], [f.to_dict() for f in
                            (e[1] if versions else [e[1]])])
                    for e in got])
    # deletes
    rec(remote.delete_version, "bkt", "obj", _fi(dt, "v1", "", 5))
    rec(remote.read_version, "bkt", "obj")
    rec(remote.delete_version, "bkt", "objX", _fi(dt, "vd", "", 0,
                                                  deleted=True), True)
    rec(remote.read_version, "bkt", "objX")
    rec(remote.delete, "bkt", "a/c")
    rec(remote.delete, "bkt", "a/c")
    rec(remote.delete_vol, "rawbkt")
    rec(remote.delete_vol, "rawbkt", True)
    rec(remote.list_vols)
    # identity
    rec(remote.set_disk_id, "disk-1")
    rec(remote.get_disk_id)
    info = remote.disk_info()
    out.append((sorted(vars(info)), info.disk_id, info.total > 0))
    return out


def _run(cpkg: str, spkg: str, root) -> tuple[list, dict]:
    crpc, cremote, cxl, cdt = PKG[cpkg]
    srpc, sremote, sxl, _ = PKG[spkg]
    os.makedirs(root)
    local = sxl.XLStorage(str(root))
    srv = srpc.RPCServer("k")
    sremote.register_storage_service(srv, {"drive0": local})
    srv.start()
    clients = Clients()
    try:
        remote = cremote.RemoteStorage(clients(cpkg, srv.endpoint, "k"),
                                       "drive0")
        answers = _surface(remote, cdt, cxl.SYS_DIR)
    finally:
        clients.close()
        srv.stop()
        local.close()
    files = {k: v for k, v in tree(root).items()
             if "/.mt.sys/tmp/" not in f"/{k}"}
    return answers, files


def test_every_call_answers_alike_both_ways(tmp_path, small_stream):
    runs = {(c, s): _run(c, s, tmp_path / f"{c}-{s}")
            for c, s in (("ref", "ref"), ("port", "ref"), ("ref", "port"),
                         ("port", "port"))}
    want, want_files = runs[("ref", "ref")]
    assert ("err", "FileCorrupt") in want and want[-1][2]
    for key, (answers, files) in runs.items():
        assert answers == want, key
        assert files == want_files, key
    # the aborted gated commit left no part behind
    assert not [k for k in want_files if "dd5" in k]


@pytest.mark.parametrize("cpkg,spkg", [("ref", "ref"), ("ref", "port"),
                                       ("port", "ref")])
def test_a_packed_shard_longer_than_a_frame(tmp_path, small_stream, cpkg,
                                            spkg):
    """Queue 3 record 61: the reference's client frames a packed shard
    longer than ``stream_chunk_bytes`` and its server writes the frames
    as a plain file at the object's path; the port's client sends it
    whole and the port's server packs it."""
    crpc, cremote, _, cdt = PKG[cpkg]
    srpc, sremote, sxl, _ = PKG[spkg]
    local = sxl.XLStorage(str(tmp_path))
    srv = srpc.RPCServer("k")
    sremote.register_storage_service(srv, {"drive0": local})
    srv.start()
    clients = Clients()
    try:
        remote = cremote.RemoteStorage(clients(cpkg, srv.endpoint, "k"),
                                       "drive0")
        remote.make_vol("bkt")
        part = _framed(bytes(range(256)) * 20)
        remote.write_packed("bkt", "obj", _fi(cdt, "v", "", 5120), part)
        packed = os.path.isdir(tmp_path / "bkt" / "obj")
    finally:
        clients.close()
        srv.stop()
        local.close()
    assert packed == ((cpkg, spkg) != ("ref", "ref"))


def test_the_contract_holds_on_the_ports_drives(tmp_path):
    abstract = StorageAPI.__abstractmethods__
    d = port_xl.XLStorage(str(tmp_path))
    hd = port_health.HealthDisk(d)
    rs = port_remote.RemoteStorage(port_rpc.RPCClient(
        "http://127.0.0.1:1", "k"), "drive0")
    for drive in (d, hd, rs):
        assert isinstance(drive, StorageAPI)
        assert all(callable(getattr(drive, m)) for m in abstract)
    ref = {n for n in dir(ref_xl.XLStorage) if not n.startswith("_")}
    assert set(abstract) <= ref


@pytest.mark.parametrize("spkg", ["ref", "port"])
def test_reopen_over_the_wire(tmp_path, spkg):
    """A peer takes back a drive that returned empty: a port server
    recreates its staging root, a reference server has no such call and
    the port's client lets it be."""
    srpc, sremote, sxl, _ = PKG[spkg]
    local = sxl.XLStorage(str(tmp_path))
    srv = srpc.RPCServer("k")
    sremote.register_storage_service(srv, {"drive0": local})
    srv.start()
    clients = Clients()
    try:
        remote = port_remote.RemoteStorage(clients("port", srv.endpoint,
                                                   "k"), "drive0")
        shutil.rmtree(tmp_path / ".mt.sys")
        remote.make_vol(".mt.sys")
        remote.reopen()
        assert (tmp_path / ".mt.sys" / "tmp").is_dir() == (spkg == "port")
    finally:
        clients.close()
        srv.stop()
        local.close()
