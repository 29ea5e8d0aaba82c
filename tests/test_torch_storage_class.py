"""Storage classes on the port's S3 server against ``minio_tpu``'s
(ROADMAP Queue 3 item 41: the port refused a part of an upload that
another package began with another storage class, and listed STANDARD
for every object).

One set of eight drives (parity 4 by default; REDUCED_REDUNDANCY is
``EC:2``, six data and two parity shards), 4 KiB blocks.  One package's
server begins a REDUCED_REDUNDANCY multipart upload and stops; the
other's, over the same drives, adds a 5 MiB part and a short last one,
completes it and PUTs a REDUCED_REDUNDANCY object.  All four pairings of
the packages run the same calls with one pinned clock and uuid counter
(``_torch_versions.pin(shared=True)``), and every run leaves the drives
the reference alone leaves.  Then GET, a range, HEAD and the listings
answer alike through either package's server, also with two drives that
hold data shards wiped (a degraded read rebuilds them), and a heal by
either package writes the same shards back."""

import base64
import os
import shutil
import threading

import pytest

import minio_tpu.s3.handlers_object as ref_ho
from minio_tpu import server_main as ref_main
from minio_tpu.objectlayer import hotread as ref_hotread
from minio_tpu.storage import commit as ref_commit
from minio_tpu_torch import server_main as port_main
from minio_tpu_torch.objectlayer import metadata as port_meta
from minio_tpu_torch.ops import rs_fused, rs_kernels
from minio_tpu_torch.s3 import handlers_object as port_ho
from minio_tpu_torch.storage import commit as port_commit

from ._torch_control import (AK, BATCH, BS, SK, THRESHOLD, both, client,
                             servers)
from ._torch_objfeat import S3NS, tree, wire
from ._torch_versions import (BATCH as LAYER_BATCH, ENGINES, N as N6,
                              assert_trees_equal, body, close, pin,
                              port_layer, put_opts, ref_layer)

N = 8
# one master key for both: no server mints one onto the drives
MASTER = "rrs-key:" + base64.b64encode(bytes(32)).decode()
RRS = {"x-amz-storage-class": "REDUCED_REDUNDANCY"}
PARTS = [body(5 << 20, 1), body(300_000, 2)]
SINGLE = body(400_000, 3)
VARIANTS = [("ref", "ref"), ("ref", "port"), ("port", "ref"),
            ("port", "port")]
MAINS = {"ref": ref_main, "port": port_main}


def _serve(pkg: str, root):
    dirs = [str(root / f"d{i}") for i in range(N)]
    kw = {"device": "cpu"} if pkg == "port" else {"backend": "numpy"}
    srv = MAINS[pkg].build_server(dirs, "127.0.0.1:0", AK, SK,
                                  block_size=BS, set_drive_count=N, **kw)
    srv.start()
    return srv


def _stop(srv) -> None:
    srv.stop()
    for t in threading.enumerate():
        # a heal-on-return sweep the drive monitor started writes on,
        # and ticks the process's commit counters, after the stop
        if t.name == "mt-drive-heal-kick":
            t.join(60)
    if srv.__module__.startswith("minio_tpu."):
        # the reference's stop leaves its drive monitor and pools alive
        srv.layer.monitor.stop()
        for s in srv.layer.sets:
            s._pool.shutdown(wait=True)


def _answers(srv) -> dict:
    """What a client sees of the two objects."""
    c = client(srv)
    out = {}
    for key in ("mp", "single"):
        out[f"get-{key}"] = c.request("GET", f"/rrs/{key}", expect=())
        out[f"head-{key}"] = c.request("HEAD", f"/rrs/{key}", expect=())
        out[f"range-{key}"] = c.request(
            "GET", f"/rrs/{key}", headers={"Range": "bytes=299990-300009"},
            expect=())
    for q in ("", "list-type=2", "versions"):
        out[f"list-{q}"] = c.request("GET", "/rrs", q, expect=())
    return out


def _run(root, begin: str, finish: str) -> dict:
    """One pairing of the sequence; the finisher's answers."""
    mp = pytest.MonkeyPatch()
    saved = (dict(ref_hotread.CONFIG.__dict__),
             dict(ref_commit.CONFIG.__dict__),
             dict(port_commit.CONFIG.__dict__))
    try:
        mp.setenv("MT_CACHE_ENABLE", "off")
        mp.setenv("MT_CRAWL_INTERVAL_S", "1000000")
        mp.setenv("MINIO_TPU_KMS_SECRET_KEY", MASTER)
        pin(mp, shared=True, batch=BATCH)
        for mod in (ref_ho, port_ho):
            mp.setattr(mod, "STREAM_PUT_THRESHOLD", THRESHOLD)
        srv = _serve(begin, root)
        try:
            c = client(srv)
            c.make_bucket("rrs")
            uid = c.create_multipart_upload("rrs", "mp", headers=RRS)
        finally:
            _stop(srv)
        srv = _serve(finish, root)
        try:
            c = client(srv)
            etags = [c.upload_part("rrs", "mp", uid, n, p)
                     for n, p in enumerate(PARTS, 1)]
            c.complete_multipart_upload("rrs", "mp", uid,
                                        list(enumerate(etags, 1)))
            c.put_object("rrs", "single", SINGLE, headers=RRS)
            info = srv.layer.get_object_info("rrs", "mp")
            assert (info.data_blocks, info.parity) == (6, 2)
            return _answers(srv)
        finally:
            _stop(srv)
    finally:
        mp.undo()
        ref_hotread.CONFIG.__dict__.update(saved[0])
        ref_commit.CONFIG.__dict__.update(saved[1])
        port_commit.CONFIG.__dict__.update(saved[2])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("rrs")
    out = {}
    for begin, finish in VARIANTS:
        root = base / f"{begin}-{finish}"
        out[(begin, finish)] = (root, _run(root, begin, finish))
    return out


def _drives(root) -> list[dict]:
    return [tree(str(root / f"d{i}")) for i in range(N)]


@pytest.mark.parametrize("variant", VARIANTS, ids="-".join)
def test_an_upload_another_package_began_completes(runs, variant):
    _, got = runs[variant]
    assert got["get-mp"].status == 200
    assert got["get-mp"].body == b"".join(PARTS)
    assert got["get-single"].body == SINGLE
    for key in ("mp", "single"):
        assert got[f"head-{key}"].headers["x-amz-storage-class"] == \
            "REDUCED_REDUNDANCY"
        assert got[f"range-{key}"].status == 206


@pytest.mark.parametrize("variant", VARIANTS[1:], ids="-".join)
def test_answers_equal_the_references(runs, variant):
    _, want = runs[("ref", "ref")]
    _, got = runs[variant]
    for name in want:
        assert wire(got[name]) == wire(want[name]), name


def test_listings_report_the_class(runs):
    _, got = runs[("port", "port")]
    for q in ("", "list-type=2"):
        classes = [c.findtext(f"{S3NS}StorageClass")
                   for c in got[f"list-{q}"].xml().iter(f"{S3NS}Contents")]
        assert classes == ["REDUCED_REDUNDANCY"] * 2


@pytest.mark.parametrize("variant", VARIANTS[1:], ids="-".join)
def test_drives_equal_the_references(runs, variant):
    want = _drives(runs[("ref", "ref")][0])
    got = _drives(runs[variant][0])
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), f"drive {i} files differ"
        for path in w:
            assert g[path] == w[path], f"drive {i}: {path} differs"


def _data_drives(key: str, k: int = 6) -> list[int]:
    """Two drives that hold data shards of ``rrs/key``."""
    dist = port_meta.hash_order(f"rrs/{key}", N)
    return [j for j in range(N) if dist[j] <= k][:2]


def test_degraded_reads_and_heals_alike(runs, tmp_path):
    """Two data shards of each object wiped: both packages' servers read
    the objects back through the rebuild, and a heal by either package
    leaves the drives of a heal by the other."""
    roots = {}
    for pkg in ("ref", "port"):
        roots[pkg] = tmp_path / pkg
        shutil.copytree(runs[(pkg, pkg)][0], roots[pkg], symlinks=True)
        for key in ("mp", "single"):
            for j in _data_drives(key):
                shutil.rmtree(roots[pkg] / f"d{j}" / "rrs" / key)
    for reader in ("ref", "port"):
        srv = _serve(reader, roots["port"])
        try:
            c = client(srv)
            plain = rs_kernels.COUNTS.plain
            assert c.get_object("rrs", "mp").body == b"".join(PARTS)
            if reader == "port":        # the rebuild ran Kernel A's plain
                assert rs_kernels.COUNTS.plain > plain
            assert c.get_object("rrs", "single").body == SINGLE
            assert c.get_object("rrs", "mp", (5 << 20, (5 << 20) + 99)) \
                .body == PARTS[1][:100]
        finally:
            _stop(srv)
    for pkg in ("ref", "port"):
        srv = _serve(pkg, roots[pkg])
        try:
            for key in ("mp", "single"):
                srv.layer.heal_object("rrs", key)
        finally:
            _stop(srv)
    for i, (g, w) in enumerate(zip(_drives(roots["port"]),
                                   _drives(roots["ref"]))):
        g = {p: b for p, b in g.items() if p.startswith("rrs/")}
        w = {p: b for p, b in w.items() if p.startswith("rrs/")}
        assert sorted(g) == sorted(w), f"drive {i} files differ"
        for path in w:
            assert g[path] == w[path], f"drive {i}: {path} differs"
    for key in ("mp", "single"):
        for j in _data_drives(key):
            assert os.path.exists(roots["port"] / f"d{j}" / "rrs" / key /
                                  "xl.meta")


@pytest.mark.parametrize("cls,status", [("STANDARD", 200), ("GLACIER", 400),
                                        ("reduced_redundancy", 200)])
def test_classes_are_judged_alike(runs, tmp_path, cls, status):
    """A class the reference does not know is InvalidStorageClass before
    anything is stored; STANDARD and a lower-case RRS are taken."""
    root = tmp_path / "cls"
    shutil.copytree(runs[("ref", "ref")][0], root, symlinks=True)
    got = {}
    for pkg in ("ref", "port"):
        srv = _serve(pkg, root)
        try:
            got[pkg] = client(srv).request(
                "PUT", "/rrs/k", body=b"x" * 100,
                headers={"x-amz-storage-class": cls}, expect=())
        finally:
            _stop(srv)
    assert got["port"].status == got["ref"].status == status
    assert wire(got["port"])[2] == wire(got["ref"])[2]


@pytest.mark.parametrize("value,status", [("EC:2", 200), ("EC:1", 200),
                                          ("EC:3", 400),
                                          ("EC:9", 400), ("RS:2", 400)])
def test_a_class_is_judged_when_it_is_set(tmp_path, value, status):
    """The admin route refuses an ``EC:`` value the set size cannot take,
    as the reference's does, before it is stored."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MINIO_TPU_KMS_SECRET_KEY", MASTER)
    try:
        with servers(tmp_path, mp) as (ref, port):
            r, p = both(ref, port, "PUT",
                        "/minio-tpu/admin/v1/config/storage_class/rrs",
                        body=value.encode())
            assert p.status == r.status == status
            assert port.config.get("storage_class", "rrs") == \
                ref.config.get("storage_class", "rrs")
    finally:
        mp.undo()


# -- the layer: another geometry on the device set and the mesh set ----------

@pytest.mark.parametrize("engine", ENGINES)
def test_a_put_and_an_upload_of_another_parity_equal_the_references(
        tmp_path, monkeypatch, engine):
    """PutObjectOptions.parity: a whole PUT, a streamed one and an
    upload's parts in that geometry (on a mesh set through Kernel C's
    plain version with its own plan), the drives the reference's."""
    pin(monkeypatch)
    ref, port = ref_layer(tmp_path / "ref"), port_layer(tmp_path / "port",
                                                        engine)
    try:
        for lay in (ref, port):
            lay.make_bucket("geo")
            for name, size in (("small", 1000), ("part", 200_000),
                               ("stream", 200_000 + 3 * LAYER_BATCH)):
                lay.put_object("geo", name, body(size, 4),
                               put_opts(lay, parity=1))
            uid = lay.new_multipart_upload("geo", "mp",
                                           put_opts(lay, parity=1))
            etags = [lay.put_object_part("geo", "mp", uid, n,
                                         body(70_000, n)).etag
                     for n in (1, 2)]
            lay.complete_multipart_upload("geo", "mp", uid,
                                          list(enumerate(etags, 1)))
        for name in ("small", "part", "stream", "mp"):
            info = port.get_object_info("geo", name)
            assert (info.data_blocks, info.parity) == (N6 - 1, 1)
        assert port.get_object("geo", "mp")[1] == body(70_000, 1) + \
            body(70_000, 2)
        if engine == "mesh":
            assert port._codec_for(1).mesh is port.codec.mesh
    finally:
        close(ref, port)
    assert_trees_equal(tmp_path / "port", tmp_path / "ref")


def test_a_mesh_set_names_a_geometry_kernel_c_cannot_take(tmp_path,
                                                          monkeypatch):
    port = port_layer(tmp_path, "mesh")

    def refuse(B, k, ro, n, hash_parity=True):
        raise ValueError("too many rows")
    monkeypatch.setattr(rs_fused, "plan", refuse)
    try:
        port.make_bucket("geo")
        with pytest.raises(ValueError, match="5 data \\+ 1 parity"):
            port.put_object("geo", "k", b"x" * 1000,
                            put_opts(port, parity=1))
        with pytest.raises(ValueError, match="out of range"):
            port.put_object("geo", "k", b"x", put_opts(port, parity=4))
    finally:
        port.close()
