"""The port's multipart uploads against minio_tpu's, on the CPU.

Six drives, parity 2, 4 KiB blocks and 64 KiB stream batches, with the
minimum part size off, so parts of a few blocks stand for real ones and
a part of 2.5 batches streams through the pipeline in three.  The same
numpy-seeded sequence runs through ``minio_tpu``'s ``ErasureObjects(
backend="numpy")`` and through the port on ``device="cpu"`` and on a
1 x 1 CPU mesh, with both packages' clocks and uuid draws pinned to
counters: after every step the drives hold the same bytes (staged
parts, sidecars, upload xl.meta, the completed object's part files and
xl.meta), the listings and errors agree, each package reads and heals
what the other wrote and finishes the other's uploads.  The tolerance
is exact: all of this is bytes.
"""

import hashlib
import io
import shutil
import threading

import pytest

import minio_tpu.objectlayer.erasure_object as ref_eo
from minio_tpu.objectlayer import interface as ref_ol
from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.ops import hh, rs_kernels

from ._torch_versions import (BATCH, BS, ENGINES, M, N, assert_trees_equal,
                              body, close, drive_numbers, is_port, pin,
                              port_layer, put_opts, ref_layer)

BKT = "mpb"
# out of order, part 2 sent twice (the retry wins), a part of 2.5
# batches from a reader, the last part empty
PART_SIZES = {1: 3 * BS + 5, 2: 2 * BS, 3: BATCH * 5 // 2 + 17, 4: 0}
UPLOAD_ORDER = [(3, 0), (1, 0), (2, 0), (2, 1), (4, 0)]


def _part_body(num: int, seed: int) -> bytes:
    return body(PART_SIZES[num], 10 * num + seed)


def _upload(lay, key: str) -> tuple[str, list]:
    """A new upload and its parts in UPLOAD_ORDER; returns (upload id,
    [(part number, ETag)] of the parts that count)."""
    uid = lay.new_multipart_upload(BKT, key, put_opts(
        lay, user_defined={"content-type": "application/x-mp",
                           "x-amz-meta-k": "v"}))
    etags = {}
    for num, seed in UPLOAD_ORDER:
        data = _part_body(num, seed)
        src = io.BytesIO(data) if num == 3 else data
        pi = lay.put_object_part(BKT, key, uid, num, src)
        assert pi.etag == hashlib.md5(data).hexdigest()
        assert pi.size == len(data)
        etags[num] = pi.etag
    return uid, sorted(etags.items())


def _want_body() -> bytes:
    return b"".join(_part_body(n, 1 if n == 2 else 0) for n in PART_SIZES)


def _part_rows(parts) -> list:
    return [(p.part_number, p.etag, p.size) for p in parts]


@pytest.fixture
def pair(tmp_path, monkeypatch, request):
    pin(monkeypatch)
    port = port_layer(tmp_path / "port", request.param)
    ref = ref_layer(tmp_path / "ref")
    for lay in (port, ref):
        lay.make_bucket(BKT)
    yield tmp_path, port, ref
    close(port, ref)


@pytest.mark.parametrize("pair", ENGINES, indirect=True)
def test_upload_complete_and_abort_match_reference(pair):
    root, port, ref = pair
    up = {}
    for lay in (port, ref):
        up[is_port(lay)] = _upload(lay, "obj/a")
    assert up[True] == up[False]
    assert_trees_equal(root / "port", root / "ref")
    uid, parts = up[True]
    assert _part_rows(port.list_object_parts(BKT, "obj/a", uid)) == \
        _part_rows(ref.list_object_parts(BKT, "obj/a", uid))
    # a second upload to abort, and a listing of both
    other = {is_port(lay): lay.new_multipart_upload(BKT, "obj/b")
             for lay in (port, ref)}
    assert other[True] == other[False]
    for lay in (port, ref):
        lay.put_object_part(BKT, "obj/b", other[True], 1, body(5000, 3))
    rows = [[(u.object_name, u.upload_id, u.user_defined)
             for u in lay.list_multipart_uploads(BKT, "obj/")]
            for lay in (port, ref)]
    assert rows[0] == rows[1] and len(rows[0]) == 2
    assert port.get_multipart_info(BKT, "obj/a", uid).user_defined == \
        {"content-type": "application/x-mp", "x-amz-meta-k": "v"}
    assert_trees_equal(root / "port", root / "ref")

    infos = [lay.complete_multipart_upload(BKT, "obj/a", uid, parts)
             for lay in (port, ref)]
    for lay in (port, ref):
        lay.abort_multipart_upload(BKT, "obj/b", other[True])
    want = _want_body()
    md5s = b"".join(bytes.fromhex(e) for _, e in parts)
    assert infos[0].etag == infos[1].etag == \
        hashlib.md5(md5s).hexdigest() + "-4"
    assert infos[0].size == len(want)
    assert_trees_equal(root / "port", root / "ref")
    assert not list(root.glob("*/d*/.mt.sys/multipart"))
    for lay in (port, ref):
        assert lay.list_multipart_uploads(BKT) == []
        info, got = lay.get_object(BKT, "obj/a")
        assert got == want
        assert info.parts == [(n, PART_SIZES[n]) for n in PART_SIZES]


@pytest.mark.parametrize("pair", ENGINES, indirect=True)
def test_ranges_across_parts(pair):
    root, port, ref = pair
    uid, parts = _upload(port, "r")
    port.complete_multipart_upload(BKT, "r", uid, parts)
    want = _want_body()
    ends = [0]
    for n in PART_SIZES:
        ends.append(ends[-1] + PART_SIZES[n])
    b1, b2 = ends[1], ends[2]
    for lo, ln in [(0, 1), (b1 - 3, 6), (b1 - BS, BS + 2 * BS + 1),
                   (b2 - 1, 2), (b1 + 7, BATCH + 3 * BS), (b2, BATCH),
                   (len(want) - 5, 100), (-9, -1), (BS - 1, 3)]:
        assert port.get_object(BKT, "r", lo, ln)[1] == (
            want[lo:lo + ln] if lo >= 0 else want[lo:])
    with pytest.raises(port_ol.InvalidRange):
        port.get_object(BKT, "r", len(want), 1)
    # the reference reads the port's object, the port reads it degraded
    ref_on_port = type(ref)([type(ref.disks[0])(d.root) for d in port.disks],
                            parity=M, block_size=BS, backend="numpy")
    try:
        assert ref_on_port.get_object(BKT, "r")[1] == want
    finally:
        close(ref_on_port)


def _wipe(root, lay, key: str, count: int) -> list[int]:
    """Remove the object from the drives of its first ``count`` data
    shards; returns the drive numbers."""
    fi, _ = lay._read_quorum_fileinfo(BKT, key)
    victims = [d for d, s in enumerate(fi.erasure.distribution)
               if s <= count]
    for d in victims:
        shutil.rmtree(f"{root}/d{d}/{BKT}/{key}")
    return victims


@pytest.mark.parametrize("pair", ENGINES, indirect=True)
def test_degraded_get_and_heal_match_reference(pair):
    root, port, ref = pair
    for lay in (port, ref):
        uid, parts = _upload(lay, "h")
        lay.complete_multipart_upload(BKT, "h", uid, parts)
    want = _want_body()
    victims = _wipe(root / "port", port, "h", M)
    assert _wipe(root / "ref", ref, "h", M) == victims
    plain = rs_kernels.COUNTS.plain
    assert port.get_object(BKT, "h")[1] == want
    assert rs_kernels.COUNTS.plain > plain, "no reconstruction ran"
    assert port.get_object(BKT, "h", BS, 3 * BS)[1] == want[BS:4 * BS]
    verify = hh.COUNTS.plain
    results = [lay.heal_object(BKT, "h") for lay in (port, ref)]
    # one verify per part of the sources, one frame per rebuilt part
    assert hh.COUNTS.plain - verify >= 2 * len(PART_SIZES) - 1
    for field in ("version_id", "before_ok", "after_ok", "dangling_purged"):
        assert getattr(results[0], field) == getattr(results[1], field)
    assert drive_numbers(results[0].healed_disks) == \
        drive_numbers(results[1].healed_disks) == sorted(victims)
    assert_trees_equal(root / "port", root / "ref")
    # the healed drives serve: wipe two others
    others = [d for d in range(N) if d not in victims][:M]
    for d in others:
        shutil.rmtree(f"{root}/port/d{d}/{BKT}/h")
    assert port.get_object(BKT, "h")[1] == want


@pytest.mark.parametrize("first", ["ref", "port"])
def test_each_package_finishes_the_others_upload(tmp_path, monkeypatch,
                                                 first):
    """An upload begun by one package on a set of drives gets parts from
    both and is completed by the other; the drives then equal those of
    the same sequence through the reference alone, and both read it."""
    pin(monkeypatch, shared=True)
    ref, port = ref_layer(tmp_path / "x"), port_layer(tmp_path / "x")
    solo = ref_layer(tmp_path / "solo")
    try:
        ref.make_bucket(BKT)
        a, b = (ref, port) if first == "ref" else (port, ref)
        uid = a.new_multipart_upload(BKT, "x")
        p1 = a.put_object_part(BKT, "x", uid, 1, body(9000, 1))
        p2 = b.put_object_part(BKT, "x", uid, 2, body(7000, 2))
        info = b.complete_multipart_upload(
            BKT, "x", uid, [(1, p1.etag), (2, p2.etag)])
        pin(monkeypatch, shared=True)
        solo.make_bucket(BKT)
        suid = solo.new_multipart_upload(BKT, "x")
        s1 = solo.put_object_part(BKT, "x", suid, 1, body(9000, 1))
        s2 = solo.put_object_part(BKT, "x", suid, 2, body(7000, 2))
        sinfo = solo.complete_multipart_upload(
            BKT, "x", suid, [(1, s1.etag), (2, s2.etag)])
        assert (uid, info.etag) == (suid, sinfo.etag)
        assert_trees_equal(tmp_path / "x", tmp_path / "solo")
        for lay in (port, ref):
            assert lay.get_object(BKT, "x")[1] == \
                body(9000, 1) + body(7000, 2)
    finally:
        close(port, ref, solo)


@pytest.mark.parametrize("pair", ["device"], indirect=True)
def test_errors_match_reference(pair):
    root, port, ref = pair

    def outcome(fn):
        try:
            fn()
            return "ok"
        except (port_ol.ObjectLayerError, ref_ol.ObjectLayerError) as e:
            return type(e).__name__

    got = {}
    for lay in (port, ref):
        uid = lay.new_multipart_upload(BKT, "e")
        p1 = lay.put_object_part(BKT, "e", uid, 1, body(3 * BS, 1))
        p2 = lay.put_object_part(BKT, "e", uid, 2, body(BS, 2))
        cases = {
            "part 0": lambda: lay.put_object_part(BKT, "e", uid, 0, b"x"),
            "part 10001": lambda: lay.put_object_part(BKT, "e", uid, 10001,
                                                      b"x"),
            "unknown upload part": lambda: lay.put_object_part(
                BKT, "e", "nope", 1, b"x"),
            "unknown upload complete": lambda: lay.complete_multipart_upload(
                BKT, "e", "nope", [(1, p1.etag)]),
            "unknown upload list": lambda: lay.list_object_parts(
                BKT, "e", "nope"),
            "unknown upload abort": lambda: lay.abort_multipart_upload(
                BKT, "e", "nope"),
            "no parts": lambda: lay.complete_multipart_upload(BKT, "e", uid,
                                                              []),
            "descending": lambda: lay.complete_multipart_upload(
                BKT, "e", uid, [(2, p2.etag), (1, p1.etag)]),
            "wrong etag": lambda: lay.complete_multipart_upload(
                BKT, "e", uid, [(1, p2.etag), (2, p2.etag)]),
            "missing part": lambda: lay.complete_multipart_upload(
                BKT, "e", uid, [(1, p1.etag), (3, p2.etag)]),
            "no bucket": lambda: lay.new_multipart_upload("nobkt", "e"),
        }
        got[is_port(lay)] = {k: outcome(fn) for k, fn in cases.items()}
        # a small part that is not the last
        lay.enforce_min_part_size = True
        got[is_port(lay)]["too small"] = outcome(
            lambda: lay.complete_multipart_upload(
                BKT, "e", uid, [(1, p1.etag), (2, p2.etag)]))
        got[is_port(lay)]["too small, last"] = outcome(
            lambda: lay.complete_multipart_upload(BKT, "e", uid,
                                                  [(2, p2.etag)]))
    assert got[True] == got[False]
    assert got[True]["too small"] == "InvalidPart"
    assert got[True]["descending"] == "InvalidPartOrder"
    assert got[True]["unknown upload part"] == "InvalidUploadID"
    assert got[True]["too small, last"] == "ok"
    assert_trees_equal(root / "port", root / "ref")


def test_content_md5_and_concurrent_parts(tmp_path):
    """A part whose body is not its Content-MD5 is refused and leaves
    nothing; concurrent uploads of parts (the same number among them)
    stage under their own names and the last promote wins whole."""
    lay = port_layer(tmp_path)
    try:
        lay.make_bucket(BKT)
        uid = lay.new_multipart_upload(BKT, "c")
        data = body(5 * BS, 4)
        with pytest.raises(port_ol.BadDigest):
            lay.put_object_part(BKT, "c", uid, 1, io.BytesIO(data),
                                content_md5=hashlib.md5(b"x").hexdigest())
        assert lay.list_object_parts(BKT, "c", uid) == []
        staged = [p.name for p in tmp_path.glob("d*/.mt.sys/multipart/*/*/*")]
        assert staged and all(n == "xl.meta" for n in staged)
        bodies = {n: body(3 * BS + n, n) for n in range(1, 7)}
        retry = body(2 * BS, 70)
        errs = []

        def up(num, data):
            try:
                lay.put_object_part(BKT, "c", uid, num, data)
            except Exception as e:  # noqa: BLE001 — checked below
                errs.append(e)

        threads = [threading.Thread(target=up, args=(n, bodies[n]))
                   for n in bodies]
        threads.append(threading.Thread(target=up, args=(2, retry)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errs
        parts = {p.part_number: p for p in
                 lay.list_object_parts(BKT, "c", uid)}
        assert sorted(parts) == list(range(1, 7))
        # part 2 is whichever upload promoted last, never a mix
        assert parts[2].etag in (hashlib.md5(bodies[2]).hexdigest(),
                                 hashlib.md5(retry).hexdigest())
        info = lay.complete_multipart_upload(
            BKT, "c", uid, [(n, parts[n].etag) for n in sorted(parts)])
        got = lay.get_object(BKT, "c")[1]
        two = bodies[2] if parts[2].etag == hashlib.md5(
            bodies[2]).hexdigest() else retry
        assert got == b"".join(two if n == 2 else bodies[n]
                               for n in range(1, 7))
        assert info.size == len(got)
        assert not [p for p in tmp_path.glob("d*/.mt.sys/multipart")]
    finally:
        lay.close()


def test_heal_of_a_small_multipart_object_writes_part_files(tmp_path):
    """A multi-part object of at most 128 KiB heals into part files, one
    per part, and the healed drive serves it.  (minio_tpu writes such an
    object's last part inline when it heals it,
    ``minio_tpu/objectlayer/healing.py:217``, and a GET that needs the
    healed drive then returns another body; the oracle is the body.)"""
    lay = port_layer(tmp_path)
    try:
        lay.make_bucket(BKT)
        uid = lay.new_multipart_upload(BKT, "s")
        parts = [(n, lay.put_object_part(BKT, "s", uid, n,
                                         body(10000, n)).etag)
                 for n in (1, 2)]
        lay.complete_multipart_upload(BKT, "s", uid, parts)
        shutil.rmtree(f"{tmp_path}/d0/{BKT}/s")
        res = lay.heal_object(BKT, "s")
        assert drive_numbers(res.healed_disks) == [0]
        (ddir,) = [p for p in (tmp_path / "d0" / BKT / "s").iterdir()
                   if p.is_dir()]
        assert sorted(p.name for p in ddir.iterdir()) == ["part.1",
                                                          "part.2"]
        for d in (1, 2):
            shutil.rmtree(f"{tmp_path}/d{d}/{BKT}/s")
        assert lay.get_object(BKT, "s")[1] == body(10000, 1) + body(10000, 2)
    finally:
        lay.close()


def test_single_core_upload_and_heal_match_reference(tmp_path, monkeypatch):
    """With one core both packages stage parts and heal in line, without
    the writer plane: the drives still equal after the upload, the
    complete and a heal of two wiped drives."""
    pin(monkeypatch)
    monkeypatch.setattr(port_eo, "SERIAL_FANOUT", True)
    monkeypatch.setattr(ref_eo, "_SINGLE_CORE", True)
    port, ref = port_layer(tmp_path / "port"), ref_layer(tmp_path / "ref")
    try:
        assert not port._pipeline_on() and not ref._pipeline_on()
        for lay in (port, ref):
            lay.make_bucket(BKT)
            uid, parts = _upload(lay, "s")
            lay.complete_multipart_upload(BKT, "s", uid, parts)
        assert_trees_equal(tmp_path / "port", tmp_path / "ref")
        victims = _wipe(tmp_path / "port", port, "s", M)
        assert _wipe(tmp_path / "ref", ref, "s", M) == victims
        got, want = (lay.heal_object(BKT, "s") for lay in (port, ref))
        assert drive_numbers(got.healed_disks) == \
            drive_numbers(want.healed_disks) == sorted(victims)
        assert_trees_equal(tmp_path / "port", tmp_path / "ref")
        assert port.get_object(BKT, "s")[1] == _want_body()
        assert not port._write_plane.threads()
    finally:
        close(port, ref)
