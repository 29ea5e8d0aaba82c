"""The port's listing and bucket calls against minio_tpu's over the same
drives, on the CPU.

``minio_tpu``'s ``ErasureObjects(backend="numpy")`` writes a namespace of
inline, packed and part-file objects (keys with spaces, unicode, nested
directories and the ``x-1`` / ``x/`` ordering trap) into four drives; a
port layer over the same drives must list it page for page as the
reference does (prefix, delimiter, marker, max-keys), resolve entries by
the same quorum when drives miss them, list the same buckets without the
system volume, and refuse to delete a bucket that holds an object of any
layout.
"""

import os
import shutil

import numpy as np
import pytest

import minio_tpu.objectlayer.erasure_object as ref_eo
from minio_tpu.objectlayer import interface as ref_ol
from minio_tpu.objectlayer.metacache import paginate as ref_paginate
from minio_tpu.storage.writers import close_write_planes
from minio_tpu.storage.xl_storage import XLStorage as RefStorage
from minio_tpu_torch.objectlayer import erasure_object as port_eo
from minio_tpu_torch.objectlayer import interface as port_ol
from minio_tpu_torch.storage.xl_storage import XLStorage

N, M, BS = 4, 2, 4096
BUCKET = "lst"
KEYS = {"a b/ü.txt": 10, "a b/z": 200_000, "dir/sub/one": 1_200_000,
        "dir/sub/two": 0, "dir/zz": 150_000, "x-1": 5, "x/y": 5,
        "x/y-2/z": 7, "日本/語": 100, "top": 50_000, "zz top": 3}
PREFIXES = ["", "a", "a b/", "dir/", "dir/sub/", "x", "x/", "日", "zzz"]


def _body(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    root = tmp_path_factory.mktemp("listing")
    dirs = [root / f"d{i}" for i in range(N)]
    for d in dirs:
        d.mkdir()
    ref = ref_eo.ErasureObjects([RefStorage(str(d)) for d in dirs],
                                parity=M, block_size=BS, backend="numpy")
    port = port_eo.ErasureObjects([XLStorage(str(d)) for d in dirs],
                                  parity=M, block_size=BS, device="cpu")
    try:
        for b in (BUCKET, "b-one", "b-two"):
            ref.make_bucket(b)
        for i, (key, size) in enumerate(KEYS.items()):
            ref.put_object(BUCKET, key, _body(size, i))
        yield root, ref, port
    finally:
        port.close()
        close_write_planes(ref)


def _page(res) -> tuple:
    return ([(o.name, o.size, o.etag, o.mod_time, o.content_type)
             for o in res.objects], list(res.prefixes), res.is_truncated,
            res.next_marker)


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("delimiter", ["", "/"])
@pytest.mark.parametrize("max_keys", [1, 3, 1000])
def test_pages_match_reference(layers, prefix, delimiter, max_keys):
    _, ref, port = layers
    marker, pages = "", 0
    while True:
        want = ref.list_objects(BUCKET, prefix, marker, delimiter, max_keys)
        got = port.list_objects(BUCKET, prefix, marker, delimiter, max_keys)
        assert _page(got) == _page(want), (prefix, delimiter, marker)
        pages += 1
        if not got.is_truncated:
            break
        marker = got.next_marker
    assert pages <= len(KEYS) + 1


def test_layouts_are_all_listed(layers):
    _, _, port = layers
    got = port.list_objects(BUCKET)
    assert [o.name for o in got.objects] == sorted(KEYS)
    assert {o.name: o.size for o in got.objects} == KEYS


@pytest.mark.parametrize("missing_on", [1, 3])
def test_quorum_resolve_matches_reference(tmp_path, missing_on):
    """An entry some drives lack is listed at quorum n // 2 and skipped
    below it, as the reference's walk resolves it."""
    dirs = [tmp_path / f"d{i}" for i in range(N)]
    for d in dirs:
        d.mkdir()
    ref = ref_eo.ErasureObjects([RefStorage(str(d)) for d in dirs],
                                parity=M, block_size=BS, backend="numpy")
    port = port_eo.ErasureObjects([XLStorage(str(d)) for d in dirs],
                                  parity=M, block_size=BS, device="cpu")
    try:
        ref.make_bucket(BUCKET)
        for i, key in enumerate(("k1", "k2/a", "k3")):
            ref.put_object(BUCKET, key, _body(300_000 * (i == 1) + 10, i))
        for d in dirs[:missing_on]:
            shutil.rmtree(d / BUCKET / "k2")
        want = ref_paginate(ref._gather_listing_iter(BUCKET, ""), "", "",
                            "", 1000)
        got = port.list_objects(BUCKET)
        assert _page(got) == _page(want)
        assert ("k2/a" in [o.name for o in got.objects]) == \
            (N - missing_on >= N // 2)
    finally:
        port.close()
        close_write_planes(ref)


def test_list_buckets_hides_the_system_volume(layers):
    root, ref, port = layers
    assert (root / "d0" / ".mt.sys").is_dir()
    got = port.list_buckets()
    assert [(b.name, b.created) for b in got] == \
        [(b.name, b.created) for b in ref.list_buckets()]
    assert [b.name for b in got] == ["b-one", "b-two", BUCKET]


def test_bucket_info(layers):
    _, ref, port = layers
    assert port.get_bucket_info("b-one").name == "b-one"
    assert port.get_bucket_info("b-one").created == \
        ref.get_bucket_info("b-one").created
    with pytest.raises(port_ol.BucketNotFound):
        port.get_bucket_info("nope")
    with pytest.raises(port_ol.BucketNotFound):
        port.list_objects("nope")


@pytest.mark.parametrize("size", [100, 300_000, 1_200_000],
                         ids=["inline", "packed", "part"])
def test_delete_bucket_sees_every_layout(tmp_path, size):
    dirs = [tmp_path / f"d{i}" for i in range(N)]
    for d in dirs:
        d.mkdir()
    ref = ref_eo.ErasureObjects([RefStorage(str(d)) for d in dirs],
                                parity=M, block_size=BS, backend="numpy")
    port = port_eo.ErasureObjects([XLStorage(str(d)) for d in dirs],
                                  parity=M, block_size=BS, device="cpu")
    try:
        ref.make_bucket("one")
        ref.put_object("one", "only/obj", _body(size, 5))
        with pytest.raises(ref_ol.BucketNotEmpty):
            ref.delete_bucket("one")
        with pytest.raises(port_ol.BucketNotEmpty):
            port.delete_bucket("one")
        port.delete_object("one", "only/obj")
        port.delete_bucket("one")
        with pytest.raises(ref_ol.BucketNotFound):
            ref.get_bucket_info("one")
        with pytest.raises(port_ol.BucketNotFound):
            port.delete_bucket("one")
        port.make_bucket("two")
        port.put_object("two", "x", _body(size, 6))
        port.delete_bucket("two", force=True)
        assert [b.name for b in port.list_buckets()] == []
    finally:
        port.close()
        close_write_planes(ref)


@pytest.mark.parametrize("seed", range(3))
def test_walk_resumes_after_a_marker(tmp_path, seed):
    """A page's walk from its marker skips the subtrees that sort before
    it unread, and yields what the whole walk yields from there on."""
    rng = np.random.default_rng(seed)
    disk = XLStorage(str(tmp_path))
    disk.make_vol(BUCKET)
    names: set[str] = set()
    while len(names) < 200:
        parts = ["".join(rng.choice(list("ab-"), int(rng.integers(1, 4))))
                 for _ in range(int(rng.integers(1, 4)))]
        name = "/".join(parts)
        if name in names or any(m.startswith(name + "/") or
                                name.startswith(m + "/") for m in names):
            continue
        names.add(name)
        (tmp_path / BUCKET / name).mkdir(parents=True, exist_ok=True)
        (tmp_path / BUCKET / name / "xl.meta").write_bytes(b"")
    full = list(disk.walk_dir(BUCKET))
    assert full == sorted(names)
    for after in full[::7] + ["", "a", "a/", "b-", "zz", "-"]:
        assert [n for n in disk.walk_dir(BUCKET, "", after) if n >= after] \
            == [n for n in full if n >= after], after
    visited = []
    scandir = os.scandir

    def counting(path):
        visited.append(path)
        return scandir(path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "scandir", counting)
        list(disk.walk_dir(BUCKET, "", full[-1]))
    assert len(visited) < len(names) // 4
