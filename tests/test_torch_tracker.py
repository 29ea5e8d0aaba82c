"""The port's data-update tracker (``minio_tpu_torch/background/
tracker.py``) and xxHash64 against ``minio_tpu``'s: the same hashes,
bloom bits and persisted JSON for the same marks, either package
resuming from the other's file, and the same ``changed_since`` answers
over a history of cycles.  Then the reference fault the port leaves
out: the reference's S3 front marks the tracker on GET and HEAD, so a
read makes the bucket's cached listing stale; the port's does not."""

import os
import time

import numpy as np
import pytest

from minio_tpu.background import tracker as ref_tr
from minio_tpu.hashing import xxhash as ref_xx
from minio_tpu.objectlayer import metacache as ref_mc
from minio_tpu_torch.background import tracker as port_tr
from minio_tpu_torch.hashing import xxhash as port_xx
from minio_tpu_torch.objectlayer import metacache as port_mc

from ._torch_control import client, servers
from ._torch_versions import close, port_layer, ref_layer

BITS = 1 << 12


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 64, 100])
def test_xxh64_equal(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    for seed in (0, 1, 3, 2 ** 63 + 5):
        assert port_xx.xxh64(data, seed) == ref_xx.xxh64(data, seed)
    if n == 0:
        assert port_xx.xxh64(b"") == 0xEF46DB3751D8E999  # the published value


def _marks(seed: int, n: int) -> list[tuple[str, str]]:
    rng = np.random.default_rng(seed)
    return [(f"b{rng.integers(4)}", f"k/{rng.integers(1000)}")
            for _ in range(n)]


@pytest.mark.parametrize("bits", [BITS, port_tr.DEFAULT_BITS])
def test_bloom_bits_equal(bits):
    ref, port = ref_tr.DataUpdateTracker(bits=bits), \
        port_tr.DataUpdateTracker(bits=bits)
    for b, k in _marks(bits, 50):
        ref.mark(b, k)
        port.mark(b, k)
    assert port._current.data == ref._current.data
    key = b"b1/k/7"
    assert list(port._current._positions(key)) == \
        list(ref._current._positions(key))


def test_changed_since_over_history():
    ref, port = ref_tr.DataUpdateTracker(bits=BITS), \
        port_tr.DataUpdateTracker(bits=BITS)
    for cycle in range(20):             # past MAX_HISTORY
        for b, k in _marks(cycle, cycle % 3):
            ref.mark(b, k)
            port.mark(b, k)
        assert port.advance() == ref.advance()
    assert port.cycle == ref.cycle == 21
    for cycle in range(0, 23):
        for b in ("b0", "b1", "b2", "b3", "none"):
            for k in ("", "k/5", "k/999"):
                assert port.changed_since(cycle, b, k) == \
                    ref.changed_since(cycle, b, k), (cycle, b, k)
    assert port.changed_since(1, "none")       # older than the history


def _tracker_files(root) -> list[bytes]:
    out = []
    for i in range(6):
        with open(f"{root}/d{i}/.mt.sys/tracker/update-tracker.json",
                  "rb") as f:
            out.append(f.read())
    return out


def test_persisted_json_equal_and_read_across(tmp_path):
    ref_lay, port_lay = ref_layer(tmp_path / "ref"), \
        port_layer(tmp_path / "port")
    try:
        ref = ref_tr.DataUpdateTracker(ref_lay, bits=BITS)
        port = port_tr.DataUpdateTracker(port_lay, bits=BITS)
        for cycle in range(3):
            for b, k in _marks(10 + cycle, 5):
                ref.mark(b, k)
                port.mark(b, k)
            ref.advance()
            port.advance()
        ref.mark("b1", "late")
        port.mark("b1", "late")
        ref._persist()
        port._persist()
        assert _tracker_files(tmp_path / "port") == \
            _tracker_files(tmp_path / "ref")
    finally:
        close(ref_lay, port_lay)
    # each package resumes from the other's file
    port_on_ref, ref_on_port = port_layer(tmp_path / "ref"), \
        ref_layer(tmp_path / "port")
    try:
        port2 = port_tr.DataUpdateTracker(port_on_ref, bits=BITS)
        ref2 = ref_tr.DataUpdateTracker(ref_on_port, bits=BITS)
        for c in range(5):
            for b in ("b0", "b1", "b3"):
                assert port2.changed_since(c, b) == \
                    ref2.changed_since(c, b) == ref.changed_since(c, b)
        assert port2.cycle == ref2.cycle == 4
    finally:
        close(port_on_ref, ref_on_port)


def test_bucket_changed_at():
    t = port_tr.DataUpdateTracker(bits=BITS)
    assert t.bucket_changed_at("b") == 0.0
    t0 = time.time()
    t.mark("b", "k")
    assert t0 <= t.bucket_changed_at("b") <= time.time()
    assert t.bucket_changed_at("other") == 0.0


# -- the reference fault: a read marks the tracker ----------------------------

@pytest.fixture
def pair(tmp_path, monkeypatch):
    with servers(tmp_path, monkeypatch) as (ref, port):
        # the real wall clock: the tracker's marks and the snapshots'
        # creation must order as they happened
        for mod in (ref_mc, port_mc):
            monkeypatch.setattr(mod, "time", time)
        yield ref, port


def _hits_misses(srv) -> tuple[int, int]:
    st = [s.metacache.stats() for s in srv.layer.sets]
    return sum(s["hits"] for s in st), sum(s["misses"] for s in st)


@pytest.mark.parametrize("read", ["GET", "HEAD"])
def test_a_read_keeps_the_cached_listing(pair, read):
    """List, read an object, list again: the port's second listing is
    served from its snapshot; the reference's walks again, because its
    front marked the tracker on the read."""
    ref, port = pair
    for srv in pair:
        c = client(srv)
        c.make_bucket("rdb")
        c.put_object("rdb", "a", b"a" * 100)
        c.put_object("rdb", "b", b"b" * 100)
    time.sleep(0.01)        # the snapshot is created after the last mark
    for srv in pair:
        assert [o["key"] for o in client(srv).list_objects("rdb")["objects"]
                ] == ["a", "b"]
    before = {id(s): _hits_misses(s) for s in pair}
    for srv in pair:
        client(srv).request(read, "/rdb/a")
        client(srv).list_objects("rdb")
    after = {id(s): _hits_misses(s) for s in pair}
    hits = {id(s): after[id(s)][0] - before[id(s)][0] for s in pair}
    misses = {id(s): after[id(s)][1] - before[id(s)][1] for s in pair}
    assert misses[id(ref)] > 0 and hits[id(ref)] == 0, "reference fault gone"
    assert misses[id(port)] == 0 and hits[id(port)] == len(port.layer.sets)
    # a write still makes the port's listing walk again
    client(port).put_object("rdb", "c", b"c")
    client(port).list_objects("rdb")
    assert _hits_misses(port)[1] > after[id(port)][1]


def test_the_tracker_is_marked_by_writes_only(pair):
    _, port = pair
    c = client(port)
    c.make_bucket("wrb")
    t = port.tracker
    t0 = t.bucket_changed_at("wrb")
    c.put_object("wrb", "k", b"x")
    t1 = t.bucket_changed_at("wrb")
    assert t1 > t0
    c.get_object("wrb", "k")
    c.head_object("wrb", "k")
    assert t.bucket_changed_at("wrb") == t1
    c.delete_object("wrb", "k")
    assert t.bucket_changed_at("wrb") > t1
    assert t.changed_since(t.cycle, "wrb", "k")
    assert os.path.basename(t._STORE_PATH) == "update-tracker.json"
