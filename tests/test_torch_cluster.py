"""In-process clusters (``cluster.py``) of both packages: three nodes of
two drives each, one set of six, parity 2, 16 KiB blocks, as the
``cluster`` fixture of ``tests/test_cluster.py`` builds them, with both
packages' clocks and uuid draws pinned (``_torch_versions.pin``).

The same calls, spread over the nodes (PUTs in every size band, an
overwrite, a delete, a multipart upload, a lock held across nodes, a
node lost and a PUT without it, a wiped node healed), leave byte-equal
drives; each package's cluster reads and heals the other's; and the peer
service carries IAM and bucket-metadata changes to the other node with
the calls the reference makes."""

import os
import shutil
import threading
import time

import pytest

from minio_tpu import cluster as ref_cluster
from minio_tpu.admin import handlers as ref_handlers
from minio_tpu.objectlayer import healing as ref_healing
from minio_tpu.parallel import peer as ref_peer
from minio_tpu.storage.writers import close_write_planes
from minio_tpu_torch import cluster as port_cluster
from minio_tpu_torch.admin import handlers as port_handlers
from minio_tpu_torch.objectlayer import healing as port_healing
from minio_tpu_torch.parallel import dsync as port_dsync
from minio_tpu_torch.parallel import peer as port_peer

from ._torch_cluster import cluster_state_left, free_ports
from ._torch_versions import assert_trees_equal, body, pin, tree

NODES, PER, PARITY = 3, 2, 2
BS = 16384
BATCH = 32 * BS                 # a 1.2 MB body streams in three batches
SIZES = {"inline": 1000, "packed": 300_000, "batches": 1_200_000}
KEYS = ["inline/0", "inline/1", "packed/0", "batches/0"]


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with cluster_state_left():
        yield


def _specs(pkg, root) -> list:
    mod = port_cluster if pkg == "port" else ref_cluster
    out = []
    for n in range(NODES):
        dirs = [f"{root}/d{n * PER + j}" for j in range(PER)]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        out.append(mod.NodeSpec(f"node{n}", dirs))
    return out


def start(pkg, root) -> list:
    if pkg == "port":
        return port_cluster.start_cluster(
            _specs(pkg, root), "cluster-secret", set_drive_count=NODES * PER,
            parity=PARITY, block_size=BS, device="cpu",
            enforce_min_part_size=False)
    return ref_cluster.start_cluster(
        _specs(pkg, root), "cluster-secret", set_drive_count=NODES * PER,
        parity=PARITY, block_size=BS, backend="numpy",
        enforce_min_part_size=False)


def stop(nodes) -> None:
    for node in nodes:
        if getattr(node, "_stopped", False):
            continue
        node._stopped = True
        layer = node.layer
        node.stop()
        if not isinstance(node, port_cluster.Node):
            # the reference's stop leaves the layer's writer threads and
            # fan-out pools
            close_write_planes(layer)
            for s in layer.sets:
                s._pool.shutdown(wait=True)


def sequence(nodes, root) -> dict:
    n0, n1, n2 = nodes
    out = {}
    n0.layer.make_bucket("bkt")
    for j, key in enumerate(KEYS):
        size = SIZES[key.split("/")[0]]
        info = nodes[j % NODES].layer.put_object("bkt", key, body(size, j))
        out[f"put {key}"] = (info.etag, info.size)
    n1.layer.put_object("bkt", "packed/0", body(SIZES["inline"], 77))
    n2.layer.delete_object("bkt", "inline/1")
    uid = n0.layer.new_multipart_upload("bkt", "mp/obj")
    parts = [(k, nodes[k].layer.put_object_part(
        "bkt", "mp/obj", uid, k, body(size, k)).etag)
        for k, size in ((1, 100_000), (2, 60_000))]
    out["mp"] = n2.layer.complete_multipart_upload("bkt", "mp/obj", uid,
                                                   parts).etag
    # a lock taken on one node excludes the others
    lk = n0.layer.sets[0].ns_lock.new_lock("bkt", "inline/0")
    lk.lock(write=True)
    try:
        with pytest.raises(Exception, match="inline/0"):
            n1.layer.sets[0].ns_lock.new_lock("bkt", "inline/0").lock(
                write=True, timeout=0.1)
    finally:
        lk.unlock()
    out["gets"] = [n2.layer.get_object("bkt", k)[1] == body(
        SIZES[k.split("/")[0]], j) for j, k in enumerate(KEYS)
        if k not in ("inline/1", "packed/0")]
    out["list"] = [o.name for o in n1.layer.list_objects("bkt").objects]
    # node 1's drives wiped of the bucket, healed from the others
    for d in (2, 3):
        shutil.rmtree(f"{root}/d{d}/bkt")
    heal = port_healing if isinstance(n0, port_cluster.Node) \
        else ref_healing
    out["heal"] = {}
    for key in KEYS + ["mp/obj"]:
        if key != "inline/1":
            r = heal.heal_object(n0.layer.get_hashed_set(key), "bkt", key)
            out["heal"][key] = (r.before_ok, r.after_ok)
    # node 2 lost: its two drives are parity's worth
    stop([n2])
    n0.layer.put_object("bkt", "degraded", body(50_000, 5))
    out["degraded"] = [n1.layer.get_object("bkt", k)[1][:64]
                       for k in ("degraded", "batches/0", "packed/0")]
    return out


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The sequence through a cluster of each package, both stopped:
    (root, {package: answers})."""
    root = tmp_path_factory.mktemp("clusters")
    mp = pytest.MonkeyPatch()
    answers = {}
    try:
        pin(mp, batch=BATCH)
        for pkg in ("ref", "port"):
            nodes = start(pkg, root / pkg)
            try:
                answers[pkg] = sequence(nodes, root / pkg)
            finally:
                stop(nodes)
    finally:
        mp.undo()
    return root, answers


def test_the_same_calls_leave_the_same_drives(clusters):
    root, answers = clusters
    want = answers["ref"]
    assert answers["port"] == want
    assert all(want["gets"]) and want["heal"]["batches/0"] == (4, 6)
    assert_trees_equal(root / "port", root / "ref", NODES * PER)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_reads_and_heals_the_others_cluster(
        clusters, tmp_path, monkeypatch, writer, reader):
    """The reader's cluster over a copy of the writer's drives: every
    body read through each node, then node 2's drives (which missed the
    PUT made without it) wiped and healed."""
    pin(monkeypatch, batch=BATCH)
    src, _ = clusters
    shutil.copytree(src / writer, tmp_path, dirs_exist_ok=True)
    before = {d: tree(tmp_path / f"d{d}") for d in (4, 5)}
    bodies = {k: body(SIZES[k.split("/")[0]], j)
              for j, k in enumerate(KEYS) if k not in ("inline/1",
                                                       "packed/0")}
    bodies["packed/0"] = body(SIZES["inline"], 77)
    bodies["degraded"] = body(50_000, 5)
    bodies["mp/obj"] = body(100_000, 1) + body(60_000, 2)
    nodes = start(reader, tmp_path)
    try:
        for j, (key, data) in enumerate(bodies.items()):
            assert nodes[j % NODES].layer.get_object("bkt", key)[1] == data
        for d in (4, 5):
            shutil.rmtree(tmp_path / f"d{d}" / "bkt")
        heal = port_healing if reader == "port" else ref_healing
        for key in bodies:
            r = heal.heal_object(nodes[1].layer.get_hashed_set(key), "bkt",
                                 key)
            assert r.after_ok == NODES * PER, key
    finally:
        stop(nodes)
    for d in (4, 5):
        after, was = (
            {k: v for k, v in t.items() if k.startswith("bkt/")}
            for t in (tree(tmp_path / f"d{d}"), before[d]))
        assert set(after) - set(was) == {"bkt/degraded/xl.meta"}
        assert {k: v for k, v in after.items() if k in was} == was


def _run_nodes(pkg, root, monkeypatch) -> list:
    """Two members started as ``run_node`` starts them, each in a thread
    (they wait for each other), on declared endpoints."""
    monkeypatch.setenv("MT_CRAWL_INTERVAL_S", "1000000")
    monkeypatch.setenv("MT_CACHE_ENABLE", "off")
    mod = port_cluster if pkg == "port" else ref_cluster
    ports = free_ports(2)
    specs = []
    for n in range(2):
        dirs = [f"{root}/n{n}d{j}" for j in range(2)]
        for d in dirs:
            os.makedirs(d)
        specs.append(mod.NodeSpec(f"n{n}", dirs,
                                  f"http://127.0.0.1:{ports[n]}"))
    kw = {"device": "cpu"} if pkg == "port" else {"backend": "numpy"}
    got = [None, None]

    def one(n):
        got[n] = mod.run_node(f"n{n}", specs, "peer-secret",
                              set_drive_count=4, block_size=BS, **kw)
    threads = [threading.Thread(target=one, args=(n,)) for n in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(got)
    return got


def _stop_nodes(pkg, pairs) -> None:
    for node, srv in pairs:
        srv.stop()
        layer = node.layer
        node.stop()
        if pkg == "ref":
            layer.monitor.stop()
            close_write_planes(layer)
            for s in layer.sets:
                s._pool.shutdown(wait=True)


def _reaches(fn, want, timeout: float = 10.0):
    """``fn()`` once it answers ``want`` (a peer's reload is
    asynchronous), else its last answer."""
    deadline = time.monotonic() + timeout
    while (got := fn()) != want and time.monotonic() < deadline:
        time.sleep(0.01)
    return got


def test_peers_reload_iam_and_bucket_metadata_at_once(tmp_path, monkeypatch):
    """Two members started by ``run_node`` in each package: node 0's IAM
    and bucket-policy changes and a write reach node 1 at once, with the
    calls the reference makes; both answer the cluster views alike."""
    calls = {"ref": [], "port": []}
    for pkg, mod in (("ref", ref_peer), ("port", port_peer)):
        orig = mod.PeerNotifier._fanout
        monkeypatch.setattr(
            mod.PeerNotifier, "_fanout",
            lambda self, method, _o=orig, _c=calls[pkg], **kw:
            (_c.append((method, kw)), _o(self, method, **kw))[1])
    seen = {}
    for pkg in ("ref", "port"):
        pairs = _run_nodes(pkg, tmp_path / pkg, monkeypatch)
        try:
            (n0, s0), (n1, s1) = pairs
            s0.layer.make_bucket("bkt")
            assert s1.bucket_meta.get("bkt") == {}     # cached as empty
            assert s1.iam.lookup_secret("alice") is None
            s0.iam.add_user("alice", "alice-secret-1", ["readwrite"])
            s0.bucket_meta.update("bkt", "policy", '{"Version": "x"}')
            oi = s0.layer.put_object("bkt", "k", b"v" * 100)
            s0.notify("s3:ObjectCreated:Put", "bkt", oi)
            _reaches(lambda: s1.iam.lookup_secret("alice"),
                     "alice-secret-1")
            _reaches(lambda: s1.bucket_meta.get("bkt").get("policy"),
                     '{"Version": "x"}')
            handlers = port_handlers if pkg == "port" else ref_handlers
            scrape = handlers._metrics_cluster(s0, {})
            seen[pkg] = (s1.iam.lookup_secret("alice"),
                         s1.bucket_meta.get("bkt").get("policy"),
                         s1.node_name, s0.peers.call_all(
                             "background_status", timeout_s=5)[0][2],
                         [ln for ln in scrape.splitlines()
                          if ln.startswith("mt_node_scrape_ok")],
                         'mt_up{server="n1"} 1' in scrape)
            s0.notify("s3:ObjectAccessed:Get", "bkt", oi)
        finally:
            _stop_nodes(pkg, pairs)
    assert seen["port"] == seen["ref"] == (
        "alice-secret-1", '{"Version": "x"}', "n1", "",
        ['mt_node_scrape_ok{server="n0"} 1',
         'mt_node_scrape_ok{server="n1"} 1'], True)
    # the reference also sends a read's mark (Queue 3 record 27)
    assert calls["ref"][-1] == ("mark_change", {"bucket": "bkt",
                                                "object_name": "k"})
    assert calls["port"] == calls["ref"][:-1] == [
        ("reload_iam", {}), ("reload_bucket_meta", {"bucket": "bkt"}),
        ("mark_change", {"bucket": "bkt", "object_name": "k"})]
    port_dsync.stop_refresher()
