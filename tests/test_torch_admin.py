"""The port's admin API against ``minio_tpu``'s, and the effect of every
kvconfig key on a live server.

Both servers (``_torch_control.servers``) answer the same admin
requests: ``info`` (uptime aside, drives by number), ``config`` on the
keys the port registers, the refusals of unknown subsystems and keys,
``heal`` of an unversioned bucket after the same damage, ``heal-status``
after the same sweep, and ``storageinfo`` (free and used bytes aside).
A request without the root credential gets AccessDenied; the scrape
answers GET only, without auth.  The admin heal route restores every
version of a versioned key (the bodies are the oracle: ``minio_tpu``'s
route heals only the latest, ROADMAP Queue 3 item 18).  Then each
registered key is set through the admin client on the live port server
and its effect checked, and the ``service`` route stops a server (and,
in a subprocess, restarts ``python -m minio_tpu_torch``).  Module order
matters: the servers are shared."""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import pytest

from minio_tpu.admin.client import AdminClient as RefAdmin
from minio_tpu_torch import server_main
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.objectlayer.interface import ObjectOptions
from minio_tpu_torch.s3.client import S3Client, S3ClientError
from minio_tpu_torch.storage import commit as port_commit
from minio_tpu_torch.storage.xl_storage import SYS_DIR

from ._torch_control import AK, BS, PER, SK, both, client, drive_no, servers
from ._torch_versions import body

PORT_SUBSYS = ("commit", "drive", "heal", "pipeline")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("admin")
    try:
        with servers(root, mp) as (ref, port):
            yield ref, port, root
    finally:
        mp.undo()


def admin(srv) -> AdminClient:
    return AdminClient(f"http://127.0.0.1:{srv.port}", AK, SK)


def ref_admin(srv) -> RefAdmin:
    return RefAdmin(f"http://127.0.0.1:{srv.port}", AK, SK)


def _json(r):
    return json.loads(r.body)


def test_info_answers_alike(pair):
    ref, port, _ = pair
    r, p = both(ref, port, "GET", "/minio-tpu/admin/v1/info")
    assert r.status == p.status == 200
    got, want = _json(p), _json(r)
    for doc in (got, want):
        doc.pop("uptime_seconds")
        for d in doc["drives"]:
            d["endpoint"] = drive_no(d["endpoint"])
            d.pop("free")
    assert got == want
    assert len(got["drives"]) == 8 and got["drives"][0]["disk_id"]


@pytest.mark.parametrize("subsys", PORT_SUBSYS)
def test_config_subsystem_answers_alike(pair, subsys):
    ref, port, _ = pair
    r, p = both(ref, port, "GET", f"/minio-tpu/admin/v1/config/{subsys}")
    assert r.status == p.status == 200
    want = _json(r)
    assert _json(p) == {k: want[k] for k in _json(p)}
    assert admin(port).get_config_kv(subsys) == _json(p)


def test_config_of_every_subsystem(pair):
    ref, port, _ = pair
    r, p = both(ref, port, "GET", "/minio-tpu/admin/v1/config")
    got, want = _json(p), _json(r)
    assert sorted(got) == sorted(PORT_SUBSYS)
    for subsys, keys in got.items():
        assert keys == {k: want[subsys][k] for k in keys}


@pytest.mark.parametrize("method,route,value", [
    ("GET", "config/nosuch", b""),
    ("PUT", "config/nosuch/key", b"1"),
    ("PUT", "config/heal/nosuch", b"1"),
    ("POST", "heal", b""),
    ("POST", "service", b""),
], ids=["get-subsys", "put-subsys", "put-key", "heal-no-bucket",
        "service-no-action"])
def test_bad_requests_are_refused_alike(pair, method, route, value):
    ref, port, _ = pair
    r, p = both(ref, port, method, f"/minio-tpu/admin/v1/{route}",
                body=value)
    assert p.status == r.status != 200
    if r.headers.get("Content-Type") == "application/json":
        assert _json(p) == _json(r)
    else:
        assert p.xml().findtext("Code") == r.xml().findtext("Code")


@pytest.mark.parametrize("method,route", [("DELETE", "config/heal"),
                                          ("PUT", "config/heal")])
def test_a_wrong_method_on_config_is_refused(pair, method, route):
    """The port answers MethodNotAllowed, as the reference's ``_config``
    means to; the reference answers InternalError there (ROADMAP Queue 3
    item 19)."""
    ref, port, _ = pair
    r, p = both(ref, port, method, f"/minio-tpu/admin/v1/{route}",
                body=b"1")
    assert (p.status, p.xml().findtext("Code")) == (405, "MethodNotAllowed")
    assert (r.status, r.xml().findtext("Code")) == (500, "InternalError")


def test_only_the_root_credential_is_admitted(pair, monkeypatch):
    ref, port, _ = pair
    # anonymous
    r, p = both(ref, port, "GET", "/minio-tpu/admin/v1/info", sign=False)
    assert p.status == r.status == 403
    assert p.xml().findtext("Code") == r.xml().findtext("Code") == \
        "AccessDenied"
    # an identity that authenticates but is not root: the reference's
    # IAM user, a second key on the port's server
    ref_admin(ref).add_user("someone", "someone-secret", ["readwrite"])
    monkeypatch.setattr(port, "lookup_secret",
                        lambda k: {AK: SK, "someone": "someone-secret"}.get(k))
    for srv in (ref, port):
        out = client(srv, "someone", "someone-secret").request(
            "GET", "/minio-tpu/admin/v1/info", expect=())
        assert out.status == 403
        assert out.xml().findtext("Code") == "AccessDenied"
    # an admin route the port does not serve
    out = client(port).request("POST", "/minio-tpu/admin/v1/add-user",
                               body=b"{}", expect=())
    assert out.status == 501
    assert out.xml().findtext("Code") == "NotImplemented"


@pytest.mark.parametrize("method", ["PUT", "POST", "HEAD", "DELETE"])
def test_metrics_answer_get_only(pair, method):
    ref, port, _ = pair
    r, p = both(ref, port, method, "/minio-tpu/metrics", sign=False)
    assert p.status == r.status == 405


def test_metrics_need_no_credential(pair):
    ref, port, _ = pair
    r, p = both(ref, port, "GET", "/minio-tpu/metrics", sign=False)
    assert p.status == r.status == 200
    assert p.headers["Content-Type"] == r.headers["Content-Type"]
    assert b"mt_up 1" in p.body
    assert admin(port).metrics().startswith("# HELP mt_up")


def _damage(root, srv, bucket: str, keys) -> None:
    """The object dirs of ``keys`` gone from the second drive of each
    key's set."""
    for k in keys:
        s = srv.layer.get_hashed_set_index(k)
        shutil.rmtree(root / f"d{s * PER + 1}" / bucket / k)


def test_heal_of_an_unversioned_bucket_answers_alike(pair):
    ref, port, root = pair
    sizes = {"inline": 900, "packed": 300_000, "part": 1_050_000}
    keys = [f"{band}/{i}" for band in sizes for i in range(3)]
    for srv in (ref, port):
        c = client(srv)
        c.make_bucket("hbk")
        for k in keys:
            c.put_object("hbk", k, body(sizes[k.split("/")[0]], int(k[-1])))
    _damage(root / "ref", ref, "hbk", keys[::2])
    _damage(root / "port", port, "hbk", keys[::2])
    got, want = admin(port).heal("hbk"), ref_admin(ref).heal("hbk")
    fields = ("object", "before_ok", "after_ok", "dangling_purged")
    for doc in (got, want):
        for row in doc["objects"]:
            row["healed"] = sorted(drive_no(e) for e in row["healed"])
    assert [{f: row[f] for f in fields + ("healed",)}
            for row in got["objects"]] == \
        [{f: row[f] for f in fields + ("healed",)}
         for row in want["objects"]]
    assert got["bucket_sets_healed"] == want["bucket_sets_healed"]
    assert sum(1 for row in got["objects"] if row["healed"]) == 5
    for k in keys:
        assert client(port).get_object("hbk", k).body == \
            body(sizes[k.split("/")[0]], int(k[-1]))


def test_heal_status_after_the_same_sweep(pair):
    ref, port, root = pair
    _damage(root / "ref", ref, "hbk", ["packed/1"])
    _damage(root / "port", port, "hbk", ["packed/1"])
    for srv in (ref, port):
        srv.healer.sweep()
    got, want = admin(port).heal_status(), ref_admin(ref).heal_status()
    for doc in (got, want):
        assert doc["sweep"].pop("lastCycle") > 0
    assert got == want
    assert got["sweep"]["objectsHealed"] == 1 and got["mrf"] is None


def test_storageinfo_answers_alike(pair):
    ref, port, _ = pair
    for srv in (ref, port):
        # no drive is slow at 1,000 times its set's median
        client(srv).request("PUT", "/minio-tpu/admin/v1/config/drive/"
                            "slow_latency_multiple", body=b"1000")
    got, want = admin(port).storage_info(), ref_admin(ref).storage_info()
    for doc in (got, want):
        for d in doc["disks"]:
            d["endpoint"] = drive_no(d["endpoint"])
            del d["free"], d["used"]
    assert got == want
    assert [d["slow"] for d in got["disks"]] == [False] * 8
    for srv in (ref, port):
        client(srv).request("PUT", "/minio-tpu/admin/v1/config/drive/"
                            "slow_latency_multiple", body=b"4")


def test_admin_heal_restores_every_version(pair):
    """A versioned key's two versions and a delete-marker key, one drive
    of their set emptied of them; the admin heal puts back every
    version, so that with two more drives gone each still reads."""
    _, port, root = pair
    c = client(port)
    c.make_bucket("vhk")
    c.set_bucket_versioning("vhk", True)
    v1 = c.put_object("vhk", "k", body(5000, 1)).headers["x-amz-version-id"]
    v2 = c.put_object("vhk", "k", body(3000, 2)).headers["x-amz-version-id"]
    m1 = c.put_object("vhk", "m", body(7000, 3)).headers["x-amz-version-id"]
    c.delete_object("vhk", "m")
    for key in ("k", "m"):
        si = port.layer.get_hashed_set_index(key)
        shutil.rmtree(root / "port" / f"d{si * PER}" / "vhk" / key)
    out = admin(port).heal("vhk")
    rows = [(r["object"], bool(r["healed"])) for r in out["objects"]]
    assert rows == [("k", True), ("k", True), ("m", True), ("m", True)]
    for key in ("k", "m"):
        si = port.layer.get_hashed_set_index(key)
        for i in (1, 2):
            shutil.rmtree(root / "port" / f"d{si * PER + i}" / "vhk" / key)
    lay = port.layer
    assert lay.get_object("vhk", "k", opts=ObjectOptions(version_id=v1))[1] \
        == body(5000, 1)
    assert lay.get_object("vhk", "k", opts=ObjectOptions(version_id=v2))[1] \
        == body(3000, 2)
    assert lay.get_object("vhk", "m", opts=ObjectOptions(version_id=m1))[1] \
        == body(7000, 3)
    with pytest.raises(Exception, match="delete marker"):
        lay.get_object("vhk", "m")


def test_reference_admin_heal_leaves_older_versions(tmp_path):
    """ROADMAP Queue 3 item 18: ``minio_tpu``'s admin heal route lists
    only latest versions (``minio_tpu/admin/handlers.py:1427-1454``), so
    the older version stays missing on the emptied drive."""
    from minio_tpu import server_main as ref_main
    dirs = [str(tmp_path / f"d{i}") for i in range(PER)]
    mp = pytest.MonkeyPatch()
    mp.setenv("MT_CACHE_ENABLE", "off")
    mp.setenv("MT_CRAWL_INTERVAL_S", "1000000")
    ref = ref_main.build_server(dirs, "127.0.0.1:0", AK, SK, backend="numpy",
                                block_size=BS)
    ref.start()
    try:
        c = client(ref)
        c.make_bucket("vhk")
        c.set_bucket_versioning("vhk", True)
        for i, size in enumerate((5000, 3000)):
            c.put_object("vhk", "k", body(size, i))
        shutil.rmtree(tmp_path / "d0" / "vhk" / "k")
        ref_admin(ref).heal("vhk")
        on_0 = ref.layer.sets[0].disks[0].list_versions("vhk", "k")
        on_3 = ref.layer.sets[0].disks[3].list_versions("vhk", "k")
        assert (len(on_0), len(on_3)) == (1, 2)
    finally:
        ref.stop()
        mp.undo()


# -- every registered key, on the live port server ----------------------------

def _set(port, subsys, key, value) -> None:
    admin(port).set_config_kv(subsys, key, value)
    assert admin(port).get_config_kv(subsys)[key] == value


def _packed(port, bucket: str, key: str) -> bool:
    s = port.layer.get_hashed_set(key)
    fi = s.disks[0].read_version(bucket, key)
    return fi.seg is not None and not fi.data_dir


def test_pipeline_depth(pair):
    """depth 0: a PUT takes the serial fan-out (no writer plane, nothing
    packed, no pipeline stats); back at 2 it is pipelined and packed."""
    _, port, _ = pair
    c = client(port)
    c.make_bucket("kv-depth")
    _set(port, "pipeline", "depth", "0")
    sets = port.layer.sets
    assert all(s._pipe_depth == 0 and not s._pipeline_on() for s in sets)
    ops = {id(s): sum(st["ops"] for st in s._write_plane.stats().values())
           for s in sets}
    stats = {id(s): dict(s.pipe_stats) for s in sets}
    c.put_object("kv-depth", "serial", body(300_000))
    c.put_object("kv-depth", "big", body(1_200_000))
    for s in sets:
        assert sum(st["ops"] for st in s._write_plane.stats().values()) \
            == ops[id(s)]
        assert s.pipe_stats == stats[id(s)]
    assert not _packed(port, "kv-depth", "serial")
    _set(port, "pipeline", "depth", "2")
    c.put_object("kv-depth", "piped", body(300_000))
    c.put_object("kv-depth", "big", body(1_200_000))
    assert _packed(port, "kv-depth", "piped")
    s = port.layer.get_hashed_set("big")
    assert s.pipe_stats["batches"] == 2
    assert 0 < s.pipe_stats["overlap_efficiency"] <= 1.0
    assert c.get_object("kv-depth", "serial").body == body(300_000)


def test_pipeline_queue_depth(pair):
    _, port, _ = pair
    _set(port, "pipeline", "queue_depth", "5")
    assert [s._write_plane.queue_bound() for s in port.layer.sets] == [5, 5]
    _set(port, "pipeline", "queue_depth", "2")
    assert [s._write_plane.queue_bound() for s in port.layer.sets] == [2, 2]


def test_commit_pack_threshold(pair):
    _, port, _ = pair
    c = client(port)
    c.make_bucket("kv-pack")
    _set(port, "commit", "pack_threshold", "200000")
    assert port_commit.CONFIG.pack_threshold == 200_000
    c.put_object("kv-pack", "a", body(300_000))
    c.put_object("kv-pack", "b", body(150_000))
    assert not _packed(port, "kv-pack", "a")
    assert _packed(port, "kv-pack", "b")
    _set(port, "commit", "pack_threshold", "1048576")
    c.put_object("kv-pack", "a", body(300_000))
    assert _packed(port, "kv-pack", "a")


def test_commit_segment_max_bytes(pair):
    """At the 1 MiB floor the drives' open segment rotates after a few
    300 KB objects; at the default it does not."""
    _, port, root = pair
    c = client(port)
    c.make_bucket("kv-seg")

    def segs():
        return {d: len([f for f in os.listdir(root / "port" / f"d{d}" /
                                              SYS_DIR / "seg")
                        if f.startswith("seg.")])
                for d in range(8)}

    before = segs()
    _set(port, "commit", "segment_max_bytes", "100")      # clamps to 1 MiB
    assert port_commit.CONFIG.segment_max_bytes == 1 << 20
    for i in range(16):
        c.put_object("kv-seg", f"o{i}", body(300_000, i))
    grown = segs()
    assert any(grown[d] > before[d] for d in grown)
    _set(port, "commit", "segment_max_bytes", "67108864")
    for i in range(16):
        c.put_object("kv-seg", f"p{i}", body(300_000, i))
    assert segs() == grown
    assert c.get_object("kv-seg", "o3").body == body(300_000, 3)


def test_commit_max_batch(pair):
    """A group commit takes at most ``max_batch`` ops, however many are
    queued."""
    _, port, _ = pair
    c = client(port)
    c.make_bucket("kv-batch")
    _set(port, "commit", "max_batch", "2")
    port_commit.COUNTS.reset()
    errs = []

    def put(i):
        try:
            client(port).put_object("kv-batch", f"o{i}", body(200_000, i))
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)
    threads = [threading.Thread(target=put, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errs
    assert port_commit.COUNTS.batches and port_commit.COUNTS.largest <= 2
    _set(port, "commit", "max_batch", "16")
    assert port_commit.CONFIG.max_batch == 16


def test_heal_max_sleep_and_bitrotscan(pair):
    _, port, _ = pair
    healer = port.healer
    assert healer.pace_s == 1.0 and healer.deep_every == 8
    _set(port, "heal", "max_sleep", "250ms")
    assert healer.pace_s == 0.25
    _set(port, "heal", "bitrotscan", "on")
    assert healer.deep_every == 1
    _set(port, "heal", "bitrotscan", "off")
    assert healer.deep_every == 8
    _set(port, "heal", "max_sleep", "0s")
    assert healer.pace_s == 0.0


def test_heal_pace_sleeps_after_each_heal(pair, monkeypatch):
    """The sweep sleeps after each heal as long as the heal took, at most
    ``pace_s``."""
    _, port, _ = pair
    slept = []
    monkeypatch.setattr("minio_tpu_torch.background.heal.time.sleep",
                        slept.append)
    _set(port, "heal", "max_sleep", "1ms")
    try:
        port.healer.sweep()
    finally:
        _set(port, "heal", "max_sleep", "1s")
    assert slept and max(slept) <= 0.001
    assert len(slept) == port.healer.progress.last["objects"]


def test_drive_slow_latency_multiple_and_min_samples(tmp_path, monkeypatch):
    """A planted slow drive (each of its ops sleeps 5 ms first) is
    flagged in ``storageinfo`` at the default knobs, and not at a higher
    multiple or a larger sample floor; flagged, never ejected.  A server
    of its own, so the last minute holds only this test's ops."""
    dirs = [str(tmp_path / f"d{i}") for i in range(4)]
    srv = server_main.build_server(dirs, "127.0.0.1:0", AK, SK,
                                   block_size=BS, device="cpu")
    srv.start()
    try:
        c = client(srv)
        c.make_bucket("kv-slow")
        for i in range(8):
            c.put_object("kv-slow", f"o{i}", body(1000, i))
        hd = srv.layer.sets[0].disks[1]
        orig = hd.inner._check_vol

        def slow_check(volume):
            time.sleep(0.005)
            return orig(volume)
        monkeypatch.setattr(hd.inner, "_check_vol", slow_check)
        for _ in range(10):
            for i in range(8):
                c.head_object("kv-slow", f"o{i}")

        def flag():
            (d,) = [d for d in admin(srv).storage_info()["disks"]
                    if d["endpoint"] == hd.endpoint()]
            return d.get("slow")

        assert flag() is True
        _set(srv, "drive", "slow_latency_multiple", "1000000")
        assert flag() is False
        _set(srv, "drive", "slow_latency_multiple", "4")
        _set(srv, "drive", "slow_min_samples", "100000")
        assert flag() is False
        _set(srv, "drive", "slow_min_samples", "10")
        assert flag() is True
        assert not hd.offline
        samples, _ = _scrape(srv)
        assert samples[("mt_node_disk_slow", (("drive", "1"),))] == 1
    finally:
        srv.stop()


def _scrape(srv):
    from .test_torch_metrics import parse
    return parse(admin(srv).metrics())


# -- the service route --------------------------------------------------------

def test_service_stop_ends_serve_forever(tmp_path):
    dirs = [str(tmp_path / f"d{i}") for i in range(4)]
    srv = server_main.build_server(dirs, "127.0.0.1:0", AK, SK,
                                   block_size=BS, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        assert admin(srv).service_stop() == {"status": "ok",
                                             "action": "stop"}
        assert srv.shutdown.wait(20)
        t.join(20)
        assert not t.is_alive()
    finally:
        srv.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_live(url: str, deadline: float) -> None:
    while time.monotonic() < deadline:
        try:
            S3Client(url, AK, SK, timeout=2).request(
                "GET", "/minio/health/live", sign=False)
            return
        except (OSError, S3ClientError):
            time.sleep(0.2)
    raise TimeoutError(url)


def test_service_restart_reexecutes_the_server(tmp_path):
    """``restart`` re-executes ``python -m minio_tpu_torch`` with the
    same arguments: the same process comes back, its uptime reset, the
    drives' objects still there; ``stop`` then ends it."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    dirs = [str(tmp_path / f"d{i}") for i in range(4)]
    env = dict(os.environ, MT_ROOT_USER=AK, MT_ROOT_PASSWORD=SK)
    proc = subprocess.Popen(
        [sys.executable, "-m", "minio_tpu_torch", "server", "--device",
         "cpu", "--block-size", str(BS), "--address",
         f"127.0.0.1:{port}", *dirs],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 60
    try:
        _wait_live(url, deadline)
        c = S3Client(url, AK, SK)
        c.make_bucket("rst")
        c.put_object("rst", "k", body(5000))
        adm = AdminClient(url, AK, SK)
        time.sleep(1.0)
        up = adm.server_info()["uptime_seconds"]
        assert up >= 1.0
        assert adm.service_restart()["action"] == "restart"
        time.sleep(1.0)                 # the old server goes away first
        _wait_live(url, deadline)
        assert proc.poll() is None
        assert adm.server_info()["uptime_seconds"] < up + 1.0
        assert c.get_object("rst", "k").body == body(5000)
        adm.service_stop()
        assert proc.wait(timeout=max(1, deadline - time.monotonic())) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with pytest.raises(OSError):            # nobody listens any more
        AdminClient(url, AK, SK).server_info()
