"""Transitions to a tier and restore on the port
(``minio_tpu_torch/objectlayer/tiering.py``, the crawler's
``transition_fn``, ``POST ?restore``, the admin ``tier`` routes) against
``minio_tpu``'s.

In the layers (``_torch_versions``: clocks, uuids and the tier key's
uuid pinned; both tiering modules on one wall clock): the same
transition, restore and delete leave the same drives and the same tier
directory, for an inline, a packed and a part-file object and a
compressed one; each package restores what the other transitioned and
reads the other's ``tiers.json``; the crawler's scan transitions the
same versions, and a noncurrent version's transition leaves the head
alone; an ``S3Tier`` on a port server round-trips; a PUT or DELETE that
lands during a transition or a restore stands on the port (ROADMAP
Queue 3 record 47).  Over HTTP
(``_torch_control``'s two servers, one master key, compression on, the
SSE draws pinned): the admin tier routes, the crawler's transitions of a
plain, an SSE-S3 and a compressed object, the stubs' GET, HEAD and copy,
``?restore`` and the deletes that free the tier copies answer alike and
leave equal drives and tier directories; a Select over a stub answers
InvalidObjectState on the port (record 46).

Where the drives may differ: ``minio_tpu`` keeps a part-file version's
data dir when the transition's empty stub replaces it (ROADMAP Queue 3
record 13); the port removes it.  Those paths are checked apart."""

import base64
import json
import os
import time
import types

import pytest

from minio_tpu import compress as ref_compress
from minio_tpu.background import crawler as ref_cr
from minio_tpu.objectlayer import tiering as ref_tier
from minio_tpu.objectlayer.bucket_meta import BucketMetadataSys as RefMeta
from minio_tpu_torch import compress as port_compress
from minio_tpu_torch import s3select as port_select
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.background import crawler as port_cr
from minio_tpu_torch.objectlayer import tiering as port_tier
from minio_tpu_torch.objectlayer.bucket_meta import BucketMetadataSys
from minio_tpu_torch.server_main import build_server as port_build
from minio_tpu_torch.storage.xl_storage import SYS_DIR

from ._torch_control import AK, SK, client, servers
from ._torch_objfeat import S3NS, Pair, assert_drives_equal, code, wire
from ._torch_versions import (Draws, N, assert_trees_equal, body, close,
                              is_port, obj_opts, pin, port_layer, put_opts,
                              ref_layer)

NOW = int(time.time())              # the tiering modules' wall clock
DAY = 24 * 3600
TEXT = b"".join(b"line %06d: a log the front stores compressed\n" % i
                for i in range(4000))


def pin_tier_clock(mp) -> None:
    """Both tiering modules read ``NOW``: a restore stamps the same
    expiry in either package."""
    clock = types.SimpleNamespace(time=lambda: float(NOW),
                                  strftime=time.strftime, gmtime=time.gmtime)
    for mod in (ref_tier, port_tier):
        mp.setattr(mod, "time", clock)


def tiering_of(lay):
    return port_tier if is_port(lay) else ref_tier


def tier_files(path) -> dict:
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def data_dir_paths(lay, bucket: str, key: str) -> list[str]:
    """The version's data dir under every drive root, to leave out of a
    comparison where ``minio_tpu`` keeps it (record 13)."""
    er = lay if not hasattr(lay, "get_hashed_set") else \
        lay.get_hashed_set(key)
    fi, _ = er._read_quorum_fileinfo(bucket, key)
    return [f"{bucket}/{key}/{fi.data_dir}"] if fi.data_dir else []


# -- the layers ---------------------------------------------------------------

SIZES = {"inline": 1000, "packed": 300_000, "part": 1_200_000}


def _compressed_opts(lay, mod_compress):
    ud = {mod_compress.META_COMPRESSION: mod_compress.COMPRESSION_ALGO,
          "x-minio-internal-actual-size": str(len(TEXT))}
    return put_opts(lay, user_defined=ud), mod_compress.compress_stream(TEXT)


def _sequence(lay, root, kind: str):
    """PUT, transition, restore, delete of one object on ``lay``; the
    tier directory and what was seen at each step."""
    tr = tiering_of(lay)
    lay.make_bucket("tier")
    if kind == "compressed":
        opts, stored = _compressed_opts(
            lay, port_compress if is_port(lay) else ref_compress)
        lay.put_object("tier", "obj", stored, opts)
    else:
        lay.put_object("tier", "obj", body(SIZES[kind], 3))
    _, stored = lay.get_object("tier", "obj")
    tsys = tr.TransitionSys(lay)
    tsys.add_tier(tr.DirTier("COLD", f"{root}-tier"))
    skip = data_dir_paths(lay, "tier", "obj")
    oi = lay.get_object_info("tier", "obj")
    oi.transition_tier = "COLD"
    tsys.transition("tier", oi)
    stub = lay.get_object_info("tier", "obj")
    seen = {"stub": (stub.size, dict(stub.user_defined)),
            "tier": tier_files(f"{root}-tier"), "stored": stored}
    tsys.transition("tier", stub)           # a stub is left as it is
    assert tsys.restore("tier", "obj", 2) is True
    assert tsys.restore("tier", "obj", 2) is False
    info, back = lay.get_object("tier", "obj")
    seen["restored"] = (back, info.mod_time, dict(info.user_defined))
    tsys.delete_tiered(info.user_defined)
    lay.delete_object("tier", "obj")
    seen["after_delete"] = tier_files(f"{root}-tier")
    return seen, skip


@pytest.mark.parametrize("kind", ["inline", "packed", "part", "compressed"])
def test_transition_restore_delete_alike(tmp_path, monkeypatch, kind):
    pin(monkeypatch)
    pin_tier_clock(monkeypatch)
    port, ref = port_layer(tmp_path / "port"), ref_layer(tmp_path / "ref")
    try:
        got, skip = _sequence(port, tmp_path / "port", kind)
        want, _ = _sequence(ref, tmp_path / "ref", kind)
    finally:
        close(port, ref)
    assert got == want
    stub_size, stub_ud = got["stub"]
    assert stub_size == 0 and stub_ud[port_tier.META_STATUS] == "complete"
    # the tier holds the stored bytes, verbatim
    assert list(got["tier"].values()) == [got["stored"]]
    assert got["restored"][0] == got["stored"]
    assert got["after_delete"] == {}
    assert_trees_equal(tmp_path / "port", tmp_path / "ref",
                       skip={i: skip for i in range(N)})
    if kind == "part":
        for i in range(N):                  # record 13
            assert not os.path.exists(tmp_path / "port" / f"d{i}" / skip[0])


def _lapse(lay, root, mp):
    """A restore whose days run out, then the sweep; what it saw."""
    tr = tiering_of(lay)
    lay.make_bucket("tier")
    lay.put_object("tier", "obj", body(SIZES["inline"], 9))
    tsys = tr.TransitionSys(lay)
    tsys.add_tier(tr.DirTier("COLD", f"{root}-tier"))
    oi = lay.get_object_info("tier", "obj")
    oi.transition_tier = "COLD"
    tsys.transition("tier", oi)
    tsys.restore("tier", "obj", 1)
    kept = tsys.sweep_expired_restores("tier")
    later = types.SimpleNamespace(time=lambda: float(NOW + 2 * DAY),
                                  strftime=time.strftime, gmtime=time.gmtime)
    mp.setattr(tr, "time", later)
    swept = tsys.sweep_expired_restores("tier")
    stub = lay.get_object_info("tier", "obj")
    return kept, swept, stub.size, tr.META_RESTORE_EXPIRY in \
        stub.user_defined, tr.is_transitioned(stub.user_defined)


def test_the_sweep_puts_the_stub_back_over_a_lapsed_restore(
        tmp_path, monkeypatch):
    """``sweep_expired_restores`` (the port's crawler does the same per
    version, ROADMAP Queue 3 item 44) re-stubs a restored copy whose
    days have run out, alike in both packages."""
    pin(monkeypatch)
    pin_tier_clock(monkeypatch)
    port, ref = port_layer(tmp_path / "port"), ref_layer(tmp_path / "ref")
    try:
        got = _lapse(port, tmp_path / "port", monkeypatch)
        want = _lapse(ref, tmp_path / "ref", monkeypatch)
    finally:
        close(port, ref)
    assert got == want == (0, 1, 0, False, True)
    assert_trees_equal(tmp_path / "port", tmp_path / "ref")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_restores_what_the_other_transitioned(
        tmp_path, monkeypatch, writer):
    pin(monkeypatch)
    pin_tier_clock(monkeypatch)
    make = {"ref": ref_layer, "port": port_layer}
    first = make[writer](tmp_path)
    data = body(SIZES["part"], 4)
    try:
        tr = tiering_of(first)
        first.make_bucket("tier")
        first.put_object("tier", "obj", data)
        tsys = tr.TransitionSys(first)
        tsys.add_tier(tr.DirTier("COLD", str(tmp_path / "tier")))
        oi = first.get_object_info("tier", "obj")
        oi.transition_tier = "COLD"
        tsys.transition("tier", oi)
        blob = tsys.to_json()
    finally:
        close(first)
    other = make["port" if writer == "ref" else "ref"](tmp_path)
    try:
        tr = tiering_of(other)
        tsys = tr.TransitionSys.from_json(other, blob)
        stub = other.get_object_info("tier", "obj")
        assert tr.is_transitioned(stub.user_defined)
        assert stub.user_defined[tr.META_SIZE] == str(len(data))
        assert tsys.restore("tier", "obj", 1) is True
        assert other.get_object("tier", "obj")[1] == data
    finally:
        close(other)


def _interleaved(lay, root, step: str, write: str):
    """A client's ``write`` ("put" or "delete") of an unversioned object
    sent while a transition's bytes go to the tier (``step``
    "transition") or while a restore fetches them ("restore"); what the
    layer and the tier hold afterwards."""
    tr = tiering_of(lay)
    lay.make_bucket("tier")
    lay.put_object("tier", "obj", body(SIZES["packed"], 21))
    tier = tr.DirTier("COLD", f"{root}-tier")
    tsys = tr.TransitionSys(lay)
    tsys.add_tier(tier)
    oi = lay.get_object_info("tier", "obj")
    oi.transition_tier = "COLD"
    if step == "restore":
        tsys.transition("tier", oi)

    def client_write():
        if write == "put":
            lay.put_object("tier", "obj", b"the client's write")
        else:
            lay.delete_object("tier", "obj")

    method = "put" if step == "transition" else "get"
    inner = getattr(tier, method)

    def racing(*args):
        out = inner(*args)
        client_write()
        return out

    tier.__dict__[method] = racing
    refused = False
    try:
        if step == "transition":
            tsys.transition("tier", oi)
        else:
            tsys.restore("tier", "obj", 1)
    except tr.TierError:
        refused = True
    try:
        info, data = lay.get_object("tier", "obj")
        held = (data, tr.is_transitioned(info.user_defined))
    except Exception as e:  # noqa: BLE001 — the layer's not-found
        held = type(e).__name__
    return held, refused, len(tier_files(f"{root}-tier"))


@pytest.mark.parametrize("write", ["put", "delete"])
@pytest.mark.parametrize("step", ["transition", "restore"])
@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_a_write_during_a_transition_or_restore_stands(
        tmp_path, monkeypatch, pkg, step, write):
    """The stub, or the restored copy, replaces only the version that
    was read: a PUT or a DELETE that lands meanwhile stands on the port
    (a transition's tier copy is removed; a restore is refused).
    ``minio_tpu`` writes over it (ROADMAP Queue 3 record 47): the
    ``[ref]`` cases show the acknowledged write lost."""
    pin(monkeypatch)
    pin_tier_clock(monkeypatch)
    lay = (port_layer if pkg == "port" else ref_layer)(tmp_path)
    try:
        held, refused, tier_left = _interleaved(lay, tmp_path, step, write)
    finally:
        close(lay)
    stood = (b"the client's write", False) if write == "put" \
        else "ObjectNotFound"
    if pkg == "port":
        assert held == stood
        assert refused == (step == "restore")
        assert tier_left == (0 if step == "transition" else 1)
    else:
        assert held != stood and not refused
        if step == "transition":
            assert held == (b"", True) and tier_left == 1
        else:
            assert held == (body(SIZES["packed"], 21), True)


TIERS = [{"type": "dir", "name": "COLD", "path": "/srv/cold"},
         {"type": "s3", "name": "REMOTE", "endpoint": "http://10.0.0.9:9000",
          "bucket": "archive", "prefix": "p/", "access_key": "ak",
          "secret_key": "sk", "region": "eu-west-1"}]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_reads_the_others_tiers(tmp_path, monkeypatch, writer):
    """``tiers/tiers.json`` on the system volume: written by one package,
    loaded by the other's boot path."""
    pin(monkeypatch)
    monkeypatch.setattr(port_tier.DirTier, "__init__", _no_mkdir)
    monkeypatch.setattr(ref_tier.DirTier, "__init__", _no_mkdir)
    blob = json.dumps(TIERS).encode()
    if writer == "ref":
        lay = ref_layer(tmp_path)
        try:
            tsys = ref_tier.TransitionSys.from_json(lay, blob)
            lay._fanout(lambda d: d.write_all(
                SYS_DIR, "tiers/tiers.json", tsys.to_json()))
        finally:
            close(lay)
        lay = port_layer(tmp_path)
        try:
            loaded = port_tier.TransitionSys(lay)
            loaded.load()
        finally:
            close(lay)
    else:
        lay = port_layer(tmp_path)
        try:
            port_tier.TransitionSys.from_json(lay, blob).save()
        finally:
            close(lay)
        lay = ref_layer(tmp_path)
        try:
            res, _ = lay._fanout(
                lambda d: d.read_all(SYS_DIR, "tiers/tiers.json"))
            loaded = ref_tier.TransitionSys.from_json(
                lay, next(r for r in res if r))
        finally:
            close(lay)
    assert json.loads(loaded.to_json()) == TIERS
    assert json.loads(loaded.to_json(redact=True))[1]["secret_key"] == \
        "REDACTED"


def _no_mkdir(self, name, path):
    self.name, self.path = name, path


LIFECYCLE = (b'<LifecycleConfiguration>'
             b'<Rule><ID>cur</ID><Status>Enabled</Status>'
             b'<Filter><Prefix>cur/</Prefix></Filter>'
             b'<Transition><Days>1</Days><StorageClass>COLD</StorageClass>'
             b'</Transition></Rule>'
             b'<Rule><ID>nc</ID><Status>Enabled</Status>'
             b'<Filter><Prefix>nc/</Prefix></Filter>'
             b'<NoncurrentVersionTransition><NoncurrentDays>1'
             b'</NoncurrentDays><StorageClass>COLD</StorageClass>'
             b'</NoncurrentVersionTransition></Rule>'
             b'</LifecycleConfiguration>')


def _scan(lay, root):
    tr = tiering_of(lay)
    meta = BucketMetadataSys(lay) if is_port(lay) else RefMeta(lay)
    cr = port_cr if is_port(lay) else ref_cr
    lay.make_bucket("ilm")
    meta.set_versioning("ilm", True)
    meta.set_config("ilm", "lifecycle", LIFECYCLE.decode())
    for name, size in (("cur/a", 1000), ("cur/b", 300_000), ("keep", 500)):
        lay.put_object("ilm", name, body(size, 5),
                       put_opts(lay, versioned=True))
    old = lay.put_object("ilm", "nc/doc", body(2000, 6),
                         put_opts(lay, versioned=True))
    lay.put_object("ilm", "nc/doc", body(2500, 7),
                   put_opts(lay, versioned=True))
    tsys = tr.TransitionSys(lay)
    tsys.add_tier(tr.DirTier("COLD", f"{root}-tier"))
    kept = data_dir_paths(lay, "ilm", "cur/b")
    res = cr.scan_usage(lay, meta, transition_fn=tr.transition_fn(tsys))
    head_ud = lay.get_object_info("ilm", "nc/doc").user_defined
    old_ud = lay.get_object_info(
        "ilm", "nc/doc", obj_opts(lay, version_id=old.version_id)
    ).user_defined
    again = cr.scan_usage(lay, meta, transition_fn=tr.transition_fn(tsys))
    return (sorted(res.transitioned), tr.is_transitioned(head_ud),
            tr.is_transitioned(old_ud), lay.get_object("ilm", "nc/doc")[1],
            tier_files(f"{root}-tier"), sorted(again.transitioned), kept)


def test_the_crawler_transitions_the_same_versions(tmp_path, monkeypatch):
    pin(monkeypatch)
    port, ref = port_layer(tmp_path / "port"), ref_layer(tmp_path / "ref")
    try:
        got = _scan(port, tmp_path / "port")
        want = _scan(ref, tmp_path / "ref")
    finally:
        close(port, ref)
    assert got == want
    transitioned, head_stubbed, old_stubbed, head_body, tier, _, kept = got
    assert transitioned == [("ilm", "cur/a"), ("ilm", "cur/b"),
                            ("ilm", "nc/doc")]
    assert not head_stubbed and old_stubbed
    assert head_body == body(2500, 7)       # the head is left alone
    assert len(tier) == 3
    # record 13: the part-file version's data dir, kept by the reference
    assert_trees_equal(tmp_path / "port", tmp_path / "ref",
                       skip={i: kept for i in range(N)})


def test_an_s3_tier_on_a_port_server_round_trips(tmp_path, monkeypatch):
    """``S3Tier`` through the port's client: the stored bytes go to the
    server's bucket under the tier's prefix, come back on restore, and
    go on delete."""
    pin(monkeypatch)
    srv = port_build([str(tmp_path / "srv" / f"d{i}") for i in range(4)],
                     "127.0.0.1:0", AK, SK, 4096, device="cpu")
    srv.start()
    lay = port_layer(tmp_path / "lay")
    try:
        client(srv).make_bucket("archive")
        data = body(SIZES["part"], 8)
        lay.make_bucket("tier")
        lay.put_object("tier", "obj", data)
        tsys = port_tier.TransitionSys(lay)
        tsys.add_tier(port_tier.S3Tier("REMOTE", srv.endpoint, "archive",
                                       AK, SK, prefix="t/"))
        oi = lay.get_object_info("tier", "obj")
        oi.transition_tier = "REMOTE"
        tsys.transition("tier", oi)
        ud = lay.get_object_info("tier", "obj").user_defined
        key = "t/" + ud[port_tier.META_KEY]
        assert client(srv).get_object("archive", key).body == data
        assert tsys.restore("tier", "obj", 1) is True
        assert lay.get_object("tier", "obj")[1] == data
        tsys.delete_tiered(ud)
        assert client(srv).get_object("archive", key,
                                      expect=(404,)).status == 404
    finally:
        close(lay)
        srv.stop()


# -- the servers -----------------------------------------------------------------

MASTER = "tier-test-key:" + base64.b64encode(bytes(range(32))).decode()
SSE = {"x-amz-server-side-encryption": "AES256"}
OBJECTS = {"plain.dat": (body(1_200_000, 11), None),
           "small.dat": (body(300_000, 12), None),
           "sse.dat": (body(300_000, 13), SSE),
           "log.txt": (TEXT, None)}
HTTP_RULE = (b'<LifecycleConfiguration><Rule><ID>t</ID><Status>Enabled'
             b'</Status><Filter><Prefix></Prefix></Filter><Transition><Date>'
             b'2020-01-01T00:00:00Z</Date><StorageClass>COLD</StorageClass>'
             b'</Transition></Rule></LifecycleConfiguration>')
ADMIN = "/minio-tpu/admin/v1/tier"
# what a crawler cycle writes that the two servers stamp apart (the
# usage's wall clock), and the tiers' paths, which differ by root
SKIP = (".mt.sys/datausage", ".mt.sys/tiers")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("MT_COMPRESSION_ENABLE", "on")
    mp.setenv("MINIO_TPU_KMS_SECRET_KEY", MASTER)
    root = tmp_path_factory.mktemp("tiering")
    try:
        with servers(root, mp) as (ref, port):
            mp.setattr(os, "urandom", Draws(23))
            pin_tier_clock(mp)
            p = Pair(ref, port, root)
            p.tier_dirs = {"ref": str(root / "tier-ref"),
                           "port": str(root / "tier-port")}
            p.same("PUT", "/tier", status=200)
            for key, (data, hdrs) in OBJECTS.items():
                p.same("PUT", f"/tier/{key}", body=data, headers=hdrs,
                       status=200)
            p.stored = {k: port.layer.get_object("tier", k)[1]
                        for k in OBJECTS}
            yield p
    finally:
        mp.undo()


def _tier_doc(pair, tag: str) -> bytes:
    return json.dumps({"type": "dir", "name": "COLD",
                       "path": pair.tier_dirs[tag]}).encode()


def _normalized(resp, pair) -> tuple:
    status, headers, data = wire(resp)
    for path in pair.tier_dirs.values():
        data = data.replace(path.encode(), b"<tier>")
    headers = [(k, "*" if k == "Content-Length" else v) for k, v in headers]
    return status, headers, data


def test_admin_tier_routes_answer_alike(pair):
    got = [client(s).request("PUT", ADMIN, body=_tier_doc(pair, tag),
                             expect=())
           for s, tag in ((pair.ref, "ref"), (pair.port, "port"))]
    assert wire(got[0]) == wire(got[1]) and got[1].status == 200
    listed = [client(s).request("GET", ADMIN, expect=())
              for s in (pair.ref, pair.port)]
    assert _normalized(listed[0], pair) == _normalized(listed[1], pair)
    assert json.loads(listed[1].body) == [
        {"type": "dir", "name": "COLD", "path": pair.tier_dirs["port"]}]
    pair.same("PUT", ADMIN, body=_tier_doc(pair, "port"), status=409)
    pair.same("PUT", ADMIN, body=b'{"type": "dir", "name": "X"}',
              status=400)
    pair.same("PUT", ADMIN, body=b'{"type": "tape", "name": "Y"}',
              status=400)
    pair.same("PUT", ADMIN, body=b'{"type": "dir", "path": "/x"}',
              status=400)
    assert AdminClient(pair.port.endpoint, AK, SK).list_tiers() == \
        json.loads(listed[1].body)


def _skip(pair) -> list:
    """What the two servers' drives may differ in: ``SKIP``, and the data
    dir ``minio_tpu`` keeps of the part-file version its transition
    replaced (record 13)."""
    return list(SKIP) + pair.kept_data_dir


def test_the_crawler_transitions_alike(pair):
    pair.same("PUT", "/tier", "lifecycle", body=HTTP_RULE, status=200)
    pair.kept_data_dir = data_dir_paths(pair.port.layer, "tier",
                                        "plain.dat")
    got = [sorted(s.crawler.run_cycle().transitioned)
           for s in (pair.ref, pair.port)]
    assert got[0] == got[1] == sorted(("tier", k) for k in OBJECTS)
    assert_drives_equal(pair.root, 8, skip=_skip(pair))
    tiers = [tier_files(pair.tier_dirs[t]) for t in ("ref", "port")]
    assert tiers[0] == tiers[1]
    # the stored bytes, verbatim: ciphertext, the compressed stream
    assert sorted(tiers[1].values()) == sorted(pair.stored.values())
    assert OBJECTS["sse.dat"][0] not in tiers[1].values()
    assert TEXT not in tiers[1].values()
    # record 13: the port's drives hold no part file of the stub
    for i in range(8):
        assert not os.path.exists(
            pair.root / "port" / f"d{i}" / pair.kept_data_dir[0])


@pytest.mark.parametrize("key", sorted(OBJECTS))
def test_stubs_answer_alike(pair, key):
    data = OBJECTS[key][0]
    pair.same("GET", f"/tier/{key}", status=403, err="InvalidObjectState")
    pair.same("GET", f"/tier/{key}", headers={"Range": "bytes=0-9"},
              status=403, err="InvalidObjectState")
    head = pair.same("HEAD", f"/tier/{key}", status=200)
    assert head.headers["Content-Length"] == str(len(data))
    assert head.headers["x-amz-storage-class"] == "COLD"
    etag = head.headers["ETag"]
    pair.same("HEAD", f"/tier/{key}", headers={"If-Match": etag},
              status=200)
    pair.same("PUT", f"/tier/copy-{key}",
              headers={"x-amz-copy-source": f"/tier/{key}"}, status=403,
              err="InvalidObjectState")


def test_restore_refusals_alike(pair):
    pair.same("POST", "/tier/plain.dat", "restore", body=b"<bad",
              status=400, err="MalformedXML")
    pair.same("POST", "/tier/plain.dat", "restore",
              body=b"<RestoreRequest><Days>0</Days></RestoreRequest>",
              status=400, err="InvalidArgument")
    pair.same("PUT", "/live", status=200)
    pair.same("PUT", "/live/obj", body=b"live", status=200)
    pair.same("POST", "/live/obj", "restore", status=403,
              err="InvalidObjectState")
    pair.same("POST", "/tier/nosuch", "restore", status=404)


COUNT_ALL = (b'<SelectObjectContentRequest><Expression>SELECT COUNT(*) '
             b'FROM S3Object</Expression><ExpressionType>SQL</ExpressionType>'
             b'<InputSerialization><CSV/></InputSerialization>'
             b'<OutputSerialization><CSV/></OutputSerialization>'
             b'</SelectObjectContentRequest>')


@pytest.mark.parametrize("key", sorted(OBJECTS))
def test_a_select_over_a_stub_is_refused(pair, key):
    """A stub's bytes are in the tier: Select answers InvalidObjectState,
    as GET does.  ``minio_tpu`` scans the empty stub instead (ROADMAP
    Queue 3 record 46): a plain stub answers 200 and COUNT(*) 0."""
    ref, port = pair.both("POST", f"/tier/{key}", "select&select-type=2",
                          COUNT_ALL)
    assert port.status == 403 and code(port) == "InvalidObjectState"
    assert ref.status != 403
    if key in ("plain.dat", "small.dat"):
        # the scan of an empty body
        assert ref.status == 200 and \
            ref.body == port_select.run_select(COUNT_ALL, b"")


@pytest.mark.parametrize("key", sorted(OBJECTS))
def test_restores_and_copies_alike(pair, key):
    data = OBJECTS[key][0]
    pair.same("POST", f"/tier/{key}", "restore",
              body=b'<RestoreRequest xmlns="http://s3.amazonaws.com/doc/'
                   b'2006-03-01/"><Days>1</Days></RestoreRequest>',
              status=202)
    pair.same("POST", f"/tier/{key}", "restore", status=200)
    got = pair.same("GET", f"/tier/{key}", status=200)
    assert got.body == data
    head = pair.same("HEAD", f"/tier/{key}", status=200)
    assert head.headers["x-amz-restore"].startswith(
        'ongoing-request="false"')
    pair.same("PUT", f"/tier/copy-{key}",
              headers={"x-amz-copy-source": f"/tier/{key}"}, status=200)
    assert pair.same("GET", f"/tier/copy-{key}").body == data
    assert pair.port.layer.get_object("tier", key)[1] == pair.stored[key]


def test_restored_drives_equal(pair):
    assert_drives_equal(pair.root, 8, skip=_skip(pair))


def test_deletes_free_the_tier_copies(pair):
    before = tier_files(pair.tier_dirs["port"])
    assert len(before) == len(OBJECTS)
    pair.same("DELETE", "/tier/plain.dat", status=204)
    doc = (b"<Delete><Object><Key>small.dat</Key></Object>"
           b"<Object><Key>nosuch</Key></Object></Delete>")
    got = pair.same("POST", "/tier", "delete", body=doc, status=200)
    assert [e.findtext(f"{S3NS}Key") for e in got.xml()] == \
        ["small.dat", "nosuch"]
    pair.same("PUT", "/tier/sse.dat", body=b"overwritten", status=200)
    left = [tier_files(pair.tier_dirs[t]) for t in ("ref", "port")]
    assert left[0] == left[1] and len(left[1]) == 1
    assert list(left[1].values()) == [pair.stored["log.txt"]]
    pair.same("DELETE", "/tier/log.txt", status=204)
    assert tier_files(pair.tier_dirs["port"]) == {} == \
        tier_files(pair.tier_dirs["ref"])
    assert pair.same("GET", "/tier/sse.dat", status=200).body == \
        b"overwritten"
    assert_drives_equal(pair.root, 8, skip=_skip(pair))
