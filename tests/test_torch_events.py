"""Event notification on the port against ``minio_tpu``: the rules map
(``bucket/notification.py`` ``match`` and ``match_pattern``) and the
event record (``events/event.py``) agree with the reference's over
tables of names, globs and keys; the same pinned request sequence on
both servers (``_torch_control``), each with a ``MemoryTarget`` on one
ARN and a ListenNotification stream open, gives equal records, every
key compared (``eventTime`` and ``sequencer`` too: each package's event
clock is pinned to its own counter from one start); and the reference's
``tests/test_events.py`` cases, repeated on the port: the pubsub and its
slow-subscriber drop, the queue store, routing through a filter, an
unknown ARN refused, webhook delivery with store-and-forward and the
listen stream.  A GET or HEAD fires its event and leaves the tracker
alone (ROADMAP Queue 3 record 27); DeleteObjects fires none, as in the
reference; a restore fires ``s3:ObjectRestore:Completed``."""

import datetime
import itertools
import json
import threading
import time
import types
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from minio_tpu.bucket import notification as ref_notif
from minio_tpu.events import MemoryTarget as RefMemoryTarget
from minio_tpu.events import event as ref_event
from minio_tpu.objectlayer import tiering as ref_tier
from minio_tpu_torch.bucket import notification as port_notif
from minio_tpu_torch.events import MemoryTarget, QueueStore, WebhookTarget
from minio_tpu_torch.events import event as port_event
from minio_tpu_torch.objectlayer import tiering as port_tier
from minio_tpu_torch.s3.client import S3ClientError
from minio_tpu_torch.utils.pubsub import PubSub

from ._torch_control import client, servers
from ._torch_objfeat import Pair, assert_no_event_threads, pin_lock_clock

NS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
ARN = "arn:minio:sqs::ev:memory"
T0 = 1_760_000_000_000_000_000
V = b"<VersioningConfiguration><Status>Enabled</Status>" \
    b"</VersioningConfiguration>"
# the reference's names have no s3:ObjectRestore:* wildcard
ALL_EVENTS = ("s3:ObjectCreated:*", "s3:ObjectRemoved:*",
              "s3:ObjectAccessed:*", "s3:ObjectRestore:Post",
              "s3:ObjectRestore:Completed")


def notify_cfg(arn=ARN, events=ALL_EVENTS, prefix="", suffix="") -> bytes:
    rules = "".join(
        f"<FilterRule><Name>{n}</Name><Value>{v}</Value></FilterRule>"
        for n, v in (("prefix", prefix), ("suffix", suffix)) if v)
    filt = f"<Filter><S3Key>{rules}</S3Key></Filter>" if rules else ""
    return (f"<NotificationConfiguration {NS}><QueueConfiguration>"
            f"<Queue>{arn}</Queue>" +
            "".join(f"<Event>{e}</Event>" for e in events) + filt +
            "</QueueConfiguration></NotificationConfiguration>").encode()


def _until(pred, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# -- the rules map and the record, host oracles --------------------------------

NAMES = sorted(n for n in ref_notif.EVENT_NAMES if not n.endswith("*"))
KEYS = ["", "a", "in/a.jpg", "in/", "in/b.txt", "out/a.jpg", "in/x/y.jpg",
        "IN/a.jpg", "a b/c%d.jpg", "ü/ß.jpg"]
CONFIGS = {
    "every": notify_cfg(events=ALL_EVENTS + ("s3:Replication:*",)),
    "prefix-suffix": notify_cfg(events=("s3:ObjectCreated:Put",
                                        "s3:ObjectAccessed:*"),
                                prefix="in/", suffix=".jpg"),
    "two-targets": notify_cfg().replace(
        b"</NotificationConfiguration>",
        b"<TopicConfiguration><Topic>arn:two</Topic><Event>"
        b"s3:ObjectRemoved:Delete</Event><Filter><S3Key><FilterRule><Name>"
        b"suffix</Name><Value>.txt</Value></FilterRule></S3Key></Filter>"
        b"</TopicConfiguration></NotificationConfiguration>"),
}


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_match_equals_the_references(cfg):
    port = port_notif.Config.parse(CONFIGS[cfg])
    ref = ref_notif.Config.parse(CONFIGS[cfg])
    for name in NAMES:
        for key in KEYS:
            assert port.match(name, key) == ref.match(name, key), (name, key)


GLOBS = ["", "*", "s3:*", "s3:ObjectCreated:*", "s3:Object*:Put",
         "s3:ObjectAccessed:?et", "s3:[OR]*", "ObjectCreated:*",
         "s3:ObjectRemoved:Delete", "*Tagging"]


@pytest.mark.parametrize("glob", GLOBS)
def test_match_pattern_equals_the_references(glob):
    for name in NAMES + ["", "s3:", "x"]:
        assert port_notif.match_pattern(glob, name) == \
            ref_notif.match_pattern(glob, name), (glob, name)


@pytest.mark.parametrize("key,size,vid", [
    ("k", 0, ""), ("in/a b.jpg", 12345, "v1"), ("ü/ß?.bin", 7, "null")])
def test_event_records_equal_the_references(key, size, vid):
    oi = types.SimpleNamespace(name=key, size=size, etag="e" * 32,
                               version_id=vid, content_type="text/plain")
    now = iter([T0 + 123_456_789] * 2)
    recs = []
    for mod in (ref_event, port_event):
        saved = mod.time
        mod.time = types.SimpleNamespace(time_ns=lambda: next(now))
        try:
            recs.append(mod.new_event("s3:ObjectCreated:Put", "bkt", oi,
                                      region="us-east-1", user="u",
                                      req_params={"a": "b"}).to_record())
        finally:
            mod.time = saved
    assert recs[0] == recs[1]
    assert recs[1]["eventTime"] == "2025-10-09T08:53:20.123Z"


# -- the pubsub and the queue store (tests/test_events.py) ----------------------

def test_pubsub_basics():
    ps = PubSub(max_queue=4)
    with ps.subscribe() as sub:
        ps.publish(1)
        ps.publish(2)
        assert sub.get(0.1) == 1
        assert sub.get(0.1) == 2
        assert sub.get(0.01) is None
    assert ps.num_subscribers == 0
    ps.publish(3)                   # no subscriber: nothing happens


def test_pubsub_slow_subscriber_drops():
    ps = PubSub(max_queue=2)
    sub = ps.subscribe()
    for i in range(10):
        ps.publish(i)
    assert [sub.get(0.01) for _ in range(3)] == [0, 1, None]
    sub.close()


def test_pubsub_close_ends_every_stream():
    ps = PubSub()
    sub = ps.subscribe()
    got = []
    t = threading.Thread(target=lambda: got.extend(sub.drain(10, 30.0)))
    t.start()
    ps.publish("a")
    assert _until(lambda: got == ["a"])
    t0 = time.monotonic()
    ps.close()
    t.join(5.0)
    assert not t.is_alive() and time.monotonic() - t0 < 1.0
    assert list(ps.subscribe().drain(10, 30.0)) == []


def test_queue_store(tmp_path):
    qs = QueueStore(str(tmp_path / "q"), limit=3)
    qs.put({"a": 1})
    time.sleep(0.001)
    qs.put({"a": 2})
    assert len(qs) == 2
    keys = qs.list()
    assert qs.get(keys[0]) == {"a": 1}      # in the order they came
    qs.delete(keys[0])
    assert len(qs) == 1
    qs.put({"a": 3})
    qs.put({"a": 4})
    with pytest.raises(Exception):
        qs.put({"a": 5})                    # at its limit


class _Sink(BaseHTTPRequestHandler):
    received: list = []
    fail = False

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        if type(self).fail:
            self.send_response(503)
            self.end_headers()
            return
        type(self).received.append((self.headers.get("Authorization"),
                                    json.loads(body)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture
def webhook_sink():
    class Sink(_Sink):
        received = []
        fail = False
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield Sink, f"http://127.0.0.1:{httpd.server_address[1]}/hook"
    httpd.shutdown()
    httpd.server_close()
    t.join()


def test_webhook_delivery_and_store_forward(tmp_path, webhook_sink):
    Sink, url = webhook_sink
    # a long cooldown: no background probe races the replay below
    tgt = WebhookTarget("arn:minio:sqs::wh:webhook", url, auth_token="tok",
                        store_dir=str(tmp_path / "whq"), max_attempts=1,
                        offline_after=1, cooldown_s=60.0)
    record = {"eventName": "ObjectCreated:Put",
              "s3": {"bucket": {"name": "b"}, "object": {"key": "k"}}}
    try:
        tgt.send(record)
        tgt.flush()
        assert Sink.received == [("tok", {"EventName": "s3:ObjectCreated:Put",
                                          "Key": "b/k",
                                          "Records": [record]})]
        # the endpoint fails: the first failure takes the target offline
        # and both records go to the store, then replay
        Sink.fail = True
        tgt.send(record)
        tgt.send(record)
        tgt.flush()
        assert len(tgt.store) == 2 and not tgt.online
        Sink.fail = False
        assert tgt.replay() == 2
        assert len(tgt.store) == 0 and len(Sink.received) == 3
        assert tgt.online
    finally:
        tgt.close()


# -- the servers -----------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("events")
    with servers(root, mp) as (ref, port):
        targets = (RefMemoryTarget(ARN), MemoryTarget(ARN))
        for srv, tgt in zip((ref, port), targets):
            srv.events.register_target(tgt)
        p = Pair(ref, port, root)
        p.targets = targets
        yield p
    ref.events._pool.shutdown(wait=True)
    mp.undo()
    assert_no_event_threads()


def _listen(srv, bucket: str, query: str, out: list) -> threading.Thread:
    """A ListenNotification stream in a thread; its records land in
    ``out`` once it ends.  Returns when the subscription is in place."""
    before = srv.events.pubsub.num_subscribers

    def run():
        r = client(srv).request("GET", f"/{bucket}", query, expect=())
        out.append(r.status)
        out.extend(json.loads(line)["Records"][0]
                   for line in r.body.split(b"\n") if line.strip())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert _until(lambda: srv.events.pubsub.num_subscribers > before)
    return t


def _mp_complete(parts) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in parts) + "</CompleteMultipartUpload>").encode()


def test_the_same_requests_give_equal_records(pair, monkeypatch, tmp_path):
    """Every event-firing call the reference has, through both servers;
    the targets' records and the listen streams' are equal, key for key,
    and in request order."""
    p = pair
    for srv in (p.ref, p.port):
        for tgt in srv.events._targets.values():
            tgt.records.clear()
    until = datetime.datetime.now(datetime.timezone.utc) + \
        datetime.timedelta(days=2)
    pin_lock_clock(monkeypatch)
    p.same("PUT", "/evq", status=200)
    p.same("PUT", "/evv", status=200)
    p.same("PUT", "/evv", "versioning", body=V, status=200)
    p.same("PUT", "/evl", headers={"x-amz-bucket-object-lock-enabled":
                                   "true"}, status=200)
    for b in ("evq", "evv", "evl"):
        p.same("PUT", f"/{b}", "notification", notify_cfg(), status=200)
    for srv, mod in ((p.ref, ref_tier), (p.port, port_tier)):
        srv.transition.add_tier(mod.DirTier(
            "COLD", str(tmp_path / ("rt" if srv is p.ref else "pt"))))
    # each package's event clock: its own counter from the same start
    for mod in (ref_event, port_event):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time_ns=itertools.count(T0, 1_000_000).__next__))
    streams = ([], [])
    listeners = [_listen(srv, "evq", "events&max-events=11&timeout=30", out)
                 for srv, out in zip((p.ref, p.port), streams)]
    big = bytes(range(256)) * 7000                  # 1.79 MB: streamed
    p.same("PUT", "/evq/small", body=b"s" * 1000, status=200)
    p.same("PUT", "/evq/big", body=big, status=200)
    p.same("GET", "/evq/small", status=200)
    p.same("HEAD", "/evq/big", status=200)
    p.same("PUT", "/evq/small", "tagging",
           b"<Tagging><TagSet><Tag><Key>a</Key><Value>1</Value></Tag>"
           b"</TagSet></Tagging>", status=200)
    p.same("DELETE", "/evq/small", "tagging", status=204)
    p.same("PUT", "/evq/copy", headers={"x-amz-copy-source": "/evq/small"},
           status=200)
    up = p.same("POST", "/evq/mp", "uploads", status=200)
    uid = up.xml().findtext(
        "{http://s3.amazonaws.com/doc/2006-03-01/}UploadId")
    etags = [p.same("PUT", "/evq/mp", f"partNumber={n}&uploadId={uid}",
                    body=bytes([n]) * 5000, status=200).headers["ETag"]
             for n in (1, 2)]
    p.same("POST", "/evq/mp", f"uploadId={uid}",
           _mp_complete([(1, etags[0]), (2, etags[1])]), status=200)
    for srv in (p.ref, p.port):
        oi = srv.layer.get_object_info("evq", "big")
        oi.transition_tier = "COLD"
        srv.transition.transition("evq", oi)
    p.same("POST", "/evq/big", "restore",
           b"<RestoreRequest><Days>1</Days></RestoreRequest>", status=202)
    p.same("POST", "/evq", "delete",
           b"<Delete><Object><Key>copy</Key></Object></Delete>", status=200)
    p.same("DELETE", "/evq/mp", status=204)
    p.same("DELETE", "/evq/nosuch", status=204)
    vid = p.same("PUT", "/evv/k", body=b"v1", status=200
                 ).headers["x-amz-version-id"]
    p.same("DELETE", "/evv/k", status=204)          # a delete marker
    p.same("DELETE", "/evv/k", f"versionId={vid}", status=204)
    lvid = p.same("PUT", "/evl/k", body=b"l", status=200
                  ).headers["x-amz-version-id"]
    p.same("PUT", "/evl/k", f"legal-hold&versionId={lvid}",
           b"<LegalHold><Status>ON</Status></LegalHold>", status=200)
    p.same("PUT", "/evl/k", f"retention&versionId={lvid}",
           ("<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>" +
            until.strftime("%Y-%m-%dT%H:%M:%SZ") +
            "</RetainUntilDate></Retention>").encode(), status=200)
    want = [("evq", "ObjectCreated:Put", "small"),
            ("evq", "ObjectCreated:Put", "big"),
            ("evq", "ObjectAccessed:Get", "small"),
            ("evq", "ObjectAccessed:Head", "big"),
            ("evq", "ObjectCreated:PutTagging", "small"),
            ("evq", "ObjectCreated:DeleteTagging", "small"),
            ("evq", "ObjectCreated:Copy", "copy"),
            ("evq", "ObjectCreated:CompleteMultipartUpload", "mp"),
            ("evq", "ObjectRestore:Completed", "big"),
            ("evq", "ObjectRemoved:Delete", "mp"),
            ("evq", "ObjectRemoved:Delete", "nosuch"),
            ("evv", "ObjectCreated:Put", "k"),
            ("evv", "ObjectRemoved:DeleteMarkerCreated", "k"),
            ("evv", "ObjectRemoved:Delete", "k"),
            ("evl", "ObjectCreated:Put", "k"),
            ("evl", "ObjectCreated:PutLegalHold", "k"),
            ("evl", "ObjectCreated:PutRetention", "k")]
    got = []
    for tgt in p.targets:
        assert _until(lambda: len(tgt.events()) >= len(want))
        time.sleep(0.05)
        got.append(sorted(tgt.events(),
                          key=lambda r: r["s3"]["object"]["sequencer"]))
    assert got[1] == got[0]
    assert [(r["s3"]["bucket"]["name"], r["eventName"],
             r["s3"]["object"]["key"]) for r in got[1]] == want
    assert got[1][0]["eventTime"] == "2025-10-09T08:53:20.000Z"
    assert got[1][0]["s3"]["object"]["sequencer"] == f"{T0:016X}"
    for t in listeners:
        t.join(30.0)
    assert streams[1] == streams[0]
    assert streams[1][0] == 200 and streams[1][1:] == got[1][:11]


def test_routing_through_a_filter_to_the_target(pair):
    port = pair.port
    tgt = MemoryTarget("arn:minio:sqs::t1:memory")
    port.events.register_target(tgt)
    try:
        c = client(port)
        c.make_bucket("evr")
        c.request("PUT", "/evr", "notification", notify_cfg(
            tgt.arn, ("s3:ObjectCreated:*", "s3:ObjectRemoved:*"),
            suffix=".jpg"))
        c.put_object("evr", "pic.jpg", b"img")
        c.put_object("evr", "doc.txt", b"txt")      # filtered out
        c.delete_object("evr", "pic.jpg")
        assert _until(lambda: len(tgt.events()) == 2)
        evs = sorted(tgt.events(), key=lambda r: r["eventName"])
        assert [e["eventName"] for e in evs] == ["ObjectCreated:Put",
                                                 "ObjectRemoved:Delete"]
        obj = evs[0]["s3"]["object"]
        assert (evs[0]["s3"]["bucket"]["name"], obj["key"], obj["size"]) \
            == ("evr", "pic.jpg", 3)
    finally:
        port.events.remove_target(tgt.arn)


def test_an_unknown_arn_is_refused(pair):
    c = client(pair.port)
    c.make_bucket("evarn")
    with pytest.raises(S3ClientError):
        c.request("PUT", "/evarn", "notification",
                  notify_cfg("arn:minio:sqs::nope:webhook"))
    assert pair.port.bucket_meta.get_config("evarn", "notification") is None


def test_the_listen_stream_filters_and_ends(pair):
    port = pair.port
    c = client(port)
    c.make_bucket("lsn")
    out = []
    q = urllib.parse.urlencode({"events": "s3:ObjectCreated:*",
                                "prefix": "in/", "timeout": "5",
                                "max-events": "1"})
    t = _listen(port, "lsn", q, out)
    c.put_object("lsn", "out/skip.bin", b"no")
    c.get_object("lsn", "out/skip.bin")
    c.get_object("lsn", "out/skip.bin")
    c.put_object("lsn", "in/take.bin", b"yes")
    t.join(15.0)
    assert out[0] == 200 and len(out) == 2
    assert out[1]["s3"]["object"]["key"] == "in/take.bin"
    # a bad bound is the client's error
    r = c.request("GET", "/lsn", "events&timeout=soon", expect=())
    assert r.status == 400 and b"InvalidArgument" in r.body


def test_a_read_fires_its_event_and_keeps_the_tracker(pair):
    """Record 27: a GET and a HEAD fire ObjectAccessed, and the tracker
    (so the cached listing) is left alone."""
    port = pair.port
    tgt = MemoryTarget("arn:minio:sqs::rd:memory")
    port.events.register_target(tgt)
    try:
        c = client(port)
        c.make_bucket("evrd")
        c.request("PUT", "/evrd", "notification", notify_cfg(tgt.arn))
        c.put_object("evrd", "k", b"x")
        marked = port.tracker.bucket_changed_at("evrd")
        c.get_object("evrd", "k")
        c.head_object("evrd", "k")
        assert _until(lambda: len(tgt.events()) == 3)
        assert sorted(e["eventName"] for e in tgt.events()) == [
            "ObjectAccessed:Get", "ObjectAccessed:Head", "ObjectCreated:Put"]
        assert port.tracker.bucket_changed_at("evrd") == marked
    finally:
        port.events.remove_target(tgt.arn)
