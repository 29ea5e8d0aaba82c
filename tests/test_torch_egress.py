"""The port's store-and-forward delivery engine (``obs/egress.py``)
against the reference's cases (``tests/test_egress.py``, those that need
no peers and no logger targets): delivery and its counts, the offline
spill with its probe and the replay that follows, a failed probe, dead
letters with no store and with a full one, a full queue, close storing
what is queued, a backlog left on disk replayed at registration; each
package replaying the queue store the other wrote; and on the port's
server (``build_server`` on the CPU) the outage drill of a store-backed
webhook target behind a blackholed proxy, the admin ``targets`` and
``targets/replay`` routes, the ``notify_webhook`` reload through
SetConfigKV (a server without targets renders no ``mt_target_*``
family), and a ``stop()`` that does not wait out a listener's
timeout.  Backoffs and probes are tens of milliseconds; every target is
closed in its test."""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from minio_tpu.events import WebhookTarget as RefWebhookTarget
from minio_tpu.obs import egress as ref_egress
from minio_tpu.parallel.faulty import Fault, FaultyProxy
from minio_tpu_torch.admin.client import AdminClient
from minio_tpu_torch.events import WebhookTarget
from minio_tpu_torch.obs import egress
from minio_tpu_torch.s3.client import S3Client
from minio_tpu_torch.server_main import build_server

from ._torch_objfeat import assert_no_event_threads

AK, SK = "egress-key", "egress-secret"
NS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
WEBHOOK_ARN = "arn:minio:sqs::1:webhook"


def _until(pred, timeout=10.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


# -- the engine ----------------------------------------------------------------

class _Probe(egress.DeliveryTarget):
    """An engine whose delivery outcome a test sets."""

    def __init__(self, **kw):
        kw.setdefault("sleep", lambda s: None)      # no real backoff
        super().__init__("test", "t1", **kw)
        self.ok = True
        self.delivered = []
        self.gate = None            # a threading.Event deliveries wait on

    def _deliver(self, rec):
        if self.gate is not None:
            self.gate.wait(5.0)
        if not self.ok:
            raise RuntimeError("endpoint down")
        self.delivered.append(rec)


def test_engine_delivers_counts_and_reports():
    t = _Probe()
    try:
        t.send({"n": 1})
        t.send({"n": 2})
        t.flush()
        assert t.delivered == [{"n": 1}, {"n": 2}]
        st = t.status()
        assert st["sent"] == 2 and st["failed"] == 0
        assert st["online"] and st["state"] == "online"
        assert st["queued"] == 0 and st["stored"] == 0
        assert st["lastSuccessTime"]
        buckets, counts, total = t.delivery_hist()
        assert counts[len(buckets)] == 2
        assert total >= 0.0
    finally:
        t.close()


def test_offline_spill_probe_and_auto_replay(tmp_path):
    turns = []

    def log_once(level, msg, dedup_key=""):
        turns.append((level, msg))
        return True

    t = _Probe(store_dir=str(tmp_path / "q"), max_attempts=1,
               offline_after=2, cooldown_s=0.05, log=log_once)
    try:
        t.ok = False
        for i in range(3):
            t.send({"n": i})
        t.flush()
        # two failures took it offline; the third record went to the
        # store without an attempt
        assert not t.online
        assert len(t.store) == 3
        assert t.failed >= 2 and t.dead_letter == 0
        assert any("offline" in m for _, m in turns)
        # the probe (a stored record) succeeds and the replay drains the
        # store, with no new traffic
        t.ok = True
        assert _until(lambda: len(t.store) == 0 and t.online)
        assert sorted(r["n"] for r in t.delivered) == [0, 1, 2]
        assert any("back online" in m for _, m in turns)
    finally:
        t.close()


def test_failed_probe_reopens_with_single_attempt(tmp_path):
    t = _Probe(store_dir=str(tmp_path / "q"), max_attempts=3,
               offline_after=1, cooldown_s=0.05)
    try:
        t.ok = False
        t.send({"n": 0})
        t.flush()
        assert not t.online
        failures = t.failed
        # after the cooldown the sender probes once, and fails
        assert _until(lambda: t.failed > failures)
        time.sleep(0.1)
        assert not t.online and len(t.store) == 1
    finally:
        t.close()


def test_dead_letter_without_store():
    t = _Probe(max_attempts=2, offline_after=10)
    try:
        t.ok = False
        t.send({"n": 0})
        t.flush()
        assert t.dead_letter == 1
        assert t.failed == 2                # both attempts counted
        assert "endpoint down" in t.last_error
    finally:
        t.close()


def test_dead_letter_on_store_full(tmp_path):
    t = _Probe(store_dir=str(tmp_path / "q"), store_limit=1,
               max_attempts=1, offline_after=1, cooldown_s=60.0)
    try:
        t.ok = False
        t.send({"n": 0})
        t.send({"n": 1})
        t.flush()
        assert len(t.store) == 1 and t.dead_letter == 1
    finally:
        t.close()


def _held(t):
    """Make ``t``'s deliveries wait on its gate; returns an Event set
    when the first delivery has begun."""
    t.gate = threading.Event()
    started = threading.Event()
    orig = t._deliver

    def deliver(rec):
        started.set()
        orig(rec)

    t._deliver = deliver
    return started


def test_queue_overflow_without_store_drops():
    t = _Probe(queue_limit=1)
    started = _held(t)
    try:
        t.send({"n": 0})
        assert started.wait(5.0)        # record 0 is in flight
        t.send({"n": 1})                # fills the queue of one
        t.send({"n": 2})                # counted dropped
        assert t.dropped == 1
    finally:
        t.gate.set()
        t.flush()
        t.close()
    assert [r["n"] for r in t.delivered] == [0, 1]


def test_close_spills_queued_records_to_store(tmp_path):
    t = _Probe(store_dir=str(tmp_path / "q"))
    started = _held(t)
    t.send({"n": 0})
    assert started.wait(5.0)
    t.send({"n": 1})
    t.send({"n": 2})
    closer = threading.Thread(target=t.close)
    closer.start()
    t.gate.set()
    closer.join(5.0)
    # the record in flight finished; the queued ones went to the store
    assert [r["n"] for r in t.delivered] == [0]
    assert len(t.store) == 2
    t.send({"n": 3})                    # closed: counted, never waited on
    assert t.dropped == 1


def test_boot_time_backlog_replays_without_new_traffic(tmp_path):
    store = egress.QueueStore(str(tmp_path / "q"))
    store.put({"n": 41})
    store.put({"n": 42})
    t = _Probe(store_dir=str(tmp_path / "q"), cooldown_s=0.05)
    egress.EgressRegistry().register(t)     # registration starts the replay
    try:
        assert _until(lambda: len(t.store) == 0)
        assert sorted(r["n"] for r in t.delivered) == [41, 42]
    finally:
        t.close()


# -- a sink ----------------------------------------------------------------------

class _Sink(BaseHTTPRequestHandler):
    received: list = []

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        type(self).received.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture
def sink():
    class Sink(_Sink):
        received = []
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Sink)
    t = threading.Thread(target=httpd.serve_forever, kwargs={
        "poll_interval": 0.05})
    t.start()
    yield Sink, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    t.join()


def _record(n: int) -> dict:
    return {"eventName": "ObjectCreated:Put",
            "s3": {"bucket": {"name": "b"}, "object": {"key": f"k{n}"}}}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_replays_the_others_queue_store(tmp_path, sink, writer):
    """A store one package's webhook target filled while its endpoint was
    down is replayed by the other package's target over the same
    ``queue_dir``, in order, leaving it empty."""
    Sink, port = sink
    url = f"http://127.0.0.1:{port}/hook"
    qdir = str(tmp_path / "q")
    store = (ref_egress if writer == "ref" else egress).QueueStore(qdir)
    for n in range(3):
        store.put(_record(n))
        time.sleep(0.001)
    names = sorted(os.listdir(qdir))
    assert len(names) == 3 and all(n.endswith(".json") for n in names)
    cls = WebhookTarget if writer == "ref" else RefWebhookTarget
    t = cls(WEBHOOK_ARN, url, store_dir=qdir, cooldown_s=60.0)
    try:
        assert len(t.store) == 3
        assert t.replay() == 3
        assert [r["Key"] for r in Sink.received] == ["b/k0", "b/k1", "b/k2"]
        assert os.listdir(qdir) == []
    finally:
        t.close()


# -- the port's server ------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("egress")
    mp = pytest.MonkeyPatch()
    mp.setenv("MT_CRAWL_INTERVAL_S", "1000000")
    srv = build_server([str(root / f"d{i}") for i in range(4)],
                       "127.0.0.1:0", AK, SK, block_size=4096, device="cpu")
    srv.start()
    yield srv
    srv.stop()
    mp.undo()
    assert_no_event_threads()


def _scrape(srv) -> str:
    return S3Client(srv.endpoint, AK, SK).request(
        "GET", "/minio-tpu/metrics", sign=False).body.decode()


def _samples(text: str, family: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{"):
            labels, value = line[len(family) + 1:].rsplit("} ", 1)
            out[labels] = float(value)
    return out


def _notify_cfg(arn) -> bytes:
    return (f"<NotificationConfiguration {NS}><QueueConfiguration>"
            f"<Queue>{arn}</Queue><Event>s3:ObjectCreated:*</Event>"
            "</QueueConfiguration></NotificationConfiguration>").encode()


def test_outage_drill_spill_scrape_and_replay(tmp_path, sink, served):
    """A store-backed webhook target behind a blackholed proxy: the PUTs
    do not wait on it, its records go to the store, the scrape and the
    ``targets`` route show it offline with its backlog, and when the
    proxy heals the background replay delivers every record once."""
    Sink, sink_port = sink
    srv = served
    proxy = FaultyProxy("127.0.0.1", sink_port).start()
    arn = "arn:minio:sqs::drill:webhook"
    t = WebhookTarget(arn, f"http://127.0.0.1:{proxy.port}/hook",
                      store_dir=str(tmp_path / "ev"), timeout=0.5,
                      max_attempts=1, offline_after=1, cooldown_s=0.25)
    srv.events.register_target(t)
    srv.egress.register(t)
    c = S3Client(srv.endpoint, AK, SK)
    try:
        c.make_bucket("drill")
        c.request("PUT", "/drill", "notification", _notify_cfg(arn))
        c.put_object("drill", "warm.bin", b"w")
        assert _until(lambda: len(Sink.received) == 1)
        proxy.set_default(Fault.blackhole())
        t0 = time.monotonic()
        for i in range(5):
            c.put_object("drill", f"o{i}.bin", b"x" * 1024)
        assert time.monotonic() - t0 < 3.0
        assert _until(lambda: len(t.store) >= 5 and not t.online)
        text = _scrape(srv)
        key = f'target="{arn}",target_type="notify"'
        assert _samples(text, "mt_target_online")[key] == 0
        assert _samples(text, "mt_target_store_length")[key] >= 5
        assert key in _samples(text, "mt_target_queue_length")
        rows = {r["target"]: r for r in json.loads(c.request(
            "GET", "/minio-tpu/admin/v1/targets").body)["targets"]}
        assert not rows[arn]["online"] and rows[arn]["lastError"]
        assert rows[arn]["state"] in ("offline", "probing")
        assert len(t.store) == 5
        proxy.set_default(None)
        assert _until(lambda: len(t.store) == 0 and t.online, timeout=15.0)
        assert _until(lambda: len(Sink.received) == 6)
        assert sorted(r["Records"][0]["s3"]["object"]["key"]
                      for r in Sink.received) == \
            ["o0.bin", "o1.bin", "o2.bin", "o3.bin", "o4.bin", "warm.bin"]
        doc = json.loads(c.request(
            "POST", "/minio-tpu/admin/v1/targets/replay").body)
        assert doc == {"node": srv.api_stats.label,
                       "replayed": {f"notify/{arn}": 0}}
    finally:
        srv.events.remove_target(arn)
        srv.egress.remove(t)
        t.close()
        proxy.stop()


def test_admin_replay_action_drains_store(tmp_path, sink, served):
    """``targets/replay`` delivers what is stored now, without waiting
    for the background probe."""
    Sink, sink_port = sink
    srv = served
    t = WebhookTarget("arn:minio:sqs::replay:webhook",
                      f"http://127.0.0.1:{sink_port}/hook", timeout=2.0,
                      store_dir=str(tmp_path / "q"), max_attempts=1,
                      offline_after=1, cooldown_s=600.0)
    srv.egress.register(t)
    try:
        t.store.put(_record(7))
        with t._mu:             # parked offline, mid-cooldown
            t._state = egress.OFFLINE
            t._opened_at = t._clock()
        doc = json.loads(S3Client(srv.endpoint, AK, SK).request(
            "POST", "/minio-tpu/admin/v1/targets/replay").body)
        assert doc["replayed"] == {f"notify/{t.arn}": 1}
        assert len(t.store) == 0 and t.online
        assert [r["Key"] for r in Sink.received] == ["b/k7"]
    finally:
        srv.egress.remove(t)
        t.close()


def test_config_reload_rebuilds_targets(tmp_path, sink, served):
    """SetConfigKV of ``notify_webhook`` rebuilds the webhook target live:
    on, it registers its ARN with a store and delivers; off, it is closed
    and the scrape has no ``mt_target_*`` family again.  ``api
    cors_allow_origin`` is accepted and read by nothing."""
    Sink, sink_port = sink
    srv = served
    adm = AdminClient(srv.endpoint, AK, SK)
    c = S3Client(srv.endpoint, AK, SK)
    assert srv.egress.targets() == [] and "mt_target_" not in _scrape(srv)
    adm.set_config_kv("api", "cors_allow_origin", "https://example.com")
    adm.set_config_kv("notify_webhook", "endpoint",
                      f"http://127.0.0.1:{sink_port}/hook")
    adm.set_config_kv("notify_webhook", "queue_dir", str(tmp_path / "q"))
    adm.set_config_kv("notify_webhook", "auth_token", "Bearer t")
    adm.set_config_kv("notify_webhook", "enable", "on")
    try:
        (t,) = srv.egress.targets()
        assert (t.target_type, t.name, t.auth_token) == \
            ("notify", WEBHOOK_ARN, "Bearer t")
        assert t.store is not None
        assert srv.events.valid_arns() == {WEBHOOK_ARN}
        c.make_bucket("reload")
        c.request("PUT", "/reload", "notification", _notify_cfg(WEBHOOK_ARN))
        c.put_object("reload", "k", b"v")
        assert _until(lambda: len(Sink.received) == 1)
        assert "mt_target_sent_total" in _scrape(srv)
    finally:
        adm.set_config_kv("notify_webhook", "enable", "off")
    assert srv.egress.targets() == [] and srv.events.valid_arns() == set()
    assert t._worker is None or not t._worker.is_alive()
    assert "mt_target_" not in _scrape(srv)


def test_stop_does_not_wait_out_a_listener(tmp_path):
    """A ListenNotification stream with a 300 s timeout ends when its
    server stops: ``stop()`` returns in well under its drain budget and
    the stream is a complete, empty answer."""
    before = set(threading.enumerate())
    srv = build_server([str(tmp_path / f"d{i}") for i in range(4)],
                       "127.0.0.1:0", AK, SK, block_size=4096, device="cpu")
    srv.start()
    out = {}
    c = S3Client(srv.endpoint, AK, SK)
    c.make_bucket("held")

    def listen():
        out["r"] = c.request("GET", "/held", "events&timeout=300",
                             expect=())

    t = threading.Thread(target=listen)
    t.start()
    assert _until(lambda: srv.events.pubsub.num_subscribers == 1)
    t0 = time.monotonic()
    srv.stop()
    took = time.monotonic() - t0
    t.join(10.0)
    assert not t.is_alive()
    assert took < srv.shutdown_drain_s
    assert out["r"].status == 200 and out["r"].body == b""
    assert_no_event_threads(before=before)
