"""The broker targets on the port's S3 server against ``minio_tpu``'s
(``_torch_control.servers``, one pair for the module): SetConfigKV of each
``notify_<kind>`` answers alike and builds ``arn:minio:sqs::1:<kind>``
live, an unknown key answers alike; a notification config naming the nine
ARNs, then the same pinned requests (each package's event clock on its
own counter from one start, as in ``test_torch_events.py``) leave equal
state in the two servers' stubs (``tests/broker_stubs.py``, one set per
server); the ``targets`` route lists the nine; ``mt_target_*`` is
labelled per target.  Last, ROADMAP Queue 3 record 55: a SetConfigKV of
one ``notify_*`` subsystem rebuilds only its target on the port, and
every target on the reference (its ``[ref]`` case)."""

import contextlib
import itertools
import json
import time
import types

import pytest

from minio_tpu.events import event as ref_event
from minio_tpu_torch.events import event as port_event

from ._torch_control import client, servers
from ._torch_objfeat import Pair, assert_no_event_threads
from .broker_stubs import (AMQPStubBroker, ESStubServer, KafkaStubBroker,
                           MQTTStubBroker, MySQLStubBroker, NATSStubBroker,
                           NSQStubBroker, PostgresStubBroker, RedisStubBroker)

NS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
T0 = 1_760_000_000_000_000_000
KINDS = ("amqp", "kafka", "mqtt", "nats", "nsq", "redis", "mysql",
         "postgresql", "elasticsearch")
ARNS = {k: f"arn:minio:sqs::1:{k}" for k in KINDS}
STUBS = {"amqp": AMQPStubBroker, "kafka": KafkaStubBroker,
         "mqtt": MQTTStubBroker, "nats": NATSStubBroker,
         "nsq": NSQStubBroker, "redis": RedisStubBroker,
         "mysql": MySQLStubBroker, "postgresql": PostgresStubBroker,
         "elasticsearch": ESStubServer}


def settings(kind: str, port: int, qdir: str) -> dict:
    """The ``notify_<kind>`` keys for a stub on ``port``."""
    addr = f"127.0.0.1:{port}"
    return dict({
        "amqp": {"url": f"amqp://minio:secret@{addr}/vh", "exchange": "ev",
                 "routing_key": "bucketlogs"},
        "kafka": {"brokers": addr, "topic": "minio-events"},
        "mqtt": {"broker": f"tcp://{addr}", "topic": "minio/events",
                 "qos": "1"},
        "nats": {"address": addr, "subject": "bucketevents",
                 "username": "evuser", "password": "evpass"},
        "nsq": {"nsqd_address": addr, "topic": "minio"},
        "redis": {"address": addr, "key": "minio_events",
                  "format": "namespace"},
        "mysql": {"dsn_string": f"evuser:evpass@tcp({addr})/minio",
                  "table": "events_ns", "format": "namespace"},
        "postgresql": {"connection_string": f"host=127.0.0.1 port={port} "
                       "user=evuser password=evpass dbname=minio",
                       "table": "events_ns", "format": "namespace"},
        "elasticsearch": {"url": f"http://{addr}", "index": "minio-log",
                          "format": "access"},
    }[kind], queue_dir=qdir, enable="on")


def state(kind: str, stub):
    """What a stub holds, JSON-comparable."""
    got = {"amqp": lambda s: (s.published, s.exchanges, s.auth),
           "kafka": lambda s: s.produced,
           "mqtt": lambda s: (s.published, s.clients),
           "nats": lambda s: (s.published, s.connects),
           "nsq": lambda s: s.published,
           "redis": lambda s: (s.hashes, s.lists),
           "mysql": lambda s: (s.sql.tables, s.sql.statements),
           "postgresql": lambda s: (s.sql.tables, s.sql.statements),
           "elasticsearch": lambda s: s.indices}[kind](stub)
    return json.loads(json.dumps(got, default=repr))


def notify_cfg(prefix: str = "br/") -> bytes:
    queues = "".join(
        f"<QueueConfiguration><Id>{k}</Id><Queue>{arn}</Queue>"
        "<Event>s3:ObjectCreated:*</Event><Event>s3:ObjectAccessed:*</Event>"
        "<Event>s3:ObjectRemoved:*</Event><Filter><S3Key><FilterRule>"
        f"<Name>prefix</Name><Value>{prefix}</Value></FilterRule></S3Key>"
        "</Filter></QueueConfiguration>" for k, arn in ARNS.items())
    return (f"<NotificationConfiguration {NS}>{queues}"
            "</NotificationConfiguration>").encode()


def _until(pred, timeout=15.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def broker_targets(srv) -> dict:
    """ARN -> the server's registered broker target."""
    return {arn: srv.events._targets.get(arn) for arn in ARNS.values()}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("brokers")
    with contextlib.ExitStack() as stack:
        stubs = {}
        for tag in ("ref", "port"):
            for kind, make in STUBS.items():
                stubs[tag, kind] = make().start()
                stack.callback(stubs[tag, kind].stop)
        with servers(root, mp) as (ref, port):
            p = Pair(ref, port, root)
            p.stubs = stubs
            assert not port.events.valid_arns() & set(ARNS.values())
            _configure(p, root / "queues")
            yield p
        ref.events._pool.shutdown(wait=True)    # its stop does not wait
        mp.undo()
    assert_no_event_threads()


def _configure(p, qroot) -> None:
    """Every ``notify_<kind>`` set on both running servers through
    SetConfigKV, each answering 200."""
    p.qroot = qroot
    for kind in KINDS:
        for tag, srv in (("ref", p.ref), ("port", p.port)):
            for key, value in settings(kind, p.stubs[tag, kind].port,
                                       str(qroot / tag / kind)).items():
                r = client(srv).request(
                    "PUT", f"/minio-tpu/admin/v1/config/notify_{kind}/{key}",
                    body=value.encode(), expect=())
                assert r.status == 200, (kind, key, r.body)


def test_set_config_kv_builds_each_target_live(pair):
    """The fixture set the nine subsystems on the running servers."""
    p = pair
    for srv in (p.ref, p.port):
        assert set(ARNS.values()) <= srv.events.valid_arns()
    for kind, arn in ARNS.items():
        t = broker_targets(p.port)[arn]
        assert type(t).__name__ == type(broker_targets(p.ref)[arn]).__name__
        assert t.store is not None and t.store.dir == str(
            p.qroot / "port" / kind)
        assert t in p.port.egress.targets()
    for path in ("config/notify_kafka/nosuch", "config/notify_nosuch/topic"):
        got = p.both("PUT", f"/minio-tpu/admin/v1/{path}", body=b"1")
        assert got[0].status == got[1].status == 400, path
        assert json.loads(got[1].body) == json.loads(got[0].body)
    got = p.both("GET", "/minio-tpu/admin/v1/config/notify_kafka")
    assert json.loads(got[1].body)["brokers"] == \
        f"127.0.0.1:{p.stubs['port', 'kafka'].port}"


def test_the_same_requests_leave_equal_stub_state(pair, monkeypatch):
    p = pair
    assert set(ARNS.values()) <= p.port.events.valid_arns()
    p.same("PUT", "/brk", status=200)
    bad = notify_cfg().replace(b"::1:kafka", b"::9:kafka")
    p.same("PUT", "/brk", "notification", bad, err="MalformedXML")
    p.same("PUT", "/brk", "notification", notify_cfg(), status=200)
    for mod in (ref_event, port_event):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time_ns=itertools.count(T0, 1_000_000).__next__))
    tricky = "br/q'u\"o\\te ü.bin"
    steps = [("PUT", "/brk/br/obj", b"x" * 5000, 1),
             ("GET", "/brk/br/obj", b"", 1),
             ("PUT", "/brk/" + tricky, b"t" * 70, 1),
             ("PUT", "/brk/br/obj", b"y" * 3000, 1),
             ("DELETE", "/brk/br/obj", b"", 1),
             ("PUT", "/brk/other/k", b"o", 0)]
    base = {t: t.sent for srv in (p.ref, p.port)
            for t in broker_targets(srv).values()}
    sent = 0
    for method, path, body, fires in steps:
        p.same(method, path, body=body)
        sent += fires
        for srv in (p.ref, p.port):
            targets = broker_targets(srv).values()
            assert _until(lambda: all(t.sent - base[t] == sent
                                      for t in targets)), \
                [(t.arn, t.sent, t.last_error) for t in targets]
    for srv in (p.ref, p.port):
        for t in broker_targets(srv).values():
            t.flush(10.0)
            assert t.sent - base[t] == 5 and t.failed == 0, \
                (t.arn, t.last_error)
    for kind in KINDS:
        if kind == "mqtt":
            assert _until(lambda: all(len(p.stubs[tag, kind].published) == 5
                                      for tag in ("ref", "port")))
        assert state(kind, p.stubs["port", kind]) == \
            state(kind, p.stubs["ref", kind]), kind
    # the namespace tables hold the tricky key alone (as the record
    # carries it, escaped); the access index holds the five events
    ps = p.stubs
    key = "brk/br/q%27u%22o%5Cte%20%C3%BC.bin"
    assert list(ps["port", "redis"].hashes["minio_events"]) == [key]
    assert list(ps["port", "mysql"].sql.tables["events_ns"]) == [key]
    assert list(ps["port", "postgresql"].sql.tables["events_ns"]) == [key]
    docs = list(ps["port", "elasticsearch"].indices["minio-log"].values())
    assert [d["Records"][0]["eventName"] for d in docs] == [
        "ObjectCreated:Put", "ObjectAccessed:Get", "ObjectCreated:Put",
        "ObjectCreated:Put", "ObjectRemoved:Delete"]
    kafka = [json.loads(v) for _, _, v in ps["port", "kafka"].produced]
    assert [d["Key"] for d in kafka] == \
        ["brk/br/obj", "brk/br/obj", key, "brk/br/obj", "brk/br/obj"]


def _rows(srv) -> dict:
    doc = json.loads(client(srv).request(
        "GET", "/minio-tpu/admin/v1/targets").body)
    return {r["target"]: r for r in doc["targets"]
            if r["type"] == "notify"}


def test_the_targets_route_lists_the_nine(pair):
    p = pair
    rows = {tag: _rows(srv) for tag, srv in (("ref", p.ref),
                                              ("port", p.port))}
    assert set(ARNS.values()) <= set(rows["port"])
    assert set(rows["port"]) == set(rows["ref"])
    for arn in ARNS.values():
        mine, theirs = rows["port"][arn], rows["ref"][arn]
        assert mine["online"] and mine["stored"] == 0
        for k in ("sent", "failed", "dropped", "online", "stored"):
            assert mine[k] == theirs[k], (arn, k)


def _target_samples(srv, family: str) -> dict:
    text = client(srv).request("GET", "/minio-tpu/metrics",
                               sign=False).body.decode()
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{"):
            labels, value = line[len(family) + 1:].rsplit("} ", 1)
            if 'target_type="notify"' in labels:
                out[labels] = float(value)
    return out


def test_mt_target_is_labelled_per_target(pair):
    p = pair
    for family in ("mt_target_sent_total", "mt_target_failed_total",
                   "mt_target_online", "mt_target_store_length"):
        got = _target_samples(p.port, family)
        assert got == _target_samples(p.ref, family), family
        for arn in ARNS.values():
            assert f'target="{arn}",target_type="notify"' in got, \
                (family, arn)


def _reconfigure_kafka(srv, topic: str):
    """SetConfigKV of ``notify_kafka topic``; returns the broker targets
    before and after."""
    before = broker_targets(srv)
    r = client(srv).request(
        "PUT", "/minio-tpu/admin/v1/config/notify_kafka/topic",
        body=topic.encode(), expect=())
    assert r.status == 200
    return before, broker_targets(srv)


def test_a_reload_rebuilds_only_the_changed_target(pair):
    """Record 55: on the port, a SetConfigKV of ``notify_kafka`` closes
    and rebuilds the Kafka target alone; every other target keeps its
    engine, its connection state and its ``mt_target_*`` counts.  The
    same values set again rebuild nothing."""
    p = pair
    sent_before = _target_samples(p.port, "mt_target_sent_total")
    before, after = _reconfigure_kafka(p.port, "minio-events-2")
    kafka = ARNS["kafka"]
    assert after[kafka] is not before[kafka] and after[kafka].sent == 0
    assert after[kafka].topic == "minio-events-2"
    for arn in set(ARNS.values()) - {kafka}:
        assert after[arn] is before[arn], arn
    sent = _target_samples(p.port, "mt_target_sent_total")
    for arn in ARNS.values():
        key = f'target="{arn}",target_type="notify"'
        assert sent[key] == (0 if arn == kafka else sent_before[key]), arn
    _, again = _reconfigure_kafka(p.port, "minio-events-2")
    assert again == after


def test_ref_a_reload_rebuilds_every_target(pair):
    """[ref] record 55: the reference rebuilds every target on a change
    of any ``notify_*`` subsystem, so the others' counts go back to 0."""
    p = pair
    before, after = _reconfigure_kafka(p.ref, "minio-events-2")
    for arn in ARNS.values():
        assert after[arn] is not before[arn] and after[arn].sent == 0, arn
    sent = _target_samples(p.ref, "mt_target_sent_total")
    assert sent[f'target="{ARNS["redis"]}",target_type="notify"'] == 0
