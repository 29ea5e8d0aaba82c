"""The other bucket configs on the port against ``minio_tpu``: the
replication and notification documents (``bucket/replication.py``,
``bucket/notification.py``) parse and write back byte for byte as the
reference's, or fail with the same error, over a table of documents;
both servers (``_torch_control``) answer every ``?replication``,
``?notification``, ``?acl``, ``?cors`` and dummy-subresource call alike,
the object's ``?acl`` too, for a missing bucket and an anonymous caller
as well; and each package reads the configs the other stored in
``bucket-meta.json``."""

import pytest

from minio_tpu.bucket import notification as ref_notif
from minio_tpu.bucket import replication as ref_repl
from minio_tpu.events import MemoryTarget as RefMemoryTarget
from minio_tpu.objectlayer.bucket_meta import BucketMetadataSys as RefMeta
from minio_tpu_torch.bucket import notification as port_notif
from minio_tpu_torch.bucket import replication as port_repl
from minio_tpu_torch.events import MemoryTarget as PortMemoryTarget
from minio_tpu_torch.objectlayer.bucket_meta import \
    BucketMetadataSys as PortMeta

from ._torch_control import client, servers
from ._torch_objfeat import Pair, assert_no_event_threads, wire
from ._torch_versions import close, port_layer, ref_layer

NS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
ARN = "arn:minio:sqs::cfg:memory"
V = b"<VersioningConfiguration><Status>Enabled</Status>" \
    b"</VersioningConfiguration>"


def repl_rule(rid="r1", prio="1", status="Enabled", dest="arn:minio:"
              "replication:us-east-1:t1:dst", filt="<Filter><Prefix>p/"
              "</Prefix></Filter>", extra="") -> str:
    return (f"<Rule>{f'<ID>{rid}</ID>' if rid else ''}<Status>{status}"
            f"</Status><Priority>{prio}</Priority>{filt}"
            f"<Destination><Bucket>{dest}</Bucket></Destination>{extra}"
            "</Rule>")


def repl_doc(*rules, role="") -> bytes:
    return (f"<ReplicationConfiguration {NS}>"
            f"{f'<Role>{role}</Role>' if role else ''}{''.join(rules)}"
            "</ReplicationConfiguration>").encode()


REPLICATION = {
    "one-rule": repl_doc(repl_rule()),
    "role-and-switches": repl_doc(repl_rule(extra=(
        "<DeleteMarkerReplication><Status>Enabled</Status>"
        "</DeleteMarkerReplication><DeleteReplication><Status>Disabled"
        "</Status></DeleteReplication>")), role="arn:role"),
    "priorities": repl_doc(repl_rule("a", "1"), repl_rule("b", "5"),
                           repl_rule("", "3", status="Disabled")),
    "tags-and": repl_doc(repl_rule(filt=(
        "<Filter><And><Prefix>x/</Prefix><Tag><Key>k</Key><Value>v</Value>"
        "</Tag><Tag><Key>j</Key><Value>w</Value></Tag></And></Filter>"))),
    "one-tag": repl_doc(repl_rule(filt="<Filter><Tag><Key>k</Key>"
                                  "<Value>v</Value></Tag></Filter>")),
    "storage-class": repl_doc(repl_rule().replace(
        "</Bucket>", "</Bucket><StorageClass>STANDARD_IA</StorageClass>")),
    "no-namespace": repl_doc(repl_rule()).replace(NS.encode(), b""),
    "malformed": b"<ReplicationConfiguration><Rule>",
    "wrong-root": b"<Replication/>",
    "no-rules": repl_doc(),
    "bad-status": repl_doc(repl_rule(status="On")),
    "no-destination": repl_doc(repl_rule(dest="")),
    "duplicate-id": repl_doc(repl_rule("a", "1"), repl_rule("a", "2")),
    "duplicate-priority": repl_doc(repl_rule("a", "1"), repl_rule("b", "1")),
    "priority-not-a-number": repl_doc(repl_rule(prio="high")),
    "empty-tag-key": repl_doc(repl_rule(filt="<Filter><Tag><Key></Key>"
                                        "</Tag></Filter>")),
}


def notif_conf(kind="Queue", arn=ARN, events=("s3:ObjectCreated:*",),
               rules=()) -> str:
    filt = "" if not rules else "<Filter><S3Key>" + "".join(
        f"<FilterRule><Name>{n}</Name><Value>{v}</Value></FilterRule>"
        for n, v in rules) + "</S3Key></Filter>"
    return (f"<{kind}Configuration><{kind}>{arn}</{kind}>" +
            "".join(f"<Event>{e}</Event>" for e in events) + filt +
            f"</{kind}Configuration>")


def notif_doc(*confs) -> bytes:
    return (f"<NotificationConfiguration {NS}>{''.join(confs)}"
            "</NotificationConfiguration>").encode()


NOTIFICATION = {
    "empty": notif_doc(),
    "queue": notif_doc(notif_conf()),
    "every-kind": notif_doc(
        notif_conf(), notif_conf("Topic", events=("s3:ObjectRemoved:*",)),
        notif_conf("CloudFunction", events=("s3:ObjectAccessed:Get",))),
    "filters": notif_doc(notif_conf(rules=(("prefix", "in/"),
                                           ("Suffix", ".jpg")))),
    "overlapping-filters": notif_doc(
        notif_conf(rules=(("prefix", "a/"),)),
        notif_conf(events=("s3:ObjectCreated:Put", "s3:ObjectRestore:*"),
                   rules=(("prefix", "a/b/"), ("prefix", "a/b/c/")))),
    "every-event": notif_doc(notif_conf(events=(
        "s3:ObjectCreated:*", "s3:ObjectRemoved:*", "s3:ObjectAccessed:*",
        "s3:ObjectRestore:Post", "s3:ObjectRestore:Completed",
        "s3:Replication:*"))),
    # the reference's names have no wildcard for the restore events
    "restore-wildcard": notif_doc(notif_conf(events=("s3:ObjectRestore:*",))),
    "unknown-arn": notif_doc(notif_conf(arn="arn:minio:sqs::x:webhook")),
    "unknown-event": notif_doc(notif_conf(events=("s3:ObjectMoved:*",))),
    "no-events": notif_doc(notif_conf(events=())),
    "no-arn": notif_doc(notif_conf(arn="")),
    "bad-rule-name": notif_doc(notif_conf(rules=(("infix", "x"),))),
    "malformed": b"<NotificationConfiguration>",
    "wrong-root": b"<Notification/>",
}


def _outcome(fn):
    """("ok", bytes written back) or ("error", class name, message,
    code)."""
    try:
        return ("ok", fn().to_xml())
    except ValueError as e:
        return ("error", type(e).__name__, str(e), getattr(e, "code", None))


# -- the documents alone -------------------------------------------------------

@pytest.mark.parametrize("name", list(REPLICATION))
def test_replication_documents_equal_the_references(name):
    doc = REPLICATION[name]
    assert _outcome(lambda: port_repl.Config.parse(doc)) == \
        _outcome(lambda: ref_repl.Config.parse(doc))


@pytest.mark.parametrize("name", list(NOTIFICATION))
@pytest.mark.parametrize("arns", [None, {ARN}], ids=["unchecked", "checked"])
def test_notification_documents_equal_the_references(name, arns):
    doc = NOTIFICATION[name]
    assert _outcome(lambda: port_notif.Config.parse(doc, arns)) == \
        _outcome(lambda: ref_notif.Config.parse(doc, arns))


@pytest.mark.parametrize("name", ["priorities", "tags-and", "one-tag",
                                  "role-and-switches"])
def test_replication_decisions_equal_the_references(name):
    port = port_repl.Config.parse(REPLICATION[name])
    ref = ref_repl.Config.parse(REPLICATION[name])
    for key in ("p/a", "x/a", "q", "p/x/a", ""):
        for tags in ({}, {"k": "v"}, {"k": "v", "j": "w"}, {"k": "x"}):
            for dm, vd in ((False, False), (True, False), (False, True)):
                got = port.replicate(key, tags, dm, vd)
                want = ref.replicate(key, tags, dm, vd)
                assert (got and (got.rule_id, got.priority)) == \
                    (want and (want.rule_id, want.priority)), (key, tags)


# -- the routes on both servers ------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("bucketcfg")
    with servers(root, mp) as (ref, port):
        ref.events.register_target(RefMemoryTarget(ARN))
        port.events.register_target(PortMemoryTarget(ARN))
        p = Pair(ref, port, root)
        for b in ("cfg", "cfgv"):
            p.same("PUT", f"/{b}", status=200)
        p.same("PUT", "/cfgv", "versioning", body=V, status=200)
        p.same("PUT", "/cfg/obj", body=b"x" * 100, status=200)
        yield p
    ref.events._pool.shutdown(wait=True)
    mp.undo()
    assert_no_event_threads()


ROUTES = [
    # replication: a bucket without versioning refuses it
    ("GET", "/cfgv", "replication", b"", None),
    ("PUT", "/cfg", "replication", REPLICATION["one-rule"], None),
    ("PUT", "/cfgv", "replication", REPLICATION["malformed"], None),
    ("PUT", "/cfgv", "replication", REPLICATION["priorities"], None),
    ("GET", "/cfgv", "replication", b"", None),
    ("POST", "/cfgv", "replication", b"", None),
    ("DELETE", "/cfgv", "replication", b"", None),
    ("GET", "/cfgv", "replication", b"", None),
    # notification: the registered ARN only; an empty one removes it
    ("GET", "/cfg", "notification", b"", None),
    ("PUT", "/cfg", "notification", NOTIFICATION["unknown-arn"], None),
    ("PUT", "/cfg", "notification", NOTIFICATION["unknown-event"], None),
    ("PUT", "/cfg", "notification", NOTIFICATION["every-kind"], None),
    ("GET", "/cfg", "notification", b"", None),
    ("DELETE", "/cfg", "notification", b"", None),
    ("PUT", "/cfg", "notification", NOTIFICATION["empty"], None),
    ("GET", "/cfg", "notification", b"", None),
    # ACLs: the canned private one only
    ("GET", "/cfg", "acl", b"", None),
    ("PUT", "/cfg", "acl", b"", None),
    ("PUT", "/cfg", "acl", b"", {"x-amz-acl": "public-read"}),
    ("PUT", "/cfg", "acl", b"<AccessControlPolicy><Grant>READ</Grant>"
     b"</AccessControlPolicy>", None),
    ("PUT", "/cfg", "acl", b"<AccessControlPolicy><Permission>FULL_CONTROL"
     b"</Permission></AccessControlPolicy>", None),
    ("DELETE", "/cfg", "acl", b"", None),
    ("GET", "/cfg/obj", "acl", b"", None),
    ("PUT", "/cfg/obj", "acl", b"", None),
    ("PUT", "/cfg/obj", "acl", b"", {"x-amz-acl": "public-read"}),
    ("DELETE", "/cfg/obj", "acl", b"", None),
    ("GET", "/cfg/nosuch", "acl", b"", None),
    # CORS and the dummy subresources
    ("GET", "/cfg", "cors", b"", None),
    ("PUT", "/cfg", "cors", b"<CORSConfiguration/>", None),
    ("DELETE", "/cfg", "cors", b"", None),
    ("GET", "/cfg", "accelerate", b"", None),
    ("GET", "/cfg", "requestPayment", b"", None),
    ("GET", "/cfg", "logging", b"", None),
    ("GET", "/cfg", "website", b"", None),
    ("DELETE", "/cfg", "website", b"", None),
    ("PUT", "/cfg", "logging", b"<BucketLoggingStatus/>", None),
    ("DELETE", "/cfg", "accelerate", b"", None),
]


def test_config_routes_answer_alike(pair):
    """One sequence through both servers, every answer compared whole."""
    for method, path, query, body, headers in ROUTES:
        pair.same(method, path, query, body, headers)
    assert pair.port.bucket_meta.get_config("cfgv", "replication") is None
    assert pair.port.bucket_meta.get_config("cfg", "notification") is None


MISSING = ["replication", "notification", "acl", "cors", "accelerate",
           "requestPayment", "logging", "website"]


@pytest.mark.parametrize("query", MISSING)
@pytest.mark.parametrize("method", ["GET", "PUT"])
def test_a_missing_bucket_and_an_anonymous_caller_alike(pair, method,
                                                        query):
    """A missing bucket answers as the reference's does (its action is
    authorised first), and an anonymous caller is refused alike on an
    existing bucket."""
    body = {"replication": REPLICATION["one-rule"],
            "notification": NOTIFICATION["queue"]}.get(query, b"")
    pair.same(method, "/nosuchbkt", query, body)
    r, p = (client(s).request(method, "/cfgv", query, body, sign=False,
                              expect=()) for s in (pair.ref, pair.port))
    assert wire(p) == wire(r)
    assert p.status == 403


def test_a_stored_notification_config_lists_its_expanded_events(pair):
    pair.same("PUT", "/cfg", "notification", NOTIFICATION["filters"],
              status=200)
    got = pair.same("GET", "/cfg", "notification", status=200)
    assert b"<Event>s3:ObjectCreated:Put</Event>" in got.body
    assert b"<Name>suffix</Name><Value>.jpg</Value>" in got.body
    pair.same("PUT", "/cfg", "notification", NOTIFICATION["empty"],
              status=200)


# -- the stored documents across packages ----------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_reads_the_configs_the_other_stored(tmp_path, writer):
    docs = {"replication": port_repl.Config.parse(
                REPLICATION["priorities"]).to_xml().decode(),
            "notification": port_notif.Config.parse(
                NOTIFICATION["every-kind"]).to_xml().decode()}
    rl, pl = ref_layer(tmp_path), port_layer(tmp_path)
    try:
        metas = {"ref": RefMeta(rl), "port": PortMeta(pl)}
        for name, doc in docs.items():
            metas[writer].set_config("bkt", name, doc)
        reader = metas["port" if writer == "ref" else "ref"]
        for name, doc in docs.items():
            assert reader.get_config("bkt", name) == doc
        mods = {"ref": (ref_repl, ref_notif), "port": (port_repl, port_notif)}
        repl, notif = mods["port" if writer == "ref" else "ref"]
        assert repl.Config.parse(reader.get_config(
            "bkt", "replication").encode()).to_xml().decode() == \
            docs["replication"]
        assert notif.Config.parse(reader.get_config(
            "bkt", "notification").encode()).to_xml().decode() == \
            docs["notification"]
    finally:
        close(rl, pl)
