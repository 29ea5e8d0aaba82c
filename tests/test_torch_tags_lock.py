"""The port's ``bucket/tags.py`` and ``bucket/objectlock.py`` against
``minio_tpu``'s, exact, on seeded and hypothesis-drawn inputs: tag sets
as Tagging documents and as ``x-amz-tagging`` headers (valid, over every
limit, duplicated, malformed) for objects and buckets, with every error
code and message; object-lock configurations, retentions and legal
holds parsed, written back and refused alike; the default retention's
dates; and the WORM rule ``check_delete_allowed`` on version metadata at
many instants, with and without the governance bypass."""

import datetime
import urllib.parse
from xml.sax.saxutils import escape

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from minio_tpu.bucket import objectlock as ref_lock
from minio_tpu.bucket import tags as ref_tags
from minio_tpu_torch.bucket import objectlock as port_lock
from minio_tpu_torch.bucket import tags as port_tags

NS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
UTC = datetime.timezone.utc
NOW = datetime.datetime(2026, 10, 17, 12, 0, 0, tzinfo=UTC)
ALPHABET = "abcXYZ09 -_.:/=+&?%é"


def outcome(fn, *a, **kw):
    """What a call gives: ("ok", value) or ("err", class name, code,
    message)."""
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return ("err", type(e).__name__, getattr(e, "code", None), str(e))


def both(name: str, *a, **kw):
    """The same call of ``name`` in both tags modules."""
    r = outcome(getattr(ref_tags, name), *a, **kw)
    p = outcome(getattr(port_tags, name), *a, **kw)
    assert p == r
    return p


def lock_both(fn, *a, **kw):
    r = outcome(fn(ref_lock), *a, **kw)
    p = outcome(fn(port_lock), *a, **kw)
    if r[0] == "ok" and hasattr(r[1], "__dict__"):
        assert p[0] == "ok" and vars(p[1]) == vars(r[1])
    else:
        assert p == r
    return p


def _word(rng, lo: int, hi: int) -> str:
    n = int(rng.integers(lo, hi + 1))
    return "".join(ALPHABET[i] for i in rng.integers(0, len(ALPHABET), n))


def _tagset(rng) -> list[tuple[str, str]]:
    """Mostly valid tag sets; now and then one past a limit."""
    n = int(rng.choice([0, 1, 3, 10, 11, 50, 51]))
    pairs = [(_word(rng, 1, 20) + str(i), _word(rng, 0, 20))
             for i in range(n)]
    kind = int(rng.integers(0, 8))
    if pairs and kind == 0:
        pairs[0] = ("", "v")
    elif pairs and kind == 1:
        pairs[0] = ("k" * int(rng.choice([128, 129])), "v")
    elif pairs and kind == 2:
        pairs[0] = ("k", "v" * int(rng.choice([256, 257])))
    elif len(pairs) > 1 and kind == 3:
        pairs[1] = (pairs[0][0], "dup")
    return pairs


def _doc(pairs, ns: bool) -> bytes:
    tags = "".join(f"<Tag><Key>{escape(k)}</Key><Value>{escape(v)}"
                   "</Value></Tag>" for k, v in pairs)
    return (f"<Tagging{' ' + NS if ns else ''}><TagSet>{tags}</TagSet>"
            "</Tagging>").encode()


@pytest.mark.parametrize("seed", range(24))
def test_tag_documents_and_headers_alike(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        pairs = _tagset(rng)
        for is_object in (True, False):
            got = both("parse_xml", _doc(pairs, bool(seed % 2)), is_object)
            if got[0] == "ok":
                assert both("to_xml", got[1]) == \
                    ("ok", ref_tags.to_xml(got[1]))
                hdr = both("to_header", got[1])[1]
                assert both("parse_header", hdr, is_object) == got
            hdr = "&".join(f"{urllib.parse.quote(k)}={urllib.parse.quote(v)}"
                           for k, v in pairs)
            both("parse_header", hdr, is_object)


@pytest.mark.parametrize("doc", [
    b"", b"<Tagging", b"<Other><TagSet/></Other>", b"<Tagging/>",
    b"<Tagging><TagSet/></Tagging>",
    b"<Tagging><TagSet><Tag><Key>a</Key></Tag></TagSet></Tagging>",
    b"<Tagging><TagSet><Tag><Value>v</Value></Tag></TagSet></Tagging>",
    f"<Tagging {NS}><TagSet><Tag><Key>a</Key><Value>1</Value></Tag>"
    "</TagSet></Tagging>".encode(),
], ids=["empty", "truncated", "root", "no-tagset", "empty-tagset",
        "no-value", "no-key", "namespaced"])
@pytest.mark.parametrize("is_object", [True, False])
def test_tag_document_edges_alike(doc, is_object):
    both("parse_xml", doc, is_object)


@pytest.mark.parametrize("hdr", ["", "a", "a=", "=b", "a=1&a=2", "a=1&&b=2",
                                 "a%20b=c%26d", "k=" + "v" * 257,
                                 "&".join(f"k{i}=v" for i in range(11)),
                                 "&".join(f"k{i}=v" for i in range(51))])
@pytest.mark.parametrize("is_object", [True, False])
def test_tag_header_edges_alike(hdr, is_object):
    both("parse_header", hdr, is_object)


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(st.text(max_size=130), st.text(max_size=260),
                       max_size=12), st.booleans())
def test_tag_headers_round_trip_alike(tags, is_object):
    hdr = both("to_header", tags)[1]
    both("parse_header", hdr, is_object)
    both("to_xml", tags)


# -- object lock ---------------------------------------------------------------

def _iso(dt: datetime.datetime) -> str:
    return dt.strftime("%Y-%m-%dT%H:%M:%SZ")


LOCK_DOCS = [
    f"<ObjectLockConfiguration {NS}><ObjectLockEnabled>Enabled"
    "</ObjectLockEnabled></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled>"
    "<Rule><DefaultRetention><Mode>GOVERNANCE</Mode><Days>3</Days>"
    "</DefaultRetention></Rule></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>COMPLIANCE"
    "</Mode><Years>2</Years></DefaultRetention></Rule>"
    "</ObjectLockConfiguration>",
    "<ObjectLockConfiguration><ObjectLockEnabled>Disabled"
    "</ObjectLockEnabled></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule/></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>WORM</Mode>"
    "<Days>1</Days></DefaultRetention></Rule></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>GOVERNANCE"
    "</Mode></DefaultRetention></Rule></ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>GOVERNANCE"
    "</Mode><Days>1</Days><Years>1</Years></DefaultRetention></Rule>"
    "</ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>GOVERNANCE"
    "</Mode><Days>0</Days></DefaultRetention></Rule>"
    "</ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>GOVERNANCE"
    "</Mode><Years>-1</Years></DefaultRetention></Rule>"
    "</ObjectLockConfiguration>",
    "<ObjectLockConfiguration><Rule><DefaultRetention><Mode>GOVERNANCE"
    "</Mode><Days>x</Days></DefaultRetention></Rule>"
    "</ObjectLockConfiguration>",
    "<Other/>", "<ObjectLockConfiguration",
]


@pytest.mark.parametrize("doc", LOCK_DOCS)
def test_lock_configurations_alike(doc):
    got = lock_both(lambda m: m.LockConfig.parse, doc.encode())
    if got[0] != "ok":
        return
    cfg = got[1]
    ref_cfg = ref_lock.LockConfig(**vars(cfg))
    assert cfg.to_xml() == ref_cfg.to_xml()
    for now in (NOW, NOW + datetime.timedelta(days=400, seconds=7)):
        assert cfg.default_retention_headers(now) == \
            ref_cfg.default_retention_headers(now)


def _retention(mode: str, until: str) -> bytes:
    return (f"<Retention {NS}><Mode>{mode}</Mode><RetainUntilDate>{until}"
            "</RetainUntilDate></Retention>").encode()


FUTURE = datetime.datetime.now(UTC) + datetime.timedelta(days=5)


@pytest.mark.parametrize("doc", [
    _retention("GOVERNANCE", _iso(FUTURE)),
    _retention("COMPLIANCE", _iso(FUTURE)),
    _retention("COMPLIANCE", FUTURE.strftime("%Y-%m-%dT%H:%M:%S")),
    _retention("COMPLIANCE", FUTURE.isoformat()),
    _retention("GOVERNANCE", "2001-01-01T00:00:00Z"),
    _retention("WORM", _iso(FUTURE)),
    _retention("GOVERNANCE", "later"),
    _retention("GOVERNANCE", ""),
    b"<Retention><Mode>GOVERNANCE</Mode></Retention>",
    b"<Other/>", b"<Retention",
], ids=["governance", "compliance", "naive", "offset", "past", "bad-mode",
        "bad-date", "empty-date", "no-date", "root", "truncated"])
def test_retentions_alike(doc):
    got = lock_both(lambda m: m.Retention.parse, doc)
    if got[0] == "ok":
        ret = got[1]
        ref_ret = ref_lock.Retention(**vars(ret))
        assert ret.to_xml() == ref_ret.to_xml()
        for now in (NOW, FUTURE, FUTURE + datetime.timedelta(seconds=1)):
            assert ret.active(now) == ref_ret.active(now)


@pytest.mark.parametrize("doc", [
    b"<LegalHold><Status>ON</Status></LegalHold>",
    f"<LegalHold {NS}><Status>OFF</Status></LegalHold>".encode(),
    b"<LegalHold><Status>on</Status></LegalHold>", b"<LegalHold/>",
    b"<Other><Status>ON</Status></Other>", b"<LegalHold",
])
def test_legal_holds_alike(doc):
    got = lock_both(lambda m: m.legal_hold_from_xml, doc)
    if got[0] == "ok":
        assert port_lock.legal_hold_to_xml(got[1]) == \
            ref_lock.legal_hold_to_xml(got[1])
    assert port_lock.legal_hold_to_xml("") == ref_lock.legal_hold_to_xml("")


def _meta(rng) -> dict:
    meta = {}
    mode = rng.choice(["", "GOVERNANCE", "COMPLIANCE", "OTHER"])
    if mode:
        meta[port_lock.AMZ_OBJECT_LOCK_MODE] = str(mode)
    until = rng.choice(["none", "past", "future", "garbage", "naive"])
    off = datetime.timedelta(hours=int(rng.integers(1, 5000)))
    if until == "past":
        meta[port_lock.AMZ_OBJECT_LOCK_RETAIN_UNTIL] = _iso(NOW - off)
    elif until == "future":
        meta[port_lock.AMZ_OBJECT_LOCK_RETAIN_UNTIL] = _iso(NOW + off)
    elif until == "naive":
        meta[port_lock.AMZ_OBJECT_LOCK_RETAIN_UNTIL] = \
            (NOW + off).strftime("%Y-%m-%dT%H:%M:%S")
    elif until == "garbage":
        meta[port_lock.AMZ_OBJECT_LOCK_RETAIN_UNTIL] = "soon"
    hold = rng.choice(["", "ON", "OFF", "on", "x"])
    if hold:
        meta[port_lock.AMZ_OBJECT_LOCK_LEGAL_HOLD] = str(hold)
    return meta


@pytest.mark.parametrize("seed", range(16))
def test_the_delete_rule_alike(seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(40):
        meta = _meta(rng)
        ret = port_lock.Retention.from_metadata(meta)
        assert vars(ret) == vars(ref_lock.Retention.from_metadata(meta))
        for now in (NOW, NOW + datetime.timedelta(days=int(
                rng.integers(0, 400)))):
            for bypass in (False, True):
                assert port_lock.check_delete_allowed(meta, bypass, now) == \
                    ref_lock.check_delete_allowed(meta, bypass, now)


def test_the_delete_rule_cases():
    """The WORM rule spelled out: a legal hold or an unexpired COMPLIANCE
    retention refuses every delete, an unexpired GOVERNANCE one yields to
    the bypass, an expired one to anyone."""
    later, earlier = _iso(NOW + datetime.timedelta(days=1)), \
        _iso(NOW - datetime.timedelta(days=1))
    m, u, h = (port_lock.AMZ_OBJECT_LOCK_MODE,
               port_lock.AMZ_OBJECT_LOCK_RETAIN_UNTIL,
               port_lock.AMZ_OBJECT_LOCK_LEGAL_HOLD)
    rule = port_lock.check_delete_allowed
    assert rule({}, False, NOW)
    assert not rule({h: "ON"}, True, NOW)
    assert not rule({m: "COMPLIANCE", u: later}, True, NOW)
    assert rule({m: "COMPLIANCE", u: earlier}, False, NOW)
    assert not rule({m: "GOVERNANCE", u: later}, False, NOW)
    assert rule({m: "GOVERNANCE", u: later}, True, NOW)
    assert not rule({m: "GOVERNANCE", u: earlier, h: "ON"}, True, NOW)
