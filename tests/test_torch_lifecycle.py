"""The port's lifecycle configuration (``minio_tpu_torch/bucket/
lifecycle.py``) against ``minio_tpu``'s: the same documents parse to the
same rules and write back the same XML, the same documents are refused,
and ``compute_action`` gives the same action for any object version and
any clock."""

import datetime

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from minio_tpu.bucket import lifecycle as ref_lc
from minio_tpu_torch.bucket import lifecycle as port_lc

NS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'
DAY_NS = 24 * 3600 * 10 ** 9
NOW = 1_760_000_000 * 10 ** 9


def _doc(*rules: str, ns: bool = True) -> bytes:
    return (f"<LifecycleConfiguration {NS if ns else ''}>"
            + "".join(rules) + "</LifecycleConfiguration>").encode()


VALID = {
    "days-prefix": _doc(
        "<Rule><ID>r1</ID><Status>Enabled</Status>"
        "<Filter><Prefix>logs/</Prefix></Filter>"
        "<Expiration><Days>3</Days></Expiration></Rule>"),
    "date-tag": _doc(
        "<Rule><Status>Enabled</Status><Filter><Tag><Key>t</Key>"
        "<Value>v</Value></Tag></Filter>"
        "<Expiration><Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>",
        ns=False),
    "and-noncurrent": _doc(
        "<Rule><ID>nc</ID><Status>Enabled</Status><Filter><And>"
        "<Prefix>a/</Prefix><Tag><Key>k1</Key><Value>1</Value></Tag>"
        "<Tag><Key>k2</Key><Value>2</Value></Tag></And></Filter>"
        "<NoncurrentVersionExpiration><NoncurrentDays>5"
        "</NoncurrentDays></NoncurrentVersionExpiration></Rule>"),
    "delete-marker": _doc(
        "<Rule><Status>Enabled</Status><Filter></Filter><Expiration>"
        "<ExpiredObjectDeleteMarker>true</ExpiredObjectDeleteMarker>"
        "</Expiration></Rule>"),
    "transition-abort": _doc(
        "<Rule><ID>t</ID><Status>Disabled</Status><Prefix>old/</Prefix>"
        "<Transition><Days>30</Days><StorageClass>WARM</StorageClass>"
        "</Transition><NoncurrentVersionTransition><NoncurrentDays>7"
        "</NoncurrentDays><StorageClass>COLD</StorageClass>"
        "</NoncurrentVersionTransition><AbortIncompleteMultipartUpload>"
        "<DaysAfterInitiation>2</DaysAfterInitiation>"
        "</AbortIncompleteMultipartUpload></Rule>",
        "<Rule><ID>u</ID><Status>Enabled</Status><Filter><Prefix>x"
        "</Prefix></Filter><Expiration><Days>1</Days></Expiration>"
        "</Rule>"),
}

INVALID = {
    "not-xml": b"<Lifecycle",
    "wrong-root": b"<Other/>",
    "no-rules": _doc(),
    "no-action": _doc("<Rule><Status>Enabled</Status></Rule>"),
    "bad-status": _doc("<Rule><Status>On</Status><Expiration><Days>1"
                       "</Days></Expiration></Rule>"),
    "zero-days": _doc("<Rule><Status>Enabled</Status><Expiration><Days>0"
                      "</Days></Expiration></Rule>"),
    "days-and-date": _doc(
        "<Rule><Status>Enabled</Status><Expiration><Days>1</Days>"
        "<Date>2020-01-01T00:00:00Z</Date></Expiration></Rule>"),
    "duplicate-id": _doc(*["<Rule><ID>d</ID><Status>Enabled</Status>"
                           "<Expiration><Days>1</Days></Expiration></Rule>"]
                         * 2),
    "transition-no-class": _doc(
        "<Rule><Status>Enabled</Status><Transition><Days>1</Days>"
        "</Transition></Rule>"),
    "empty-tag-key": _doc(
        "<Rule><Status>Enabled</Status><Filter><Tag><Key></Key></Tag>"
        "</Filter><Expiration><Days>1</Days></Expiration></Rule>"),
}


@pytest.mark.parametrize("name", sorted(VALID))
def test_parse_and_to_xml_equal(name):
    ref = ref_lc.Lifecycle.parse(VALID[name])
    port = port_lc.Lifecycle.parse(VALID[name])
    assert port.to_xml() == ref.to_xml()
    assert repr(port.rules) == repr(ref.rules)
    # the written document parses back to itself
    assert port_lc.Lifecycle.parse(port.to_xml()).to_xml() == port.to_xml()


@pytest.mark.parametrize("name", sorted(INVALID))
def test_refusals_equal(name):
    with pytest.raises(ref_lc.LifecycleError) as ref_err:
        ref_lc.Lifecycle.parse(INVALID[name])
    with pytest.raises(port_lc.LifecycleError) as port_err:
        port_lc.Lifecycle.parse(INVALID[name])
    assert str(port_err.value) == str(ref_err.value)


RULES = _doc(
    "<Rule><ID>exp</ID><Status>Enabled</Status><Filter><Prefix>exp/"
    "</Prefix></Filter><Expiration><Days>2</Days></Expiration></Rule>",
    "<Rule><ID>date</ID><Status>Enabled</Status><Filter><Tag><Key>t</Key>"
    "<Value>v</Value></Tag></Filter><Expiration><Date>"
    "2025-10-01T00:00:00Z</Date></Expiration></Rule>",
    "<Rule><ID>nc</ID><Status>Enabled</Status><Filter><Prefix>v/</Prefix>"
    "</Filter><NoncurrentVersionExpiration><NoncurrentDays>3"
    "</NoncurrentDays></NoncurrentVersionExpiration>"
    "<NoncurrentVersionTransition><NoncurrentDays>1</NoncurrentDays>"
    "<StorageClass>COLD</StorageClass></NoncurrentVersionTransition>"
    "</Rule>",
    "<Rule><ID>dm</ID><Status>Enabled</Status><Filter><Prefix>d/</Prefix>"
    "</Filter><Expiration><ExpiredObjectDeleteMarker>true"
    "</ExpiredObjectDeleteMarker></Expiration></Rule>",
    "<Rule><ID>tr</ID><Status>Enabled</Status><Filter><Prefix>t/</Prefix>"
    "</Filter><Transition><Days>1</Days><StorageClass>WARM</StorageClass>"
    "</Transition></Rule>",
    "<Rule><ID>off</ID><Status>Disabled</Status><Filter><Prefix></Prefix>"
    "</Filter><Expiration><Days>1</Days></Expiration></Rule>")

opts = st.fixed_dictionaries({
    "name": st.sampled_from(["exp/a", "v/b", "d/c", "t/d", "other", ""]),
    "mod_time_ns": st.integers(NOW - 10 * DAY_NS, NOW + DAY_NS),
    "user_tags": st.sampled_from([{}, {"t": "v"}, {"t": "w"}]),
    "is_latest": st.booleans(),
    "delete_marker": st.booleans(),
    "num_versions": st.integers(1, 3),
    "successor_mod_time_ns": st.sampled_from(
        [0, NOW - 5 * DAY_NS, NOW - 2 * DAY_NS, NOW]),
})


@settings(max_examples=300, deadline=None)
@given(o=opts, now=st.integers(NOW - DAY_NS, NOW + 10 * DAY_NS))
def test_compute_action_equal(o, now):
    ref = ref_lc.Lifecycle.parse(RULES)
    port = port_lc.Lifecycle.parse(RULES)
    r = ref.compute_action(ref_lc.ObjectOpts(**o), now_ns=now)
    p = port.compute_action(port_lc.ObjectOpts(**o), now_ns=now)
    assert p.name == r.name


def test_actions_of_each_rule():
    """The rules' own examples, as the crawler meets them."""
    lc = port_lc.Lifecycle.parse(RULES)
    A = port_lc.Action
    past = NOW - 3 * DAY_NS

    def act(**kw):
        return lc.compute_action(port_lc.ObjectOpts(**kw), now_ns=NOW)

    assert act(name="exp/a", mod_time_ns=past) is A.DELETE
    assert act(name="exp/a", mod_time_ns=NOW) is A.NONE
    assert act(name="x", user_tags={"t": "v"}, mod_time_ns=NOW) is A.DELETE
    assert act(name="v/b", is_latest=False,
               successor_mod_time_ns=NOW - 4 * DAY_NS) is A.DELETE_VERSION
    assert act(name="v/b", is_latest=False,
               successor_mod_time_ns=NOW - 2 * DAY_NS) is \
        A.TRANSITION_VERSION
    assert act(name="d/c", delete_marker=True) is A.DELETE_MARKER_DELETE
    assert act(name="d/c", delete_marker=True, num_versions=2) is A.NONE
    assert act(name="t/d", mod_time_ns=past) is A.TRANSITION
    assert act(name="other", mod_time_ns=0) is A.NONE
    assert datetime.datetime(2025, 10, 1, tzinfo=datetime.timezone.utc) \
        == lc.rules[1].expiration_date
