"""The port's IAM policy engine against ``minio_tpu``'s: the same
actions and canned policies, the same documents parsed and written back,
and the same verdict for seeded statements (wildcards, Deny over Allow,
conditions) over seeded actions, resources and contexts."""

import json

import numpy as np
import pytest

from minio_tpu.iam import policy as ref_pol
from minio_tpu_torch.iam import policy as port_pol

ACTIONS = ["s3:GetObject", "s3:PutObject", "s3:DeleteObject",
           "s3:ListBucket", "s3:GetObjectVersion", "s3:CreateBucket",
           "s3:GetBucketPolicy", "s3:ListAllMyBuckets", "admin:*",
           "admin:ServerInfo"]
PATTERNS = ["s3:*", "s3:Get*", "s3:?etObject", "*", "admin:*",
            "s3:PutObject", "s3:List*", "s3:GetObject"]
RESOURCES = ["alpha", "alpha/a.txt", "alpha/pub/x", "beta/k", "beta",
             "al[pha]/x", "gamma/dir/sub/file", ""]
RES_PATTERNS = ["arn:aws:s3:::alpha/*", "arn:aws:s3:::alpha", "*",
                "arn:aws:s3:::*/pub/*", "beta/?", "arn:aws:s3:::al[pha]/*",
                "gamma/*/file", "arn:aws:s3:::gamma/dir/*"]
CONDITIONS = [{}, {"StringEquals": {"aws:username": "u1"}},
              {"StringNotEquals": {"aws:username": ["u2", "u3"]}},
              {"StringLike": {"s3:prefix": "pub/*"}},
              {"NumericLessThan": {"x": "1"}}]
CONTEXTS = [{}, {"aws:username": "u1"}, {"aws:username": "u2"},
            {"s3:prefix": "pub/a"}, {"s3:prefix": "priv/a"}]


def test_actions_and_canned_policies_equal_the_references():
    names = [n for n in dir(ref_pol) if n.isupper()]
    assert names == [n for n in dir(port_pol) if n.isupper()]
    for n in names:
        if n == "CANNED":
            continue
        want = getattr(ref_pol, n)
        got = getattr(port_pol, n)
        assert (got.to_json() if isinstance(got, port_pol.Policy)
                else got) == (want.to_json()
                              if isinstance(want, ref_pol.Policy) else want)
    assert {k: v.to_json() for k, v in port_pol.CANNED.items()} == \
        {k: v.to_json() for k, v in ref_pol.CANNED.items()}


def _doc(rng) -> dict:
    sts = []
    for _ in range(int(rng.integers(1, 4))):
        st = {"Effect": "Deny" if rng.random() < 0.3 else "Allow",
              "Action": [PATTERNS[i] for i in
                         rng.choice(len(PATTERNS), rng.integers(1, 3))],
              "Resource": [RES_PATTERNS[i] for i in
                           rng.choice(len(RES_PATTERNS),
                                      rng.integers(0, 3))]}
        if rng.random() < 0.5:
            st["Action"] = st["Action"][0]        # a bare string
        cond = CONDITIONS[rng.integers(0, len(CONDITIONS))]
        if cond:
            st["Condition"] = cond
        sts.append(st)
    return {"Version": "2012-10-17",
            "Statement": sts if len(sts) > 1 or rng.random() < 0.5
            else sts[0]}


@pytest.mark.parametrize("seed", range(8))
def test_verdicts_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        text = json.dumps(_doc(rng))
        ref = ref_pol.Policy.from_json(text)
        port = port_pol.Policy.from_json(text)
        assert port.to_json() == ref.to_json()
        assert port.is_empty() == ref.is_empty()
        for action in ACTIONS:
            for resource in RESOURCES:
                for ctx in CONTEXTS:
                    assert port.is_allowed(action, resource, ctx) == \
                        ref.is_allowed(action, resource, ctx), \
                        (text, action, resource, ctx)


@pytest.mark.parametrize("pattern,value", [
    ("*", ""), ("a*c", "abc"), ("a*c", "ac"), ("a?c", "abc"), ("a?c", "ac"),
    ("[ab]", "a"), ("[ab]", "[ab]"), ("x*", "X1"), ("*/pub/*", "b/pub/k")])
def test_wildcards_match_alike(pattern, value):
    assert port_pol._match(pattern, value) == ref_pol._match(pattern, value)


def test_a_malformed_document_is_refused_alike():
    for text in ("{", "[]", '{"Statement": 5}'):
        errs = []
        for mod in (ref_pol, port_pol):
            try:
                mod.Policy.from_json(text)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 — the type is compared
                errs.append(type(e).__name__)
        assert errs[0] == errs[1]
