"""Bucket policies (``minio_tpu/bucket/policy.py``, pkg/bucket/policy).

A bucket policy is an AWS policy document with Principals: it grants or
denies anonymous or named callers actions on one bucket.  Statements
reuse the IAM engine's matching (``iam/policy.py``) and add the
principal (``"*"`` for everyone, anonymous callers included).  A
Condition the engine cannot evaluate is refused when the policy is put,
so a Deny is never skipped later.  ``is_allowed`` answers True, False
(an explicit Deny) or None (no statement speaks: IAM decides).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..iam import policy as iampol


class BucketPolicyError(ValueError):
    pass


@dataclass
class BPStatement(iampol.Statement):
    principals: list[str] = field(default_factory=list)

    def matches_principal(self, who: str) -> bool:
        # who="" means anonymous; "*" matches everyone including anonymous
        return any(p == "*" or p == who for p in self.principals)

    @classmethod
    def from_dict(cls, d: dict) -> "BPStatement":
        base = iampol.Statement.from_dict(d)
        # conditions must be {op: {key: value}} with operators the engine
        # evaluates — reject anything else at PUT time so a Deny can never
        # be silently skipped at request time (fail-closed by construction)
        if not isinstance(base.conditions, dict) or any(
                not isinstance(kv, dict) for kv in base.conditions.values()):
            raise BucketPolicyError("invalid Condition block")
        supported = {"StringEquals", "StringNotEquals", "StringLike"}
        unknown = set(base.conditions) - supported
        if unknown:
            raise BucketPolicyError(
                f"unsupported condition operator(s): {sorted(unknown)}")
        pr = d.get("Principal", {})
        if pr == "*":
            principals = ["*"]
        elif isinstance(pr, dict):
            aws = pr.get("AWS", [])
            principals = aws if isinstance(aws, list) else [aws]
        else:
            raise BucketPolicyError("invalid Principal")
        if not principals:
            raise BucketPolicyError("Principal required in bucket policy")
        return cls(effect=base.effect, actions=base.actions,
                   resources=base.resources, conditions=base.conditions,
                   principals=principals)

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["Principal"] = {"AWS": self.principals}
        return d


@dataclass
class BucketPolicy:
    version: str = "2012-10-17"
    statements: list[BPStatement] = field(default_factory=list)

    @classmethod
    def parse(cls, data: bytes, bucket: str = "") -> "BucketPolicy":
        try:
            d = json.loads(data)
        except json.JSONDecodeError as e:
            raise BucketPolicyError("malformed policy JSON") from e
        sts = d.get("Statement", [])
        if isinstance(sts, dict):
            sts = [sts]
        if not sts:
            raise BucketPolicyError("Statement required")
        pol = cls(version=d.get("Version", "2012-10-17"),
                  statements=[BPStatement.from_dict(x) for x in sts])
        if bucket:
            for st in pol.statements:
                for res in st.resources:
                    plain = res.removeprefix("arn:aws:s3:::")
                    if not (plain == bucket or
                            plain.startswith(bucket + "/") or
                            iampol._match(plain.split("/", 1)[0], bucket)):
                        raise BucketPolicyError(
                            f"resource {res} outside bucket {bucket}")
        return pol

    def to_json(self) -> bytes:
        return json.dumps({
            "Version": self.version,
            "Statement": [s.to_dict() for s in self.statements]}).encode()

    def is_allowed(self, who: str, action: str, resource: str = "",
                   context: dict | None = None) -> bool | None:
        """Three-valued: True=allow, False=explicit deny, None=no opinion
        (lets IAM user policy decide) — mirrors how cmd/auth-handler.go
        combines bucket policy with IAM."""
        context = context or {}
        verdict: bool | None = None
        for st in self.statements:
            if not (st.matches_principal(who)
                    and st.matches_action(action)
                    and st.matches_resource(resource)
                    and st.matches_conditions(context)):
                continue
            if st.effect == "Deny":
                return False
            verdict = True
        return verdict
