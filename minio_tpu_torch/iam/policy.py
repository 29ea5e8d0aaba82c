"""The IAM policy engine (``minio_tpu/iam/policy.py``, pkg/iam/policy).

AWS policy documents: Version and Statement, each with Effect, Action,
Resource and string Conditions (StringEquals, StringNotEquals,
StringLike); ``*`` and ``?`` wildcards as AWS matches them.  Evaluation
as policy.IsAllowed: an explicit Deny wins, then any Allow, else the
implicit deny.  The canned policies are cmd/iam.go's.
"""

from __future__ import annotations

import fnmatch
import json
from dataclasses import dataclass, field

# S3 action names (subset; grows with handler coverage)
GET_OBJECT = "s3:GetObject"
GET_OBJECT_VERSION = "s3:GetObjectVersion"
PUT_OBJECT = "s3:PutObject"
DELETE_OBJECT = "s3:DeleteObject"
DELETE_OBJECT_VERSION = "s3:DeleteObjectVersion"
LIST_BUCKET = "s3:ListBucket"
LIST_BUCKET_VERSIONS = "s3:ListBucketVersions"
CREATE_BUCKET = "s3:CreateBucket"
DELETE_BUCKET = "s3:DeleteBucket"
LIST_ALL_MY_BUCKETS = "s3:ListAllMyBuckets"
GET_BUCKET_LOCATION = "s3:GetBucketLocation"
GET_BUCKET_VERSIONING = "s3:GetBucketVersioning"
PUT_BUCKET_VERSIONING = "s3:PutBucketVersioning"
LIST_MULTIPART_UPLOADS = "s3:ListBucketMultipartUploads"
ABORT_MULTIPART = "s3:AbortMultipartUpload"
LIST_PARTS = "s3:ListMultipartUploadParts"
GET_BUCKET_POLICY = "s3:GetBucketPolicy"
PUT_BUCKET_POLICY = "s3:PutBucketPolicy"
DELETE_BUCKET_POLICY = "s3:DeleteBucketPolicy"
GET_BUCKET_TAGGING = "s3:GetBucketTagging"
PUT_BUCKET_TAGGING = "s3:PutBucketTagging"
GET_OBJECT_TAGGING = "s3:GetObjectTagging"
PUT_OBJECT_TAGGING = "s3:PutObjectTagging"
DELETE_OBJECT_TAGGING = "s3:DeleteObjectTagging"
GET_LIFECYCLE = "s3:GetLifecycleConfiguration"
PUT_LIFECYCLE = "s3:PutLifecycleConfiguration"
GET_REPLICATION = "s3:GetReplicationConfiguration"
PUT_REPLICATION = "s3:PutReplicationConfiguration"
GET_BUCKET_NOTIFICATION = "s3:GetBucketNotification"
PUT_BUCKET_NOTIFICATION = "s3:PutBucketNotification"
LISTEN_NOTIFICATION = "s3:ListenNotification"
GET_BUCKET_ENCRYPTION = "s3:GetEncryptionConfiguration"
PUT_BUCKET_ENCRYPTION = "s3:PutEncryptionConfiguration"
GET_BUCKET_OBJECT_LOCK = "s3:GetBucketObjectLockConfiguration"
PUT_BUCKET_OBJECT_LOCK = "s3:PutBucketObjectLockConfiguration"
GET_OBJECT_RETENTION = "s3:GetObjectRetention"
PUT_OBJECT_RETENTION = "s3:PutObjectRetention"
GET_OBJECT_LEGAL_HOLD = "s3:GetObjectLegalHold"
PUT_OBJECT_LEGAL_HOLD = "s3:PutObjectLegalHold"
BYPASS_GOVERNANCE = "s3:BypassGovernanceRetention"
GET_BUCKET_ACL = "s3:GetBucketAcl"
PUT_BUCKET_ACL = "s3:PutBucketAcl"
GET_OBJECT_ACL = "s3:GetObjectAcl"
PUT_OBJECT_ACL = "s3:PutObjectAcl"
SELECT_OBJECT_CONTENT = "s3:GetObject"  # Select authorizes as GetObject
ADMIN_ALL = "admin:*"


def _match(pattern: str, value: str) -> bool:
    """AWS wildcard match: * = any sequence, ? = one char."""
    if pattern == "*":
        return True
    # fnmatch translates the same wildcards; escape [] to literals
    pattern = pattern.replace("[", "[[]")
    return fnmatch.fnmatchcase(value, pattern)


@dataclass
class Statement:
    effect: str = "Allow"                     # Allow | Deny
    actions: list[str] = field(default_factory=list)
    resources: list[str] = field(default_factory=list)
    conditions: dict = field(default_factory=dict)

    def matches_action(self, action: str) -> bool:
        return any(_match(a, action) for a in self.actions)

    def matches_resource(self, resource: str) -> bool:
        if not self.resources:
            return True                       # account-level actions
        return any(_match(r.removeprefix("arn:aws:s3:::"), resource)
                   for r in self.resources)

    def matches_conditions(self, context: dict) -> bool:
        for op, kv in self.conditions.items():
            for key, want in kv.items():
                got = context.get(key)
                want_list = want if isinstance(want, list) else [want]
                if op == "StringEquals":
                    if got not in want_list:
                        return False
                elif op == "StringNotEquals":
                    if got in want_list:
                        return False
                elif op == "StringLike":
                    if got is None or \
                            not any(_match(w, got) for w in want_list):
                        return False
                else:
                    return False              # unknown operator: no match
        return True

    def to_dict(self) -> dict:
        d = {"Effect": self.effect, "Action": self.actions,
             "Resource": self.resources}
        if self.conditions:
            d["Condition"] = self.conditions
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Statement":
        def aslist(v):
            return v if isinstance(v, list) else [v]
        return cls(effect=d.get("Effect", "Allow"),
                   actions=aslist(d.get("Action", [])),
                   resources=aslist(d.get("Resource", [])),
                   conditions=d.get("Condition", {}))


@dataclass
class Policy:
    version: str = "2012-10-17"
    statements: list[Statement] = field(default_factory=list)

    def is_allowed(self, action: str, resource: str = "",
                   context: dict | None = None) -> bool:
        """Deny wins; then any Allow; else implicit deny
        (pkg/iam/policy IsAllowed)."""
        context = context or {}
        allowed = False
        for st in self.statements:
            if not (st.matches_action(action)
                    and st.matches_resource(resource)
                    and st.matches_conditions(context)):
                continue
            if st.effect == "Deny":
                return False
            allowed = True
        return allowed

    def to_json(self) -> str:
        return json.dumps({
            "Version": self.version,
            "Statement": [s.to_dict() for s in self.statements]})

    @classmethod
    def from_json(cls, s: str | bytes) -> "Policy":
        d = json.loads(s)
        sts = d.get("Statement", [])
        if isinstance(sts, dict):
            sts = [sts]
        return cls(version=d.get("Version", "2012-10-17"),
                   statements=[Statement.from_dict(x) for x in sts])

    def is_empty(self) -> bool:
        return not self.statements


# canned policies (cmd/iam.go embedded defaults)
READ_ONLY = Policy(statements=[
    Statement(actions=[GET_BUCKET_LOCATION, GET_OBJECT], resources=["*"])])
WRITE_ONLY = Policy(statements=[
    Statement(actions=[PUT_OBJECT], resources=["*"])])
READ_WRITE = Policy(statements=[
    Statement(actions=["s3:*"], resources=["*"])])
CONSOLE_ADMIN = Policy(statements=[
    Statement(actions=["s3:*", "admin:*"], resources=["*"])])

CANNED = {
    "readonly": READ_ONLY,
    "writeonly": WRITE_ONLY,
    "readwrite": READ_WRITE,
    "consoleAdmin": CONSOLE_ADMIN,
}
