"""A bucket's default encryption (``minio_tpu/bucket/encryption.py``,
pkg/bucket/encryption/bucket-sse-config.go): the
ServerSideEncryptionConfiguration whose one rule applies SSE-S3
(``AES256``) or SSE-KMS (``aws:kms``, with an optional key id) to a PUT
that sends no SSE header of its own."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass

from . import strip_ns


class BucketSSEError(ValueError):
    pass


@dataclass
class SSEConfig:
    algorithm: str = ""          # "AES256" | "aws:kms"
    kms_key_id: str = ""

    @classmethod
    def parse(cls, data: bytes) -> "SSEConfig":
        try:
            root = ET.fromstring(data)
        except ET.ParseError as e:
            raise BucketSSEError("malformed encryption XML") from e
        strip_ns(root)
        if root.tag != "ServerSideEncryptionConfiguration":
            raise BucketSSEError("malformed encryption XML")
        rules = root.findall("Rule")
        if len(rules) != 1:
            raise BucketSSEError("exactly one Rule required")
        by_default = rules[0].find("ApplyServerSideEncryptionByDefault")
        if by_default is None:
            raise BucketSSEError("ApplyServerSideEncryptionByDefault "
                                 "required")
        algo = by_default.findtext("SSEAlgorithm") or ""
        if algo not in ("AES256", "aws:kms"):
            raise BucketSSEError(f"unsupported SSEAlgorithm {algo!r}")
        return cls(algorithm=algo,
                   kms_key_id=by_default.findtext("KMSMasterKeyID") or "")

    def to_xml(self) -> bytes:
        root = ET.Element("ServerSideEncryptionConfiguration",
                          xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
        by_default = ET.SubElement(ET.SubElement(root, "Rule"),
                                   "ApplyServerSideEncryptionByDefault")
        ET.SubElement(by_default, "SSEAlgorithm").text = self.algorithm
        if self.kms_key_id:
            ET.SubElement(by_default, "KMSMasterKeyID").text = \
                self.kms_key_id
        return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)
