"""Object and bucket tags (``minio_tpu/bucket/tags.py``,
pkg/tags/tags.go).

An object holds at most 10 tags and a bucket 50; a key has 1 to 128
characters, a value at most 256, and no key appears twice.  Tags come
as the S3 ``Tagging`` document (``?tagging``) or as the URL-encoded
``x-amz-tagging`` header, the form an object's metadata stores them in.
"""

from __future__ import annotations

import urllib.parse
import xml.etree.ElementTree as ET

from . import strip_ns

TAG_KEY = "x-amz-tagging"           # the metadata key of an object's tags


class TagError(ValueError):
    """A refused tag set; ``code`` is its S3 error code."""

    def __init__(self, code: str, msg: str):
        super().__init__(msg)
        self.code = code


def _validate(tags: dict[str, str], is_object: bool) -> None:
    limit = 10 if is_object else 50
    if len(tags) > limit:
        raise TagError("InvalidTag" if is_object else "BadRequest",
                       f"more than {limit} tags")
    for k, v in tags.items():
        if not k or len(k) > 128:
            raise TagError("InvalidTag", "tag key empty or too long")
        if len(v) > 256:
            raise TagError("InvalidTag", "tag value too long")


def parse_xml(data: bytes, is_object: bool = True) -> dict[str, str]:
    """A ``Tagging`` document's tags, validated."""
    try:
        root = ET.fromstring(data)
    except ET.ParseError as e:
        raise TagError("MalformedXML", "bad tagging XML") from e
    strip_ns(root)
    if root.tag != "Tagging":
        raise TagError("MalformedXML", "bad tagging XML")
    tagset = root.find("TagSet")
    if tagset is None:
        raise TagError("MalformedXML", "missing TagSet")
    tags: dict[str, str] = {}
    for t in tagset.findall("Tag"):
        k = t.findtext("Key") or ""
        if k in tags:
            raise TagError("InvalidTag", "duplicate tag key")
        tags[k] = t.findtext("Value") or ""
    _validate(tags, is_object)
    return tags


def parse_header(value: str, is_object: bool = True) -> dict[str, str]:
    """``k1=v1&k2=v2`` (the ``x-amz-tagging`` header), validated."""
    tags: dict[str, str] = {}
    for k, v in urllib.parse.parse_qsl(value, keep_blank_values=True):
        if k in tags:
            raise TagError("InvalidTag", "duplicate tag key")
        tags[k] = v
    _validate(tags, is_object)
    return tags


def to_header(tags: dict[str, str]) -> str:
    return urllib.parse.urlencode(tags)


def to_xml(tags: dict[str, str]) -> bytes:
    root = ET.Element(
        "Tagging", xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
    tagset = ET.SubElement(root, "TagSet")
    for k, v in tags.items():
        t = ET.SubElement(tagset, "Tag")
        ET.SubElement(t, "Key").text = k
        ET.SubElement(t, "Value").text = v
    return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)
