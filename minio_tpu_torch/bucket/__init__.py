"""Bucket configuration documents: the bucket policy, the lifecycle
configuration, the quota, tags and object lock."""

import xml.etree.ElementTree as ET


def strip_ns(root: ET.Element) -> None:
    """Drop XML namespaces in place: a config parses with or without
    the client's xmlns."""
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
