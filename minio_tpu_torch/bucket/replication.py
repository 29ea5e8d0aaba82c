"""The bucket replication configuration (``minio_tpu/bucket/replication.py``,
pkg/bucket/replication/*.go).

``Config.parse`` reads a ReplicationConfiguration: rules with a
priority, a Destination ARN, an optional filter and the
DeleteMarkerReplication and DeleteReplication switches; ``to_xml``
writes it back as the reference does (rules by falling priority).
``replicate`` is the data path's decision (mustReplicate,
cmd/bucket-replication.go:100), which the server's replication plane
(``background/replication.py``) takes for every write and delete.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional

from . import strip_ns
from .lifecycle import Filter        # the same Prefix / Tag / And shape


class ReplicationError(ValueError):
    pass


@dataclass
class Rule:
    rule_id: str = ""
    status: str = "Enabled"
    priority: int = 0
    filter: Filter = field(default_factory=Filter)
    destination_arn: str = ""    # arn:minio:replication:<region>:<id>:<bucket>
    storage_class: str = ""
    delete_marker_replication: bool = False
    delete_replication: bool = False


def _enabled(el: Optional[ET.Element]) -> bool:
    return el is not None and (el.findtext("Status") or "") == "Enabled"


@dataclass
class Config:
    role: str = ""
    rules: list[Rule] = field(default_factory=list)

    @classmethod
    def parse(cls, data: bytes) -> "Config":
        try:
            root = ET.fromstring(data)
        except ET.ParseError as e:
            raise ReplicationError("malformed replication XML") from e
        strip_ns(root)
        if root.tag != "ReplicationConfiguration":
            raise ReplicationError("malformed replication XML")
        cfg = cls(role=root.findtext("Role") or "")
        for rel in root.findall("Rule"):
            r = Rule(rule_id=rel.findtext("ID") or "",
                     status=rel.findtext("Status") or "")
            if r.status not in ("Enabled", "Disabled"):
                raise ReplicationError("invalid rule Status")
            r.priority = int(rel.findtext("Priority") or 0)
            r.filter = Filter.from_xml(rel.find("Filter"))
            dest = rel.find("Destination")
            if dest is None or not (dest.findtext("Bucket") or ""):
                raise ReplicationError("rule requires Destination/Bucket")
            r.destination_arn = dest.findtext("Bucket") or ""
            r.storage_class = dest.findtext("StorageClass") or ""
            r.delete_marker_replication = _enabled(
                rel.find("DeleteMarkerReplication"))
            r.delete_replication = _enabled(rel.find("DeleteReplication"))
            cfg.rules.append(r)
        if not cfg.rules:
            raise ReplicationError("at least one Rule required")
        ids = [r.rule_id for r in cfg.rules if r.rule_id]
        if len(ids) != len(set(ids)):
            raise ReplicationError("duplicate rule ID")
        prios = [r.priority for r in cfg.rules]
        if len(prios) != len(set(prios)):
            raise ReplicationError("duplicate rule Priority")
        return cfg

    def to_xml(self) -> bytes:
        root = ET.Element("ReplicationConfiguration",
                          xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
        if self.role:
            ET.SubElement(root, "Role").text = self.role
        for r in sorted(self.rules, key=lambda x: -x.priority):
            rel = ET.SubElement(root, "Rule")
            if r.rule_id:
                ET.SubElement(rel, "ID").text = r.rule_id
            ET.SubElement(rel, "Status").text = r.status
            ET.SubElement(rel, "Priority").text = str(r.priority)
            rel.append(r.filter.to_xml())
            dest = ET.SubElement(rel, "Destination")
            ET.SubElement(dest, "Bucket").text = r.destination_arn
            if r.storage_class:
                ET.SubElement(dest, "StorageClass").text = r.storage_class
            for tag, on in (("DeleteMarkerReplication",
                             r.delete_marker_replication),
                            ("DeleteReplication", r.delete_replication)):
                ET.SubElement(ET.SubElement(rel, tag), "Status").text = \
                    "Enabled" if on else "Disabled"
        return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)

    def match_rule(self, name: str, tags: dict[str, str]) -> Optional[Rule]:
        """The enabled rule of highest priority that matches the object."""
        best: Optional[Rule] = None
        for r in self.rules:
            if r.status == "Enabled" and r.filter.matches(name, tags) and \
                    (best is None or r.priority > best.priority):
                best = r
        return best

    def replicate(self, name: str, tags: dict[str, str],
                  delete_marker: bool = False,
                  versioned_delete: bool = False) -> Optional[Rule]:
        """mustReplicate: the rule to apply, or None."""
        r = self.match_rule(name, tags)
        if r is None:
            return None
        if delete_marker and not r.delete_marker_replication:
            return None
        if versioned_delete and not r.delete_replication:
            return None
        return r
