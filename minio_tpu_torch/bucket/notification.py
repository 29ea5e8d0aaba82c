"""The bucket notification configuration (``minio_tpu/bucket/notification.py``,
pkg/event/config.go and rules.go).

A NotificationConfiguration holds Queue, Topic and CloudFunction
configurations, each mapping a set of event names and a prefix and
suffix filter to a target ARN.  ``Config.parse`` checks each ARN
against the registered targets when given them; ``match`` is the rules
map that routes one event to its targets (pkg/event/rulesmap.go), and
``match_pattern`` the event-name glob of ListenNotification.
"""

from __future__ import annotations

import fnmatch
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from . import strip_ns


class NotificationError(ValueError):
    pass


# pkg/event/name.go: the event names a configuration may name; a
# wildcard stands for every name under it
EVENT_NAMES = {
    "s3:ObjectCreated:*", "s3:ObjectCreated:Put", "s3:ObjectCreated:Post",
    "s3:ObjectCreated:Copy", "s3:ObjectCreated:CompleteMultipartUpload",
    "s3:ObjectCreated:PutRetention", "s3:ObjectCreated:PutLegalHold",
    "s3:ObjectCreated:PutTagging", "s3:ObjectCreated:DeleteTagging",
    "s3:ObjectRemoved:*", "s3:ObjectRemoved:Delete",
    "s3:ObjectRemoved:DeleteMarkerCreated",
    "s3:ObjectAccessed:*", "s3:ObjectAccessed:Get",
    "s3:ObjectAccessed:Head",
    "s3:Replication:*", "s3:Replication:OperationFailedReplication",
    "s3:Replication:OperationCompletedReplication",
    "s3:ObjectRestore:Post", "s3:ObjectRestore:Completed",
}


def _expand(name: str) -> set[str]:
    if name.endswith(":*"):
        prefix = name[:-1]
        return {n for n in EVENT_NAMES
                if n.startswith(prefix) and not n.endswith("*")}
    return {name}


@dataclass
class TargetConfig:
    arn: str = ""
    events: set[str] = field(default_factory=set)      # expanded names
    prefix: str = ""
    suffix: str = ""

    def matches(self, event_name: str, key: str) -> bool:
        return event_name in self.events and key.startswith(self.prefix) \
            and key.endswith(self.suffix)


@dataclass
class Config:
    targets: list[TargetConfig] = field(default_factory=list)

    @classmethod
    def parse(cls, data: bytes,
              valid_arns: set[str] | None = None) -> "Config":
        try:
            root = ET.fromstring(data)
        except ET.ParseError as e:
            raise NotificationError("malformed notification XML") from e
        strip_ns(root)
        if root.tag != "NotificationConfiguration":
            raise NotificationError("malformed notification XML")
        cfg = cls()
        for kind, arn_tag in (("QueueConfiguration", "Queue"),
                              ("TopicConfiguration", "Topic"),
                              ("CloudFunctionConfiguration",
                               "CloudFunction")):
            for qel in root.findall(kind):
                t = TargetConfig(arn=qel.findtext(arn_tag) or "")
                if not t.arn:
                    raise NotificationError(f"missing {arn_tag} ARN")
                if valid_arns is not None and t.arn not in valid_arns:
                    raise NotificationError(f"unknown ARN {t.arn}")
                for ev in qel.findall("Event"):
                    name = ev.text or ""
                    if name not in EVENT_NAMES:
                        raise NotificationError(f"unknown event {name}")
                    t.events |= _expand(name)
                if not t.events:
                    raise NotificationError("no events configured")
                key = qel.find("Filter/S3Key")
                for rule in (key.findall("FilterRule")
                             if key is not None else []):
                    n = (rule.findtext("Name") or "").lower()
                    v = rule.findtext("Value") or ""
                    if n not in ("prefix", "suffix"):
                        raise NotificationError(f"bad filter rule name {n}")
                    setattr(t, n, v)
                cfg.targets.append(t)
        return cfg

    def to_xml(self) -> bytes:
        root = ET.Element("NotificationConfiguration",
                          xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
        for t in self.targets:
            qel = ET.SubElement(root, "QueueConfiguration")
            ET.SubElement(qel, "Queue").text = t.arn
            for name in sorted(t.events):
                ET.SubElement(qel, "Event").text = name
            if t.prefix or t.suffix:
                key = ET.SubElement(ET.SubElement(qel, "Filter"), "S3Key")
                for n in ("prefix", "suffix"):
                    if getattr(t, n):
                        r = ET.SubElement(key, "FilterRule")
                        ET.SubElement(r, "Name").text = n
                        ET.SubElement(r, "Value").text = getattr(t, n)
        return b'<?xml version="1.0" encoding="UTF-8"?>' + ET.tostring(root)

    def match(self, event_name: str, key: str) -> set[str]:
        """The ARNs this event goes to."""
        return {t.arn for t in self.targets if t.matches(event_name, key)}


def match_pattern(pattern: str, value: str) -> bool:
    """The event-name glob of ListenNotification; empty matches all."""
    return fnmatch.fnmatchcase(value, pattern) if pattern else True
