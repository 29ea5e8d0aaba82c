"""The bucket lifecycle configuration and its actions
(``minio_tpu/bucket/lifecycle.py``, pkg/bucket/lifecycle/lifecycle.go).

``Lifecycle.parse`` reads and validates the S3 LifecycleConfiguration
XML, ``to_xml`` writes it back as the reference does, and
``compute_action`` (ComputeAction, lifecycle.go:225) says what is due
for one object version: expiry of the current version, of a noncurrent
version (from the moment its successor was written) or of a delete
marker that is the last version, or a transition, whose tier
``transition_storage_class`` names.  The crawler
(``background/crawler.py``) acts on both.
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from . import strip_ns

ERR_MALFORMED = "malformed lifecycle XML"


class LifecycleError(ValueError):
    pass


class Action(Enum):
    """pkg/bucket/lifecycle/lifecycle.go:37-57."""
    NONE = 0
    DELETE = 1                   # expire current version
    DELETE_VERSION = 2           # expire a noncurrent version
    TRANSITION = 3
    TRANSITION_VERSION = 4
    DELETE_MARKER_DELETE = 5     # remove an expired delete marker


def _text(el: ET.Element, tag: str) -> Optional[str]:
    child = el.find(tag)
    return child.text if child is not None else None


def _parse_days(el: ET.Element, tag: str) -> Optional[int]:
    t = _text(el, tag)
    if t is None:
        return None
    try:
        d = int(t)
    except ValueError as e:
        raise LifecycleError(f"invalid {tag}") from e
    if d <= 0:
        raise LifecycleError(f"{tag} must be positive")
    return d


def _parse_date(el: ET.Element, tag: str) -> Optional[datetime.datetime]:
    t = _text(el, tag)
    if t is None:
        return None
    try:
        dt = datetime.datetime.fromisoformat(t.replace("Z", "+00:00"))
    except ValueError as e:
        raise LifecycleError(f"invalid {tag}") from e
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt


@dataclass
class Filter:
    """Rule filter: Prefix, Tag, or And{Prefix,Tags}
    (pkg/bucket/lifecycle/filter.go)."""
    prefix: str = ""
    tags: dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_xml(cls, el: Optional[ET.Element]) -> "Filter":
        f = cls()
        if el is None:
            return f
        p = _text(el, "Prefix")
        if p is not None:
            f.prefix = p
        tag = el.find("Tag")
        if tag is not None:
            k, v = _text(tag, "Key"), _text(tag, "Value")
            if not k:
                raise LifecycleError("empty tag key in filter")
            f.tags[k] = v or ""
        and_el = el.find("And")
        if and_el is not None:
            p = _text(and_el, "Prefix")
            if p is not None:
                f.prefix = p
            for tag in and_el.findall("Tag"):
                k, v = _text(tag, "Key"), _text(tag, "Value")
                if not k:
                    raise LifecycleError("empty tag key in filter")
                f.tags[k] = v or ""
        return f

    def to_xml(self) -> ET.Element:
        el = ET.Element("Filter")
        if self.tags:
            parent = ET.SubElement(el, "And") if (
                self.prefix or len(self.tags) > 1) else el
            if self.prefix:
                ET.SubElement(parent, "Prefix").text = self.prefix
            for k, v in self.tags.items():
                t = ET.SubElement(parent, "Tag")
                ET.SubElement(t, "Key").text = k
                ET.SubElement(t, "Value").text = v
        else:
            ET.SubElement(el, "Prefix").text = self.prefix
        return el

    def matches(self, name: str, tags: dict[str, str]) -> bool:
        if not name.startswith(self.prefix):
            return False
        return all(tags.get(k) == v for k, v in self.tags.items())


@dataclass
class Rule:
    rule_id: str = ""
    status: str = "Enabled"
    filter: Filter = field(default_factory=Filter)
    # current-version expiration
    expiration_days: Optional[int] = None
    expiration_date: Optional[datetime.datetime] = None
    expired_delete_marker: bool = False
    # noncurrent versions
    noncurrent_expiration_days: Optional[int] = None
    # transitions (storage-class tiering)
    transition_days: Optional[int] = None
    transition_date: Optional[datetime.datetime] = None
    transition_storage_class: str = ""
    noncurrent_transition_days: Optional[int] = None
    noncurrent_transition_storage_class: str = ""
    abort_multipart_days: Optional[int] = None

    def validate(self) -> None:
        if self.status not in ("Enabled", "Disabled"):
            raise LifecycleError("invalid rule Status")
        if (self.expiration_days is None and self.expiration_date is None
                and not self.expired_delete_marker
                and self.noncurrent_expiration_days is None
                and self.transition_days is None
                and self.transition_date is None
                and self.noncurrent_transition_days is None
                and self.abort_multipart_days is None):
            raise LifecycleError(
                "rule has no expiration/transition/abort action")
        if self.expiration_days is not None and \
                self.expiration_date is not None:
            raise LifecycleError("Days and Date are mutually exclusive")


def _rule_from_xml(el: ET.Element) -> Rule:
    r = Rule()
    r.rule_id = _text(el, "ID") or ""
    if len(r.rule_id) > 255:
        raise LifecycleError("rule ID longer than 255")
    r.status = _text(el, "Status") or ""
    f = el.find("Filter")
    if f is None and _text(el, "Prefix") is not None:  # legacy top-level
        r.filter = Filter(prefix=_text(el, "Prefix") or "")
    else:
        r.filter = Filter.from_xml(f)
    exp = el.find("Expiration")
    if exp is not None:
        r.expiration_days = _parse_days(exp, "Days")
        r.expiration_date = _parse_date(exp, "Date")
        r.expired_delete_marker = \
            (_text(exp, "ExpiredObjectDeleteMarker") or "") == "true"
    nce = el.find("NoncurrentVersionExpiration")
    if nce is not None:
        r.noncurrent_expiration_days = _parse_days(nce, "NoncurrentDays")
    tr = el.find("Transition")
    if tr is not None:
        r.transition_days = _parse_days(tr, "Days")
        r.transition_date = _parse_date(tr, "Date")
        r.transition_storage_class = _text(tr, "StorageClass") or ""
        if not r.transition_storage_class:
            raise LifecycleError("Transition requires StorageClass")
    nct = el.find("NoncurrentVersionTransition")
    if nct is not None:
        r.noncurrent_transition_days = _parse_days(nct, "NoncurrentDays")
        r.noncurrent_transition_storage_class = \
            _text(nct, "StorageClass") or ""
    ab = el.find("AbortIncompleteMultipartUpload")
    if ab is not None:
        r.abort_multipart_days = _parse_days(ab, "DaysAfterInitiation")
    r.validate()
    return r


def _rule_to_xml(r: Rule) -> ET.Element:
    el = ET.Element("Rule")
    if r.rule_id:
        ET.SubElement(el, "ID").text = r.rule_id
    ET.SubElement(el, "Status").text = r.status
    el.append(r.filter.to_xml())
    if (r.expiration_days is not None or r.expiration_date is not None
            or r.expired_delete_marker):
        exp = ET.SubElement(el, "Expiration")
        if r.expiration_days is not None:
            ET.SubElement(exp, "Days").text = str(r.expiration_days)
        if r.expiration_date is not None:
            ET.SubElement(exp, "Date").text = \
                r.expiration_date.strftime("%Y-%m-%dT%H:%M:%SZ")
        if r.expired_delete_marker:
            ET.SubElement(exp, "ExpiredObjectDeleteMarker").text = "true"
    if r.noncurrent_expiration_days is not None:
        nce = ET.SubElement(el, "NoncurrentVersionExpiration")
        ET.SubElement(nce, "NoncurrentDays").text = \
            str(r.noncurrent_expiration_days)
    if r.transition_storage_class:
        tr = ET.SubElement(el, "Transition")
        if r.transition_days is not None:
            ET.SubElement(tr, "Days").text = str(r.transition_days)
        if r.transition_date is not None:
            ET.SubElement(tr, "Date").text = \
                r.transition_date.strftime("%Y-%m-%dT%H:%M:%SZ")
        ET.SubElement(tr, "StorageClass").text = r.transition_storage_class
    if r.noncurrent_transition_days is not None:
        nct = ET.SubElement(el, "NoncurrentVersionTransition")
        ET.SubElement(nct, "NoncurrentDays").text = \
            str(r.noncurrent_transition_days)
        ET.SubElement(nct, "StorageClass").text = \
            r.noncurrent_transition_storage_class
    if r.abort_multipart_days is not None:
        ab = ET.SubElement(el, "AbortIncompleteMultipartUpload")
        ET.SubElement(ab, "DaysAfterInitiation").text = \
            str(r.abort_multipart_days)
    return el


@dataclass
class ObjectOpts:
    """Inputs to ComputeAction (pkg/bucket/lifecycle/lifecycle.go:198)."""
    name: str
    mod_time_ns: int = 0
    user_tags: dict[str, str] = field(default_factory=dict)
    is_latest: bool = True
    delete_marker: bool = False
    num_versions: int = 1
    # for noncurrent versions: when the *successor* was written, i.e. the
    # moment this version became noncurrent
    successor_mod_time_ns: int = 0


@dataclass
class Lifecycle:
    rules: list[Rule] = field(default_factory=list)

    @classmethod
    def parse(cls, data: bytes) -> "Lifecycle":
        try:
            root = ET.fromstring(data)
        except ET.ParseError as e:
            raise LifecycleError(ERR_MALFORMED) from e
        strip_ns(root)
        if root.tag != "LifecycleConfiguration":
            raise LifecycleError(ERR_MALFORMED)
        rules = [_rule_from_xml(r) for r in root.findall("Rule")]
        if not rules:
            raise LifecycleError("at least one Rule required")
        if len(rules) > 1000:
            raise LifecycleError("more than 1000 rules")
        ids = [r.rule_id for r in rules if r.rule_id]
        if len(ids) != len(set(ids)):
            raise LifecycleError("duplicate rule ID")
        return cls(rules=rules)

    def to_xml(self) -> bytes:
        root = ET.Element(
            "LifecycleConfiguration",
            xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
        for r in self.rules:
            root.append(_rule_to_xml(r))
        return (b'<?xml version="1.0" encoding="UTF-8"?>' +
                ET.tostring(root))

    # -- evaluation --------------------------------------------------------

    def _filtered(self, obj: ObjectOpts):
        for r in self.rules:
            if r.status != "Enabled":
                continue
            if r.filter.matches(obj.name, obj.user_tags):
                yield r

    def compute_action(self, obj: ObjectOpts,
                       now_ns: Optional[int] = None) -> Action:
        """pkg/bucket/lifecycle/lifecycle.go:225 ComputeAction."""
        if now_ns is None:
            now_ns = int(datetime.datetime.now(
                datetime.timezone.utc).timestamp() * 1e9)
        day_ns = 24 * 3600 * 1e9
        for r in self._filtered(obj):
            if not obj.is_latest:
                if r.noncurrent_expiration_days is not None and \
                        obj.successor_mod_time_ns:
                    if now_ns >= obj.successor_mod_time_ns + \
                            r.noncurrent_expiration_days * day_ns:
                        return Action.DELETE_VERSION
                if r.noncurrent_transition_days is not None and \
                        obj.successor_mod_time_ns:
                    if now_ns >= obj.successor_mod_time_ns + \
                            r.noncurrent_transition_days * day_ns:
                        return Action.TRANSITION_VERSION
                continue
            if obj.delete_marker:
                # a delete marker with no other versions "expires" when the
                # rule asks for ExpiredObjectDeleteMarker, or when plain
                # Days elapse (cmd/data-crawler.go lifecycle path)
                if obj.num_versions == 1 and (
                        r.expired_delete_marker or
                        (r.expiration_days is not None and
                         now_ns >= obj.mod_time_ns +
                         r.expiration_days * day_ns)):
                    return Action.DELETE_MARKER_DELETE
                continue
            if r.expiration_date is not None and \
                    now_ns >= r.expiration_date.timestamp() * 1e9:
                return Action.DELETE
            if r.expiration_days is not None and \
                    now_ns >= obj.mod_time_ns + r.expiration_days * day_ns:
                return Action.DELETE
            if r.transition_date is not None and \
                    now_ns >= r.transition_date.timestamp() * 1e9:
                return Action.TRANSITION
            if r.transition_days is not None and \
                    now_ns >= obj.mod_time_ns + r.transition_days * day_ns:
                return Action.TRANSITION
        return Action.NONE

    def transition_storage_class(self, obj: ObjectOpts,
                                 now_ns: Optional[int] = None) -> str:
        """The storage class (the tier) of the transition that is due for
        ``obj``: the rule ``compute_action`` answers TRANSITION for, not
        merely the first that matches."""
        if now_ns is None:
            now_ns = int(datetime.datetime.now(
                datetime.timezone.utc).timestamp() * 1e9)
        day_ns = 24 * 3600 * 1e9
        for r in self._filtered(obj):
            if not obj.is_latest:
                if r.noncurrent_transition_days is not None and \
                        obj.successor_mod_time_ns and \
                        now_ns >= obj.successor_mod_time_ns + \
                        r.noncurrent_transition_days * day_ns:
                    return r.noncurrent_transition_storage_class
                continue
            if r.transition_date is not None and \
                    now_ns >= r.transition_date.timestamp() * 1e9 and \
                    r.transition_storage_class:
                return r.transition_storage_class
            if r.transition_days is not None and \
                    now_ns >= obj.mod_time_ns + \
                    r.transition_days * day_ns and \
                    r.transition_storage_class:
                return r.transition_storage_class
        return ""
