"""Object lock: the bucket's default retention, an object version's
retention and legal hold, and the rule a delete must pass
(``minio_tpu/bucket/objectlock.py``; pkg/bucket/object/lock/lock.go,
cmd/bucket-object-lock.go).

A version's lock lives in its metadata under the S3 header names: a
mode (GOVERNANCE or COMPLIANCE) with a retain-until date, and a legal
hold (ON or OFF).  ``check_delete_allowed`` is the WORM rule: a legal
hold or an unexpired COMPLIANCE retention refuses every delete of the
version, an unexpired GOVERNANCE retention yields only to a caller
allowed ``s3:BypassGovernanceRetention`` who asks to bypass it.
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional

from . import strip_ns

GOVERNANCE = "GOVERNANCE"
COMPLIANCE = "COMPLIANCE"

# the version's metadata keys (the request headers, stored verbatim)
AMZ_OBJECT_LOCK_MODE = "x-amz-object-lock-mode"
AMZ_OBJECT_LOCK_RETAIN_UNTIL = "x-amz-object-lock-retain-until-date"
AMZ_OBJECT_LOCK_LEGAL_HOLD = "x-amz-object-lock-legal-hold"

_S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"
_XML_DECL = b'<?xml version="1.0" encoding="UTF-8"?>'


class ObjectLockError(ValueError):
    pass


def _utc(text: str) -> datetime.datetime:
    """An ISO 8601 date, UTC when it names no zone; ValueError if bad."""
    dt = datetime.datetime.fromisoformat(text.replace("Z", "+00:00"))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt


def _root(data: bytes, what: str) -> ET.Element:
    try:
        root = ET.fromstring(data)
    except ET.ParseError as e:
        raise ObjectLockError(f"malformed {what} XML") from e
    strip_ns(root)
    return root


@dataclass
class LockConfig:
    """The bucket's ObjectLockConfiguration and its default retention."""
    enabled: bool = False
    mode: str = ""               # "", GOVERNANCE or COMPLIANCE
    days: Optional[int] = None
    years: Optional[int] = None

    @classmethod
    def parse(cls, data: bytes) -> "LockConfig":
        root = _root(data, "object-lock")
        if root.tag != "ObjectLockConfiguration":
            raise ObjectLockError("malformed object-lock XML")
        cfg = cls()
        cfg.enabled = (root.findtext("ObjectLockEnabled") or "") == "Enabled"
        rule = root.find("Rule")
        if rule is not None:
            ret = rule.find("DefaultRetention")
            if ret is None:
                raise ObjectLockError("Rule requires DefaultRetention")
            cfg.mode = ret.findtext("Mode") or ""
            if cfg.mode not in (GOVERNANCE, COMPLIANCE):
                raise ObjectLockError("invalid retention Mode")
            days, years = ret.findtext("Days"), ret.findtext("Years")
            if (days is None) == (years is None):
                raise ObjectLockError(
                    "exactly one of Days or Years required")
            if days is not None:
                cfg.days = int(days)
                if cfg.days <= 0:
                    raise ObjectLockError("Days must be positive")
            if years is not None:
                cfg.years = int(years)
                if cfg.years <= 0:
                    raise ObjectLockError("Years must be positive")
        return cfg

    def to_xml(self) -> bytes:
        root = ET.Element("ObjectLockConfiguration", xmlns=_S3_NS)
        ET.SubElement(root, "ObjectLockEnabled").text = "Enabled"
        if self.mode:
            ret = ET.SubElement(ET.SubElement(root, "Rule"),
                                "DefaultRetention")
            ET.SubElement(ret, "Mode").text = self.mode
            if self.days is not None:
                ET.SubElement(ret, "Days").text = str(self.days)
            if self.years is not None:
                ET.SubElement(ret, "Years").text = str(self.years)
        return _XML_DECL + ET.tostring(root)

    def default_retention_headers(
            self, now: Optional[datetime.datetime] = None) -> dict[str, str]:
        """The metadata a new version takes under the default rule: {}
        without one."""
        if not self.mode:
            return {}
        now = now or datetime.datetime.now(datetime.timezone.utc)
        days = (self.days or 0) + 365 * (self.years or 0)
        until = now + datetime.timedelta(days=days)
        return {AMZ_OBJECT_LOCK_MODE: self.mode,
                AMZ_OBJECT_LOCK_RETAIN_UNTIL:
                    until.strftime("%Y-%m-%dT%H:%M:%SZ")}


@dataclass
class Retention:
    """A version's retention: a mode and the date it ends."""
    mode: str = ""
    retain_until: Optional[datetime.datetime] = None

    @classmethod
    def parse(cls, data: bytes) -> "Retention":
        """A ``Retention`` document; its date must lie ahead."""
        root = _root(data, "retention")
        if root.tag != "Retention":
            raise ObjectLockError("malformed retention XML")
        mode = root.findtext("Mode") or ""
        if mode not in (GOVERNANCE, COMPLIANCE):
            raise ObjectLockError("invalid retention Mode")
        try:
            dt = _utc(root.findtext("RetainUntilDate") or "")
        except ValueError as e:
            raise ObjectLockError("invalid RetainUntilDate") from e
        if dt <= datetime.datetime.now(datetime.timezone.utc):
            raise ObjectLockError("RetainUntilDate must be in the future")
        return cls(mode=mode, retain_until=dt)

    @classmethod
    def from_metadata(cls, meta: dict[str, str]) -> "Retention":
        until = None
        until_s = meta.get(AMZ_OBJECT_LOCK_RETAIN_UNTIL, "")
        if until_s:
            try:
                until = _utc(until_s)
            except ValueError:
                until = None
        return cls(mode=meta.get(AMZ_OBJECT_LOCK_MODE, ""),
                   retain_until=until)

    def to_xml(self) -> bytes:
        root = ET.Element("Retention", xmlns=_S3_NS)
        ET.SubElement(root, "Mode").text = self.mode
        if self.retain_until:
            ET.SubElement(root, "RetainUntilDate").text = \
                self.retain_until.astimezone(
                    datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        return _XML_DECL + ET.tostring(root)

    def active(self, now: Optional[datetime.datetime] = None) -> bool:
        if not self.mode or self.retain_until is None:
            return False
        now = now or datetime.datetime.now(datetime.timezone.utc)
        return now < self.retain_until


def legal_hold_from_xml(data: bytes) -> str:
    status = _root(data, "legal hold").findtext("Status") or ""
    if status not in ("ON", "OFF"):
        raise ObjectLockError("invalid legal hold Status")
    return status


def legal_hold_to_xml(status: str) -> bytes:
    root = ET.Element("LegalHold", xmlns=_S3_NS)
    ET.SubElement(root, "Status").text = status or "OFF"
    return _XML_DECL + ET.tostring(root)


def check_delete_allowed(meta: dict[str, str],
                         governance_bypass: bool = False,
                         now: Optional[datetime.datetime] = None) -> bool:
    """Whether this exact version may be deleted
    (enforceRetentionForDeletion)."""
    if meta.get(AMZ_OBJECT_LOCK_LEGAL_HOLD, "").upper() == "ON":
        return False
    ret = Retention.from_metadata(meta)
    if not ret.active(now):
        return True
    if ret.mode == COMPLIANCE:
        return False
    return governance_bypass
