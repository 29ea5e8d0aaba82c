"""The S3 event record (``minio_tpu/events/event.py``, pkg/event/event.go).

What a target and a ListenNotification client receive: one entry of the
AWS event message's ``Records``, eventVersion 2.0, eventSource
``minio:s3``, the bucket and the object under ``s3``, and a sequencer
that orders the events.  The keys are those of pkg/event/event.go.
"""

from __future__ import annotations

import datetime
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Event:
    event_name: str
    bucket: str
    key: str
    size: int = 0
    etag: str = ""
    version_id: str = ""
    region: str = ""
    user_identity: str = ""
    request_params: dict[str, str] = field(default_factory=dict)
    response_elements: dict[str, str] = field(default_factory=dict)
    content_type: str = ""
    user_metadata: dict[str, str] = field(default_factory=dict)
    time_ns: int = 0
    sequencer: str = ""

    def to_record(self) -> dict[str, Any]:
        """One entry of Records[] (pkg/event/event.go:60-107)."""
        ts = datetime.datetime.fromtimestamp(
            (self.time_ns or time.time_ns()) / 1e9,
            datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] \
            + "Z"
        return {
            "eventVersion": "2.0",
            "eventSource": "minio:s3",
            "awsRegion": self.region,
            "eventTime": ts,
            "eventName": self.event_name.removeprefix("s3:"),
            "userIdentity": {"principalId": self.user_identity},
            "requestParameters": self.request_params,
            "responseElements": self.response_elements,
            "s3": {
                "s3SchemaVersion": "1.0",
                "configurationId": "Config",
                "bucket": {
                    "name": self.bucket,
                    "ownerIdentity": {"principalId": self.user_identity},
                    "arn": f"arn:aws:s3:::{self.bucket}",
                },
                "object": {
                    "key": urllib.parse.quote(self.key),
                    "size": self.size,
                    "eTag": self.etag,
                    "contentType": self.content_type,
                    "userMetadata": self.user_metadata,
                    "versionId": self.version_id,
                    "sequencer": self.sequencer,
                },
            },
            "source": {
                "host": "127.0.0.1",
                "port": "",
                "userAgent": "minio-tpu",
            },
        }


def new_event(event_name: str, bucket: str, oi, region: str = "",
              user: str = "", req_params: dict | None = None) -> Event:
    """The event of an object-layer result (an ObjectInfo, or the result
    of a delete)."""
    now = time.time_ns()
    return Event(
        event_name=event_name, bucket=bucket,
        key=getattr(oi, "name", ""), size=getattr(oi, "size", 0),
        etag=getattr(oi, "etag", ""),
        version_id=getattr(oi, "version_id", ""),
        content_type=getattr(oi, "content_type", ""),
        region=region, user_identity=user,
        request_params=req_params or {},
        time_ns=now, sequencer=f"{now:016X}")
