"""Notification targets (``minio_tpu/events/targets.py``,
pkg/event/target/*): the webhook, which POSTs each record, and an
in-memory target for tests and diagnostics.  The broker targets (AMQP,
Kafka, MQTT, NATS, NSQ, Redis, MySQL, PostgreSQL, Elasticsearch) are in
``brokers.py``, on the same ``StoreForwardTarget``.

A network target rides the store-and-forward engine (``obs/egress.py``):
``send`` queues without waiting, a sender thread retries with backoff,
an endpoint that keeps failing takes the target offline (records go to
the disk ``QueueStore``) until a probe brings it back and the store
replays; a record that can be neither delivered nor stored is
dead-lettered, never raised into the request.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Optional

from ..obs.egress import DeliveryTarget, QueueStore  # noqa: F401 — re-export


class TargetError(Exception):
    pass


class Target:
    """pkg/event/target's interface: an ARN, send, close, replay."""

    arn: str = ""

    def send(self, record: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


def event_payload(record: dict) -> dict:
    """The envelope a webhook receives (pkg/event/target sendEvent):
    {"EventName", "Key", "Records"}."""
    return {
        "EventName": "s3:" + record.get("eventName", ""),
        "Key": f"{record['s3']['bucket']['name']}/"
               f"{record['s3']['object']['key']}",
        "Records": [record],
    }


class StoreForwardTarget(DeliveryTarget):
    """A target on the delivery engine, named by its ARN."""

    def __init__(self, arn: str, store_dir: Optional[str] = None,
                 **engine):
        super().__init__("notify", arn, store_dir=store_dir, **engine)
        self.arn = arn


class WebhookTarget(StoreForwardTarget):
    """POST each record as {"EventName", "Key", "Records": [...]}
    (pkg/event/target/webhook.go), with ``auth_token`` as its
    Authorization header when set."""

    def __init__(self, arn: str, endpoint: str, auth_token: str = "",
                 store_dir: Optional[str] = None, timeout: float = 5.0,
                 **engine):
        super().__init__(arn, store_dir, **engine)
        self.endpoint = endpoint
        self.auth_token = auth_token
        self.timeout = timeout

    def _deliver(self, record: dict) -> None:
        req = urllib.request.Request(
            self.endpoint, data=json.dumps(event_payload(record)).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": self.auth_token}
                        if self.auth_token else {})})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            if resp.status // 100 != 2:
                raise TargetError(f"webhook returned {resp.status}")


class MemoryTarget(Target):
    """Keeps the records in memory."""

    def __init__(self, arn: str):
        self.arn = arn
        self.records: list[dict] = []
        self._mu = threading.Lock()

    def send(self, record: dict) -> None:
        with self._mu:
            self.records.append(record)

    def events(self) -> list[dict]:
        with self._mu:
            return list(self.records)
