"""The notification system (``minio_tpu/events/notifier.py``,
cmd/notification.go with pkg/event/rulesmap.go).

``send`` publishes every event to the pubsub that ListenNotification
streams read, then routes it through the bucket's notification config to
the registered targets, on a worker pool: delivery never runs on the
request's thread.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..bucket.notification import Config as NotificationConfig
from ..utils.pubsub import PubSub
from .event import new_event
from .targets import Target


class NotificationSys:
    def __init__(self, bucket_meta, region: str = "", workers: int = 4):
        self._bucket_meta = bucket_meta
        self._region = region
        self._targets: dict[str, Target] = {}
        self._mu = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="mt-event-send")
        self.pubsub = PubSub()

    # -- the target registry (cmd/config/notify) -------------------------

    def register_target(self, target: Target) -> None:
        with self._mu:
            self._targets[target.arn] = target

    def remove_target(self, arn: str) -> None:
        with self._mu:
            self._targets.pop(arn, None)

    def valid_arns(self) -> set[str]:
        with self._mu:
            return set(self._targets)

    # -- firing ----------------------------------------------------------

    def _config(self, bucket: str) -> Optional[NotificationConfig]:
        try:
            return self._bucket_meta.get_parsed(bucket, "notification",
                                                NotificationConfig.parse)
        except ValueError:
            return None

    def send(self, event_name: str, bucket: str, oi,
             req_params: dict | None = None, user: str = "") -> None:
        ev = new_event(event_name, bucket, oi, region=self._region,
                       user=user, req_params=req_params)
        record = ev.to_record()
        # a listener sees every event and filters it itself
        self.pubsub.publish({"name": event_name, "bucket": bucket,
                             "key": ev.key, "record": record})
        cfg = self._config(bucket)
        if cfg is None:
            return
        arns = cfg.match(event_name, ev.key)
        if not arns:
            return
        with self._mu:
            targets = [self._targets[a] for a in arns if a in self._targets]
        for t in targets:
            try:
                self._pool.submit(self._deliver, t, record)
            except RuntimeError:        # closed: the server is stopping
                return

    @staticmethod
    def _deliver(target: Target, record: dict) -> None:
        try:
            target.send(record)
        except Exception:  # noqa: BLE001 — a target keeps its own retries
            pass

    def close(self) -> None:
        """End the listeners' streams, stop the workers (joined) and close
        every target: a store-backed one stores what it still queues."""
        self.pubsub.close()
        self._pool.shutdown(wait=True)
        with self._mu:
            targets = list(self._targets.values())
        for t in targets:
            try:
                t.close()
            except Exception:  # noqa: BLE001 — shutdown goes on
                pass
