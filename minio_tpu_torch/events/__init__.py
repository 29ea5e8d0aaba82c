"""Bucket event notification (``minio_tpu/events/``, pkg/event and
cmd/notification.go): an event fired by an object call goes to the
ListenNotification streams and, through the bucket's notification
config, to the registered targets (the webhook, on the store-and-forward
engine of ``obs/egress.py``)."""

from .event import Event, new_event          # noqa: F401 — public API
from .notifier import NotificationSys        # noqa: F401 — public API
from .targets import (                       # noqa: F401 — public API
    MemoryTarget, QueueStore, Target, WebhookTarget)
