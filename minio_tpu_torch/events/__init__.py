"""Bucket event notification (``minio_tpu/events/``, pkg/event and
cmd/notification.go): an event fired by an object call goes to the
ListenNotification streams and, through the bucket's notification
config, to the registered targets (the webhook and the nine broker
kinds, on the store-and-forward engine of ``obs/egress.py``)."""

from .brokers import (                       # noqa: F401 — public API
    BROKER_KINDS, AMQPTarget, ElasticsearchTarget, KafkaTarget, MQTTTarget,
    MySQLTarget, NATSTarget, NSQTarget, PostgreSQLTarget, RedisTarget,
    target_from_config)
from .event import Event, new_event          # noqa: F401 — public API
from .notifier import NotificationSys        # noqa: F401 — public API
from .targets import (                       # noqa: F401 — public API
    MemoryTarget, QueueStore, Target, WebhookTarget)
