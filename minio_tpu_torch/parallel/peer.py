"""The peer service: change propagation between nodes
(the control-plane half of ``minio_tpu/parallel/peer.py``,
cmd/peer-rest-{client,server,common}.go).

When one node changes IAM or a bucket's metadata, it tells every peer,
whose caches reload at once (peerRESTMethodLoadBucketMetadata, LoadUser,
LoadPolicy, cmd/peer-rest-common.go:27-61); every write marks the peers'
update trackers, so their cached listings go stale at once.  The service
also answers the cluster-wide admin views: each node's scrape
(``metrics?scope=cluster``), background status and event targets.  The
observability half of the reference's service (trace, log, X-ray,
forensics, history, alerts, metering, profiles, speed tests, netperf,
health info) is ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import queue
import threading
import time

from .rpc import RPCClient, RPCServer


def register_peer_service(rpc: RPCServer, srv) -> None:
    """Export a node's reload hooks and its admin views as the ``peer``
    service; ``srv`` is the node's S3Server."""

    def reload_bucket_meta(bucket: str) -> bool:
        # the port's one bucket-level cache is the metadata's (the
        # reference also evicts a bucket-existence cache it keeps)
        srv.bucket_meta.invalidate(bucket)
        return True

    def reload_iam() -> bool:
        srv.iam.load()
        return True

    def mark_change(bucket: str, object_name: str = "") -> bool:
        """A peer wrote: mark this node's tracker (its cached listings
        of the bucket go stale), or without a tracker drop them."""
        if srv.tracker is not None:
            srv.tracker.mark(bucket, object_name)
        else:
            from ..objectlayer.metacache import managers_of
            for mc in managers_of(srv.layer):
                mc.invalidate(bucket)
        if not object_name:
            srv.bucket_meta.invalidate(bucket)    # a create or delete
        return True

    def metrics_render() -> dict:
        """This node's scrape with a ``server`` label on every sample,
        and the node's name."""
        from ..admin.handlers import render_local
        return {"node": srv.node_name,
                "doc": render_local(srv, node=srv.node_name)}

    def background_status() -> dict:
        from ..admin.handlers import background_status as _bg
        return {**_bg(srv), "node": srv.node_name}

    def target_status() -> dict:
        return {"node": srv.node_name, "targets": srv.egress.status()}

    def target_replay() -> dict:
        return {"node": srv.node_name, "replayed": srv.egress.replay_all()}

    rpc.register("peer", {
        "reload_bucket_meta": reload_bucket_meta,
        "reload_iam": reload_iam,
        "mark_change": mark_change,
        "metrics_render": metrics_render,
        "background_status": background_status,
        "target_status": target_status,
        "target_replay": target_replay,
    })


class PeerNotifier:
    """The sending side: change notifications fanned out to every peer,
    best effort and asynchronous (NotificationSys, cmd/notification.go).
    One worker and a bounded queue per peer, so a dead peer piles up
    neither threads nor work; a dropped notification is safe, since a
    reload is whole and a restarted peer reloads anyway."""

    QUEUE_MAX = 64

    def __init__(self, clients: list[RPCClient]):
        self.clients = clients
        self._queues: dict[str, queue.Queue] = {}
        self._workers: list[threading.Thread] = []
        self._closed = False
        self._mu = threading.Lock()

    def _queue_for(self, c: RPCClient) -> queue.Queue | None:
        with self._mu:
            if self._closed:
                return None
            q = self._queues.get(c.endpoint)
            if q is None:
                q = self._queues[c.endpoint] = queue.Queue(self.QUEUE_MAX)

                def worker():
                    while True:
                        item = q.get()
                        if item is None:        # close()
                            return
                        method, kwargs = item
                        try:
                            c.call("peer", method, _idempotent=True,
                                   **kwargs)
                        except Exception:  # noqa: BLE001 — peer down
                            pass

                t = threading.Thread(target=worker, daemon=True,
                                     name="mt-peer-fanout")
                self._workers.append(t)
                t.start()
            return q

    def _fanout(self, method: str, **kwargs) -> None:
        for c in self.clients:
            q = self._queue_for(c)
            if q is None:
                return
            try:
                q.put_nowait((method, kwargs))
            except queue.Full:
                pass    # a backlogged peer: a later reload covers it

    def close(self, timeout: float = 10.0) -> None:
        """End the workers (each finishes the notification in hand) and
        join them."""
        with self._mu:
            self._closed = True
            queues = list(self._queues.values())
            workers = list(self._workers)
        for q in queues:
            q.put(None)
        deadline = time.monotonic() + timeout
        for t in workers:
            t.join(max(0.0, deadline - time.monotonic()))

    def bucket_meta_changed(self, bucket: str) -> None:
        self._fanout("reload_bucket_meta", bucket=bucket)

    def object_changed(self, bucket: str, object_name: str = "") -> None:
        self._fanout("mark_change", bucket=bucket, object_name=object_name)

    def iam_changed(self) -> None:
        self._fanout("reload_iam")

    def call_all_iter(self, method: str, timeout_s: float = 30.0,
                      idempotent: bool = True, **kwargs):
        """``peer.<method>`` on every peer at once, yielding ``(endpoint,
        result, error)`` as the replies land; a peer past ``timeout_s``
        yields the error ``timeout`` (its call is bounded by the same
        deadline and ends on its own)."""
        done: queue.Queue = queue.Queue()

        def one(c: RPCClient):
            try:
                r = c.call("peer", method, _idempotent=idempotent,
                           _timeout=timeout_s, **kwargs)
                done.put((c.endpoint, r, ""))
            except Exception as e:  # noqa: BLE001 — peer down or slow
                done.put((c.endpoint, None, f"{type(e).__name__}: {e}"))

        for c in self.clients:
            threading.Thread(target=one, args=(c,), daemon=True,
                             name="mt-peer-call").start()
        deadline = time.monotonic() + timeout_s
        pending = {c.endpoint for c in self.clients}
        while pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                for ep in sorted(pending):
                    yield ep, None, "timeout"
                return
            try:
                ep, result, err = done.get(timeout=remaining)
            except queue.Empty:
                continue
            pending.discard(ep)
            yield ep, result, err

    def call_all(self, method: str, timeout_s: float = 30.0,
                 idempotent: bool = True, **kwargs) -> list:
        return list(self.call_all_iter(method, timeout_s=timeout_s,
                                       idempotent=idempotent, **kwargs))
