"""The config subsystem: a key-value registry with environment overrides
(``minio_tpu/utils/kvconfig.py``, cmd/config/config.go:209,302).

``Config`` is {subsystem: {key: value}} over registered defaults.  A
lookup takes the environment first (``MT_<SUBSYS>_<KEY>``, the
reference's MINIO_<SUBSYS>_<KEY>), then the value ``set`` gave (admin
SetConfigKV), then the default.  Only the subsystems and keys the port
honours are registered; an unknown one raises KeyError.

Bound to an object layer, the dynamic layer persists as the reference
keeps it: ``.mt.sys/config/config.json`` on every drive of the layer's
metadata set, sealed with DARE under the admin secret
(``secure/configcrypt.py``), written on every ``set`` and read when the
``Config`` is built.  A plaintext blob, or one sealed under a retired
secret (``MT_ADMIN_SECRET_OLD``), is read and written back sealed under
the current one.  The port never writes plaintext: without libcrypto
sealing raises.
"""

from __future__ import annotations

import json
import os
import threading

ENV_PREFIX = "MT"

_REGISTRY: dict[str, dict[str, str]] = {}


def register_subsys(name: str, defaults: dict[str, str]) -> None:
    _REGISTRY[name] = dict(defaults)


def parse_duration(s: str, default: float = 10.0) -> float:
    """'10s' / '2m' / '500ms' / a bare number -> seconds."""
    s = (s or "").strip()
    try:
        if s.endswith("ms"):
            return float(s[:-2]) / 1000.0
        if s.endswith("s"):
            return float(s[:-1])
        if s.endswith("m"):
            return float(s[:-1]) * 60.0
        return float(s)
    except ValueError:
        return default


# the reference's defaults, for the keys the port reads
register_subsys("api", {
    # the request plane (s3/server.py reload_api_config): concurrent S3
    # requests (0: 16 x the CPU count), how long one waits for a slot,
    # and the waiting line beyond which a request is shed at once with
    # 503 and Retry-After (0: twice requests_max)
    "requests_max": "0",
    "requests_deadline": "10s",
    "requests_queue": "0",
    # per connection: the socket timeout for the request line, headers
    # and keep-alive idle; the absolute budget for reading one body,
    # body_deadline + Content-Length / body_min_rate (bytes/s, 0: no
    # size term), past which the request answers 408
    "read_header_timeout": "30s",
    "body_deadline": "2m",
    "body_min_rate": "1048576",
    # stop(): how long in-flight requests may finish once the listener
    # has closed (0: sever at once)
    "shutdown_drain_s": "5s",
    # registered so a SetConfigKV of it is accepted; read by nothing, as
    # in the reference
    "cors_allow_origin": "*",
    # the memory governor (utils/memgov.py): its watermark (0: admit
    # everything; sizes as 268435456, 256MiB, 1GiB) and the Retry-After
    # of a shed
    "mem_limit": "0",
    "mem_retry_after": "1s",
    # S3 Select (s3select/): decoded object bytes are scanned this many
    # at a time, so a scan holds a few blocks whatever the object's size
    "select_block_bytes": "1048576",
})
register_subsys("heal", {
    # bitrotscan=on makes every sweep deep; max_sleep caps the sleep
    # after each heal (background/heal.py pace_s)
    "bitrotscan": "off",
    "max_sleep": "1s",
})
register_subsys("scanner", {
    # the crawler's pacing (background/crawler.py): after a cycle it also
    # waits ``delay`` x that cycle's seconds, at most ``max_wait``
    "delay": "10",
    "max_wait": "15s",
})
register_subsys("rebalance", {
    # the pool drain (background/rebalance.py): ``enable`` runs the
    # threshold rebalance (a decommissioned pool drains either way),
    # ``max_workers`` keys move at once, ``bandwidth`` caps the moved
    # bytes/s (0: no cap); heal.max_sleep paces each move
    "enable": "off",
    "max_workers": "1",
    "bandwidth": "0",
})
register_subsys("quota", {
    # hard bucket quotas (s3/handlers_object.py _check_quota): off stops
    # enforcing the limits, which stay stored; read on every write
    "enable": "on",
})
register_subsys("drive", {
    # slow-drive detection over the drives' last-minute latency windows
    # (storage/health.py slow_drives), read at every scrape and
    # storageinfo call: a drive whose p50 exceeds ``slow_latency_multiple``
    # x the median of the other drives of its set, over at least
    # ``slow_min_samples`` ops, is flagged, never ejected
    "slow_latency_multiple": "4",
    "slow_min_samples": "10",
})
register_subsys("pipeline", {
    # the pipelined PUT (objectlayer/erasure_object.py): ``depth`` batches
    # in flight per stream (0: the serial fan-out, nothing packed);
    # ``queue_depth`` ops queued per drive writer before enqueue blocks
    "depth": "2",
    "queue_depth": "2",
})
register_subsys("storage_class", {
    # the parity of each S3 storage class (cmd/config/storageclass):
    # ``standard`` for a PUT without x-amz-storage-class or with STANDARD
    # (empty: the set's default parity), ``rrs`` for REDUCED_REDUNDANCY;
    # as EC:<parity>, read on every write (s3/handlers_object.py)
    "standard": "",
    "rrs": "EC:2",
})
register_subsys("compression", {
    # transparent compression (compress/, s3/handlers_object.py): off by
    # default; when on, a PUT whose key ends in one of ``extensions`` or
    # whose Content-Type starts with one of ``mime_types`` is stored
    # compressed; read on every write
    "enable": "off",
    "extensions": ".txt,.log,.csv,.json,.tar,.xml,.bin",
    "mime_types": "text/*,application/json,application/xml",
})
register_subsys("tls", {
    # TLS on both planes (secure/certs.py): enable=on serves the S3 front
    # and the internode RPC (mutual TLS) over TLS, and their clients
    # speak it, with the files of ``certs_dir`` (public.crt and
    # private.key, internode/, CAs/, sni/<host>/); read when the server
    # or node is built, while the certificate files reload live
    "enable": "off",
    "certs_dir": "",
})
register_subsys("federation", {
    # bucket DNS federation (utils/fed_dns.py): the records of this
    # server's buckets in ``dns_file`` (or etcd, when the etcd subsystem
    # names endpoints), under ``domain``, naming ``advertise`` (host:port)
    # or the bound address; read once, when the server is built
    "enable": "off",
    "domain": "",
    "dns_file": "",
    "advertise": "",
})
register_subsys("commit", {
    # the group-commit plane (storage/commit.py): ops per group commit,
    # the packing ceiling and the segment rotation point
    "max_batch": "16",
    "pack_threshold": "1048576",
    "segment_max_bytes": "67108864",
})
register_subsys("rpc", {
    # the internode plane (parallel/rpc.py): the per-peer circuit
    # breaker, the shared retry policy (utils/retry.py; retry_budget 0
    # turns the budget off), and the framed streaming of bulk bodies
    # longer than stream_chunk_bytes (live: S3Server.reload_rpc_config)
    "breaker_failures": "3",
    "breaker_cooldown": "3s",
    "retry_attempts": "3",
    "retry_base": "50ms",
    "retry_cap": "2s",
    "retry_budget": "10",
    "stream_enable": "on",
    "stream_chunk_bytes": "1048576",
})
register_subsys("notify_webhook", {
    # the webhook event target (events/targets.py, ARN
    # arn:minio:sqs::1:webhook), rebuilt live on a change
    # (s3/server.py reload_egress_config): ``queue_dir`` gives it a disk
    # store, ``queue_limit`` bounds its queue and that store
    "enable": "off", "endpoint": "", "auth_token": "", "queue_dir": "",
    "queue_limit": "10000",
})
# the broker event targets (events/brokers.py target_from_config, ARN
# arn:minio:sqs::1:<kind>), each rebuilt live on a change of its own
# subsystem; the keys are the reference's (cmd/config/notify)
for _kind, _keys in (
        ("amqp", ("url", "exchange", "routing_key")),
        ("kafka", ("brokers", "topic")),
        ("mqtt", ("broker", "topic", "qos")),
        ("nats", ("address", "subject", "username", "password")),
        ("nsq", ("nsqd_address", "topic")),
        ("redis", ("address", "key", "format", "password")),
        ("mysql", ("dsn_string", "table", "format")),
        ("postgresql", ("connection_string", "table", "format")),
        ("elasticsearch", ("url", "index", "format"))):
    register_subsys(f"notify_{_kind}", {
        "enable": "off",
        **{k: {"qos": "0", "format": "namespace"}.get(k, "") for k in _keys},
        "queue_dir": "", "queue_limit": "10000"})
register_subsys("policy_opa", {
    # the external policy webhook (secure/opa.py): with a ``url``, every
    # authorisation but root's is the webhook's, and any failure denies;
    # ``timeout`` bounds each of ``retry_attempts``; rebuilt live
    # (s3/server.py reload_policy_config)
    "url": "",
    "auth_token": "",
    "timeout": "2s",
    "retry_attempts": "2",
})
register_subsys("etcd", {
    # IAM's store (utils/etcd.py, iam/sys.py attach_etcd): with
    # ``endpoints`` (comma-separated http://host:port) IAM keeps its state
    # under <path_prefix>/config/iam/ there instead of on the drives;
    # read when the server is built
    "endpoints": "",
    "path_prefix": "",
})
register_subsys("identity_ldap", {
    # AssumeRoleWithLDAPIdentity's directory (iam/ldap.py, the
    # reference's keys); read when the server is built, as the
    # reference's server reads them (ROADMAP Queue 3 record 60)
    "server_addr": "",
    "sts_expiry": "1h",
    "lookup_bind_dn": "",
    "lookup_bind_password": "",
    "user_dn_search_base_dn": "",
    "user_dn_search_filter": "",        # %s: the username
    "group_search_filter": "",          # %s: the username, %d: its DN
    "group_search_base_dn": "",
})
register_subsys("identity_openid", {
    # AssumeRoleWithWebIdentity's provider (iam/openid.py); read when the
    # server is built
    "enable": "off",
    "issuer": "",                   # the expected iss claim
    "client_id": "",                # the expected aud or azp
    "claim_name": "policy",         # the claim naming the IAM policies
    "jwks_file": "",                # a JWKS document's path (RS256)
    "jwks": "",                     # an inline JWKS (wins over the file)
    "hs256_secret": "",             # the shared secret of HS256 tokens
})


CONFIG_PATH = "config/config.json"          # in the system volume


class Config:
    """Layered lookup: env > dynamic set > defaults.  ``layer`` (an
    object layer with a ``meta_set``) makes the dynamic layer persist,
    sealed under ``secret``."""

    def __init__(self, layer=None, secret: str = ""):
        self._layer = layer
        self._secret = secret or ""
        self._dynamic: dict[str, dict[str, str]] = {}
        self._mu = threading.Lock()
        self._persist_mu = threading.Lock()
        if layer is not None:
            self._load()

    @staticmethod
    def _env_key(subsys: str, key: str) -> str:
        return f"{ENV_PREFIX}_{subsys.upper()}_{key.upper()}"

    def get(self, subsys: str, key: str) -> str:
        env = os.environ.get(self._env_key(subsys, key))
        if env is not None:
            return env
        with self._mu:
            dyn = self._dynamic.get(subsys, {}).get(key)
        if dyn is not None:
            return dyn
        defaults = _REGISTRY.get(subsys)
        if defaults is None or key not in defaults:
            raise KeyError(f"{subsys}.{key}")
        return defaults[key]

    def set(self, subsys: str, key: str, value: str) -> None:
        defaults = _REGISTRY.get(subsys)
        if defaults is None:
            raise KeyError(subsys)
        if key not in defaults:
            raise KeyError(f"{subsys}.{key}")
        with self._mu:
            self._dynamic.setdefault(subsys, {})[key] = value
        self._persist()

    def get_subsys(self, subsys: str) -> dict[str, str]:
        defaults = _REGISTRY.get(subsys)
        if defaults is None:
            raise KeyError(subsys)
        return {k: self.get(subsys, k) for k in defaults}

    def subsystems(self) -> list[str]:
        return sorted(_REGISTRY)

    # -- at rest (cmd/config-current.go) -------------------------------------

    def _persist(self) -> None:
        if self._layer is None:
            return
        from ..secure import configcrypt
        from ..storage.xl_storage import SYS_DIR
        er = self._layer.meta_set
        with self._persist_mu:      # snapshot and write, one at a time
            with self._mu:
                blob = json.dumps(self._dynamic).encode()
            blob = configcrypt.encrypt_data(self._secret, blob)
            er._fanout(lambda d: d.write_all(SYS_DIR, CONFIG_PATH, blob),
                       er.disks)

    def _load(self) -> None:
        """The first copy that opens under the current or an old secret;
        resealed under the current one when it was not sealed by it."""
        from ..secure import configcrypt
        from ..storage.xl_storage import SYS_DIR
        er = self._layer.meta_set
        res, _ = er._fanout(lambda d: d.read_all(SYS_DIR, CONFIG_PATH),
                            er.disks)
        olds = configcrypt.old_secrets_from_env()
        for r in res:
            if r is None:
                continue
            try:
                blob, reseal = configcrypt.maybe_decrypt(self._secret, r,
                                                         olds)
                doc = json.loads(blob)
            except (configcrypt.DecryptError, json.JSONDecodeError):
                continue            # sealed under a secret not offered
            with self._mu:
                self._dynamic = doc
            if reseal:
                self._persist()
            return


def parse_storage_class(value: str, drive_count: int) -> int | None:
    """'EC:4' -> parity 4 (cmd/config/storageclass/storage-class.go);
    None for an empty value.  ValueError for another form, or a parity
    outside 1..drive_count // 2 (the write path needs a parity shard)."""
    if not value:
        return None
    if not value.startswith("EC:"):
        raise ValueError(f"invalid storage class {value!r}")
    parity = int(value[3:])
    if parity < 1 or parity > drive_count // 2:
        raise ValueError(f"parity {parity} out of range")
    return parity
