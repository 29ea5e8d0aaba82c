"""The config subsystem: a key-value registry with environment overrides
(``minio_tpu/utils/kvconfig.py``, cmd/config/config.go:209,302).

``Config`` is {subsystem: {key: value}} over registered defaults.  A
lookup takes the environment first (``MT_<SUBSYS>_<KEY>``, the
reference's MINIO_<SUBSYS>_<KEY>), then the value ``set`` gave (admin
SetConfigKV), then the default.  Only the subsystems and keys the port
honours are registered; an unknown one raises KeyError.

The dynamic layer lives in memory: the port writes no
``.mt.sys/config/config.json`` and reads none (the reference seals that
file with DARE, which the port does not have yet, ROADMAP Queue 1 item
14), so a restart starts from the environment and the defaults.
"""

from __future__ import annotations

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
register_subsys("heal", {
    # bitrotscan=on makes every sweep deep; max_sleep caps the sleep
    # after each heal (background/heal.py pace_s)
    "bitrotscan": "off",
    "max_sleep": "1s",
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
register_subsys("commit", {
    # the group-commit plane (storage/commit.py): ops per group commit,
    # the packing ceiling and the segment rotation point
    "max_batch": "16",
    "pack_threshold": "1048576",
    "segment_max_bytes": "67108864",
})


class Config:
    """Layered lookup: env > dynamic set > defaults."""

    def __init__(self):
        self._dynamic: dict[str, dict[str, str]] = {}
        self._mu = threading.Lock()

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

    def get_subsys(self, subsys: str) -> dict[str, str]:
        defaults = _REGISTRY.get(subsys)
        if defaults is None:
            raise KeyError(subsys)
        return {k: self.get(subsys, k) for k in defaults}

    def subsystems(self) -> list[str]:
        return sorted(_REGISTRY)
