"""Reusable framed-buffer pool for the PUT pipeline
(``minio_tpu/utils/bufpool.py``), holding host tensors.

Every stream batch's framed shards, (k + m, framed_len) bytes, come back
from the device into a host buffer that the drive writers read.  On the
card the pool holds **pinned** tensors, so that copy runs as one
``non_blocking`` DMA instead of through freshly allocated pageable memory
(``.cpu()``), whose first touch costs more than the copy; a pinned
allocation is slow too, so buffers are recycled.  On the CPU it holds
plain tensors.

Keyed by exact shape and pinnedness; bounded in total bytes; ``acquire``
never blocks (a miss allocates).  A buffer goes back with ``release``
only after every drive write of its batch has completed (the writer
plane's batch release), so a later batch never encodes into bytes a
drive has yet to write.
"""

from __future__ import annotations

import threading

import torch

# with 60 MiB stream batches a framed buffer is ~80 MiB: a handful of
# batches across concurrent streams
DEFAULT_MAX_BYTES = 512 << 20


class BufPool:
    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self._mu = threading.Lock()
        self._free: dict[tuple, list[torch.Tensor]] = {}
        self._held = 0
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.checked_out = 0        # acquired and not yet released

    def acquire(self, shape: tuple, pinned: bool) -> torch.Tensor:
        """A uint8 host tensor of ``shape``: a recycled one when free,
        else a new one (pinned when asked)."""
        key = (tuple(shape), pinned)
        with self._mu:
            self.checked_out += 1
            lst = self._free.get(key)
            if lst:
                buf = lst.pop()
                self._held -= buf.numel()
                self.hits += 1
                return buf
            self.misses += 1
        return torch.empty(key[0], dtype=torch.uint8, pin_memory=pinned)

    def release(self, buf: torch.Tensor) -> None:
        """Return a buffer for reuse; dropped once the pool holds
        ``max_bytes``."""
        with self._mu:
            self.checked_out -= 1
            if self._held + buf.numel() > self.max_bytes:
                return
            key = (tuple(buf.shape), buf.is_pinned())
            self._free.setdefault(key, []).append(buf)
            self._held += buf.numel()


# process-wide pool shared by every erasure set's PUT pipeline
GLOBAL = BufPool()
