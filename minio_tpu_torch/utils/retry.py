"""Jittered exponential backoff under a retry budget
(``minio_tpu/utils/retry.py``: cmd/rest retries with the gRPC
retry-throttling token bucket).

One policy is shared by every caller of a transport; its budget keeps a
failing peer from seeing offered load times attempts: each retry spends
a token, each success refunds part of one, and an empty bucket stops the
retries while first attempts still pass.  The jitter's ``rng`` and the
``sleep`` can be injected, so a test drives the policy with a seeded
generator and a recording sleep.
"""

from __future__ import annotations

import random
import threading
import time


class RetryBudget:
    """The token bucket: a retry spends one token, a success refunds
    ``refund`` (up to ``capacity``); with less than one token left,
    retries are refused."""

    def __init__(self, capacity: float = 10.0, refund: float = 0.5):
        self.capacity = float(capacity)
        self.refund = float(refund)
        self._tokens = float(capacity)
        self._mu = threading.Lock()

    def try_spend(self) -> bool:
        with self._mu:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def credit(self) -> None:
        with self._mu:
            self._tokens = min(self.capacity, self._tokens + self.refund)

    @property
    def tokens(self) -> float:
        with self._mu:
            return self._tokens


class RetryPolicy:
    """``attempts`` counts the first try (3: at most two retries); only
    idempotent work is retried, and only while the budget holds.  The
    delay before retry ``n`` is uniform over [0, min(cap, base * 2^n)]
    (full jitter), so clients that failed together do not retry in step."""

    def __init__(self, attempts: int = 3, base_s: float = 0.05,
                 cap_s: float = 2.0, budget: RetryBudget | None = None,
                 rng: random.Random | None = None, sleep=time.sleep):
        self.attempts = max(1, int(attempts))
        self.base_s = base_s
        self.cap_s = cap_s
        self.budget = budget
        self.rng = rng or random.Random()
        self.sleep = sleep

    def backoff_s(self, retry_nr: int) -> float:
        """The delay before retry ``retry_nr`` (from 0)."""
        return self.rng.uniform(
            0.0, min(self.cap_s, self.base_s * (2 ** retry_nr)))

    def may_retry(self, attempt: int, idempotent: bool) -> bool:
        """Whether the failed ``attempt`` (from 0: the first try) may be
        followed by another; a retry it allows spends budget."""
        if attempt + 1 >= self.attempts or not idempotent:
            return False
        return self.budget is None or self.budget.try_spend()

    def wait(self, attempt: int) -> None:
        self.sleep(self.backoff_s(attempt))

    def on_success(self) -> None:
        if self.budget is not None:
            self.budget.credit()
