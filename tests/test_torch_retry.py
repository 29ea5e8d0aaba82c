"""The port's ``utils/retry.py`` against ``minio_tpu``'s: under one pinned
``random`` stream the same backoffs, the same retry verdicts and the same
budget, attempt by attempt, for policies drawn from a numpy seed."""

import random

import numpy as np
import pytest

from minio_tpu.utils import retry as ref_retry
from minio_tpu_torch.utils import retry as port_retry

from ._torch_ident import no_state_left


@pytest.fixture(scope="module", autouse=True)
def _no_state_left():
    with no_state_left():
        yield


def _run(mod, seed: int, attempts: int, base: float, cap: float,
         capacity: float, refund: float, outcomes: list) -> list:
    """Drive one policy through ``outcomes`` (True: the call succeeded)
    with a recording sleep; every verdict, delay and token count."""
    slept = []
    budget = mod.RetryBudget(capacity, refund)
    pol = mod.RetryPolicy(attempts=attempts, base_s=base, cap_s=cap,
                          budget=budget, rng=random.Random(seed),
                          sleep=slept.append)
    trace, attempt = [], 0
    for ok in outcomes:
        if ok:
            pol.on_success()
            trace.append(("ok", budget.tokens))
            attempt = 0
            continue
        verdict = pol.may_retry(attempt, idempotent=attempt % 5 != 4)
        trace.append(("fail", attempt, verdict, budget.tokens))
        if verdict:
            pol.wait(attempt)
            attempt += 1
        else:
            attempt = 0
    trace.append(("slept", slept))
    trace.append(("backoffs", [pol.backoff_s(n) for n in range(8)]))
    return trace


@pytest.mark.parametrize("seed", range(8))
def test_backoffs_and_budget_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    args = (int(rng.integers(1 << 30)), int(rng.integers(0, 6)),
            float(rng.uniform(0.001, 0.2)), float(rng.uniform(0.05, 3.0)),
            float(rng.integers(0, 6)), float(rng.uniform(0.0, 1.5)),
            [bool(b) for b in rng.random(40) < 0.3])
    assert _run(port_retry, *args) == _run(ref_retry, *args)


def test_defaults_match_the_reference():
    for attempts in (-1, 0, 1, "4"):
        p = port_retry.RetryPolicy(attempts=attempts)
        r = ref_retry.RetryPolicy(attempts=attempts)
        assert (p.attempts, p.base_s, p.cap_s, p.budget) == \
            (r.attempts, r.base_s, r.cap_s, r.budget)
    pb, rb = port_retry.RetryBudget(), ref_retry.RetryBudget()
    assert (pb.capacity, pb.refund, pb.tokens) == \
        (rb.capacity, rb.refund, rb.tokens)
