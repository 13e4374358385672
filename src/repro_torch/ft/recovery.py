"""Retry policy for the serving runtime (port of ``repro.ft.recovery``,
``RetryPolicy`` only; the circuit breaker comes with the fault-tolerance
slice).

``RetryPolicy`` is the exponential-backoff + jitter schedule the batcher
bounds by each request's remaining deadline budget. Stdlib-only.
"""
from __future__ import annotations

import dataclasses
import random


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with multiplicative jitter.

    Attempt ``k`` (0-based) sleeps ``backoff_ms * 2**k`` scaled by
    ``1 + jitter * U[0,1)``.  The caller compares each delay against the
    request's remaining deadline budget and stops retrying when the
    sleep alone would blow it.
    """

    retries: int = 0
    backoff_ms: float = 1.0
    jitter: float = 0.5

    def backoff_s(self, attempt: int,
                  rng: random.Random | None = None) -> float:
        base = self.backoff_ms * (2 ** attempt) / 1e3
        if self.jitter > 0 and rng is not None:
            base *= 1.0 + self.jitter * rng.random()
        return base
