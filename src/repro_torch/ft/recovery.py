"""Self-healing primitives: circuit breaker + retry policy (port of
``repro.ft.recovery``).

``CircuitBreaker`` guards the stage-2 device-resident fast path.  The
classic three-state walk, tuned for a path that has a fallback scoring
the same requests (re-stacking) rather than an error response:

* CLOSED — traffic flows; ``failures`` consecutive recorded failures
  trip it OPEN;
* OPEN — ``allow()`` is False (the engine routes every pack through the
  re-stacking fallback) until ``cooldown_ms`` elapses, then the next
  ``allow()`` moves to HALF_OPEN;
* HALF_OPEN — probes flow freely (no in-flight probe bookkeeping: a
  probe whose outcome is never reported must not wedge the breaker);
  ``probes`` consecutive successes close it, any failure re-opens.

The clock is injectable so tests walk the cooldown without sleeping.
``RetryPolicy`` is the exponential-backoff + jitter schedule the batcher
bounds by each request's remaining deadline budget.  Module import is
stdlib-only; ``CircuitOpenError`` is imported lazily at raise time.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Thread-safe three-state circuit breaker with injectable clock."""

    def __init__(self, failures: int = 5, cooldown_ms: float = 100.0,
                 probes: int = 1, clock=time.monotonic, on_transition=None):
        if failures < 1:
            raise ValueError("failures must be >= 1")
        if cooldown_ms < 0:
            raise ValueError("cooldown_ms must be >= 0")
        if probes < 1:
            raise ValueError("probes must be >= 1")
        self.failure_threshold = failures
        self.cooldown_ms = cooldown_ms
        self.probes = probes
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._opened_at = 0.0
        self._consecutive = 0
        self._half_open_ok = 0
        self.opens = 0
        self.closes = 0
        self.failures_recorded = 0
        self.successes_recorded = 0

    # -- state ----------------------------------------------------------
    @property
    def state(self) -> str:
        pending: list = []
        with self._lock:
            self._maybe_half_open(pending)
            state = self._state
        self._flush(pending)
        return state

    def _maybe_half_open(self, pending: list) -> None:
        # lock held
        if (self._state == OPEN
                and (self._clock() - self._opened_at) * 1e3
                >= self.cooldown_ms):
            self._transition(HALF_OPEN, pending)
            self._half_open_ok = 0

    def _transition(self, new: str, pending: list) -> None:
        # lock held; pending defers the callback until the lock drops
        old, self._state = self._state, new
        if old != new and self._on_transition is not None:
            pending.append((old, new))

    def _flush(self, pending: list) -> None:
        for old, new in pending:
            self._on_transition(old, new)

    # -- the guard ------------------------------------------------------
    def allow(self) -> bool:
        """True when traffic may take the guarded path right now."""
        pending: list = []
        with self._lock:
            self._maybe_half_open(pending)
            ok = self._state != OPEN
        self._flush(pending)
        return ok

    def guard(self) -> None:
        """Raise ``CircuitOpenError`` instead of returning False."""
        if not self.allow():
            from repro_torch.serve.errors import CircuitOpenError
            raise CircuitOpenError(
                f"circuit open ({self.failures_recorded} failures recorded; "
                f"cooldown {self.cooldown_ms:g} ms)")

    def record_success(self) -> None:
        pending: list = []
        with self._lock:
            self.successes_recorded += 1
            if self._state == CLOSED:
                self._consecutive = 0
            elif self._state == HALF_OPEN:
                self._half_open_ok += 1
                if self._half_open_ok >= self.probes:
                    self._transition(CLOSED, pending)
                    self.closes += 1
                    self._consecutive = 0
        self._flush(pending)

    def record_failure(self) -> None:
        pending: list = []
        with self._lock:
            self.failures_recorded += 1
            if self._state == HALF_OPEN:
                self._transition(OPEN, pending)
                self.opens += 1
                self._opened_at = self._clock()
            elif self._state == CLOSED:
                self._consecutive += 1
                if self._consecutive >= self.failure_threshold:
                    self._transition(OPEN, pending)
                    self.opens += 1
                    self._opened_at = self._clock()
            else:
                # failure reported while open (a straggler from before
                # the trip): extend the cooldown window
                self._opened_at = self._clock()
        self._flush(pending)

    def call(self, fn, *args, **kwargs):
        """Run ``fn`` through the breaker: guard, then record outcome."""
        self.guard()
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    def stats(self) -> dict:
        pending: list = []
        with self._lock:
            self._maybe_half_open(pending)
            snap = {
                "state": self._state,
                "opens": self.opens,
                "closes": self.closes,
                "failures": self.failures_recorded,
                "successes": self.successes_recorded,
                "consecutive_failures": self._consecutive,
            }
        self._flush(pending)
        return snap


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
