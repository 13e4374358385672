"""Typed error taxonomy for the serving runtime.

One hierarchy rooted at ``ServeError`` so callers can catch the whole
serving failure surface with a single except clause, or pick off the
specific failure class they can handle:

* ``AdmissionError``     — request shed by the SLO admission controller
  (fails fast at ``submit``, never reaches the engine);
* ``BatcherClosedError`` — request stranded by ``close()`` (the drain
  backstop: never silently abandoned);
* ``FaultInjected``      — a deterministic fault fired at a named
  injection site (``repro.ft.faults``), or injected corruption was
  detected at collect;
* ``RetryExhausted``     — every retry attempt failed or the request's
  remaining deadline budget could not fund another backoff sleep; the
  last underlying failure rides on ``__cause__``;
* ``CircuitOpenError``   — the stage-2 circuit breaker is open and the
  guarded fast path refused the call (the engine normally routes around
  this via the re-stacking fallback rather than surfacing it);
* ``WorkerCrashedError`` — the batcher worker thread died mid-flight;
  the supervisor resolves every affected future with this (or retries
  it) and respawns the loop.

A copy of ``repro.serve.errors``, so a caller catches the same names in
both packages. Stdlib-only.
"""
from __future__ import annotations

__all__ = [
    "ServeError",
    "AdmissionError",
    "BatcherClosedError",
    "FaultInjected",
    "RetryExhausted",
    "CircuitOpenError",
    "WorkerCrashedError",
]


class ServeError(RuntimeError):
    """Base class for every typed serving-runtime failure."""


class AdmissionError(ServeError):
    """Request shed by the admission controller (never scored).

    Carries the SLO class and the queue depth at shed time so callers
    can distinguish load shedding from infeasible deadlines.
    """

    def __init__(self, msg: str, *, slo: str = "best_effort",
                 queue_depth: int = 0):
        super().__init__(msg)
        self.slo = slo
        self.queue_depth = queue_depth


class BatcherClosedError(ServeError):
    """Request stranded by ``close()``: the batcher shut down before it
    could be scored."""


class FaultInjected(ServeError):
    """A deterministic fault fired at a named injection site."""

    def __init__(self, msg: str, *, site: str | None = None):
        super().__init__(msg)
        self.site = site


class RetryExhausted(ServeError):
    """All retry attempts failed, or the deadline budget ran out.

    The last underlying failure is chained on ``__cause__``.
    """

    def __init__(self, msg: str, *, attempts: int = 0):
        super().__init__(msg)
        self.attempts = attempts


class CircuitOpenError(ServeError):
    """The circuit breaker is open: the guarded path refused the call."""


class WorkerCrashedError(ServeError):
    """The batcher worker thread died while this request was in flight
    or queued; the supervisor resolved the future instead of hanging it."""
