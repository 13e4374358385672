"""Async request queue that coalesces candidate chunks across users
(port of ``repro.serve.batcher``, with its request-tracing instants:
``submit``, ``admission_shed``, ``admission_degrade``, ``queue_claim``,
``group_launch``, ``resolve``, ``retry``, ``retry_exhausted``,
``worker_crash``, ``worker_respawn``; and spans of its worker's own work
around the engine's: ``batcher.wait`` (a blocking get with nothing in
flight), ``batcher.linger`` (a group's forming, with ``reqs``, ``rows``,
``depth`` — the requests queued when it opened — and the tracer's
``dropped``), ``batcher.claim`` and ``batcher.resolve`` (the waiters'
done callbacks included)). The ``queued`` gauge counts the admitted requests not yet
claimed.

At "millions of users" scale the compiled stage-2 buckets sit mostly idle
if each request is served alone: every ragged pool pays its own padding and
every call its own dispatch. ``CoalescingBatcher`` is the standard
industrial answer — requests from *different users* are queued, and their
candidate chunks are packed into shared power-of-two buckets, each executed
as ONE cross-user stage-2 call (row-wise user reps gathered by a per-row
user index; see ``ServingEngine.score_coalesced``).

Usage::

    batcher = CoalescingBatcher(engine, linger_ms=2.0)
    fut = batcher.submit(req)          # non-blocking; Future[ServeResult]
    ...
    result = fut.result()
    batcher.close()

or synchronously for a burst of concurrent requests::

    results = batcher.score_many(reqs)

A single worker thread drains the queue: the first waiting request opens a
batch, then the worker lingers up to ``linger_ms`` (or until ``max_batch``
candidate rows / ``max_coalesce`` requests are waiting) collecting
co-arriving requests before handing the group to the engine. Coalesced
scores equal per-request ``engine.score`` up to the fp32 summation order
the libraries pick per bucket size — both run the same row-wise graph.

**Continuous dispatch** (``continuous=True``, the default) — instead of
blocking on each group's results before touching the queue again
(lockstep), the worker launches a group via the engine's two-phase API
(``begin_coalesced``) and immediately returns to the queue: group k+1 is
formed, packed into its own transfer buffers, and launched while
group k still executes on device, up to ``max_inflight`` outstanding
groups; finished groups are harvested the moment their device results
are ready (non-blocking ``engine.poll``), so overlap never inflates a
completed request's latency. Stage 2 runs back-to-back with zero idle
whenever work is queued.
Groups are launched AND collected in formation order, so results, counters
and dispatch order are identical to lockstep — the loop changes *when*
packs launch, never *what* they compute. An engine without
``begin_coalesced`` falls back to lockstep transparently.

**SLO classes** — ``submit(req, slo="deadline", deadline_ms=...)`` marks a
request latency-critical: deadline requests jump the FIFO (the queue is
priority-ordered, FIFO within each class) and shrink the linger window —
a group opened by (or joined by) a deadline request lingers only
``linger_ms * deadline_linger_frac``, further capped by the request's
remaining deadline budget, so a latency-critical arrival never waits out a
full best-effort linger behind older bulk traffic.

**Admission control** (``admission=True``) — the overload valve upstream
of the priority queue. At submit time, under the queue lock:

* a ``best_effort`` request arriving at queue depth >=
  ``shed_queue_depth`` is SHED: its future fails immediately with a typed
  ``AdmissionError`` (fail fast — never queued, never hung);
* a ``best_effort`` request arriving at queue depth >=
  ``degrade_queue_depth`` is DEGRADED: its candidate pool is truncated to
  the first ``ceil(n * degrade_frac)`` rows (results carry
  ``degraded=True``) — less device work per admitted request, so the
  queue drains faster without dropping users entirely;
* a ``deadline`` request is NEVER shed by queue depth — only when its own
  ``deadline_ms`` budget is already below ``deadline_headroom_ms`` (an
  infeasible deadline: shedding immediately beats returning a late
  answer).

So under overload, best-effort work is degraded first and shed second,
while the deadline class keeps its strict queue priority — the counters
``shed_requests`` / ``shed_best_effort`` / ``shed_deadline`` /
``degraded_requests`` (surfaced by ``RankingService.stats()``) are the
overload alarm. Without admission control the priority is strict and
unbounded: a workload whose deadline-class arrival rate alone saturates
the worker starves queued best-effort requests for as long as the
saturation lasts — that is the intended contract (``deadline_requests /
requests`` is the counter to alarm on).

**Self-healing** (``retries > 0``) — a group whose launch or collect
fails with a retryable error does not fail its waiters outright: each
member is retried individually (``engine.score_coalesced([req])``) with
exponential backoff + jitter, every attempt bounded by the request's
remaining deadline budget — a retry whose backoff would overrun the
deadline stops immediately and the future resolves with a typed
``RetryExhausted`` carrying the last error as ``__cause__``. Typed
refusals (``AdmissionError``, ``BatcherClosedError``) are never retried.

**Worker supervision** — the dispatch loop runs under a supervisor on
the worker thread: an escaped exception (e.g. an injected ``worker_loop``
fault) is a *worker crash*, not a hang.
The supervisor fails-or-retries every request the crashed loop was holding
(the group being formed), collects every in-flight group, and restarts the
dispatch loop on the same thread (``worker_crashes`` /
``worker_respawns`` count the events). An admitted future therefore
always resolves — with a result, a typed error, or a retry outcome —
and ``close()`` semantics are unchanged.

``close()`` drains: every admitted request still queued is scored (with
zero linger) and every in-flight group collected before the worker exits,
so no accepted future is ever abandoned. Anything left after a worker
death or join timeout is failed with ``BatcherClosedError``.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import random
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Sequence

from repro_torch.ft.recovery import RetryPolicy
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.engine import ServeRequest, ServeResult, ServingEngine
from repro_torch.serve.errors import (
    AdmissionError,
    BatcherClosedError,
    RetryExhausted,
    WorkerCrashedError,
)

SLO_BEST_EFFORT = "best_effort"
SLO_DEADLINE = "deadline"
_PRIO = {SLO_DEADLINE: 0, SLO_BEST_EFFORT: 1}


@dataclasses.dataclass(order=True)
class _Item:
    """Priority-queue entry: deadline class first, FIFO within a class."""
    prio: int
    seq: int
    req: ServeRequest | None = dataclasses.field(compare=False, default=None)
    fut: Future | None = dataclasses.field(compare=False, default=None)
    deadline_at: float | None = dataclasses.field(compare=False, default=None)
    submitted_at: float | None = dataclasses.field(compare=False,
                                                   default=None)
    degraded: bool = dataclasses.field(compare=False, default=False)


class CoalescingBatcher:
    def __init__(self, engine: ServingEngine, *, linger_ms: float = 2.0,
                 max_coalesce: int = 64, auto_start: bool = True,
                 deadline_linger_frac: float = 0.25,
                 continuous: bool = True, max_inflight: int = 2,
                 admission: bool = False,
                 shed_queue_depth: int | None = None,
                 degrade_queue_depth: int | None = None,
                 degrade_frac: float = 0.5,
                 deadline_headroom_ms: float = 0.0,
                 retries: int = 0,
                 retry_backoff_ms: float = 1.0,
                 retry_jitter: float = 0.5,
                 retry_seed: int = 0):
        if getattr(engine, "_multiproc", False):
            # same hazard class as hedging under SPMD: each process's
            # batcher thread would form groups from its own wall-clock
            # linger/scheduling, so dispatch sequences (and collective
            # schedules) diverge across workers and the fleet deadlocks.
            # Multi-process serving drives score_coalesced directly in
            # lockstep (repro_torch.dist.runner).
            raise ValueError(
                "CoalescingBatcher cannot wrap a multi-process sharded "
                "engine: group formation is timing-dependent and would "
                "desynchronize the SPMD collective schedule")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.engine = engine
        self.linger_ms = linger_ms
        self.max_coalesce = max_coalesce
        self.deadline_linger_frac = deadline_linger_frac
        self.continuous = continuous
        self.max_inflight = max_inflight
        self.admission = admission
        self.shed_queue_depth = shed_queue_depth
        self.degrade_queue_depth = degrade_queue_depth
        self.degrade_frac = degrade_frac
        self.deadline_headroom_ms = deadline_headroom_ms
        self.retries = retries
        self._retry_policy = RetryPolicy(retries=retries,
                                         backoff_ms=retry_backoff_ms,
                                         jitter=retry_jitter)
        self._retry_rng = random.Random(retry_seed)
        # the engine's fault injector (None in production): the batcher
        # owns exactly one site — worker_loop, poked at group formation —
        # so chaos schedules can kill the dispatch loop deterministically
        self._injector = getattr(engine, "fault_injector", None)
        self._q: queue.PriorityQueue = queue.PriorityQueue()
        self._seq = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()     # serializes submit vs close
        self._worker: threading.Thread | None = None
        # worker-loop state held at instance level so the crash supervisor
        # can see exactly what the dispatch loop was holding when it died
        self._inflight: deque = deque()   # (claimed items, handle), FIFO
        self._forming: list = []          # dequeued, not yet launched
        self._queued = 0              # admitted, not yet claimed by the worker
        self.batches = 0              # engine handoffs
        self.coalesced_requests = 0   # requests scored in a >1-request group
        self.requests = 0
        self.deadline_requests = 0    # submitted with the deadline SLO
        self.shed_requests = 0        # failed fast by admission control
        self.shed_best_effort = 0     # ... of the best_effort class
        self.shed_deadline = 0        # ... of the deadline class (infeasible)
        self.degraded_requests = 0    # admitted with a truncated pool
        self.retries_attempted = 0    # individual re-scores after a failure
        self.retries_exhausted = 0    # requests failed after all retries
        self.worker_crashes = 0       # dispatch-loop escapes caught
        self.worker_respawns = 0      # dispatch-loop restarts (same thread)
        # observability: the engine's tracer (``tracer`` below) and
        # metrics registry (a private one when the engine has none). Queue
        # wait and request latency are log-bucketed histograms:
        # Histogram.record is locked, so the worker's records and stats()
        # reads cannot race
        self.metrics = getattr(engine, "metrics", None) or MetricsRegistry()
        self.queue_wait = self.metrics.histogram("queue_wait_ms")
        self.request_latency = self.metrics.histogram("request_latency_ms")
        for name in ("requests", "batches", "coalesced_requests",
                     "deadline_requests", "shed_requests",
                     "shed_best_effort", "shed_deadline",
                     "degraded_requests", "retries_attempted",
                     "retries_exhausted", "worker_crashes",
                     "worker_respawns"):
            self.metrics.gauge(name, lambda n=name: getattr(self, n))
        # admitted requests not yet claimed by the worker
        self.metrics.gauge("queued", lambda: self._queued)
        if auto_start:
            self.start()

    @property
    def tracer(self):
        """The engine's tracer, read per event (None when tracing is off),
        so a tracer attached to the engine later traces the batcher too."""
        return getattr(self.engine, "tracer", None)

    @property
    def queue_wait_ms(self) -> float:
        """Cumulative submit->handoff wait — the queueing share of
        end-to-end latency that the engine's StageProfiler cannot see (the
        total of the ``queue_wait_ms`` histogram, which also carries the
        p50/p99 tail)."""
        return self.queue_wait.total

    @classmethod
    def from_plan(cls, engine: ServingEngine, batch, ft=None,
                  *, auto_start: bool = True) -> "CoalescingBatcher":
        """Build a batcher from a ``BatchPlan`` (the ``ServePlan`` spine's
        batch section) — the one wiring every entry point shares. The
        optional ``ft`` (the plan's ``FaultPlan`` section) carries the
        retry knobs; omitted, retries are off."""
        kw: dict = {}
        if ft is not None:
            kw = dict(retries=ft.retries,
                      retry_backoff_ms=ft.retry_backoff_ms,
                      retry_jitter=ft.retry_jitter,
                      retry_seed=ft.seed)
        return cls(engine, linger_ms=batch.linger_ms,
                   max_coalesce=batch.max_coalesce,
                   deadline_linger_frac=batch.deadline_linger_frac,
                   continuous=batch.continuous,
                   max_inflight=batch.max_inflight,
                   admission=batch.admission,
                   shed_queue_depth=batch.shed_queue_depth,
                   degrade_queue_depth=batch.degrade_queue_depth,
                   degrade_frac=batch.degrade_frac,
                   deadline_headroom_ms=batch.deadline_headroom_ms,
                   auto_start=auto_start, **kw)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._run, name="coalescing-batcher", daemon=True)
        self._worker.start()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker AFTER the queue drains: every admitted request
        is still scored (with zero linger) and every in-flight group
        collected. Only requests stranded by a dead or hung worker are
        failed — with ``BatcherClosedError``, so no waiter blocks
        forever."""
        with self._lock:              # no submit can interleave past here
            self._stop.set()
            self._q.put(_Item(prio=2, seq=self._next_seq()))  # wake worker
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            self._worker = None
        # backstop only: with a live worker the drain loop above has
        # emptied the queue before exiting
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if (item.fut is not None
                    and item.fut.set_running_or_notify_cancel()):
                item.fut.set_exception(
                    BatcherClosedError("batcher closed before this request "
                                       "was scored"))

    def __enter__(self) -> "CoalescingBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission ---------------------------------------------------------
    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _shed(self, fut: Future, slo: str, reason: str) -> Future:
        self.shed_requests += 1
        if slo == SLO_DEADLINE:
            self.shed_deadline += 1
        else:
            self.shed_best_effort += 1
        if self.tracer is not None:
            self.tracer.instant("admission_shed", slo=slo,
                                depth=self._queued, reason=reason)
        # claim-then-fail: the waiter sees the typed error immediately —
        # a shed future must never hang
        fut.set_running_or_notify_cancel()
        fut.set_exception(AdmissionError(
            f"request shed by admission control: {reason}",
            slo=slo, queue_depth=self._queued))
        return fut

    def _degrade(self, req: ServeRequest) -> ServeRequest | None:
        n = self._candidate_rows(req)
        keep = max(1, math.ceil(n * self.degrade_frac))
        if keep >= n:
            return None
        return dataclasses.replace(
            req, candidate_feeds={k: v[:keep]
                                  for k, v in req.candidate_feeds.items()})

    def submit(self, req: ServeRequest, *, slo: str = SLO_BEST_EFFORT,
               deadline_ms: float | None = None) -> "Future[ServeResult]":
        """Enqueue a request; resolves once its group has been scored.

        ``slo="deadline"`` marks it latency-critical: it jumps ahead of
        queued best-effort requests and shrinks its group's linger.
        ``deadline_ms`` (optional, implies the deadline class) additionally
        caps the linger by the remaining budget.

        With ``admission=True`` an overloaded queue sheds (typed
        ``AdmissionError``, failed fast) or degrades (truncated candidate
        pool) best-effort work per the class docstring; the returned
        future always resolves either way.
        """
        if deadline_ms is not None:
            slo = SLO_DEADLINE
        if slo not in _PRIO:
            raise ValueError(f"unknown SLO class {slo!r}")
        with self._lock:              # atomic vs the close() shutdown decision
            if (self._stop.is_set() or self._worker is None
                    or not self._worker.is_alive()):
                raise RuntimeError("batcher is not running (call start())")
            fut: Future = Future()
            self.requests += 1
            if slo == SLO_DEADLINE:
                self.deadline_requests += 1
            degraded = False
            if self.admission:
                if slo == SLO_DEADLINE:
                    # deadline work is never shed by depth — only when its
                    # own budget is already infeasible (a late answer is
                    # worth less than an immediate, typed refusal)
                    if (deadline_ms is not None
                            and deadline_ms < self.deadline_headroom_ms):
                        return self._shed(
                            fut, slo,
                            f"deadline budget {deadline_ms:g}ms is below "
                            f"the {self.deadline_headroom_ms:g}ms headroom "
                            f"floor")
                else:
                    if (self.shed_queue_depth is not None
                            and self._queued >= self.shed_queue_depth):
                        return self._shed(
                            fut, slo,
                            f"queue depth {self._queued} >= shed threshold "
                            f"{self.shed_queue_depth} (best_effort)")
                    if (self.degrade_queue_depth is not None
                            and self._queued >= self.degrade_queue_depth):
                        slim = self._degrade(req)
                        if slim is not None:
                            req = slim
                            degraded = True
                            self.degraded_requests += 1
                            if self.tracer is not None:
                                self.tracer.instant(
                                    "admission_degrade",
                                    depth=self._queued, user=req.user_id)
            now = time.perf_counter()
            deadline_at = (now + deadline_ms / 1e3
                           if deadline_ms is not None else None)
            self._queued += 1
            seq = self._next_seq()
            if self.tracer is not None and self.tracer.sampled(seq):
                # req=seq is the request's trace identity: queue_claim /
                # group_launch / resolve carry the same seq, and
                # group_launch links it to the engine's group id
                self.tracer.instant("submit", req=seq, slo=slo,
                                    user=req.user_id, degraded=degraded)
            self._q.put(_Item(prio=_PRIO[slo], seq=seq,
                              req=req, fut=fut, deadline_at=deadline_at,
                              submitted_at=now, degraded=degraded))
        return fut

    def score_many(self, reqs: Sequence[ServeRequest],
                   slo: str = SLO_BEST_EFFORT) -> list[ServeResult]:
        """Submit a burst of concurrent requests; wait for all results."""
        futs = [self.submit(r, slo=slo) for r in reqs]
        return [f.result() for f in futs]

    # -- worker -------------------------------------------------------------
    def _candidate_rows(self, req: ServeRequest) -> int:
        return next(iter(req.candidate_feeds.values())).shape[0]

    def _linger_until(self, item: _Item, now: float) -> float:
        """Group-close time implied by one member: full linger for
        best-effort, the shrunken deadline linger (further capped by the
        request's remaining budget) for deadline-class requests."""
        if item.prio == _PRIO[SLO_DEADLINE]:
            until = now + self.linger_ms * self.deadline_linger_frac / 1e3
            if item.deadline_at is not None:
                until = min(until, item.deadline_at)
            return until
        return now + self.linger_ms / 1e3

    def _run(self) -> None:
        """Worker-thread entry: a supervisor around the dispatch loop.

        An exception escaping ``_run_loop`` is a *worker crash*. The
        supervisor resolves everything the dead loop was holding — the
        group being formed is failed-or-retried with a typed
        ``WorkerCrashedError``, every in-flight group is collected — then
        restarts the dispatch loop on this same thread. No admitted
        future ever rides a dead loop.
        """
        stop_crashes = 0
        while True:
            try:
                self._run_loop()
                return                # clean exit: stop set, queue drained
            except BaseException as e:
                self.worker_crashes += 1
                if self.tracer is not None:
                    self.tracer.instant("worker_crash",
                                        error=type(e).__name__)
                self._on_worker_crash(e)
                if self._stop.is_set():
                    # crash-looping during drain: give up after a few
                    # restarts — close()'s backstop fails the remainder
                    # with a typed BatcherClosedError (typed, not hung)
                    stop_crashes += 1
                    if stop_crashes >= 3:
                        return
                self.worker_respawns += 1
                if self.tracer is not None:
                    self.tracer.instant("worker_respawn",
                                        respawns=self.worker_respawns)

    def _on_worker_crash(self, exc: BaseException) -> None:
        """Resolve everything the dead dispatch loop was holding."""
        forming, self._forming = self._forming, []
        if forming:
            err = WorkerCrashedError(
                f"batcher worker crashed during group formation: "
                f"{type(exc).__name__}: {exc}")
            err.__cause__ = exc
            self._fail_or_retry(forming, err)
        while self._inflight:
            self._collect_one(self._inflight)

    def _run_loop(self) -> None:
        """The dispatch loop.

        Continuous mode keeps up to ``max_inflight`` launched groups
        outstanding: with work queued, the next group is formed and
        launched (host-side packing into per-pack transfer buffers)
        while the previous group still executes on device — stage 2 never
        waits on the host. Groups are collected oldest-first: eagerly as
        soon as their results are ready (``_harvest``), or blocking when
        the queue momentarily empties / the in-flight budget is reached. Lockstep
        mode (``continuous=False``, or an engine without the two-phase
        API) scores each group to completion before the next.

        On ``close()`` the loop drains: remaining queued requests are
        scored with zero linger and all in-flight groups collected before
        the thread exits — an admitted future is never abandoned.
        """
        inflight = self._inflight     # (claimed items, engine handle), FIFO
        continuous = (self.continuous
                      and hasattr(self.engine, "begin_coalesced"))
        prof = getattr(self.engine, "profiler", None)
        while True:
            t_idle = None
            try:
                if inflight:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        # queue momentarily dry: harvest the oldest group
                        # (device time, not idle time)
                        self._collect_one(inflight)
                        continue
                else:
                    t_idle = time.perf_counter()
                    item = self._q.get(timeout=0.05)
            except queue.Empty:
                if prof is not None:
                    prof.add("queue_idle", time.perf_counter() - t_idle)
                trc = self.tracer
                if trc is not None:
                    trc.complete("batcher.wait", t_idle,
                                 time.perf_counter() - t_idle)
                if self._stop.is_set():
                    return
                continue
            if t_idle is not None and prof is not None:
                # partial wait before this arrival: nothing was in flight,
                # so the device sat idle for it
                idle = time.perf_counter() - t_idle
                if idle > 1e-4:
                    prof.add("queue_idle", idle)
            if t_idle is not None:
                trc = self.tracer
                if trc is not None:
                    trc.complete("batcher.wait", t_idle,
                                 time.perf_counter() - t_idle)
            if item.req is None:      # wake marker (close() or stale)
                continue
            group = self._form_group(item, inflight)
            try:
                self._launch_group(group, inflight, continuous, prof)
            finally:
                # launched (or resolved): the crash supervisor no longer
                # owns these items
                self._forming = []
            while len(inflight) >= self.max_inflight:
                self._collect_one(inflight)
            self._harvest(inflight)

    def _form_group(self, item: _Item, inflight: deque) -> list[_Item]:
        trc = self.tracer
        with self._lock:
            if trc is not None:
                depth = self._queued          # this item included
            self._queued -= 1
        if trc is not None:
            t0 = time.perf_counter()
        # crash-visible formation state: if the loop dies past this line,
        # the supervisor owns every item in the list and resolves it
        group = self._forming = [item]
        if self._injector is not None:
            self._injector.poke("worker_loop", req=item.seq)
        rows = self._candidate_rows(item.req)
        # draining after close(): no linger — ship everything, fast
        deadline = (time.perf_counter() if self._stop.is_set()
                    else self._linger_until(item, time.perf_counter()))
        while (len(group) < self.max_coalesce
               and rows < self.engine.max_batch):
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            if inflight:
                # linger in short slices so a previous group whose device
                # results finish MID-linger is harvested immediately — its
                # waiters must not sit out this group's window
                self._harvest(inflight)
                timeout = min(timeout, 5e-4)
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                continue
            if nxt.req is None:
                continue
            with self._lock:
                self._queued -= 1
            group.append(nxt)
            rows += self._candidate_rows(nxt.req)
            # a deadline request joining an open group truncates the
            # remaining linger to its own (shrunken) window
            deadline = min(deadline,
                           self._linger_until(nxt, time.perf_counter()))
        if trc is not None:
            trc.complete("batcher.linger", t0, time.perf_counter() - t0,
                         reqs=len(group), rows=rows, depth=depth,
                         dropped=trc.dropped)
        return group

    def _launch_group(self, group: list[_Item], inflight: deque,
                      continuous: bool, prof) -> None:
        # claim each future before doing work: a waiter that cancelled while
        # its request sat queued is dropped here, and a claimed (RUNNING)
        # future can no longer be cancelled — so set_result below cannot
        # race a cancel and kill the worker with InvalidStateError
        now = time.perf_counter()
        trc = self.tracer
        for it in group:
            if it.submitted_at is None:
                continue
            wait_ms = (now - it.submitted_at) * 1e3
            self.queue_wait.record(wait_ms)
            if trc is not None and trc.sampled(it.seq):
                trc.instant("queue_claim", req=it.seq,
                            wait_ms=round(wait_ms, 3))
        claimed = [it for it in group
                   if it.fut.set_running_or_notify_cancel()]
        if trc is not None:
            trc.complete("batcher.claim", now, time.perf_counter() - now,
                         reqs=len(claimed))
        if not claimed:
            return
        reqs = [it.req for it in claimed]
        if not continuous:
            if trc is not None:
                trc.instant("group_launch",
                            reqs=[it.seq for it in claimed])
            try:
                results = self.engine.score_coalesced(reqs)
            except BaseException as e:      # propagate to every waiter
                self._fail_or_retry(claimed, e)
                return
            self._resolve(claimed, results)
            return
        overlapped = bool(inflight)
        t0 = time.perf_counter()
        try:
            handle = self.engine.begin_coalesced(reqs)
        except BaseException as e:
            self._fail_or_retry(claimed, e)
            return
        if trc is not None:
            # request -> group linkage: each member seq joins the engine
            # group id the two-phase API assigned this launch
            trc.instant("group_launch", group=getattr(handle, "gid", None),
                        reqs=[it.seq for it in claimed],
                        overlapped=overlapped)
        if overlapped and prof is not None:
            # host work done UNDER a still-executing previous group — the
            # time the continuous loop hides beneath device compute
            prof.add("overlap", time.perf_counter() - t0)
        inflight.append((claimed, handle))

    def _harvest(self, inflight: deque) -> None:
        """Collect (oldest-first) every in-flight group whose device
        results are already materialized — non-blocking, via the engine's
        ``poll``. Keeps result latency flat at low load, where groups
        finish long before the in-flight budget forces a collect."""
        poll = getattr(self.engine, "poll", None)
        while inflight and poll is not None and poll(inflight[0][1]):
            self._collect_one(inflight)

    def _collect_one(self, inflight: deque) -> None:
        claimed, handle = inflight.popleft()
        try:
            results = self.engine.collect(handle)
        except BaseException as e:
            self._fail_or_retry(claimed, e)
            return
        self._resolve(claimed, results)

    # -- failure resolution and retry ---------------------------------------
    def _fail_or_retry(self, items: list[_Item],
                       exc: BaseException) -> None:
        """Resolve each item after a failure: typed refusals (and
        already-exhausted retries) fail the future immediately; anything
        else is re-scored per request when retries are configured. Every
        future resolves one way or the other — none hang."""
        retryable = (self.retries > 0
                     and not isinstance(exc, (AdmissionError,
                                              BatcherClosedError,
                                              RetryExhausted)))
        for it in items:
            if it.fut.done():
                continue
            if (not it.fut.running()
                    and not it.fut.set_running_or_notify_cancel()):
                continue          # cancelled while queued / forming
            if not retryable:
                it.fut.set_exception(exc)
                continue
            self._retry_one(it, exc)

    def _retry_one(self, it: _Item, first_exc: BaseException) -> None:
        """Re-score one request with exponential backoff + jitter, every
        attempt bounded by the request's remaining deadline budget — a
        backoff that would overrun the deadline stops the retry loop.
        Resolves the future with a result or a typed ``RetryExhausted``
        carrying the last error as ``__cause__``."""
        trc = self.tracer
        last = first_exc
        attempts = 0
        for attempt in range(self.retries):
            delay_s = self._retry_policy.backoff_s(attempt,
                                                   rng=self._retry_rng)
            if (it.deadline_at is not None
                    and it.deadline_at - time.perf_counter() <= delay_s):
                break             # remaining budget cannot cover the wait
            if delay_s > 0:
                time.sleep(delay_s)
            attempts += 1
            self.retries_attempted += 1
            if trc is not None:
                trc.instant("retry", req=it.seq, attempt=attempts,
                            error=type(last).__name__)
            try:
                res = self.engine.score_coalesced([it.req])[0]
            except (AdmissionError, BatcherClosedError) as e:
                last = e
                break             # typed refusal: retrying cannot help
            except BaseException as e:
                last = e
                continue
            if it.degraded:
                res.degraded = True
            if it.submitted_at is not None:
                self.request_latency.record(
                    (time.perf_counter() - it.submitted_at) * 1e3)
            if trc is not None and trc.sampled(it.seq):
                trc.instant("resolve", req=it.seq, retried=attempts)
            it.fut.set_result(res)
            return
        self.retries_exhausted += 1
        if trc is not None:
            trc.instant("retry_exhausted", req=it.seq, attempts=attempts,
                        error=type(last).__name__)
        err = RetryExhausted(
            f"request failed after {attempts} retry attempt(s): "
            f"{type(last).__name__}: {last}", attempts=attempts)
        err.__cause__ = last
        it.fut.set_exception(err)

    def _resolve(self, claimed: list[_Item], results) -> None:
        self.batches += 1
        if len(claimed) > 1:
            self.coalesced_requests += len(claimed)
        now = time.perf_counter()
        trc = self.tracer
        for it, res in zip(claimed, results):
            if it.degraded:
                res.degraded = True
            if it.submitted_at is not None:
                self.request_latency.record((now - it.submitted_at) * 1e3)
            if trc is not None and trc.sampled(it.seq):
                trc.instant("resolve", req=it.seq)
            it.fut.set_result(res)
        if trc is not None:
            # the waiters' done callbacks ran on this thread, inside it
            trc.complete("batcher.resolve", now, time.perf_counter() - now,
                         reqs=len(claimed))
