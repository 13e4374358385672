"""``PromotionWorker`` — async, frequency-gated cold -> hot promotion (a copy
of ``repro.mem.promote``).

A cold hit serves the request from the arena read alone; whether the user
DESERVES a hot (and hence device-tier) slot is decided off the request
path by this worker. The policy is Zipf-friendly: promotion requires
``touches`` cold hits within a ``window_s`` sliding window, so a one-shot
tail user — the overwhelming majority of a Zipf stream — never enters the
hot LRU, never evicts a genuinely-hot user, and never costs a device-table
row write. A user crossing the threshold is promoted by re-reading its
arena row, turning it into the hot cache's form with ``to_hot`` (the
engine passes a copy onto the card: the hot cache, the device tier's row
writes and the re-stacking ``torch.cat`` all take device tensors) and
``put``-ting it into the hot cache: the NEXT request finds it there, all
without a single stage-1 recompute.

The worker never touches the device tier directly — device residency
always follows the engine's normal resolve path one request later.

Threading: one daemon thread drains a queue of touch events. ``touch`` is
non-blocking (queue put). The worker calls ``cold.peek`` (arena leaf
lock) and ``cache.put`` (cache lock; its removal listeners fire OUTSIDE
that lock and may demote back into the arena) — the lock order
worker -> cache -> (released) -> arena is acyclic. ``flush()`` blocks
until every touch enqueued so far has been processed — what makes
promotion deterministic in tests and benchmarks.

Promotion is best-effort, as in the reference: a failure never reaches the
serving path and never kills the worker. Unlike the reference, which
swallows it silently, the port counts each failure in ``errors`` (with
the last message in ``last_error``), so a run can tell a promotion that
failed from one that was never due.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Hashable, Mapping

Key = tuple[Hashable, Hashable]          # (user_id, feature_version)

_PRUNE_EVERY = 1024      # touches between sweeps of stale touch histories


class PromotionWorker:
    """Background promotion policy over a (cold store, hot cache) pair."""

    def __init__(self, cold, cache, *, touches: int = 2,
                 window_s: float = 60.0, tracer=None,
                 clock=time.monotonic,
                 to_hot: Callable[[Mapping[str, Any]], Mapping[str, Any]]
                 | None = None):
        if touches < 1:
            raise ValueError(f"touches must be >= 1, got {touches}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.cold = cold
        self.cache = cache
        self.touches = touches
        self.window_s = window_s
        self._tracer = tracer
        self._clock = clock
        self._to_hot = to_hot
        self._q: queue.Queue = queue.Queue()
        # key -> deque of touch timestamps inside the window
        self._history: dict[Key, deque] = {}
        self._since_prune = 0
        self.touches_seen = 0
        self.promotions = 0
        self.errors = 0                  # failed promotions (best-effort)
        self.last_error: str | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._run,
                                        name="mem-promoter", daemon=True)
        self._thread.start()

    def set_tracer(self, tracer) -> None:
        """Attach a ``Tracer`` for the ``promote`` instants (or None)."""
        self._tracer = tracer

    # -- request-path API ----------------------------------------------------
    def touch(self, key: Key) -> None:
        """Record one cold hit for ``key`` (non-blocking)."""
        if not self._closed:
            self._q.put(key)

    def flush(self, timeout: float | None = 10.0) -> None:
        """Block until every touch enqueued so far is processed."""
        if timeout is None:
            self._q.join()
            return
        done = threading.Event()
        # ride the queue: a sentinel task enqueued now is processed only
        # after everything ahead of it
        self._q.put(done)
        done.wait(timeout)

    def stop(self) -> None:
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=10.0)

    # -- worker loop ---------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if isinstance(item, threading.Event):
                    item.set()
                    continue
                self._process(item)
            except Exception as e:
                # promotion is best-effort: a failed put (e.g. a closing
                # cache) must not kill the worker or the serving path —
                # but it is counted, never hidden
                self.errors += 1
                self.last_error = f"{type(e).__name__}: {e}"
            finally:
                self._q.task_done()

    def _process(self, key: Key) -> None:
        self.touches_seen += 1
        now = self._clock()
        hist = self._history.setdefault(key, deque())
        hist.append(now)
        while hist and now - hist[0] > self.window_s:
            hist.popleft()
        self._since_prune += 1
        if self._since_prune >= _PRUNE_EVERY:
            self._since_prune = 0
            stale = [k for k, h in self._history.items()
                     if not h or now - h[-1] > self.window_s]
            for k in stale:
                self._history.pop(k, None)
        if len(hist) < self.touches:
            return
        self._history.pop(key, None)
        if key in self.cache:
            return                      # already promoted by another path
        reps = self.cold.peek(key)
        if reps is None:
            return                      # demoted/evicted/invalidated since
        if self._to_hot is not None:
            reps = self._to_hot(reps)
        self.cache.put(key, reps)
        self.promotions += 1
        if self._tracer is not None:
            self._tracer.instant("promote", user=key[0],
                                 touches=self.touches)

    def stats(self) -> dict:
        return {
            "touches_seen": self.touches_seen,
            "promotions": self.promotions,
            "pending": self._q.qsize(),
            "tracked_keys": len(self._history),
            "touches": self.touches,
            "window_s": self.window_s,
            "errors": self.errors,
            "last_error": self.last_error,
        }
