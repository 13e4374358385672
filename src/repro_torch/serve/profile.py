"""Stage-boundary timing for the serving hot path (port of
``repro.serve.profile``, with the phases this engine records).

* ``stage1``   — user-tower compute on cache miss (waits for the device);
* ``cold_read`` — with the cold tier armed, a hot miss's arena lookup and,
  on a cold hit, the copy of its rows onto the card (once per such miss);
* ``demote``   — one hot-LRU eviction copied from the card into the cold
  arena (fired on whichever thread evicted);
* ``pack``     — host-side bucket assembly: pinned transfer-buffer fills,
  rep-table stacking, the host->device copies being enqueued (one entry
  per pack);
* ``slots``    — device-tier slot resolution, once per call on an engine
  with the device-resident tier: the row writes of new users enqueued
  before any launch (absent without the tier);
* ``dispatch`` — enqueueing stage 2 on the device stream (host time only:
  eager PyTorch returns before the device finishes);
* ``device``   — waiting on stage-2 results (the pack's CUDA event);
* ``unpack``   — copying scores to the host and slicing per-request views;
* ``queue_idle`` — continuous batcher loop time with nothing in flight
  and the request queue empty (the device starved for work);
* ``overlap``  — host time spent forming-and-launching group k+1 while
  group k was still in flight (work the continuous loop hides under
  device compute).

Phases are cumulative wall-clock totals plus call counts. Totals are
mutated under a lock: concurrent callers may profile against one engine.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator

PHASES = ("stage1", "cold_read", "demote", "pack", "slots", "dispatch",
          "device", "unpack", "queue_idle", "overlap")


class StageProfiler:
    """Cumulative per-phase wall-clock accounting for the serve hot path."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._total_s: dict[str, float] = dict.fromkeys(PHASES, 0.0)
        self._calls: dict[str, int] = dict.fromkeys(PHASES, 0)

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Time one phase occurrence (``with prof.phase("pack"): ...``)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        if name not in self._total_s:
            raise KeyError(f"unknown profile phase {name!r}; "
                           f"expected one of {PHASES}")
        with self._lock:
            self._total_s[name] += seconds
            self._calls[name] += 1

    def snapshot(self, reset: bool = False) -> dict[str, dict[str, float]]:
        """Per-phase ``{total_ms, calls, mean_us}``; ``reset=True`` zeroes
        the totals under the same lock acquisition."""
        with self._lock:
            out = {}
            for p in PHASES:
                calls = self._calls[p]
                total = self._total_s[p]
                out[p] = {
                    "total_ms": total * 1e3,
                    "calls": calls,
                    "mean_us": (total / calls * 1e6) if calls else 0.0,
                }
            if reset:
                for p in PHASES:
                    self._total_s[p] = 0.0
                    self._calls[p] = 0
            return out
