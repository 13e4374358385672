"""Log-bucketed histogram registry — tail percentiles without samples
(a copy of ``repro.obs.metrics``).

Totals cannot show that p99 queue wait is 40x p50 under a burst, which is
the number an SLO lives or dies on, and retaining raw samples does not
scale. ``Histogram`` keeps log-spaced bucket counts instead: values land
in geometric buckets ``base**k`` with ``base = 2**(1/4)`` (about 9%
relative resolution), and ``percentile(q)`` interpolates inside the
covering bucket — p50/p90/p99 in O(buckets) memory, any value range.

``MetricsRegistry`` puts the counters behind ONE ``snapshot()``:

* ``histogram(name)`` — get-or-create a named histogram (request
  latency, queue wait);
* ``gauge(name, fn)`` — register a zero-argument callable sampled at
  snapshot time;
* ``snapshot()`` — ``{name: histogram summary | gauge value}``.

Thread safety: ``record`` takes a per-histogram lock (a leaf lock, never
calling out), so the batcher worker and direct callers can record
concurrently; registry mutation takes the registry lock.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable

# quarter-octave buckets: boundaries 2**(k/4), ~19% wide (±9% error)
_LOG_BASE = 4.0
_PCTS = (50.0, 90.0, 99.0)


class Histogram:
    """Log-bucketed value distribution with percentile estimation."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._buckets: dict[int, int] = {}   # k -> count; value in
        #                                      (2**((k-1)/4), 2**(k/4)]
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    @staticmethod
    def _index(value: float) -> int:
        # non-positive values share one underflow bucket: latencies and
        # waits are >= 0, and a 0 observation carries no log-scale info
        if value <= 0.0:
            return -(10**9)
        return math.ceil(math.log2(value) * _LOG_BASE)

    @staticmethod
    def _upper(k: int) -> float:
        return 0.0 if k == -(10**9) else 2.0 ** (k / _LOG_BASE)

    def record(self, value: float) -> None:
        k = self._index(value)
        with self._lock:
            self._buckets[k] = self._buckets.get(k, 0) + 1
            self.count += 1
            self.total += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (0 < q <= 100): the upper edge of the
        covering bucket, linearly interpolated inside it, clamped to the
        exact observed min/max so single-bucket distributions stay
        honest."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q / 100.0 * self.count
            seen = 0
            for k in sorted(self._buckets):
                n = self._buckets[k]
                if seen + n >= target:
                    lo = max(self._upper(k - 1), self.min)
                    hi = min(self._upper(k), self.max)
                    if hi <= lo:
                        return min(max(self._upper(k), self.min), self.max)
                    frac = (target - seen) / n
                    return lo + (hi - lo) * frac
                seen += n
            return self.max

    def snapshot(self) -> dict[str, float]:
        pcts = {f"p{int(p)}": self.percentile(p) for p in _PCTS}
        with self._lock:
            return {
                "count": self.count,
                "total": self.total,
                "mean": (self.total / self.count) if self.count else 0.0,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                **pcts,
            }

    def reset(self) -> None:
        """Zero the distribution (one lock acquisition) — benches window
        a measurement by resetting after warmup."""
        with self._lock:
            self._buckets.clear()
            self.count = 0
            self.total = 0.0
            self.min = math.inf
            self.max = -math.inf


class MetricsRegistry:
    """Named histograms + lazily-sampled gauges behind one snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[str, Histogram] = {}
        self._gauges: dict[str, Callable[[], Any]] = {}

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
            return h

    def gauge(self, name: str, fn: Callable[[], Any]) -> None:
        """Register (or replace) a counter sampled at snapshot time."""
        with self._lock:
            self._gauges[name] = fn

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            hists = dict(self._hists)
            gauges = dict(self._gauges)
        out: dict[str, Any] = {n: h.snapshot() for n, h in hists.items()}
        for n, fn in gauges.items():
            try:
                out[n] = fn()
            except Exception:                    # a dead gauge must never
                out[n] = None                    # take stats() down
        return out
