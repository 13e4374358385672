"""Straggler mitigation with real duplicate execution (tail-at-scale
hedging; port of ``repro.serve.hedging``).

Two layers:

* ``HedgePolicy`` — the *decision*: a rolling-quantile latency tracker whose
  ``hedge_deadline_ms`` says how long a chunk may run before a duplicate is
  worth launching (p99 of the recent window, floored at ``min_hedge_ms``).
* ``HedgedRunner`` — the *execution*: runs the chunk on a worker thread,
  waits out the policy deadline, and if the primary is still straggling
  launches a duplicate of the same computation; the **first completed
  result wins** and the loser is cancelled (best effort: a not-yet-started
  future is cancelled outright; an in-flight dispatch cannot be
  interrupted, so it is abandoned — its result is discarded and never
  blocks the caller).

In the port both executions run the engine's stage 2 on the engine's CUDA
stream (the worker enters ``torch.inference_mode`` and that stream itself:
both are per-thread state), so they compute the same scores. An abandoned
loser keeps its own references to the pack's tensors until its call
returns, so nothing it reads is freed under it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait


class HedgePolicy:
    """Rolling-quantile hedging decision (tail-at-scale).

    Thread-safe: ``observe`` runs on whichever thread finishes a chunk
    while ``hedge_deadline_ms`` reads the window from the dispatcher —
    the window is snapshotted under a lock, so the sort never sees a
    deque mutating beneath it.
    """

    def __init__(self, quantile: float = 0.99, window: int = 512,
                 min_hedge_ms: float = 5.0):
        self.q = quantile
        self.lat = deque(maxlen=window)
        self.min_hedge_ms = min_hedge_ms
        self._lock = threading.Lock()

    def observe(self, latency_ms: float) -> None:
        with self._lock:
            self.lat.append(latency_ms)

    def hedge_deadline_ms(self) -> float:
        with self._lock:
            xs = list(self.lat)
        if len(xs) < 16:
            return self.min_hedge_ms * 10
        xs.sort()
        idx = min(len(xs) - 1, int(self.q * len(xs)))
        return max(xs[idx], self.min_hedge_ms)

    def should_hedge(self, elapsed_ms: float) -> bool:
        return elapsed_ms >= self.hedge_deadline_ms()


@dataclasses.dataclass
class HedgeOutcome:
    hedged: bool                  # a duplicate was actually launched
    winner: str                   # "primary" | "hedge"
    latency_ms: float             # first-result latency seen by the caller
    deadline_ms: float            # policy deadline that gated the duplicate


class HedgedRunner:
    """Run ``fn(*args)`` with policy-gated duplicate execution.

    ``fn`` must be deterministic and safe to invoke concurrently with
    itself (the engine's blocking stage-2 dispatch qualifies). The runner owns a small thread
    pool with headroom beyond the 2 slots a single call needs: an abandoned
    loser keeps its worker busy until its dispatch finishes, and with only
    2 workers a burst of consecutive stragglers would queue every new
    primary/duplicate behind zombies — silently disabling hedging exactly
    when it matters.

    The headroom is still finite, so the runner tracks outstanding pool
    work explicitly: once every worker is held by a zombie, a new primary
    would be *queued behind abandoned stragglers* — strictly worse than
    not hedging. Instead the call runs inline on the caller thread
    (``pool_exhausted`` counts these), and a duplicate that cannot get a
    worker simply isn't launched — the primary is awaited as if the
    deadline had not expired.
    """

    def __init__(self, fn, policy: HedgePolicy | None = None,
                 max_workers: int = 8):
        self.fn = fn
        self.policy = policy or HedgePolicy()
        self.max_workers = max_workers
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="hedge")
        self._olock = threading.Lock()
        self._outstanding = 0         # submitted, not yet finished (zombies
        #                               included: a worker is busy until its
        #                               abandoned dispatch actually returns)
        self.hedges_launched = 0
        self.hedge_wins = 0
        self.pool_exhausted = 0       # calls denied a worker (inline / no-dup)

    def _submit(self, *args) -> Future | None:
        """Submit to the pool iff a worker slot is actually free —
        returns None when zombies hold every slot (the caller falls back
        rather than queue behind abandoned work)."""
        with self._olock:
            if self._outstanding >= self.max_workers:
                return None
            self._outstanding += 1
        fut = self._pool.submit(self.fn, *args)

        def _done(_f, self=self):
            with self._olock:
                self._outstanding -= 1

        fut.add_done_callback(_done)
        return fut

    def run(self, *args) -> tuple[object, HedgeOutcome]:
        deadline_ms = self.policy.hedge_deadline_ms()
        t0 = time.perf_counter()
        primary = self._submit(*args)
        if primary is None:
            # zombie-pool starvation: every worker is busy with abandoned
            # stragglers. Run inline — the caller thread does the work
            # NOW instead of queueing behind zombies of indefinite life.
            self.pool_exhausted += 1
            result = self.fn(*args)
            latency_ms = (time.perf_counter() - t0) * 1e3
            self.policy.observe(latency_ms)
            return result, HedgeOutcome(hedged=False, winner="primary",
                                        latency_ms=latency_ms,
                                        deadline_ms=deadline_ms)
        done, _ = wait({primary}, timeout=deadline_ms / 1e3,
                       return_when=FIRST_COMPLETED)
        if done:
            result, hedged, winner = primary.result(), False, "primary"
        else:
            # primary is straggling: duplicate the chunk, first result wins
            backup = self._submit(*args)
            if backup is None:
                # no free worker for the duplicate — hedging is pointless
                # (the duplicate would queue behind the very stragglers
                # it is meant to beat); await the primary instead
                self.pool_exhausted += 1
                result = primary.result()
                latency_ms = (time.perf_counter() - t0) * 1e3
                self.policy.observe(latency_ms)
                return result, HedgeOutcome(hedged=False, winner="primary",
                                            latency_ms=latency_ms,
                                            deadline_ms=deadline_ms)
            self.hedges_launched += 1
            done, not_done = wait({primary, backup},
                                  return_when=FIRST_COMPLETED)
            # both may have completed between the deadline and the wait;
            # prefer the primary then (identical results either way)
            first = primary if primary in done else backup
            winner = "primary" if first is primary else "hedge"
            if winner == "hedge":
                self.hedge_wins += 1
            for f in not_done:
                f.cancel()        # not-started duplicates die here; an
            result = first.result()  # in-flight loser is abandoned, not awaited
            hedged = True
        latency_ms = (time.perf_counter() - t0) * 1e3
        self.policy.observe(latency_ms)
        return result, HedgeOutcome(hedged=hedged, winner=winner,
                                    latency_ms=latency_ms,
                                    deadline_ms=deadline_ms)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
