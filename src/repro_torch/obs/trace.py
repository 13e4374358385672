"""Bounded ring-buffer tracer for the serving hot path (a copy of
``repro.obs.trace``).

``StageProfiler`` answers "where does the mean microsecond go";
it cannot answer "what did THIS request wait on" or "were those two
stage-2 groups actually overlapped". ``Tracer`` records the missing
per-event timeline: span events (begin/end or complete, with wall-clock
timestamps and durations) and instant events, each stamped with the
recording thread's id and free-form args carrying the propagated
request/group context (``req=<submit seq>``, ``group=<engine group id>``).

Design constraints, in order:

* **bounded** — events land in a ring buffer of ``capacity`` entries;
  under sustained load the newest events win and ``dropped`` counts the
  overwritten ones. Tracing never grows without bound and never blocks
  the hot path on I/O (export is a separate, offline step —
  ``repro_torch.obs.export``).
* **thread-safe** — the batcher worker, direct ``score`` callers, and
  the exporting thread all touch one buffer; every mutation is taken
  under a single lock whose critical section is an append (the lock is
  a leaf: ``Tracer`` never calls out under it, so it can be used from
  inside other subsystems' locks without ordering hazards).
* **cheap** — one ``perf_counter`` + one locked append per event;
  callers keep the ``tracer is None`` fast path when tracing is off
  (``ObsPlan.trace`` defaults to False), and ``sample_every`` thins
  per-request events under load without losing group-level spans.

Timestamps are ``time.perf_counter()`` (monotonic, high-resolution)
plus a wall-clock epoch captured at construction, so exports from
different processes land on one comparable wall-clock timeline.

Event tuples are ``(ph, name, ts, dur, tid, track, args)``:

* ``ph`` — Chrome trace-event phase: ``"X"`` complete span, ``"B"`` /
  ``"E"`` begin/end pair (used for the synthetic per-group tracks,
  whose end is only known at ``collect``), ``"i"`` instant;
* ``ts`` / ``dur`` — perf_counter seconds (export converts to µs);
* ``tid`` — ``threading.get_native_id()`` of the recording thread: the
  operating system's id, which ``torch.profiler`` records beside each CUDA
  runtime call, so a span can be joined with the calls its thread made;
* ``track`` — None for "the recording thread's track", or a synthetic
  track name (e.g. ``"group:0"``) the exporter maps to its own timeline
  row so overlapping groups are visibly concurrent in Perfetto.

Two kinds of record keep the hot path's cost down and what describes the
process out of the ring; ``events()`` lists both as ``"X"`` spans:

* ``steps`` — consecutive spans of one call (a compiled stage's copy-in,
  replay and copy-out) held as one ring entry;
* ``pin`` — a standing event (a captured graph's kernel map), kept apart
  from the ring: never overwritten, never cleared, listed first.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterator

DEFAULT_CAPACITY = 65536

# The port's spans beside the reference's events, under dotted names that
# never equal one of those: each nests, on its thread, inside the span it
# splits — ``stage1.*`` inside ``stage1``, ``pack.*`` inside ``pack``,
# ``stage2.*`` inside ``dispatch``, ``collect.*`` inside ``collect``.
# Recorded on every traced engine call; besides these, on the card only,
# ``collect.wait`` (a pack's CUDA event) and each captured graph's kernel
# map (``stage1.graph`` / ``stage2.graph``), and ``stage1.lock`` /
# ``stage2.lock`` while another thread holds the graph pool's lock.
PORT_SPANS = ("stage1.copy_in", "stage1.replay", "stage1.copy_out",
              "stage1.sync", "pack.alloc", "pack.fill", "stage2.copy_in",
              "stage2.replay", "stage2.copy_out", "collect.unpack")
# the batcher thread's own work around the engine's spans
BATCHER_SPANS = ("batcher.wait", "batcher.linger", "batcher.claim",
                 "batcher.resolve")


class Tracer:
    """Lock-protected bounded ring buffer of trace events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 sample_every: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}")
        self.capacity = capacity
        self.sample_every = sample_every
        # wall/perf epoch pair: export aligns per-process perf_counter
        # timelines onto one wall clock (merged dist traces line up)
        self.epoch_wall = time.time()
        self.epoch_perf = time.perf_counter()
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._thread_names: dict[int, str] = {}
        self._pinned: dict[tuple, tuple] = {}
        self.recorded = 0        # total events ever pushed

    # -- recording -----------------------------------------------------------
    def _push(self, ph: str, name: str, ts: float, dur: float,
              track: str | None, args: dict | None) -> None:
        # the OS id the Thread object holds: get_native_id() is a system
        # call on every event
        tid = threading.current_thread().native_id
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            self._events.append((ph, name, ts, dur, tid, track, args))
            self.recorded += 1

    def instant(self, name: str, *, track: str | None = None,
                **args: Any) -> None:
        """Record a point-in-time event (cache hit, shed verdict, fork)."""
        self._push("i", name, time.perf_counter(), 0.0, track, args or None)

    def complete(self, name: str, t0: float, dur_s: float, *,
                 track: str | None = None, **args: Any) -> None:
        """Record a finished span with an explicit start + duration (both
        in perf_counter seconds) — for phases whose timing the caller
        already measured."""
        self._push("X", name, t0, dur_s, track, args or None)

    def steps(self, names: tuple, bounds: tuple, **args: Any) -> None:
        """Record consecutive spans as one ring entry: ``names[i]`` from
        ``bounds[i]`` to ``bounds[i + 1]`` (a None name leaves that
        interval out), each with ``args``. ``events()`` lists them as
        separate complete spans."""
        self._push("S", names, bounds[0], bounds, None, args or None)

    def pin(self, name: str, key: Any, **args: Any) -> None:
        """Record a standing event, kept apart from the ring: it is never
        overwritten or cleared, and ``events()`` lists it first, as a
        zero-length span at the time it was pinned. A second pin of the
        same ``(name, key)`` replaces the first."""
        ev = ("X", name, time.perf_counter(), 0.0,
              threading.current_thread().native_id, None, args or None)
        with self._lock:
            self._pinned[(name, key)] = ev

    @contextmanager
    def span(self, name: str, *, track: str | None = None,
             **args: Any) -> Iterator[None]:
        """Time a block as one complete span."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._push("X", name, t0, time.perf_counter() - t0, track,
                       args or None)

    def begin(self, name: str, *, track: str | None = None,
              **args: Any) -> None:
        """Open a span whose end is recorded separately (``end``) — the
        per-group tracks use this because a group's end is only known at
        ``collect``, possibly out of order with other groups."""
        self._push("B", name, time.perf_counter(), 0.0, track, args or None)

    def end(self, name: str, *, track: str | None = None,
            **args: Any) -> None:
        self._push("E", name, time.perf_counter(), 0.0, track, args or None)

    def sampled(self, seq: int) -> bool:
        """True when per-request events for submit seq ``seq`` should be
        recorded (``sample_every`` thinning; group spans are never
        thinned)."""
        return seq % self.sample_every == 0

    # -- inspection ----------------------------------------------------------
    def events(self) -> list[tuple]:
        """Snapshot the pinned events, then the buffer (oldest first), with
        each ``steps`` entry listed as its spans."""
        with self._lock:
            out = list(self._pinned.values())
            raw = list(self._events)
        for ev in raw:
            if ev[0] != "S":
                out.append(ev)
                continue
            _, names, _, b, tid, track, args = ev
            out.extend(("X", n, b[i], b[i + 1] - b[i], tid, track, args)
                       for i, n in enumerate(names) if n is not None)
        return out

    def thread_names(self) -> dict[int, str]:
        with self._lock:
            return dict(self._thread_names)

    @property
    def dropped(self) -> int:
        """Events overwritten by the ring bound (newest always win)."""
        with self._lock:
            return self.recorded - len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.recorded = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
