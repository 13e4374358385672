"""Chrome trace-event JSON export — open the serving timeline in Perfetto
(a copy of ``repro.obs.export``).

Serializes one or more ``Tracer`` buffers to the Chrome trace-event
format (https://ui.perfetto.dev loads it directly, as does
``chrome://tracing``):

* one track (``tid``) per REAL thread that recorded events — the
  batcher worker, direct callers, the dist worker's main thread;
* one SYNTHETIC track per outstanding stage-2 group (``track="group:k"``
  events from the engine's two-phase API), so two overlapped groups
  render as two concurrent slices instead of an un-renderable nested
  mess on the worker's track — the continuous batcher's overlap (and
  any future transfer race) becomes *visible*;
* ``pid`` per tracer (scenario, or dist shard index after
  ``merge_trace_files``), with ``process_name`` / ``thread_name``
  metadata events naming every timeline row.

Timestamps: tracers record ``perf_counter`` seconds plus a wall-clock
epoch; export emits wall-aligned microseconds relative to the earliest
event (``baseWallUs`` keeps the absolute base), so per-worker files
merged across processes land on one comparable timeline.
"""
from __future__ import annotations

import json
from typing import Any, Mapping, Sequence

from repro_torch.obs.trace import Tracer

_CAT = "serve"
# synthetic tracks start far above the compacted real-thread tids so the
# two id spaces can never collide
_SYNTH_TID_BASE = 1000


def _json_safe(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, Mapping):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return str(v)


def chrome_events(tracer: Tracer, *, pid: int = 0,
                  process_name: str = "serve") -> tuple[list[dict], float]:
    """Convert one tracer's buffer to Chrome trace events.

    Returns ``(events, base_wall_us)`` — timestamps are µs relative to
    the tracer's earliest event; ``base_wall_us`` is that event's
    absolute wall-clock µs (merge realigns with it).
    """
    raw = tracer.events()
    thread_names = tracer.thread_names()
    base_perf = min((ts for _, _, ts, _, _, _, _ in raw),
                    default=tracer.epoch_perf)
    base_wall_us = (tracer.epoch_wall
                    + (base_perf - tracer.epoch_perf)) * 1e6

    # compact real thread ids (sorted for determinism) + synthetic tracks
    real_tids = sorted({tid for _, _, _, _, tid, track, _ in raw
                        if track is None} | set(thread_names))
    tid_of = {t: i + 1 for i, t in enumerate(real_tids)}
    tracks = sorted({track for _, _, _, _, _, track, _ in raw
                     if track is not None})
    track_tid = {t: _SYNTH_TID_BASE + i for i, t in enumerate(tracks)}

    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "cat": "__metadata", "args": {"name": process_name},
    }]
    for t in real_tids:
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": tid_of[t], "cat": "__metadata",
            "args": {"name": thread_names.get(t, f"thread-{t}")},
        })
    for t in tracks:
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": track_tid[t], "cat": "__metadata",
            "args": {"name": t},
        })

    for ph, name, ts, dur, tid, track, args in raw:
        ev: dict[str, Any] = {
            "name": name, "cat": _CAT, "ph": ph,
            "ts": (ts - base_perf) * 1e6, "pid": pid,
            "tid": track_tid[track] if track is not None else tid_of[tid],
        }
        if ph == "X":
            ev["dur"] = dur * 1e6
        if ph == "i":
            ev["s"] = "t"                 # thread-scoped instant
        if args:
            ev["args"] = _json_safe(args)
        events.append(ev)
    return events, base_wall_us


def trace_payload(tracers: Tracer | Mapping[str, Tracer],
                  ) -> dict:
    """Build the Perfetto-loadable payload for one or more tracers
    (``{name: tracer}`` gets one pid per name; a bare tracer gets
    pid 0)."""
    if isinstance(tracers, Tracer):
        tracers = {"serve": tracers}
    per = [chrome_events(t, pid=i, process_name=name)
           for i, (name, t) in enumerate(tracers.items())]
    if not per:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "baseWallUs": 0.0}
    base = min(b for _, b in per)
    events: list[dict] = []
    for evs, b in per:
        shift = b - base
        for ev in evs:
            if ev["ph"] != "M":
                ev = dict(ev, ts=ev["ts"] + shift)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "baseWallUs": base}


def write_trace(path: str,
                tracers: Tracer | Mapping[str, Tracer]) -> dict:
    """Serialize ``tracers`` to ``path``; returns the payload."""
    payload = trace_payload(tracers)
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload


def merge_trace_files(paths: Sequence[str], out_path: str,
                      names: Sequence[str] | None = None) -> dict:
    """Merge per-worker trace files into one timeline: file i's events
    are reassigned ``pid=i`` (the dist runner passes shard order, so
    pid == shard index) and shifted onto the earliest file's wall-clock
    base, so cross-process overlap reads directly off the merged view."""
    payloads = []
    for p in paths:
        with open(p) as f:
            payloads.append(json.load(f))
    bases = [p.get("baseWallUs", 0.0) for p in payloads]
    base = min(bases, default=0.0)
    events: list[dict] = []
    for i, (payload, b) in enumerate(zip(payloads, bases)):
        shift = b - base
        name = names[i] if names is not None else f"shard-{i}"
        for ev in payload.get("traceEvents", []):
            ev = dict(ev, pid=i)
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    ev["args"] = {"name": name}
            else:
                ev["ts"] = ev.get("ts", 0.0) + shift
            events.append(ev)
    merged = {"traceEvents": events, "displayTimeUnit": "ms",
              "baseWallUs": base}
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return merged
