"""The device trace of a sub-window: ``torch.profiler`` (CUPTI) events
moved onto the host's ``time.perf_counter`` clock, the device's busy
intervals, kernel time by name, and the device's idle gaps attributed to
what the host was doing.

The profiler's clock is tied to ``perf_counter`` by an anchor: a
``record_function`` range opened at a ``perf_counter`` reading right
after the profiler starts. Kernels, copies and sets all count as device
work; the busy time is the union of their intervals inside the
sub-window.
"""
from __future__ import annotations

import heapq
import time

ANCHOR = "portbench.anchor"


def kernel_name(name: str) -> str:
    """A device op's qualified name without its return type, template
    arguments, parameters or anonymous namespaces: ``void
    (anonymous namespace)::q_t_tc_kernel<2>(float const*, ...)`` ->
    ``q_t_tc_kernel``. Copies and sets keep their names."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    depth, out = 0, []
    for ch in name.replace("(anonymous namespace)::", ""):
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    words = "".join(out).split()
    return words[-1] if words else name


class SubWindow:
    """Start and stop a profiler inside a running window; ``ops`` are
    then ``(name, start, end)`` in ``perf_counter`` seconds."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self._anchor = None
        self.ops: list[tuple[str, float, float]] = []

    @staticmethod
    def warm() -> None:
        """Start and stop a profiler once, in set-up, so the first start
        inside the window does not pay CUPTI's initialisation."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        with record_function(ANCHOR):
            self._anchor = time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self, at: float | None = None) -> None:
        """Stop the profiler; the sub-window ends ``at`` (a
        ``perf_counter`` reading, by default now). Stopping takes a second
        or more under load, so a window stops it after its close."""
        self.t1 = time.perf_counter() if at is None else at
        self.prof.stop()

    def collect(self) -> None:
        """Read the events (after the window: this is the slow part)."""
        raw = _raw_events(self.prof)
        anchor = [s for n, s, _, dev in raw if n == ANCHOR and not dev]
        if not anchor:
            raise RuntimeError("profiler trace has no anchor range")
        shift = self._anchor - anchor[0]
        self.ops = sorted((kernel_name(n), s + shift, e + shift)
                          for n, s, e, dev in raw if dev and n != ANCHOR)
        self.prof = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def clipped(self):
        """Device ops inside the sub-window, clipped to it."""
        for n, s, e in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                yield n, s, e

    def busy(self) -> list[tuple[float, float]]:
        """The union of device-op intervals inside the sub-window."""
        out: list[list[float]] = []
        for _, s, e in sorted(self.clipped(), key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def by_name(self) -> dict[str, float]:
        """Device seconds per op name inside the sub-window."""
        out: dict[str, float] = {}
        for n, s, e in self.clipped():
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def time_of(self, patterns) -> float:
        """Device seconds of the ops whose name contains any pattern."""
        return sum(t for n, t in self.by_name().items()
                   if any(p in n for p in patterns))

    def gaps(self) -> list[tuple[float, float]]:
        """The device's idle intervals inside the sub-window."""
        out, t = [], self.t0
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out


def attribute_gaps(gaps, spans, default: str) -> dict[str, float]:
    """Idle seconds by what the host was doing: each instant of a gap
    goes to the shortest host span ``(name, start, end)`` covering it (the
    first listed among equals), and to ``default`` where none does.
    ``gaps`` are disjoint; one sweep over them in time order."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][1])
    out: dict[str, float] = {}
    live: list = []          # heap of (duration, index, end, name)
    j = 0
    for g0, g1 in sorted(gaps):
        t = g0
        while t < g1:
            while j < len(order) and spans[order[j]][1] <= t:
                name, s, e = spans[order[j]][:3]
                heapq.heappush(live, (e - s, order[j], e, name))
                j += 1
            while live and live[0][2] <= t:
                heapq.heappop(live)
            nxt = min(g1, spans[order[j]][1]) if j < len(order) else g1
            if live:
                nxt = min(nxt, live[0][2])
                name = live[0][3]
            else:
                name = default
            out[name] = out.get(name, 0.0) + (nxt - t)
            t = nxt
    return out


def _raw_events(prof) -> list[tuple[str, float, float, bool]]:
    """``(name, start s, end s, on the device)`` of every event the
    profiler recorded (its Kineto results, unparsed)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() * 1e-9
        dev = "CUDA" in str(ev.device_type())
        if dev and getattr(ev, "is_user_annotation", bool)():
            continue                # a range's shadow on the device
        out.append((ev.name(), s, s + ev.duration_ns() * 1e-9, dev))
    return out
