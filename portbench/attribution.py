"""The layer beneath the program's spans: what the served path's new spans
read as per-layer metrics, and each device op of the profiled sub-window
named by the program span, executor node and host op that launched it.

Device ops are attributed without the profiler's correlation ids, which
the sub-window does not keep, from three facts: every op of the served
path runs on one stream, in the order its launches were made; each
compiled stage's call records its steps as spans (``<stage>.copy_in``,
``.replay``, ``.copy_out``, ``graph=`` the captured entry); and each entry's
kernel map (a ``<stage>.graph`` span, built in set-up from a profiled run
with correlation ids) lists the device ops each step launches, a replay's
with the node and host op behind each kernel. Walking the steps in host
order, each step takes the next ops in device order whose names are its
list, skipping at most ``SKIP`` ops launched by others (the unpack's
copies) or by a step that took none.

Order, not time, does the matching: the device trace's clock is off the
host's by up to milliseconds at the sub-window's start (its anchor is read
on a thread that can lose the GIL between the range and the clock), and
drifts from it by thousands of parts per million under load. Time only
picks where the walk starts: of the places within ``ANCHOR_S`` of the first
step where its list begins, the one from which the first
``ANCHOR_STEPS`` steps match the most, with the fewest ops skipped.

The lag of each matched step (its first op's start less the step's start),
through a running lower envelope (the 10th percentile of the last
``ENVELOPE``), is the two clocks' offset there plus the launch latency: it
is reported at the sub-window's start and end, and taken off each op to put
the device on the host's clock, to within that latency. On that clock an
op no step takes goes to the shortest host span covering the latest instant
it can have been launched at (its start, or the next matched step's start
if earlier), and the idle gaps are attributed to host spans again. Ops no
span covers, steps whose list is not found, replays whose kernels the map
could not match to the eager run: each is counted, none is guessed.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import sys
from collections import deque

import numpy as np

from portbench import devtrace, readers

STEPS = ("copy_in", "replay", "copy_out")
SKIP = 64               # ops a step's list may start past the last match
ANCHOR_S = 0.02         # how far from the first step the walk may start
ANCHOR_STEPS = 128      # steps that score a start
ANCHOR_FIRST = 8        # the steps a walk may start at
ENVELOPE = 64           # matched steps the lag envelope runs over
NO_SPAN = "no host span"


def span_mean_ms(run, name: str) -> float | None:
    """Mean host ms of the spans ``name`` that start in the window."""
    d = [e - s for n, s, e, _ in run.spans
         if n == name and run.t0 <= s < run.t1]
    return 1e3 * sum(d) / len(d) if d else None


def queue_depth(run) -> float | None:
    """Median of the batcher's queue depth when each group of the window
    opened (``batcher.linger``'s ``depth``)."""
    d = [a["depth"] for n, s, _, a in run.spans
         if n == "batcher.linger" and run.t0 <= s < run.t1 and "depth" in a]
    return float(np.median(d)) if d else None


def _union(iv) -> list[list[float]]:
    out: list[list[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Seconds where two sorted disjoint interval lists overlap."""
    i = j = 0
    t = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            t += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return t


def batcher_self_ms(run) -> float | None:
    """The batcher thread's own ms per group in the window: the union of
    its ``batcher.*`` spans less the engine's spans inside them, over the
    groups it launched (``batcher.claim``)."""
    t0, t1 = run.t0, run.t1
    groups = sum(1 for n, s, _, _ in run.spans
                 if n == "batcher.claim" and t0 <= s < t1)
    if not groups:
        return None
    own, eng = [], []
    for n, s, e, _ in run.spans:
        s, e = max(s, t0), min(e, t1)
        if e > s:
            (own if n.startswith("batcher.") else eng).append((s, e))
    own = _union(own)
    mine = sum(e - s for s, e in own) - _overlap(own, _union(eng))
    return 1e3 * mine / groups


def dropped(run) -> int | None:
    """The tracer's overwritten events, as the last group of the run saw
    them (``batcher.linger``'s ``dropped``)."""
    d = [a["dropped"] for n, _, _, a in run.spans
         if n == "batcher.linger" and "dropped" in a]
    return max(d) if d else None


@dataclasses.dataclass
class Attribution:
    """Device seconds of the sub-window, clipped to it, by what launched
    them."""
    busy_s: float = 0.0             # every op's seconds
    by_map_s: float = 0.0           # ops a step's kernel map took
    by_time_s: float = 0.0          # ops given to a covering span
    replay_s: float = 0.0           # the stage-2 replays' kernels
    replay_node_s: float = 0.0      # ... matched to a node and host op
    tail_s: float = 0.0             # the attention node's tail kernels
    replays: int = 0                # stage-2 replays whose kernels started
    #                                 in the sub-window
    unmatched_steps: int = 0        # steps whose list was not found
    lag_first_s: float = 0.0        # the lag envelope after the first
    #                                 ``ENVELOPE`` matches (the clocks'
    #                                 offset plus the launch latency)
    lag_last_s: float = 0.0         # ... and at the last
    idle_gaps: dict = dataclasses.field(default_factory=dict)
    #                                 idle seconds by host span, on the
    #                                 corrected clock
    by_key: dict = dataclasses.field(default_factory=dict)
    by_kernel: dict = dataclasses.field(default_factory=dict)


def _maps(spans) -> dict:
    """Kernel maps by (stage, entry): per step, ``(node op, node, host op,
    name)`` of each device op, the names as the device trace gives them
    (a copy step's ops have no node: ``""``)."""
    out = {}
    k = devtrace.kernel_name
    for n, _, _, a in spans:
        stage, _, step = n.rpartition(".")
        if step == "graph" and "replay" in a:
            out[(stage, a["graph"])] = {
                "copy_in": [("", "", "", k(x)) for x in a["copy_in"]],
                "replay": [(no, nd, op, k(x))
                           for no, nd, op, x in a["replay"]],
                "copy_out": [("", "", "", k(x)) for x in a["copy_out"]]}
    return out


def _find(ops, p: int, names: list) -> int | None:
    """The first ``q`` in ``[p, p + SKIP]`` where ``ops[q:]`` begins with
    ``names``."""
    first, n = names[0], len(names)
    for q in range(p, min(len(ops) - n, p + SKIP) + 1):
        if ops[q][0] == first and all(ops[q + i][0] == names[i]
                                      for i in range(1, n)):
            return q
    return None


def _walk(ops, lists, p: int, first: int = 0,
          count: int | None = None) -> list:
    """``(step, q)`` of each step of ``lists`` (names per step, in host
    order; ``count`` of them from step ``first``) that takes ops from
    ``q`` on, walking from op ``p``."""
    out = []
    end = len(lists) if count is None else min(len(lists), first + count)
    for i in range(first, end):
        names = lists[i]
        if not names:
            continue
        q = _find(ops, p, names)
        if q is not None:
            out.append((i, q))
            p = q + len(names)
    return out


def _start(ops, lists, times) -> tuple[int, int]:
    """Where the walk starts, ``(step, op)``: of the ops within
    ``ANCHOR_S`` of one of the first ``ANCHOR_FIRST`` steps that begin its
    list, the one whose walk over the next ``ANCHOR_STEPS`` steps leaves
    the fewest steps unmatched (a step before it counts) and ops skipped,
    together. The first steps' ops can be missing from the trace, which
    starts while they run; a walk from such a step takes a later call's
    ops, which look alike, and skips ops wherever the calls differ."""
    best, start = None, (0, 0)
    firsts = [k for k, names in enumerate(lists[:ANCHOR_FIRST]) if names]
    for i in firsts:
        name, t = lists[i][0], times[i]
        lo = bisect.bisect_left(ops, t - ANCHOR_S, key=lambda o: o[1])
        hi = bisect.bisect_right(ops, t + ANCHOR_S, key=lambda o: o[1])
        for q in range(lo, hi):
            if ops[q][0] != name:
                continue
            walk = _walk(ops, lists, q, i, ANCHOR_STEPS)
            used = sum(len(lists[k]) for k, _ in walk)
            skipped = walk[-1][1] + len(lists[walk[-1][0]]) - q - used
            unmatched = (sum(1 for x in lists[i:i + ANCHOR_STEPS] if x)
                         - len(walk) + sum(1 for k in firsts if k < i))
            score = -(unmatched + skipped)
            if best is None or score > best:
                best, start = score, (i, q)
    return start


def _covering(points, spans) -> list[str | None]:
    """The shortest span ``(name, start, end)`` covering each of the
    sorted ``points``, or None."""
    order = sorted(spans, key=lambda x: x[1])
    live: list = []                 # heap of (duration, index, end, name)
    out, j = [], 0
    for t in points:
        while j < len(order) and order[j][1] <= t:
            n, s, e = order[j]
            heapq.heappush(live, (e - s, j, e, n))
            j += 1
        while live and live[0][2] < t:
            heapq.heappop(live)
        out.append(live[0][3] if live else None)
    return out


def attribute(run) -> Attribution | None:
    """Every device op of the sub-window by (span, node, host op); None
    where the trace holds no kernel map (a program that records none).
    Computed once a run."""
    if "_attribution" not in run.__dict__:
        sub = run.sub
        maps = _maps(run.spans) if sub is not None and sub.ops else {}
        run.__dict__["_attribution"] = (_attribute(run, sub, maps)
                                        if maps else None)
    return run.__dict__["_attribution"]


def _attribute(run, sub, maps) -> Attribution:
    res = Attribution()
    ops = sorted(sub.ops, key=lambda o: o[1])
    steps = []
    for n, s, _, a in run.spans:
        stage, _, step = n.rpartition(".")
        if step in STEPS and sub.t0 <= s < sub.t1 \
                and (stage, a.get("graph")) in maps:
            steps.append((s, n, step == "replay" and stage == "stage2",
                          maps[(stage, a["graph"])][step]))
    steps.sort(key=lambda x: x[0])
    took: list = [None] * len(ops)  # (span, node op, node, host op, by map)
    loose: list[tuple[int, float]] = []     # (op no step took, next step)
    started: list[float] = []       # matched stage-2 replays
    lags: deque = deque(maxlen=ENVELOPE)
    at, envs = [], []               # ops' device start at each match, and
    #                                 the lag envelope there
    lists = [[k for *_, k in want] for _, _, _, want in steps]
    first, p = _start(ops, lists, [x[0] for x in steps]) if steps \
        else (0, 0)
    loose.extend((i, steps[first][0]) for i in range(p))
    for k, q in _walk(ops, lists, p, first):
        s, n, stage2_replay, want = steps[k]
        lags.append(ops[q][1] - s)
        at.append(ops[q][1])
        envs.append(sorted(lags)[len(lags) // 10])
        loose.extend((i, s) for i in range(p, q))
        for i, (no, nd, op, _) in enumerate(want):
            took[q + i] = (n, no, nd, op, True)
        if stage2_replay:
            started.append(ops[q][1])
        p = q + len(want)
    res.unmatched_steps = sum(1 for x in lists if x) - len(at)
    loose.extend((i, float("inf")) for i in range(p, len(ops)))
    # the device on the host's clock: each op less the lag envelope there
    if envs:
        res.lag_first_s = envs[min(ENVELOPE, len(envs)) - 1]
        res.lag_last_s = envs[-1]
        drift = np.interp([o[1] for o in ops], at, envs)
    else:
        drift = np.zeros(len(ops))
    loose = sorted(((i, min(ops[i][1] - drift[i], b)) for i, b in loose),
                   key=lambda x: x[1])
    host = [(n, s, e) for n, s, e, _ in run.spans]
    names = _covering([t for _, t in loose], host)
    for (i, _), name in zip(loose, names):
        if name is not None:
            took[i] = (name, "", "", "", False)
    fixed = devtrace.SubWindow()
    fixed.t0, fixed.t1 = sub.t0, sub.t1
    fixed.ops = [(k, s - d, e - d) for (k, s, e), d in zip(ops, drift)]
    res.idle_gaps = devtrace.attribute_gaps(fixed.gaps(), host, NO_SPAN)
    res.replays = sum(1 for t in started if sub.t0 <= t < sub.t1)
    fam = tuple(pat for pats in readers.FAMILIES.values() for pat in pats)
    for (k, s, e), t in zip(ops, took):
        s, e = max(s, sub.t0), min(e, sub.t1)
        if e <= s:
            continue
        d = e - s
        res.busy_s += d
        if t is None:
            key = (NO_SPAN, "-", "-")
        else:
            span, node_op, node, op, by_map = t
            if by_map:
                res.by_map_s += d
            else:
                res.by_time_s += d
            if node_op is None:             # the map could not name it
                key = (span, "?", "?")
            else:
                key = (span, node or "-", op or "-")
            if span == "stage2.replay":
                res.replay_s += d
                if node_op:
                    res.replay_node_s += d
                    if node_op == "target_attention" and not any(
                            pat in k for pat in fam):
                        res.tail_s += d
        res.by_key[key] = res.by_key.get(key, 0.0) + d
        res.by_kernel[key + (k,)] = res.by_kernel.get(key + (k,), 0.0) + d
    return res


def attention_tail_ms(run) -> float | None:
    """Device ms per stage-2 call of the kernels the target-attention node
    launches outside the ``gather_einsum`` and ``mari_matmul`` families;
    prints the attribution's report first."""
    res = attribute(run)
    report(run, res)
    if res is None or not res.replays:
        return None
    return 1e3 * res.tail_s / res.replays


def report(run, res: Attribution | None, top: int = 15, out=None) -> None:
    """The sub-window's device time by (span, node, host op), its shares,
    and the tracer's dropped events, on standard error."""
    out = sys.stderr if out is None else out
    print(f"attribution tracer.dropped {dropped(run)!r}", file=out)
    if res is None:
        print("attribution none: the trace holds no kernel map", file=out)
        return
    b = res.busy_s or 1.0
    print(f"attribution busy_s {res.busy_s:.6f} to_span "
          f"{100 * (res.by_map_s + res.by_time_s) / b:.2f}% (by_map "
          f"{100 * res.by_map_s / b:.2f}%, by_time "
          f"{100 * res.by_time_s / b:.2f}%) unattributed "
          f"{100 * (1 - (res.by_map_s + res.by_time_s) / b):.2f}% "
          f"stage2_replay_s {res.replay_s:.6f} to_node_and_op "
          f"{100 * res.replay_node_s / (res.replay_s or 1.0):.2f}% "
          f"replays {res.replays} unmatched_steps {res.unmatched_steps} "
          f"lag_envelope_us {1e6 * res.lag_first_s:.1f} -> "
          f"{1e6 * res.lag_last_s:.1f}", file=out)
    rows = sorted(res.idle_gaps.items(), key=lambda x: -x[1])[:top]
    for span, t in rows:
        print(f"attribution idle_gap {span} {t:.6f}", file=out)
    rows = sorted(res.by_key.items(), key=lambda x: -x[1])[:top]
    for (span, node, op), t in rows:
        print(f"attribution span_node_op {span} {node} {op} {t:.6f}",
              file=out)
    rows = sorted(res.by_kernel.items(), key=lambda x: -x[1])[:top]
    for (span, node, op, k), t in rows:
        print(f"attribution kernel {k} {span} {node} {op} {t:.6f}",
              file=out)
