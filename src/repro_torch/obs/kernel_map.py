"""Kernel maps: which executor node and host op launched each kernel of a
captured graph.

A replayed graph shows the profiler its kernels under one
``cudaGraphLaunch``, with no op above them. A kernel map names them from
one profiled run of the same steps in set-up (``graph.compiled`` makes
it): each step inside a ``torch.profiler`` range ``compiled.<step>``, the
body run eagerly once with a range ``node <op> <name>`` around each
executor node (``graph.executor.node_ranges``), then one replay. This
module reads such a run; it launches nothing itself.
"""
from __future__ import annotations

import difflib

# a profiled step's range, and an executor node's
STEP_RANGE = "compiled."
NODE_RANGE_PREFIX = "node "


def profiler_running() -> bool:
    """True while a ``torch.profiler`` (or autograd profiler) records in
    this process: a kernel map is then not built, so an operator's own
    profiler is never nested."""
    import torch
    return bool(torch.autograd._profiler_enabled())


def profile_events(prof) -> tuple[list, list]:
    """``(cpu, dev)`` of a finished ``torch.profiler`` run: host events
    ``(name, start ns, end ns, thread, correlation id, is a range)`` and
    device ops ``(name, start ns, correlation id)``."""
    cpu, dev = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        if "CUDA" in str(ev.device_type()):
            if not ev.is_user_annotation():      # a range's device shadow
                dev.append((ev.name(), s, ev.correlation_id()))
        else:
            cpu.append((ev.name(), s, s + ev.duration_ns(),
                        ev.start_thread_id(), ev.correlation_id(),
                        bool(ev.is_user_annotation())))
    return cpu, dev


def kernel_map(cpu: list, dev: list) -> dict:
    """An entry's kernel map from one profiled run of its steps, each in a
    range ``compiled.<step>``: ``copy_in``, ``eager`` (the body run
    eagerly inside node ranges), ``replay`` and ``copy_out`` (events as
    ``profile_events`` gives them).

    Each device op goes by its correlation id to the runtime call that
    launched it (``cudaLaunchKernel``, ``cudaGraphLaunch``,
    ``cudaMemcpyAsync``, ...), and from that call's thread and time to
    the innermost step range, the innermost ``node <op> <name>`` range and
    the outermost host op inside the innermost range. Returns:

    * ``copy_in`` / ``copy_out``: the names of those steps' device ops, in
      device order;
    * ``replay``: per device op of the graph, in order, ``(node op, node,
      host op, name)``, the first three taken from the eager run's op it
      was matched to by name (``difflib`` over the two lists, so an op
      only one run launched does not shift the rest): ``""`` where the
      body launched it outside any node, None where the eager run has no
      op of that name there;
    * ``eager``: how many device ops the eager run launched."""
    corrs = {c for _, _, c in dev}
    launch: dict[int, tuple[int, int]] = {}
    ranges, ops = [], []
    for name, s, e, tid, corr, is_range in cpu:
        if is_range:
            ranges.append((name, s, e, tid))
        elif name.startswith("cu") and corr in corrs:
            launch.setdefault(corr, (s, tid))
        else:
            ops.append((name, s, e, tid))
    steps: dict[str, list] = {}
    for name, _, corr in sorted(dev, key=lambda d: d[1]):
        if corr not in launch:
            continue
        t, tid = launch[corr]
        around = sorted((r for r in ranges
                         if r[3] == tid and r[1] <= t <= r[2]),
                        key=lambda r: r[1])
        step = [r[0] for r in around if r[0].startswith(STEP_RANGE)]
        if not step:
            continue
        node = [r[0] for r in around if r[0].startswith(NODE_RANGE_PREFIX)]
        node_op, node_name = (node[-1].split(" ", 2)[1:] if node
                              else ("", ""))
        inner = around[-1][1]
        host = [o for o in ops if o[3] == tid and inner <= o[1] <= t <= o[2]]
        op = min(host, key=lambda o: o[1])[0] if host else ""
        steps.setdefault(step[-1][len(STEP_RANGE):], []).append(
            (node_op, node_name, op, name))
    eager = steps.get("eager", [])
    replay = [k for *_, k in steps.get("replay", [])]
    out: list = [(None, None, None, k) for k in replay]
    match = difflib.SequenceMatcher(None, [k for *_, k in eager], replay,
                                    autojunk=False)
    for a, b, n in match.get_matching_blocks():
        out[b:b + n] = eager[a:a + n]
    return {"copy_in": tuple(k for *_, k in steps.get("copy_in", [])),
            "replay": tuple(out),
            "copy_out": tuple(k for *_, k in steps.get("copy_out", [])),
            "eager": len(eager)}
