"""The port's benchmark: one cell, one run.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` finds the cell in ``BENCHMARK.json``, its configuration
in ``configs/<name>.json``, its traffic in ``mixes/<name>.json``, its
model's plain reference in ``reference/<model>.py`` and work counts in
``work/<model>.py``, and each metric's reader in ``metrics/<name>.py``.
The mix names the driver:

* ``served`` — requests (``traffic.served_stream``: open-loop arrivals,
  or a closed loop of clients) submitted to ``CoalescingBatcher.submit``
  over a ``ServingEngine`` built from the configuration's plan; a
  request's latency runs from its due time (closed loop: its submit) to
  its scores on the host;
* ``bulk`` — one client calling ``launch/steps.py``'s compiled serve
  program back to back on feeds copied in from a ring of pinned batches,
  its scores copied back; a call's latency runs from its copy-in to its
  scores on the host.

Set-up (counted in ``setup_s``) builds the kernels (``build/`` in the
checkout), draws weights and traffic inputs on the card from the seed,
builds the system and warms every shape the traffic can reach. The
window then runs for ``--seconds``; with ``--trace 1`` the program's own
tracer is on and a ``torch.profiler`` sub-window covers its last
``SUB_WINDOW_S`` seconds.
After the window: the peak memory is read, the program is freed, and
the scores of a seeded sample are held to the reference (``judge``).

The last line of standard output is the result; the numbers compared
and their limits end standard error. A run without a card, or with
fewer cards than the cell asks for, or that finds ``jax``, ``jaxlib``,
``flax`` or ``repro`` loaded after the window (looked for when it
closes, and again after the reference and the metric readers ran),
prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import math
import queue
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np

from portbench import devtrace, inputs, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SUB_WINDOW_S = 4.0          # the profiled sub-window, the window's last
DRAIN_S = 60.0              # how long after the window a due answer may come
WARM_USER_ID = 1 << 36      # warm-up users, below the stream's ids


# -- what the harness finds by name ------------------------------------------

def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def load_file(kind: str, name: str) -> types.ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (a metric's name may
    hold dots)."""
    path = HERE / kind / f"{name}.py"
    mod_name = f"portbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer metrics."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


def _call(path: str):
    mod, _, attr = path.partition(":")
    return getattr(importlib.import_module(mod), attr)


def build_graph(cfg: dict):
    """The configuration's graph, from its builder and sizes."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg["build"].items()}
    fn = _call(cfg["builder"])
    if cfg.get("config_class"):
        return fn(_call(cfg["config_class"])(**kw))
    return fn(**kw)


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


# -- one run's record ---------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What one window produced, for the metric readers."""
    kind: str
    seconds: float
    t0: float
    t1: float
    start: np.ndarray          # per request: due time (served) / copy-in
    done: np.ndarray           # per request: scores on the host (nan: never)
    rows: np.ndarray           # per request: candidates
    spans: list                # host spans (name, start, end, args)
    counters: dict
    cfg: dict
    path: str
    work: types.ModuleType
    peaks: dict
    sub: devtrace.SubWindow | None = None
    setup_s: float = 0.0
    failed: int = 0
    notes: dict = dataclasses.field(default_factory=dict)

    def latencies_ms(self) -> np.ndarray:
        ok = ~np.isnan(self.done)
        return (self.done[ok] - self.start[ok]) * 1e3

    def completed_rows(self) -> int:
        ok = ~np.isnan(self.done) & (self.done <= self.t1)
        return int(self.rows[ok].sum())

    def packs(self, a: float, b: float) -> list[tuple[int, int]]:
        """(real rows, users) of each pack or call started in [a, b)."""
        return [(int(g["rows"]), int(g["users"]))
                for n, s, _, g in self.spans
                if n in ("pack", "call") and a <= s < b]

    def stage1_runs(self, a: float, b: float) -> int:
        return sum(1 for n, s, _, _ in self.spans
                   if n in ("stage1", "call") and a <= s < b)

    def least_time(self, family: str, a: float, b: float) -> float:
        pf, pb = self.peaks["flops_per_s"], self.peaks["bytes_per_s"]
        t = 0.0
        for rows, users in self.packs(a, b):
            ops = self.work.kernel_work(self.build, self.path, rows, users)
            t += sum(max(f / pf, by / pb) for f, by in ops.get(family, ()))
        return t

    def model_flops(self, a: float, b: float) -> float:
        rows = sum(r for r, _ in self.packs(a, b))
        return (rows * self.work.candidate_flops(self.build)
                + self.stage1_runs(a, b) * self.work.user_flops(self.build))

    @property
    def build(self) -> dict:
        return self.cfg["build"]


# -- drivers ------------------------------------------------------------------

class _System:
    """What both drivers share: the configuration, the reference, the
    weights drawn from the seed, and the feature rows."""

    def __init__(self, cfg: dict, mix: dict, seed: int, seconds: float,
                 device, trace: bool):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.seconds, self.device, self.trace = seconds, device, trace
        self.ref = load_file("reference", cfg["model"])
        self.work = load_file("work", cfg["model"])
        self.peaks = load_json(HERE / "peaks.json")
        self.params = inputs.draw_params(
            self.ref.param_shapes(cfg["build"]), self.seed, device,
            table_std=cfg["init"]["table_std"],
            bias_scale=cfg["init"]["bias_scale"])
        self.user_spec, self.cand_spec = self.ref.feed_specs(cfg["build"])
        self.feat_gen = inputs.generator(self.seed, inputs.FEATURES_STREAM,
                                         device)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def record(self, **kw) -> Run:
        return Run(cfg=self.cfg, path=self.path, work=self.work,
                   peaks=self.peaks, **kw)


class Served(_System):
    """Traffic through ``CoalescingBatcher`` over a
    ``ServingEngine`` (two-stage serving under the configuration's plan)."""
    path = "two_stage"

    def setup(self) -> None:
        from repro_torch.serve import (CoalescingBatcher, ServePlan,
                                       ServingEngine)
        cfg, mix = self.cfg, self.mix
        serve = cfg["serve"]
        plan = ServePlan.preset(serve["preset"]).evolve(**serve["plan"])
        if self.trace:
            plan = plan.evolve(obs__trace=True, obs__trace_capacity=1 << 21)
        graph, _ = build_graph(cfg)
        self.engine = ServingEngine(graph, self.params, plan,
                                    device=self.device)
        self.batcher = CoalescingBatcher.from_plan(self.engine, plan.batch,
                                                   plan.ft)
        self.users = inputs.draw_rows(self.user_spec,
                                      int(mix["user_feature_sets"]),
                                      self.feat_gen)
        self.cands = inputs.draw_rows(self.cand_spec,
                                      int(mix["candidate_rows"]),
                                      self.feat_gen)
        self.stream = traffic.served_stream(mix, self.seed, self.seconds)
        self._warm()

    def request(self, uid: int, uset: int, off: int, n: int):
        from repro_torch.serve import ServeRequest
        return ServeRequest(
            user_id=int(uid),
            user_feeds={k: v[uset:uset + 1] for k, v in self.users.items()},
            candidate_feeds={k: v[off:off + n]
                             for k, v in self.cands.items()})

    def _pack_shapes(self, buckets: list[int]) -> list[tuple[int, int]]:
        """(users, bucket) of each pack the traffic can reach: one client
        sending one pool size packs its own chunks, one user at a time;
        other traffic can put each pow2 count of users up to the pack's
        user budget in each bucket."""
        from repro_torch.dist.topology import plan_buckets
        eng, arr, pool = self.engine, self.mix["arrivals"], self.mix["pool"]
        if arr["kind"] == "closed_loop" and int(arr["clients"]) == 1 \
                and pool["lo"] == pool["hi"]:
            return sorted({(1, b) for b in plan_buckets(
                int(pool["lo"]), 1, min_bucket=eng.min_bucket,
                max_batch=eng.max_batch)})
        users = [1 << k for k in range(
            next_pow2(eng.max_users_per_batch).bit_length())]
        return [(u, b) for u in users for b in buckets if b >= u]

    def _warm(self) -> None:
        """Every stage-2 graph the traffic can reach, captured and then
        replayed; stage 1; the rep cache filled to its bound; one request
        through the batcher."""
        eng = self.engine
        n_sets = len(next(iter(self.users.values())))
        buckets, b = [], eng.min_bucket
        while b < eng.max_batch:
            buckets.append(b)
            b *= 2
        buckets.append(eng.max_batch)
        shapes = self._pack_shapes(buckets)
        uid = WARM_USER_ID
        for u, b in shapes:
            sizes = [b // u] * u
            sizes[0] += b - sum(sizes)
            reqs = [self.request(uid + j, j % n_sets, 0, sizes[j])
                    for j in range(u)]
            uid += u
            for _ in range(2):
                eng.score_coalesced(reqs)
        # the rep cache at its steady state: full, so that each new user
        # evicts one and reuses its memory, as in a long-running server
        cap = eng.plan.cache.max_cached_users or 0
        per = next_pow2(eng.max_users_per_batch)
        rows = max(1, buckets[0] // per)
        fill = [(uid + k, k % n_sets) for k in range(cap)]
        uid += cap
        for k in range(0, len(fill), per):
            eng.score_coalesced([self.request(u, us, 0, rows)
                                 for u, us in fill[k:k + per]])
        self.batcher.submit(self.request(uid, 0, 0, shapes[0][1])).result()
        self.sync()
        self.compiled = (eng.stage1_compilations, eng.stage2_compilations)

    def window(self) -> Run:
        s, eng, bat = self.stream, self.engine, self.batcher
        n = len(s)
        arr = self.mix["arrivals"]
        closed = arr["kind"] == "closed_loop"
        done = np.full(n, np.nan)
        # the sample held to the reference: drawn with the stream, or in a
        # closed loop a seeded reservoir over the requests sent and the
        # longest request finished
        check = set() if closed else set(s.check.tolist())
        res = traffic.Reservoir(int(self.mix["check_sample"]), self.seed)
        kept: dict[int, np.ndarray] = {}
        longest = [-1, 0, None]         # index, pool, scores
        errors: list[str] = []
        left = [n]
        cv = threading.Condition()
        free = queue.SimpleQueue()      # a closed loop's clients, once free

        def finish(i, fut):
            t = time.perf_counter()
            exc = fut.exception()
            if exc is None:
                done[i] = t
                scores = fut.result().scores
                if i in check:
                    kept[i] = scores
            elif len(errors) < 5:
                errors.append(f"request {i}: {exc!r}")
            with cv:
                if exc is None and closed and s.pool[i] > longest[1]:
                    longest[:] = [i, int(s.pool[i]), scores]
                left[0] -= 1
                if not left[0]:
                    cv.notify_all()
            if closed:
                free.put(i)

        def send(i):
            if closed:
                k = res.slot()
                if k is not None:
                    res.items[k] = i
                    check.add(i)
            fut = bat.submit(self.request(s.user_id[i], s.user_set[i],
                                          s.offset[i], s.pool[i]))
            fut.add_done_callback(functools.partial(finish, i))

        sub = devtrace.SubWindow() if self.trace else None
        eng.profiler.snapshot(reset=True)
        bat.queue_wait.reset()
        if eng.tracer is not None:
            eng.tracer.clear()
        gc.collect()
        gc.freeze()
        t0 = time.perf_counter() + 0.01
        t1 = t0 + self.seconds
        sub_at = t1 - min(SUB_WINDOW_S, self.seconds / 2)
        start = t0 + s.due
        late = np.zeros(n)
        if closed:
            clients = int(arr["clients"])
            lag = t0 - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            sent = 0
            while sent < n:
                now = time.perf_counter()
                if sent >= clients:      # wait for a client to be free
                    try:
                        free.get(timeout=max(t1 - now, 1e-6))
                    except queue.Empty:
                        break
                    now = time.perf_counter()
                if now >= t1:
                    break
                if sub is not None and sub.t0 is None and now >= sub_at:
                    sub.start()
                    now = time.perf_counter()
                start[sent] = now
                send(sent)
                sent += 1
            with cv:
                left[0] -= n - sent     # never sent
            n = sent
        else:
            for i in range(n):
                due = t0 + s.due[i]
                if sub is not None and sub.t0 is None and due >= sub_at:
                    sub.start()
                lag = due - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
                late[i] = time.perf_counter() - due
                send(i)
        lag = t1 - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        prof = eng.profiler.snapshot()
        qwait = bat.queue_wait.percentile(50) if bat.queue_wait.count \
            else None
        with cv:
            cv.wait_for(lambda: not left[0], timeout=DRAIN_S)
        if sub is not None and sub.t0 is not None:
            sub.stop(at=t1)
        gc.unfreeze()
        spans = []
        if eng.tracer is not None:
            spans = [(name, ts, ts + dur, args or {})
                     for ph, name, ts, dur, _, _, args in eng.tracer.events()
                     if ph == "X"]
        if closed:
            check &= set(res.items)
            if longest[0] >= 0:
                check.add(longest[0])
                kept[longest[0]] = longest[2]
        self.kept = {i: v for i, v in kept.items() if i in check}
        run = self.record(
            kind="served", seconds=self.seconds, t0=t0, t1=t1,
            start=start[:n], done=done[:n].copy(), rows=s.pool[:n].copy(),
            spans=spans, sub=sub,
            counters={"profiler": prof, "queue_wait_p50_ms": qwait},
            failed=int(np.isnan(done[:n]).sum()))
        run.notes = {
            "requests": n, "errors": errors,
            "stream_used_up": bool(closed and n == len(s)),
            "late_ms_p99": float(np.percentile(late[:n], 99) * 1e3) if n
            else 0,
            "compiles_in_window": [
                eng.stage1_compilations - self.compiled[0],
                eng.stage2_compilations - self.compiled[1]]}
        return run

    def check_items(self):
        """(user feeds, candidate feeds, program scores) of each sampled
        request."""
        s = self.stream
        for i in sorted(self.kept):
            u, o, n = s.user_set[i], s.offset[i], s.pool[i]
            yield ({k: v[u:u + 1] for k, v in self.users.items()},
                   {k: v[o:o + n] for k, v in self.cands.items()},
                   self.kept[i])

    def release(self) -> None:
        self.batcher.close()
        self.engine.close()
        del self.batcher, self.engine


class Bulk(_System):
    """One client calling the compiled single-call serve program back to
    back, one user against ``rows`` candidates a call."""
    path = "single_call"

    def setup(self) -> None:
        import torch
        from repro_torch.core.mari import convert_params, mari_rewrite
        from repro_torch.launch.steps import _recsys_serve
        cfg, mix = self.cfg, self.mix
        rows = int(mix["rows"])
        graph, _ = build_graph(cfg)
        self.prog_params = convert_params(mari_rewrite(graph), self.params)
        prog = _recsys_serve(types.SimpleNamespace(
            BUILD=lambda: build_graph(cfg)), rows)
        self.serve = prog.compiled(self.device)
        pin = self.device.type == "cuda"
        self.ring = []
        for _ in range(int(mix["feed_ring"])):
            feeds = inputs.draw_rows(self.user_spec, 1, self.feat_gen,
                                     pin=pin)
            feeds.update(inputs.draw_rows(self.cand_spec, rows,
                                          self.feat_gen, pin=pin))
            self.ring.append({k: torch.as_tensor(v)
                              for k, v in feeds.items()})
        self.rows = rows
        for _ in range(2):
            self.serve(self.prog_params, self.ring[0]).cpu()
        self.sync()
        self.compiled = self.serve.compilations

    def window(self) -> Run:
        sub = devtrace.SubWindow() if self.trace else None
        res = traffic.Reservoir(int(self.mix["check_sample"]), self.seed)
        self.kept: list = []
        starts, dones, spans = [], [], []
        gc.collect()
        gc.freeze()
        t0 = time.perf_counter()
        t1 = t0 + self.seconds
        sub_at = t1 - min(SUB_WINDOW_S, self.seconds / 2)
        i = 0
        while True:
            t = time.perf_counter()
            if t >= t1:
                break
            if sub is not None and sub.t0 is None and t >= sub_at:
                sub.start()
                t = time.perf_counter()
            slot = i % len(self.ring)
            out = self.serve(self.prog_params, self.ring[slot])
            t_mid = time.perf_counter()
            host = out.cpu().numpy()
            t_done = time.perf_counter()
            starts.append(t)
            dones.append(t_done)
            spans.append(("call", t, t_mid, {"rows": self.rows, "users": 1}))
            spans.append(("scores_to_host", t_mid, t_done, {}))
            k = res.slot()
            if k is not None:
                res.items[k] = (slot, host.copy())
            i += 1
        if sub is not None and sub.t0 is not None:
            sub.stop(at=t1)
        gc.unfreeze()
        self.kept = [x for x in res.items if x is not None]
        run = self.record(
            kind="bulk", seconds=self.seconds, t0=t0, t1=t1,
            start=np.array(starts), done=np.array(dones),
            rows=np.full(len(starts), self.rows), spans=spans, sub=sub,
            counters={})
        run.notes = {"calls": i,
                     "compiles_in_window": self.serve.compilations
                     - self.compiled}
        return run

    def check_items(self):
        for slot, got in self.kept:
            feeds = self.ring[slot]
            user = {k: feeds[k] for k in self.user_spec}
            cand = {k: feeds[k] for k in self.cand_spec}
            yield user, cand, got

    def release(self) -> None:
        del self.serve, self.prog_params


DRIVERS = {"served": Served, "bulk": Bulk}


# -- the comparison that decides ``correct`` ----------------------------------

def judge(system, *, control: bool = False) -> dict:
    """Hold the sampled answers to the reference, computed in fp32 with
    TF32 off. ``score_gap`` is the widest gap between a served score and
    the reference's, over the root mean square of the reference's scores
    on the same rows. With ``control`` the reference computed with TF32 on
    stands in the program's place."""
    import torch
    dev = system.device
    build = system.cfg["build"]
    n_out = system.ref.outputs(build)
    gap, sq, count, items, bad = 0.0, 0.0, 0, 0, 0

    def on_dev(feeds):
        return {k: torch.as_tensor(v).to(dev) for k, v in feeds.items()}

    for user, cand, got in system.check_items():
        u, c = on_dev(user), on_dev(cand)
        want = system.ref.forward(system.params, u, c, build)
        if control:
            got = system.ref.forward(system.params, u, c, build,
                                     allow_tf32=True).cpu().numpy()
        want = want.double().cpu().numpy()
        n = next(iter(cand.values())).shape[0]
        got = np.asarray(got, dtype=np.float64)
        items += 1
        if got.shape != (n, n_out) or not np.isfinite(got).all():
            bad += 1
            continue
        gap = max(gap, float(np.abs(got - want).max()))
        sq += float((want ** 2).sum())
        count += want.size
    rms = math.sqrt(sq / count) if count else 0.0
    return {"checked": items, "bad_shape_or_nan": bad,
            "score_gap": gap / rms if rms > 0 else math.inf}


def verdict(readings: dict, failed: int, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number compared beside its limit."""
    checks = {
        "score_gap": {"value": readings["score_gap"],
                      "limit": limits["score_gap"]},
        "bad_answers": {"value": readings["bad_shape_or_nan"], "limit": 0},
        "failed_requests": {"value": failed, "limit": 0},
    }
    ok = (readings["checked"] >= 1
          and readings["bad_shape_or_nan"] == 0 and failed == 0
          and readings["score_gap"] <= limits["score_gap"])
    return ok, checks


# -- one run -------------------------------------------------------------------

def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def breakdown(run: Run) -> dict:
    sub = run.sub
    ops = sorted(sub.by_name().items(), key=lambda x: -x[1])[:10]
    host = [(n, s, e) for n, s, e, _ in run.spans
            if e > sub.t0 and s < sub.t1]
    gaps = devtrace.attribute_gaps(sub.gaps(), host,
                                   "no host span (queue, linger, client)")
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in sorted(
                gaps.items(), key=lambda x: -x[1])[:10]]}


def make_system(cfg: dict, mix: dict, seed: int, seconds: float, device,
                trace: bool = False):
    """The system of a configuration under a mix, built and warm."""
    system = DRIVERS[mix["driver"]](cfg, mix, seed, seconds, device, trace)
    system.setup()
    if trace:
        devtrace.SubWindow.warm()
    return system


def execute(system, metrics: list[dict], chips: int, t_start: float, *,
            check_modules: bool = True) -> tuple[dict | None, dict]:
    """Everything of a run after set-up: the window, the peak memory, the
    look for modules the port may not load, the program freed, the
    sampled answers judged, the metrics read. Returns the result line
    (None when a forbidden module was found) and notes for standard
    error."""
    import torch
    dev = system.device
    run = system.window()
    run.setup_s = run.t0 - t_start
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    found = forbidden_modules() if check_modules else []
    if found:
        return None, {"forbidden_modules": found}
    system.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    traced = run.sub is not None and run.sub.t1 is not None
    if traced:
        run.sub.collect()
    t_ref = time.perf_counter()
    readings = judge(system)
    notes = {"setup_s": run.setup_s,
             "reference_s": time.perf_counter() - t_ref,
             "checked": readings["checked"], **run.notes}
    ok, checks = verdict(readings, run.failed, system.cfg["checks"])
    values = {}
    for m in metrics:
        value = load_file("metrics", m["name"]).read(run)
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": int(chips), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok), "attempted": int(len(run.start)),
           "failed": int(run.failed), "metrics": values, "device": device}
    if traced:
        device["busy_s"] = run.sub.busy_s()
        device["window_s"] = run.sub.window_s
        out["breakdown"] = breakdown(run)
    out["checks"] = checks
    # the reference and the readers have run in this process since the look
    found = forbidden_modules() if check_modules else []
    if found:
        return None, {**notes, "forbidden_modules": found}
    return out, notes


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    trace = bool(args.trace)
    bench = load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"needs {wl['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kbuild
    t_build = time.perf_counter()
    kbuild.build_all()
    build_s = time.perf_counter() - t_build
    system = make_system(load_config(wl["config"]),
                         traffic.load_mix(wl["traffic"]), args.seed,
                         args.seconds, torch.device("cuda", 0), trace)
    out, notes = execute(system, cell_metrics(bench, args.workload, trace),
                         wl["chips"], t_start)
    print(json.dumps({"build_s": build_s, **notes}, default=str),
          file=sys.stderr)
    if out is None:
        print(f"modules loaded that the port may not use: "
              f"{notes['forbidden_modules']}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
