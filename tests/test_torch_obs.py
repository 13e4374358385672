"""The port's request tracing on the CPU (``repro_torch.obs`` and its
wiring), mirroring tests/test_obs.py: the ring-buffer tracer's contracts,
Chrome trace export (validated by ``benchmarks/check_trace.validate``),
``ObsPlan`` on the plan spine, and the engine / batcher / cache / fault
events — whose names and sites are held against the reference's on the
same scenario — plus ``launch/serve.py --trace``. Tracing never changes a
score.
"""
import json
import threading
import warnings

import jax
import numpy as np
import pytest

from benchmarks.check_trace import validate
from repro.graph.executor import init_graph_params as j_init
from repro.models.ranking import PaperRankingConfig as JPaperCfg
from repro.models.ranking import build_paper_ranking_model as j_paper
from repro.serve import ServePlan as JPlan, ServeRequest as JRequest
from repro.serve import ServingEngine as JEngine
from repro_torch.common import params_from_numpy
from repro_torch.graph.executor import init_graph_params
from repro_torch.launch import serve as launcher
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model)
from repro_torch.graph import compiled, executor
from repro_torch.obs import (BATCHER_SPANS, PORT_SPANS, Tracer,
                             chrome_events, kernel_map, merge_trace_files,
                             trace_payload, write_trace)
from repro_torch.serve import (CoalescingBatcher, ObsPlan, PlanError,
                               PlanResolutionWarning, RankingService,
                               ServePlan, ServeRequest, ServingEngine)


@pytest.fixture(scope="module")
def paper():
    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.03))
    params = init_graph_params(graph, seed=0, device="cpu")
    user_in = {n.name for n in graph.input_nodes()
               if n.attrs.get("domain") == "user"}
    return graph, params, user_in


def _feeds(graph, n, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for node in graph.input_nodes():
        rows = 1 if node.attrs["domain"] == "user" else n
        out[node.name] = rng.standard_normal(
            (rows,) + tuple(node.attrs["shape"])).astype(np.float32)
    return out


def _request(graph, user_in, uid, n, seed, version=0, cls=ServeRequest):
    feeds = _feeds(graph, n, seed)
    return cls(user_id=uid,
               user_feeds={k: v for k, v in feeds.items() if k in user_in},
               candidate_feeds={k: v for k, v in feeds.items()
                                if k not in user_in},
               feature_version=version)


TRACE_PLAN = ServePlan().evolve(obs__trace=True, batch__hedging=False)


def _engine(paper, plan=TRACE_PLAN):
    graph, params, _ = paper
    return ServingEngine(graph, params, plan=plan, device="cpu")


# -- Tracer -----------------------------------------------------------------

class TestTracer:
    def test_ring_wrap_keeps_newest(self):
        t = Tracer(capacity=8)
        for i in range(24):
            t.instant("e", i=i)
        assert len(t) == 8
        assert t.dropped == 16 and t.recorded == 24
        assert [e[6]["i"] for e in t.events()] == list(range(16, 24))

    def test_span_kinds_and_thread_stamp(self):
        t = Tracer()
        with t.span("work", group=1):
            pass
        t.begin("group", track="group:0", group=1)
        t.end("group", track="group:0", group=1)
        t.instant("hit", user=3)
        t.complete("stage1", 1.0, 0.5, user=3)
        assert [e[0] for e in t.events()] == ["X", "B", "E", "i", "X"]
        # the operating system's thread id, which the profiler records
        tid = threading.get_native_id()
        assert all(e[4] == tid for e in t.events())
        assert t.thread_names()[tid] == threading.current_thread().name
        t.clear()
        assert len(t) == 0 and t.recorded == 0

    def test_steps_are_one_entry_listed_as_spans(self):
        """Consecutive spans in one ring entry, a None name a gap; the
        ring counts the entry once."""
        t = Tracer(capacity=4)
        t.steps(("a", None, "c"), (1.0, 2.0, 2.5, 4.0), graph=7)
        assert len(t) == 1 and t.recorded == 1
        tid = threading.get_native_id()
        assert t.events() == [("X", "a", 1.0, 1.0, tid, None, {"graph": 7}),
                              ("X", "c", 2.5, 1.5, tid, None, {"graph": 7})]

    def test_pins_outlive_the_ring_and_clear(self):
        """A pinned event is listed first, survives the ring's wrap and
        ``clear``, and a second pin of its key replaces it."""
        t = Tracer(capacity=2)
        t.pin("map", 0, v=1)
        t.pin("map", 1, v=2)
        t.pin("map", 0, v=3)
        for i in range(5):
            t.instant("e", i=i)
        assert t.dropped == 3
        ev = t.events()
        assert [(e[0], e[1], e[3], e[6]) for e in ev[:2]] == [
            ("X", "map", 0.0, {"v": 3}), ("X", "map", 0.0, {"v": 2})]
        assert [e[6]["i"] for e in ev[2:]] == [3, 4]
        t.clear()
        assert [e[6]["v"] for e in t.events()] == [3, 2]
        assert len(t) == 0

    def test_sampling(self):
        t = Tracer(sample_every=4)
        assert [s for s in range(9) if t.sampled(s)] == [0, 4, 8]
        assert all(Tracer().sampled(s) for s in range(5))

    def test_rejects_bad_params(self):
        with pytest.raises(ValueError):
            Tracer(capacity=0)
        with pytest.raises(ValueError):
            Tracer(sample_every=0)

    def test_concurrent_writers_no_negative_or_orphaned_spans(self):
        t = Tracer(capacity=100_000)
        n_threads, per = 8, 300

        def work(wid):
            for i in range(per):
                with t.span("op", wid=wid, i=i):
                    pass
                track = f"group:{wid}"
                t.begin("group", track=track, group=wid * per + i)
                t.instant("hit", wid=wid)
                t.end("group", track=track, group=wid * per + i)

        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        evs = t.events()
        assert len(evs) == n_threads * per * 4 and t.dropped == 0
        assert all(e[3] >= 0.0 for e in evs if e[0] == "X")
        depth = {}
        for ph, _, _, _, _, track, _ in evs:
            if ph == "B":
                depth[track] = depth.get(track, 0) + 1
            elif ph == "E":
                depth[track] = depth.get(track, 0) - 1
                assert depth[track] >= 0, "E before its B on one track"
        assert all(d == 0 for d in depth.values())
        assert {e[4] for e in evs} <= set(t.thread_names())


# -- export -----------------------------------------------------------------

class TestExport:
    def _tracer(self):
        t = Tracer()
        with t.span("pack", group=1):
            pass
        t.begin("group", track="group:0", group=1)
        t.instant("cache_hit", user="u1")
        t.end("group", track="group:0", group=1)
        return t

    def test_chrome_events_shape(self):
        events, _ = chrome_events(self._tracer(), pid=3, process_name="din")
        meta = [e for e in events if e["ph"] == "M"]
        assert {"process_name", "thread_name"} <= {e["name"] for e in meta}
        gtrack = [e for e in meta if e["args"]["name"] == "group:0"]
        assert gtrack and gtrack[0]["tid"] >= 1000
        real = [e for e in events if e["ph"] != "M"]
        assert all(e["pid"] == 3 for e in events)
        assert min(e["ts"] for e in real) == 0.0
        x = [e for e in real if e["ph"] == "X"]
        assert x and all(e["dur"] >= 0.0 for e in x)

    def test_payload_validates_and_is_json(self, tmp_path):
        payload = write_trace(str(tmp_path / "t.json"),
                              {"a": self._tracer(), "b": self._tracer()})
        assert validate(payload) == []
        reloaded = json.loads((tmp_path / "t.json").read_text())
        assert validate(reloaded) == []
        assert {e["pid"] for e in reloaded["traceEvents"]} == {0, 1}
        assert trace_payload(Tracer())["traceEvents"][0]["ph"] == "M"

    def test_merge_assigns_shard_pids(self, tmp_path):
        paths = []
        for i in range(3):
            p = str(tmp_path / f"w{i}.json")
            write_trace(p, self._tracer())
            paths.append(p)
        merged = merge_trace_files(paths, str(tmp_path / "merged.json"))
        assert validate(merged) == []
        assert {e["pid"] for e in merged["traceEvents"]} == {0, 1, 2}
        names = {e["args"]["name"] for e in merged["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert names == {"shard-0", "shard-1", "shard-2"}

    def test_validator_catches_violations(self):
        ok = trace_payload(self._tracer())
        assert validate(ok) == []
        bad = json.loads(json.dumps(ok))
        bad["traceEvents"].append({"name": "group", "ph": "E",
                                   "pid": 9, "tid": 9, "ts": 1.0})
        assert any("E without open B" in m for m in validate(bad))


# -- ObsPlan ------------------------------------------------------------------

class TestObsPlan:
    def test_defaults_match_the_reference(self):
        plan = ServePlan()
        assert plan.obs == ObsPlan()
        assert plan.obs.trace is False and plan.obs.metrics is True
        for name in ("paper", "vanilla", "uoi", "tpu"):
            assert (ServePlan.preset(name).to_dict()["obs"]
                    == JPlan.preset(name).to_dict()["obs"])

    def test_round_trip(self):
        plan = ServePlan().evolve(obs__trace=True, obs__trace_capacity=4096,
                                  obs__sample_every=8, obs__metrics=False)
        again = ServePlan.from_json(plan.to_json())
        assert again == plan and again.obs.trace_capacity == 4096

    @pytest.mark.parametrize("obs", [dict(trace=True, trace_capacity=0),
                                     dict(trace=True, sample_every=0),
                                     dict(trace=1)])
    def test_rejects(self, obs):
        with pytest.raises(PlanError):
            ServePlan(obs=ObsPlan(**obs))

    def test_resolves_trace_knobs_without_trace(self):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            plan = ServePlan(obs=ObsPlan(trace=False, trace_capacity=4096,
                                         sample_every=8))
        assert any(issubclass(x.category, PlanResolutionWarning) for x in w)
        assert plan.obs.trace_capacity is None
        assert plan.obs.sample_every == 1
        assert any("without trace=True" in n for n in plan.resolution_notes)


# -- the engine, batcher and caches ------------------------------------------

class TestEngineTracing:
    def test_off_by_default(self, paper):
        eng = _engine(paper, ServePlan())
        assert eng.tracer is None and eng.metrics is not None
        eng.close()

    def test_linkage_survives_out_of_order_collect(self, paper):
        graph, _, user_in = paper
        eng = _engine(paper)
        h1 = eng.begin_coalesced([_request(graph, user_in, 1, 9, seed=1)])
        h2 = eng.begin_coalesced([_request(graph, user_in, 2, 9, seed=2)])
        eng.collect(h2)
        eng.collect(h1)
        assert h1.gid != h2.gid and h1.track != h2.track
        by_track = {}
        for ph, name, _, _, _, track, args in eng.tracer.events():
            if name == "group":
                by_track.setdefault(track, []).append((ph, args["group"]))
        for track, seq in by_track.items():
            assert [p for p, _ in seq] == ["B", "E"], (track, seq)
            assert len({g for _, g in seq}) == 1
        h3 = eng.begin_coalesced([_request(graph, user_in, 3, 9, seed=3)])
        assert h3.track == "group:0"              # the slot was released
        eng.collect(h3)
        assert validate(trace_payload(eng.tracer)) == []
        eng.close()

    def test_exception_in_begin_closes_group_span(self, paper):
        graph, _, user_in = paper
        eng = _engine(paper)
        req = _request(graph, user_in, 1, 9, seed=1)
        # an uncached user with no user feeds: stage 1 fails mid-begin
        bad = ServeRequest(user_id=999, user_feeds={},
                           candidate_feeds=req.candidate_feeds)
        with pytest.raises(Exception):
            eng.begin_coalesced([bad])
        assert validate(trace_payload(eng.tracer)) == []
        ends = [e for e in eng.tracer.events()
                if e[1] == "group" and e[0] == "E"]
        assert ends and ends[-1][6].get("error") is True
        h = eng.begin_coalesced([req])
        assert h.track == "group:0"
        eng.collect(h)
        eng.close()

    def test_events_match_the_reference(self, paper):
        """The same scenario through the reference's traced engine and the
        port's: every reference event under its name, with the same phase
        and argument keys (timings and thread ids aside), and beside them
        exactly the port's declared spans (``PORT_SPANS``)."""
        graph, _, user_in = paper
        jg = j_paper(JPaperCfg().scaled(0.03))[0]
        jp = j_init(jg, jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        fields = dict(obs__trace=True, batch__hedging=False,
                      batch__max_batch=32, batch__min_bucket=8,
                      cache__max_cached_users=2)
        jeng = JEngine(jg, jp, JPlan().evolve(**fields))
        teng = ServingEngine(graph, tp, ServePlan().evolve(**fields),
                             device="cpu")
        pools = ((0, 9), (1, 40), (0, 5), (2, 12), (3, 3))
        for eng, cls in ((jeng, JRequest), (teng, ServeRequest)):
            reqs = [_request(graph, user_in, u, n, seed=10 + i, cls=cls)
                    for i, (u, n) in enumerate(pools)]
            eng.score(reqs[0])
            h1 = eng.begin_coalesced(reqs[1:3])
            h2 = eng.begin_coalesced(reqs[3:])
            eng.collect(h2)
            eng.collect(h1)

        def shape(eng):
            out = {}
            for ph, name, _, _, _, track, args in eng.tracer.events():
                out.setdefault(name, set()).add(
                    (ph, track is not None, tuple(sorted(args or {}))))
            return out

        want, got = shape(jeng), shape(teng)
        assert set(want) <= set(got)
        assert set(got) - set(want) == set(PORT_SPANS)
        assert {"group", "stage1", "pack", "dispatch", "begin_coalesced",
                "collect", "cache_hit", "cache_miss",
                "cache_evict"} <= set(got)
        for name in want:
            assert got[name] == want[name], name
        assert validate(trace_payload(teng.tracer)) == []
        jeng.close()
        teng.close()

    def test_batcher_stream_trace_and_stats(self, paper):
        graph, _, user_in = paper
        eng = _engine(paper, TRACE_PLAN.evolve(batch__continuous=True,
                                               batch__max_inflight=2))
        reqs = [_request(graph, user_in, i % 3, 7 + (i % 3) * 8, seed=i)
                for i in range(18)]
        with CoalescingBatcher.from_plan(eng, eng.plan.batch) as b:
            futs = []

            def submit(chunk):
                futs.extend([b.submit(r) for r in chunk])

            threads = [threading.Thread(target=submit, args=(reqs[i::3],))
                       for i in range(3)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            res = [f.result() for f in futs]
        assert len(res) == len(reqs)
        evs = eng.tracer.events()
        names = {e[1] for e in evs}
        assert {"submit", "queue_claim", "group_launch", "resolve",
                "group", "pack", "dispatch", "collect"} <= names
        assert {"cache_hit", "cache_miss"} & names
        submitted = {e[6]["req"] for e in evs if e[1] == "submit"}
        gids = {e[6]["group"] for e in evs if e[1] == "group"}
        launches = [e[6] for e in evs if e[1] == "group_launch"]
        assert launches
        for args in launches:
            assert set(args["reqs"]) <= submitted
            if args.get("group") is not None:
                assert args["group"] in gids
        assert validate(trace_payload(eng.tracer)) == []
        lat = b.request_latency.snapshot()
        assert lat["count"] == len(reqs) and lat["p99"] >= lat["p50"] > 0
        snap = b.metrics.snapshot()
        assert snap["requests"] == len(reqs)
        assert snap["cache_hits"] == eng.cache.hits  # the engine's registry
        eng.close()

    def test_admission_shed_instant(self, paper):
        graph, _, user_in = paper
        eng = _engine(paper, TRACE_PLAN.evolve(
            batch__admission=True, batch__deadline_headroom_ms=50.0))
        with CoalescingBatcher.from_plan(eng, eng.plan.batch) as b:
            # a deadline budget below the headroom floor: shed on submit
            fut = b.submit(_request(graph, user_in, 0, 5, seed=0),
                           deadline_ms=1.0)
            assert fut.exception(timeout=5) is not None
        shed = [e for e in eng.tracer.events() if e[1] == "admission_shed"]
        assert shed and shed[0][6]["slo"] == "deadline"
        eng.close()

    def test_tracing_leaves_scores_unchanged(self, paper):
        graph, _, user_in = paper
        reqs = [_request(graph, user_in, i, 9 + i, seed=i) for i in range(3)]
        plain = _engine(paper, ServePlan().evolve(batch__hedging=False))
        traced = _engine(paper)
        for r in reqs:
            np.testing.assert_array_equal(plain.score(r).scores,
                                          traced.score(r).scores)
        a = plain.score_coalesced(reqs)
        b = traced.score_coalesced(reqs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.scores, y.scores)
        assert len(traced.tracer) > 0
        plain.close()
        traced.close()

    def test_sample_every_thins_request_events(self, paper):
        graph, _, user_in = paper
        eng = _engine(paper, TRACE_PLAN.evolve(obs__sample_every=1000))
        with CoalescingBatcher(eng, linger_ms=1.0) as b:
            for i in range(5):
                b.submit(_request(graph, user_in, 0, 9, seed=i)).result()
        names = [e[1] for e in eng.tracer.events()]
        assert "group" in names and "pack" in names
        assert names.count("submit") <= 1
        eng.close()

    def test_device_store_and_fault_instants(self, paper):
        """The device tier's slot_steal / slot_drop / table_fork /
        quarantine, the fault injector's fault_injected, the engine's
        fork_armed and breaker events."""
        graph, _, user_in = paper
        eng = _engine(paper, TRACE_PLAN.evolve(
            cache__device_resident=True, cache__device_slots=1,
            cache__max_cached_users=4, ft__inject=True,
            ft__sites=("slot_write:error:after=3,count=1",),
            ft__breaker_failures=1, ft__breaker_cooldown_ms=0.0))
        a, b, c = (_request(graph, user_in, u, 9, seed=u) for u in (1, 2, 3))
        eng.score(a)
        h_a = eng.begin_coalesced([a])
        h_b = eng.begin_coalesced([b])        # steals a's slot, in flight
        eng.collect(h_a)
        eng.collect(h_b)
        eng.invalidate_user(2)                # frees b's slot
        eng.score(c)
        eng.score(a)                          # the 4th write: injected
        eng.score(b)
        names = {e[1] for e in eng.tracer.events()}
        assert {"slot_steal", "slot_drop", "table_fork", "fork_armed",
                "fault_injected", "quarantine", "breaker_open"} <= names
        assert validate(trace_payload(eng.tracer)) == []
        eng.close()

    def test_corruption_detected_instant(self, paper):
        graph, _, user_in = paper
        eng = _engine(paper, TRACE_PLAN.evolve(
            ft__inject=True, ft__sites=("collect:corrupt:count=1",)))
        with pytest.raises(Exception, match="corrupted"):
            eng.score(_request(graph, user_in, 0, 9, seed=0))
        names = [e[1] for e in eng.tracer.events()]
        assert "corruption_detected" in names and "fault_injected" in names
        ends = [e for e in eng.tracer.events()
                if e[1] == "group" and e[0] == "E"]
        assert ends[-1][6].get("error") is True
        assert validate(trace_payload(eng.tracer)) == []
        eng.close()

    def test_service_writes_one_tracer_per_scenario(self, paper, tmp_path):
        graph, params, user_in = paper
        svc = RankingService(TRACE_PLAN, device="cpu")
        svc.register("a", graph=graph, params=params)
        svc.register("b", graph=graph, params=params)
        for i in range(4):
            svc.score("ab"[i % 2], _request(graph, user_in, i, 9, seed=i))
        payload = write_trace(str(tmp_path / "svc.json"),
                              {sc: svc.engine(sc).tracer
                               for sc in ("a", "b")})
        assert validate(payload, require=["submit", "group"]) == []
        assert {e["pid"] for e in payload["traceEvents"]} == {0, 1}
        svc.close()


# -- the port's spans beneath the reference's --------------------------------

# each child span's parent: the span it splits, on the same thread
PARENT = {"stage1": "stage1", "pack": "pack", "stage2": "dispatch",
          "collect": "collect"}


def _spans(tracer):
    return [(name, ts, ts + dur, tid, args or {})
            for ph, name, ts, dur, tid, _, args in tracer.events()
            if ph == "X"]


def _served(paper, plan, n=12):
    """``n`` requests of three users' pools through a batcher."""
    graph, _, user_in = paper
    eng = _engine(paper, plan)
    reqs = [_request(graph, user_in, 100 + i, 5 + 7 * (i % 3), seed=i)
            for i in range(n)]
    with CoalescingBatcher.from_plan(eng, eng.plan.batch) as b:
        res = [f.result() for f in [b.submit(r) for r in reqs]]
    return eng, b, reqs, res


class TestPortSpans:
    def test_children_nest_in_their_parents_on_one_thread(self, paper):
        eng, _, _, _ = _served(paper, TRACE_PLAN)
        spans = _spans(eng.tracer)
        names = {n for n, *_ in spans}
        assert set(PORT_SPANS) <= names
        assert set(BATCHER_SPANS) - {"batcher.wait"} <= names
        # the batcher's spans all on its worker thread, not the caller's
        tids = {tid for name, _, _, tid, _ in spans
                if name.startswith("batcher.")}
        assert len(tids) == 1 and threading.get_native_id() not in tids
        for name, s, e, tid, _ in spans:
            head = name.partition(".")[0]
            if name in PORT_SPANS:
                assert any(p == PARENT[head] and t == tid and ps <= s
                           and e <= pe
                           for p, ps, pe, t, _ in spans), name
            assert e >= s
        eng.close()

    def test_stage_spans_once_per_call(self, paper):
        eng, _, _, _ = _served(paper, TRACE_PLAN)
        count = {}
        for name, *_ in _spans(eng.tracer):
            count[name] = count.get(name, 0) + 1
        assert count["stage1"] == eng.stage1_calls > 0
        for step in ("copy_in", "replay", "copy_out", "sync"):
            assert count[f"stage1.{step}"] == count["stage1"], step
        assert count["dispatch"] == eng.stage2_calls > 0
        for step in ("copy_in", "replay", "copy_out"):
            assert count[f"stage2.{step}"] == count["dispatch"], step
        assert count["pack.alloc"] == count["pack.fill"] == count["pack"]
        assert count["collect.unpack"] == count["pack"]
        eng.close()

    def test_a_compiled_call_is_one_ring_entry(self):
        """A traced call records its three steps as one ``steps`` entry:
        consecutive spans, each with the entry's ordinal."""
        import torch

        def body(params, feeds):
            return {"y": feeds["x"] * params["w"]}

        run = compiled.CompiledRun(body, device="cpu", name="s")
        tracer = Tracer()
        run.set_tracer(tracer)
        params = {"w": torch.tensor(2.0)}
        for n in (3, 3, 5):
            run(params, {"x": torch.ones(n)})
        assert len(tracer) == 3
        ev = tracer.events()
        assert [e[1] for e in ev] == ["s.copy_in", "s.replay",
                                      "s.copy_out"] * 3
        assert [e[6]["graph"] for e in ev] == [0] * 6 + [1] * 3
        for a, b in zip(ev, ev[1:]):
            if a[1] != "s.copy_out":
                assert a[2] + a[3] == pytest.approx(b[2])

    def test_linger_carries_its_group(self, paper):
        eng, b, reqs, _ = _served(paper, TRACE_PLAN)
        linger = [a for n, *_, a in _spans(eng.tracer)
                  if n == "batcher.linger"]
        claims = [a for n, *_, a in _spans(eng.tracer)
                  if n == "batcher.claim"]
        assert linger and len(linger) == len(claims) == b.batches
        for a in linger:
            assert set(a) == {"reqs", "rows", "depth", "dropped"}
            assert 1 <= a["reqs"] and 1 <= a["depth"] <= len(reqs)
            assert a["dropped"] == 0
        assert sum(a["reqs"] for a in linger) == len(reqs)
        assert sum(a["rows"] for a in linger) == sum(
            next(iter(r.candidate_feeds.values())).shape[0] for r in reqs)
        resolved = [a["reqs"] for n, *_, a in _spans(eng.tracer)
                    if n == "batcher.resolve"]
        assert sum(resolved) == len(reqs)
        eng.close()

    def test_queued_gauge(self, paper):
        eng, b, _, _ = _served(paper, ServePlan().evolve(
            batch__hedging=False))
        assert b.metrics.snapshot()["queued"] == 0
        assert "group_wall_ms" not in b.metrics.snapshot()
        eng.close()

    def test_off_records_nothing_and_profiles_nothing(self, paper,
                                                      monkeypatch):
        """With tracing off no span is pushed, the compiled stages read no
        clock, and nothing opens a profiler or a profiler range."""
        calls = {"push": 0, "clock": 0, "profiler": 0}

        def push(*a, **k):
            calls["push"] += 1

        def clock():
            calls["clock"] += 1
            return 0.0

        def profiler(*a, **k):
            calls["profiler"] += 1
            raise AssertionError("a profiler call with tracing off")

        monkeypatch.setattr(Tracer, "_push", push)
        monkeypatch.setattr(compiled, "time",
                            type("T", (), {"perf_counter": clock}))
        import torch.profiler
        monkeypatch.setattr(torch.profiler, "profile", profiler)
        monkeypatch.setattr(torch.profiler, "record_function", profiler)
        eng, _, reqs, res = _served(paper, ServePlan().evolve(
            batch__hedging=False))
        assert len(res) == len(reqs) and eng.tracer is None
        assert calls == {"push": 0, "clock": 0, "profiler": 0}
        eng.close()

    def test_traced_and_untraced_batchers_score_alike(self, paper):
        plain = _served(paper, ServePlan().evolve(batch__hedging=False))
        traced = _served(paper, TRACE_PLAN)
        for x, y in zip(plain[3], traced[3]):
            np.testing.assert_array_equal(x.scores, y.scores)
        plain[0].close()
        traced[0].close()


class TestKernelMap:
    def test_node_ranges_name_each_node(self, paper):
        import torch
        from torch.profiler import ProfilerActivity, profile
        graph, params, user_in = paper
        ex = executor.Executor(graph, "uoi", device="cpu")
        feeds = {k: torch.as_tensor(v)
                 for k, v in _feeds(graph, 3, seed=0).items()}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ex.run(params, feeds)
            with executor.node_ranges():
                ex.run(params, feeds)
        got = [ev.name() for ev in prof.profiler.kineto_results.events()
               if ev.is_user_annotation()]
        assert sorted(got) == sorted(f"node {n.op} {n.name}"
                                     for n in graph.topo_order())
        assert getattr(executor._NODE_RANGE, "fn", None) is None

    def test_node_ranges_are_per_thread(self, paper):
        """Ranges opened on one thread leave another thread's runs
        alone."""
        seen = []
        with executor.node_ranges():
            seen.append(getattr(executor._NODE_RANGE, "fn", None))
            th = threading.Thread(target=lambda: seen.append(
                getattr(executor._NODE_RANGE, "fn", None)))
            th.start()
            th.join()
        assert seen[0] is not None and seen[1] is None

    def test_map_from_made_up_events(self):
        """Device ops to runtime calls by correlation id, to steps and
        nodes by thread and time; a kernel only the replay launched gets
        no node, and does not shift the ones after it."""
        R = True
        cpu = [
            ("compiled.copy_in", 0, 10, 1, 0, R),
            ("aten::copy_", 1, 9, 1, 90, False),
            ("cudaMemcpyAsync", 2, 3, 1, 1, False),
            ("compiled.eager", 20, 60, 1, 0, R),
            ("node target_attention attn", 21, 40, 1, 0, R),
            ("aten::add", 22, 30, 1, 91, False),
            ("aten::add_", 23, 29, 1, 92, False),
            ("cudaLaunchKernel", 24, 25, 1, 2, False),
            ("cudaLaunchKernel", 32, 33, 1, 3, False),
            ("aten::take", 45, 50, 1, 93, False),
            ("cudaLaunchKernel", 46, 47, 1, 4, False),
            ("cudaLaunchKernel", 46, 47, 2, 9, False),   # another thread
            ("compiled.replay", 70, 80, 1, 0, R),
            ("cudaGraphLaunch", 71, 72, 1, 5, False),
            ("compiled.copy_out", 81, 90, 1, 0, R),
            ("cudaMemcpyAsync", 82, 83, 1, 6, False),
        ]
        dev = [("Memcpy HtoD (Pinned -> Device)", 4, 1),
               ("k_add", 26, 2), ("k_mlp", 34, 3), ("k_take", 48, 4),
               ("stray", 48, 9),
               ("k_add", 73, 5), ("k_extra", 74, 5), ("k_mlp", 75, 5),
               ("k_take", 76, 5), ("Memcpy DtoD (Device -> Device)", 84, 6)]
        m = kernel_map.kernel_map(cpu, dev)
        assert m["copy_in"] == ("Memcpy HtoD (Pinned -> Device)",)
        assert m["copy_out"] == ("Memcpy DtoD (Device -> Device)",)
        assert m["eager"] == 3
        assert m["replay"] == (
            ("target_attention", "attn", "aten::add", "k_add"),
            (None, None, None, "k_extra"),
            ("target_attention", "attn", "", "k_mlp"),
            ("", "", "aten::take", "k_take"))


@pytest.mark.parametrize("argv", [
    ["--arch", "fm"],
    ["--scenario", "fm,deepfm"],
])
def test_launcher_writes_a_trace(tmp_path, capsys, argv):
    path = tmp_path / "t.json"
    launcher.main(argv + ["--requests", "4", "--candidates", "64",
                          "--device", "cpu", "--trace", str(path)])
    assert "wrote trace" in capsys.readouterr().out
    payload = json.loads(path.read_text())
    assert validate(payload, require=["group", "pack", "dispatch",
                                      "collect"]) == []
