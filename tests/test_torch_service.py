"""The port's serving runtime on the CPU, held against the JAX reference:
``RankingService`` hosting din / deepfm / fm / dlrm-mlperf on the
reference's params, the shared rep-cache budget and its scenario
namespacing, the ``CoalescingBatcher``'s admission, SLO and drain contracts
(run on both packages' batchers over the same stand-in engine), the
continuous loop on the port's engine, and the ``repro_torch.launch.serve``
launcher. fp32 rtol = atol = 2e-4, never bitwise.
"""
import json
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest

import repro.configs as jconfigs
import repro.serve as jserve
import repro.serve.batcher as jbatcher
import repro_torch.configs as tconfigs
import repro_torch.serve as tserve
import repro_torch.serve.batcher as tbatcher
from repro.graph.executor import init_graph_params as j_init
from repro_torch.common import params_from_numpy
from repro_torch.data.features import make_recsys_feeds
from repro_torch.launch import serve as launcher
from repro_torch.serve.profile import PHASES

TOL = dict(rtol=2e-4, atol=2e-4)
SCENARIOS = ("din", "deepfm", "fm", "dlrm-mlperf")
FIELDS = dict(batch__max_batch=64, batch__min_bucket=16,
              batch__linger_ms=20.0, batch__max_coalesce=4)


def _ref_plan(preset="paper", **kw):
    return jserve.ServePlan.preset(preset).evolve(batch__hedging=False,
                                                  **FIELDS, **kw)


def _plan(preset="paper", **kw):
    return tserve.ServePlan.preset(preset).evolve(**FIELDS, **kw)


@pytest.fixture(scope="module")
def problems():
    """Per scenario: the reference's smoke graph and params, the port's
    smoke graph, and the params carried across as numpy."""
    out = {}
    for sc in SCENARIOS:
        jg = jconfigs.get_config(sc).smoke_build()()[0]
        jp = j_init(jg, jax.random.PRNGKey(0))
        tg = tconfigs.get_config(sc).smoke_build()()[0]
        out[sc] = (jg, jp, tg, jax.tree_util.tree_map(np.asarray, jp))
    return out


def _service(problems, plan=None, **kw):
    svc = tserve.RankingService(plan if plan is not None else _plan(),
                                device="cpu", **kw)
    for sc in SCENARIOS:
        _, _, tg, np_params = problems[sc]
        svc.register(sc, graph=tg, params=params_from_numpy(np_params, "cpu"))
    return svc


def _stream(svc, n, uid=lambda r: r % 2, seed=100):
    """Round-robin over the scenarios; the SAME user ids in every scenario,
    so only the per-scenario key scope keeps the cache entries apart."""
    rng = np.random.default_rng(seed)
    items = []
    for r in range(n):
        sc = SCENARIOS[r % len(SCENARIOS)]
        uf, cf = svc.split_feeds(sc, make_recsys_feeds(svc.source_graph(sc),
                                                       7 + r, rng))
        items.append((sc, tserve.ServeRequest(uid(r), uf, cf)))
    return items


# -- RankingService against the reference engines ---------------------------

@pytest.mark.parametrize("preset", ["paper", "tpu"])
def test_service_matches_reference_engines(problems, preset):
    with _service(problems, _plan(preset)) as svc:
        assert svc.scenarios == sorted(SCENARIOS)
        items = _stream(svc, 12)
        results = svc.score_many(items)
        again = [svc.score(sc, req) for sc, req in items]    # cached users
        refs = {sc: jserve.ServingEngine(problems[sc][0], problems[sc][1],
                                         _ref_plan(preset))
                for sc in SCENARIOS}
        for (sc, req), res, res2 in zip(items, results, again):
            want = refs[sc].score(jserve.ServeRequest(
                req.user_id, req.user_feeds, req.candidate_feeds)).scores
            assert res.scores.shape == want.shape
            np.testing.assert_allclose(res.scores, want, **TOL,
                                       err_msg=f"{sc} vs the reference")
            np.testing.assert_allclose(res2.scores, res.scores, **TOL)
        for sc in SCENARIOS:
            assert ([r.dense for r in svc.engine(sc).conversion.rewrites]
                    == [r.dense for r in refs[sc].conversion.rewrites])
            refs[sc].close()
        stats = svc.stats()["scenarios"]
        assert all(v["stage2_calls"] >= 1 and v["requests"] == 6
                   for v in stats.values())


def test_registry_registration_matches_standalone_engine():
    """Register by name: the registry's smoke build with params drawn from
    the service seed, scoring as a standalone engine built the same way."""
    from repro_torch.graph.executor import init_graph_params
    with tserve.RankingService(_plan(), smoke=True, seed=3,
                               device="cpu") as svc:
        svc.register("dlrm-mlperf")
        graph = tconfigs.get_config("dlrm-mlperf").smoke_build()()[0]
        ref = tserve.ServingEngine(graph, init_graph_params(graph, seed=3,
                                                            device="cpu"),
                                   _plan(), device="cpu")
        rng = np.random.default_rng(1)
        for uid in range(3):
            uf, cf = svc.split_feeds("dlrm-mlperf", make_recsys_feeds(
                graph, 20 + uid, rng))
            req = tserve.ServeRequest(uid, uf, cf)
            np.testing.assert_allclose(svc.score("dlrm-mlperf", req).scores,
                                       ref.score(req).scores, **TOL)


def test_shared_cache_is_scoped_per_scenario(problems):
    with _service(problems, shared_cache_users=16) as svc:
        svc.score_many(_stream(svc, 8, uid=lambda r: r // 4))
        keys = svc.shared_cache.keys()
        assert {uid[0] for uid, _ in keys} == set(SCENARIOS)
        assert len(keys) == 8                     # 4 scenarios x 2 users
        svc.engine("din").invalidate_user(0)      # touches din only
        assert len(svc.shared_cache) == 7
        assert ("din", 0) not in {uid for uid, _ in svc.shared_cache.keys()}
        assert ("fm", 0) in {uid for uid, _ in svc.shared_cache.keys()}


def test_shared_budget_and_evictions_match_reference(problems):
    """ONE LRU budget spans the scenarios. Each scoped user arrives once,
    so the counts do not depend on how the batcher threads interleave;
    the reference service on the same stream counts the same."""
    budget = 3
    with _service(problems, shared_cache_users=budget) as svc:
        items = _stream(svc, 8, uid=lambda r: r // 4)     # 8 distinct keys
        svc.score_many(items)
        ours = svc.stats()["shared_cache"]
    with jserve.RankingService(_ref_plan(), shared_cache_users=budget) as ref:
        for sc in SCENARIOS:
            ref.register(sc, graph=problems[sc][0], params=problems[sc][1])
        ref.score_many([(sc, jserve.ServeRequest(r.user_id, r.user_feeds,
                                                 r.candidate_feeds))
                        for sc, r in items])
        theirs = ref.stats()["shared_cache"]
    for field in ("users", "max_users", "hits", "misses", "evictions"):
        assert ours[field] == theirs[field], field
    assert (ours["users"], ours["evictions"], ours["misses"]) == (3, 5, 8)


def test_register_and_lifecycle_errors(problems):
    svc = _service(problems)
    with pytest.raises(ValueError, match="already registered"):
        svc.register("din", graph=problems["din"][2],
                     params=params_from_numpy(problems["din"][3], "cpu"))
    with pytest.raises(ValueError, match="together"):
        svc.register("din2", graph=problems["din"][2])
    with pytest.raises(KeyError, match="not registered"):
        svc.score("paper-ranking", None)
    with pytest.raises(KeyError, match="not ported yet"):
        svc.register("qwen3-14b")
    assert "fm" in svc and "paper-ranking" not in svc
    assert list(svc) == sorted(SCENARIOS)
    sc, req = _stream(svc, 1)[0]
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.register("paper-ranking")
    with pytest.raises(RuntimeError, match="not running"):
        svc.submit(sc, req)


def test_per_scenario_plan_override(problems):
    jg, _, tg, np_params = problems["fm"]
    with tserve.RankingService(_plan(), device="cpu") as svc:
        svc.register("fm", graph=tg, params=params_from_numpy(np_params,
                                                               "cpu"),
                     plan=_plan().evolve(graph__mode="vani"))
        svc.register("fm-mari", graph=tg,
                     params=params_from_numpy(np_params, "cpu"))
        assert svc.engine("fm").mode == "vani"
        assert svc.engine("fm-mari").mode == "mari"
        uf, cf = svc.split_feeds("fm", make_recsys_feeds(
            tg, 9, np.random.default_rng(0)))
        req = tserve.ServeRequest(0, uf, cf)
        a, b = svc.score_many([("fm", req), ("fm-mari", req)])
        np.testing.assert_allclose(a.scores, b.scores, **TOL)


def test_stats_expose_profile_latency_and_cache_bytes(problems):
    with _service(problems) as svc:
        svc.score_many(_stream(svc, 4))
        st = svc.stats()
        for sc in SCENARIOS:
            s = st["scenarios"][sc]
            assert s["preset"] is None and s["mode"] == "mari"
            assert set(s["profile"]) == set(PHASES)
            assert s["profile"]["pack"]["calls"] >= 1
            assert s["queue_wait_ms"] >= 0.0
            assert s["latency"]["request_ms"]["count"] == 1
        cache = st["shared_cache"]
        assert cache["bytes"] > 0
        boundary = set().union(*(svc.engine(sc).split.boundary
                                 for sc in SCENARIOS))
        assert set(cache["boundary_bytes"]) == boundary


# -- the batcher's framework-free contracts, on both packages ---------------

IMPLS = {"reference": (jbatcher, jserve), "port": (tbatcher, tserve)}


class _GatedEngine:
    """Engine stand-in: the FIRST group blocks on a gate so submissions
    pile up behind it; the order and size of every scored request are
    recorded."""
    max_batch = 1 << 30

    def __init__(self, serve_mod):
        self.result_cls = serve_mod.ServeResult
        self.groups: list[list[int]] = []
        self.scored = []
        self.gate = threading.Event()
        self.first_group = threading.Event()

    def score_coalesced(self, reqs):
        hold = not self.first_group.is_set()
        self.first_group.set()
        self.groups.append([r.user_id for r in reqs])
        self.scored.extend(reqs)
        if hold:
            self.gate.wait(timeout=30)
        return [self.result_cls(
            scores=np.zeros((next(iter(r.candidate_feeds.values())).shape[0],
                             1)), latency_ms=0.0, n_batches=1,
            user_cache_hit=False) for r in reqs]


def _tiny(serve_mod, uid, n=8):
    return serve_mod.ServeRequest(uid, {}, {"x": np.zeros((n, 2),
                                                          np.float32)})


@pytest.fixture(params=list(IMPLS))
def impl(request):
    return IMPLS[request.param]


def _held(impl, **kw):
    bmod, smod = impl
    spy = _GatedEngine(smod)
    b = bmod.CoalescingBatcher(spy, linger_ms=0.0, max_coalesce=1, **kw)
    blocker = b.submit(_tiny(smod, 999))
    assert spy.first_group.wait(timeout=30)   # worker now held mid-group
    return spy, b, blocker


def test_admission_sheds_best_effort_fast_and_typed(impl):
    bmod, smod = impl
    spy, b, blocker = _held(impl, admission=True, shed_queue_depth=2)
    try:
        filler = [b.submit(_tiny(smod, u)) for u in range(2)]
        t0 = time.perf_counter()
        shed = b.submit(_tiny(smod, 50))
        assert shed.done() and time.perf_counter() - t0 < 1.0
        with pytest.raises(smod.AdmissionError) as ei:
            shed.result(timeout=1)
        assert ei.value.slo == "best_effort" and ei.value.queue_depth >= 2
        dl = [b.submit(_tiny(smod, 70 + i), slo="deadline") for i in range(2)]
        spy.gate.set()
        for f in [blocker] + filler + dl:
            f.result(timeout=30)
    finally:
        spy.gate.set()
        b.close()
    assert (b.shed_requests, b.shed_best_effort, b.shed_deadline) == (1, 1, 0)
    scored = [r.user_id for r in spy.scored]
    assert 50 not in scored and {70, 71} <= set(scored)


def test_admission_sheds_infeasible_deadline(impl):
    bmod, smod = impl
    spy = _GatedEngine(smod)
    spy.first_group.set()
    with bmod.CoalescingBatcher(spy, linger_ms=0.0, admission=True,
                                deadline_headroom_ms=5.0) as b:
        with pytest.raises(smod.AdmissionError, match="headroom"):
            b.submit(_tiny(smod, 1), deadline_ms=2.0).result(timeout=1)
        b.submit(_tiny(smod, 2), deadline_ms=50.0).result(timeout=30)
    assert (b.shed_deadline, b.shed_best_effort) == (1, 0)


def test_admission_degrades_best_effort_only(impl):
    bmod, smod = impl
    spy, b, blocker = _held(impl, admission=True, degrade_queue_depth=1,
                            degrade_frac=0.5)
    try:
        filler = b.submit(_tiny(smod, 1))
        deg = b.submit(_tiny(smod, 2, n=9))
        dl = b.submit(_tiny(smod, 3, n=8), slo="deadline")
        spy.gate.set()
        res = deg.result(timeout=30)
        assert res.degraded is True and res.scores.shape[0] == 5   # ceil(4.5)
        assert dl.result(timeout=30).degraded is False
        for f in (blocker, filler):
            f.result(timeout=30)
    finally:
        spy.gate.set()
        b.close()
    assert b.degraded_requests == 1
    rows = {r.user_id: r.candidate_feeds["x"].shape[0] for r in spy.scored}
    assert rows[2] == 5 and rows[3] == 8


def test_admission_off_never_sheds(impl):
    bmod, smod = impl
    spy, b, blocker = _held(impl, shed_queue_depth=1, degrade_queue_depth=1)
    try:
        futs = [b.submit(_tiny(smod, u)) for u in range(4)]
        spy.gate.set()
        for f in [blocker] + futs:
            assert f.result(timeout=30).degraded is False
    finally:
        spy.gate.set()
        b.close()
    assert b.shed_requests == 0 and b.degraded_requests == 0


def test_deadline_request_jumps_queued_best_effort(impl):
    bmod, smod = impl
    spy, b, blocker = _held(impl)
    try:
        futs = [b.submit(_tiny(smod, u)) for u in (1, 2, 3)]
        futs.append(b.submit(_tiny(smod, 9), slo="deadline"))
        spy.gate.set()
        for f in [blocker] + futs:
            f.result(timeout=30)
    finally:
        spy.gate.set()
        b.close()
    assert spy.groups == [[999], [9], [1], [2], [3]]
    assert (b.requests, b.deadline_requests, b.batches) == (5, 1, 5)


def test_linger_shrinks_for_deadline_class(impl):
    bmod, smod = impl
    b = bmod.CoalescingBatcher(_GatedEngine(smod), linger_ms=100.0,
                               auto_start=False)
    now = time.perf_counter()
    dl = bmod._PRIO[bmod.SLO_DEADLINE]
    assert b._linger_until(bmod._Item(prio=dl, seq=1), now) - now == \
        pytest.approx(0.1 * b.deadline_linger_frac, rel=1e-6)
    it = bmod._Item(prio=dl, seq=2, deadline_at=now + 0.001)
    assert b._linger_until(it, now) - now == pytest.approx(0.001, rel=1e-6)
    it = bmod._Item(prio=bmod._PRIO[bmod.SLO_BEST_EFFORT], seq=3)
    assert b._linger_until(it, now) - now == pytest.approx(0.1, rel=1e-6)
    with pytest.raises(RuntimeError, match="not running"):
        b.submit(_tiny(smod, 0))


def test_bad_slo_rejected(impl):
    bmod, smod = impl
    spy = _GatedEngine(smod)
    spy.first_group.set()
    with bmod.CoalescingBatcher(spy, linger_ms=0.0) as b:
        with pytest.raises(ValueError, match="SLO"):
            b.submit(_tiny(smod, 0), slo="gold-plated")


def test_close_under_load_leaves_nothing_hanging(impl):
    bmod, smod = impl
    spy, b, blocker = _held(impl)
    futs = [b.submit(_tiny(smod, u)) for u in range(1, 8)]
    closer = threading.Thread(target=b.close)
    closer.start()
    time.sleep(0.05)
    spy.gate.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    for f in [blocker] + futs:
        assert f.result(timeout=5) is not None
    assert len(spy.scored) == 8


def test_stranded_future_fails_typed(impl):
    bmod, smod = impl
    b = bmod.CoalescingBatcher(_GatedEngine(smod), auto_start=False)
    fut = Future()
    b._q.put(bmod._Item(prio=1, seq=b._next_seq(), req=_tiny(smod, 1),
                        fut=fut, submitted_at=time.perf_counter()))
    b.close()
    with pytest.raises(smod.BatcherClosedError):
        fut.result(timeout=1)


def test_from_plan_wires_the_batch_section():
    fields = dict(batch__linger_ms=3.5, batch__max_coalesce=7,
                  batch__deadline_linger_frac=0.5, batch__continuous=False,
                  batch__max_inflight=3, batch__admission=True,
                  batch__shed_queue_depth=9, batch__degrade_queue_depth=4,
                  batch__degrade_frac=0.25, batch__deadline_headroom_ms=1.5)
    spy = _GatedEngine(tserve)
    ours = tbatcher.CoalescingBatcher.from_plan(
        spy, tserve.ServePlan().evolve(**fields).batch, auto_start=False)
    theirs = jbatcher.CoalescingBatcher.from_plan(
        spy, jserve.ServePlan().evolve(**fields).batch, auto_start=False)
    for key in fields:
        name = key.split("__")[1]
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.retries == theirs.retries == 0


# -- retries through RetryPolicy, on both packages ---------------------------

class _FlakyEngine:
    """Engine stand-in: the first ``fail_calls`` scoring calls raise, then
    every request scores ``user_id`` on each row. ``two_phase`` adds
    ``begin_coalesced`` / ``collect`` so the continuous loop drives it, and
    the failure surfaces at collect."""
    max_batch = 1 << 30

    def __init__(self, serve_mod, fail_calls=0, exc=None, two_phase=False):
        self.result_cls = serve_mod.ServeResult
        self.fail_calls = fail_calls
        self.exc = exc if exc is not None else RuntimeError("boom")
        self.calls: list[int] = []
        if two_phase:
            self.begin_coalesced = lambda reqs: reqs
            self.collect = self.score_coalesced

    def score_coalesced(self, reqs):
        self.calls.append(len(reqs))
        if len(self.calls) <= self.fail_calls:
            raise self.exc
        return [self.result_cls(
            scores=np.full((next(iter(r.candidate_feeds.values())).shape[0],
                            1), float(r.user_id)),
            latency_ms=0.0, n_batches=1, user_cache_hit=False) for r in reqs]


@pytest.mark.parametrize("two_phase", [False, True])
def test_retry_recovers_transient_failure(impl, two_phase):
    bmod, smod = impl
    eng = _FlakyEngine(smod, fail_calls=1, two_phase=two_phase)
    with bmod.CoalescingBatcher(eng, linger_ms=0.5, continuous=two_phase,
                                retries=2, retry_backoff_ms=0.1,
                                retry_jitter=0.0) as b:
        res = b.submit(_tiny(smod, 7)).result(timeout=10)
    assert float(res.scores[0, 0]) == 7.0
    assert (b.retries_attempted, b.retries_exhausted) == (1, 0)
    assert eng.calls == [1, 1]                 # the group, then the retry


def test_retry_exhausted_is_typed_with_cause(impl):
    bmod, smod = impl
    eng = _FlakyEngine(smod, fail_calls=100)
    with bmod.CoalescingBatcher(eng, linger_ms=0.5, continuous=False,
                                retries=2, retry_backoff_ms=0.1,
                                retry_jitter=0.0) as b:
        with pytest.raises(smod.RetryExhausted) as ei:
            b.submit(_tiny(smod, 1)).result(timeout=10)
    assert ei.value.attempts == 2 and b.retries_exhausted == 1
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert eng.calls == [1, 1, 1]


def test_retry_respects_deadline_budget(impl):
    bmod, smod = impl
    eng = _FlakyEngine(smod, fail_calls=100)
    with bmod.CoalescingBatcher(eng, linger_ms=0.0, continuous=False,
                                retries=5, retry_backoff_ms=200.0,
                                retry_jitter=0.0) as b:
        t0 = time.perf_counter()
        with pytest.raises(smod.RetryExhausted) as ei:
            b.submit(_tiny(smod, 1), deadline_ms=20.0).result(timeout=10)
        elapsed = time.perf_counter() - t0
    # the first 200 ms backoff already overruns the 20 ms budget
    assert ei.value.attempts == 0 and elapsed < 1.0
    assert eng.calls == [1]


@pytest.mark.parametrize("refusal", ["none", "admission"])
def test_unretried_failures_keep_their_error(impl, refusal):
    """With retries off the original error reaches the waiter; a typed
    refusal is never retried even with retries on."""
    bmod, smod = impl
    if refusal == "none":
        exc, retries, want = RuntimeError("boom"), 0, RuntimeError
    else:
        exc = smod.AdmissionError("no", slo="best_effort", queue_depth=0)
        retries, want = 3, smod.AdmissionError
    eng = _FlakyEngine(smod, fail_calls=100, exc=exc)
    with bmod.CoalescingBatcher(eng, linger_ms=0.5, continuous=False,
                                retries=retries, retry_backoff_ms=0.1) as b:
        with pytest.raises(want):
            b.submit(_tiny(smod, 1)).result(timeout=10)
    assert b.retries_attempted == 0 and eng.calls == [1]


def test_retry_policy_schedule_matches_reference():
    import random

    from repro.ft.recovery import RetryPolicy as JPolicy
    from repro_torch.ft.recovery import RetryPolicy as TPolicy
    for kw in (dict(retries=3, backoff_ms=2.0, jitter=0.0),
               dict(retries=4, backoff_ms=10.0, jitter=0.5)):
        ours, theirs = TPolicy(**kw), JPolicy(**kw)
        r1, r2 = random.Random(0), random.Random(0)
        assert ([ours.backoff_s(a, rng=r1) for a in range(6)]
                == [theirs.backoff_s(a, rng=r2) for a in range(6)])
    assert TPolicy(backoff_ms=2.0, jitter=0.0).backoff_s(2) == 0.008


# -- the continuous loop on the port's engine -------------------------------

def _dlrm_requests(tg, n_req, rng):
    user_in = {n.name for n in tg.input_nodes()
               if n.attrs.get("domain") == "user"}
    out = []
    for i in range(n_req):
        feeds = make_recsys_feeds(tg, 6 + 3 * (i % 4), rng)
        uid = i % 3 if i % 2 == 0 else 100 + i    # hot trio + cold tail
        out.append(tserve.ServeRequest(
            uid, {k: v for k, v in feeds.items() if k in user_in},
            {k: v for k, v in feeds.items() if k not in user_in}))
    return out


def test_continuous_loop_matches_lockstep_and_per_request(problems):
    _, _, tg, np_params = problems["dlrm-mlperf"]
    params = params_from_numpy(np_params, "cpu")
    reqs = _dlrm_requests(tg, 12, np.random.default_rng(4))
    ref_eng = tserve.ServingEngine(tg, params, _plan("tpu"), device="cpu")
    ref = [ref_eng.score(r).scores for r in reqs]   # same cache semantics
    counts = {}
    for continuous in (False, True):
        eng = tserve.ServingEngine(tg, params, _plan("tpu"), device="cpu")
        with tbatcher.CoalescingBatcher(eng, linger_ms=2000.0,
                                        max_coalesce=4,
                                        continuous=continuous,
                                        max_inflight=2) as b:
            out = b.score_many(reqs)
        for want, got in zip(ref, out):
            np.testing.assert_allclose(got.scores, want, **TOL)
        assert all(r.coalesced for r in out)
        counts[continuous] = (b.requests, b.batches, b.coalesced_requests)
        assert eng._inflight == []
    # groups close at max_coalesce, never on the (long) linger
    assert counts[False] == counts[True] == (12, 3, 12)


def test_loop_profiler_phases_and_latency_histograms(problems):
    _, _, tg, np_params = problems["dlrm-mlperf"]
    eng = tserve.ServingEngine(tg, params_from_numpy(np_params, "cpu"),
                               _plan(), device="cpu")
    with tbatcher.CoalescingBatcher(eng, linger_ms=0.0) as b:
        futs = [b.submit(r) for r in
                _dlrm_requests(tg, 8, np.random.default_rng(5))]
        for f in futs:
            f.result(timeout=120)
        time.sleep(0.12)                        # an idle tick or two
    snap = eng.profiler.snapshot()
    assert snap["queue_idle"]["calls"] >= 1 and "overlap" in snap
    assert b.request_latency.snapshot()["count"] == 8
    assert b.queue_wait.snapshot()["count"] == 8
    assert b.metrics.snapshot()["requests"] == 8


# -- the launcher -----------------------------------------------------------

def test_launcher_serves_three_scenarios_on_cpu(capsys):
    launcher.main(["--scenario", "dlrm-mlperf,deepfm,fm,fm", "--requests",
                   "6", "--candidates", "40", "--max-batch", "32",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "scenarios=deepfm,dlrm-mlperf,fm" in out
    for sc in ("dlrm-mlperf", "deepfm", "fm"):
        assert f"scenario={sc} n=2 " in out
    assert "shared_cache users=" in out


@pytest.mark.parametrize("arch,rewrites", [("dlrm-mlperf", "['top_mlp_0']"),
                                           ("deepfm", "['deep_mlp_0']"),
                                           ("fm", "[]")])
def test_launcher_single_arch_tpu_preset(capsys, arch, rewrites):
    launcher.main(["--arch", arch, "--preset", "tpu", "--requests", "3",
                   "--candidates", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"MaRI rewrote: {rewrites}" in out
    assert f"arch={arch} mode=mari n=1 " in out


def test_launcher_dump_plan_round_trips(tmp_path):
    path = tmp_path / "plan.json"
    launcher.main(["--preset", "tpu", "--dump-plan", str(path),
                   "--requests", "0"])
    assert tserve.ServePlan.load(str(path)) == tserve.ServePlan.preset("tpu")
    # every dumped field equals the reference preset's, both as JSON (the
    # ft section's tuple of sites is a list there)
    theirs = json.loads(jserve.ServePlan.preset("tpu").to_json())
    for section, fields in json.loads(path.read_text()).items():
        for name, value in fields.items():
            assert theirs[section][name] == value, (section, name)
    over = tmp_path / "over.json"
    launcher.main(["--plan", str(path), "--mode", "uoi", "--max-batch", "256",
                   "--no-continuous", "--no-use-pallas", "--dump-plan",
                   str(over), "--requests", "0"])
    plan = tserve.ServePlan.load(str(over))
    assert (plan.graph.mode, plan.batch.max_batch, plan.batch.continuous,
            plan.kernel.use_pallas) == ("uoi", 256, False, False)
    with pytest.raises(SystemExit):
        launcher.main(["--plan", str(path), "--preset", "tpu"])


@pytest.mark.parametrize("flag", [["--cold-tier"], ["--no-cold-tier"]])
def test_launcher_refuses_unported_flags(flag, tmp_path):
    """``--cold-tier`` is ported (the memory tier): it maps onto
    ``mem.cold_tier`` as the reference's does. The shard section's knobs
    stay unported, and a flag for them is refused."""
    path = tmp_path / "plan.json"
    launcher.main(flag + ["--dump-plan", str(path), "--requests", "0"])
    assert tserve.ServePlan.load(str(path)).mem.cold_tier is (
        flag[0] == "--cold-tier")
    with pytest.raises(SystemExit):
        launcher.main(flag + ["--shard-candidates", "--requests", "0"])


def test_launcher_defaults_to_cuda():
    with pytest.raises(RuntimeError, match="is_available"):
        launcher.main(["--arch", "fm", "--requests", "1", "--candidates",
                       "4"])
