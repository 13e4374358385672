"""The port's fault tolerance and hedging on the CPU, held against the JAX
reference: fault specs parsed and pokes fired the same for the same seed
(``ft/faults.py``), the same ``CircuitBreaker`` walks, ``HedgedRunner``'s
pool exhaustion (from tests/test_ft_recovery.py), the plan's ``hedging`` /
device-tier / ``ft`` resolution rows giving the same resolved fields and
warnings as the reference's ``ServePlan``, the port's presets equal to the
reference's, and the engine's self-healing (quarantine, breaker, detected
corruption, retries through the batcher, a crashed worker loop) against
the reference's per-request ``score()`` at fp32 rtol = atol = 2e-4.
"""
import dataclasses
import threading
import time
import warnings

import jax
import numpy as np
import pytest

import repro.ft.faults as jfaults
import repro.ft.recovery as jrec
import repro.serve as jserve
import repro.serve.hedging as jhedge
import repro_torch.ft.faults as tfaults
import repro_torch.ft.recovery as trec
import repro_torch.serve as tserve
import repro_torch.serve.hedging as thedge
from repro.graph.executor import init_graph_params
from repro.models.ranking import PaperRankingConfig as JPaperCfg
from repro.models.ranking import build_paper_ranking_model as j_paper
from repro_torch.common import params_from_numpy
from repro_torch.models.ranking import PaperRankingConfig as TPaperCfg
from repro_torch.models.ranking import build_paper_ranking_model as t_paper
from repro_torch.serve.errors import (CircuitOpenError, FaultInjected,
                                      RetryExhausted, WorkerCrashedError)

TOL = dict(rtol=2e-4, atol=2e-4)


# -- fault specs and the injector -------------------------------------------

GOOD_SPECS = ["stage2_dispatch:error:after=10,count=3",
              "transfer_copy:delay:delay_ms=25", "collect:corrupt:p=0.5",
              "slot_write:error", "slot_write:error:count=4",
              "table_fork:corrupt:count=1,after=2", "worker_loop:error",
              "spmd_heartbeat:delay", "stage1:error:p=0.25,count=2",
              "pack:corrupt"]
BAD_SPECS = ["nope:error", "stage1:explode", "stage1:error:p=0",
             "stage1:error:count=0", "stage1:error:after=-1",
             "stage1:error:delay_ms=5", "stage1:error:count",
             "stage1:error:zap=1", "", "stage1:error:p=1.5"]


def test_sites_and_kinds_are_the_reference_ones():
    assert tfaults.SITES == jfaults.SITES and len(tfaults.SITES) == 9
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults.CORRUPT == jfaults.CORRUPT


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_specs_parse_as_in_the_reference(spec):
    ours, ref = tfaults.parse_fault_spec(spec), jfaults.parse_fault_spec(spec)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.describe() == ref.describe()
    assert tfaults.parse_fault_spec(ours.describe()) == ours


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_rejected_as_in_the_reference(spec):
    with pytest.raises(ValueError):
        jfaults.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        tfaults.parse_fault_spec(spec)


def _fire_log(mod, error_cls, specs, seed, pokes, arm_at=0):
    inj = mod.FaultInjector(specs, seed=seed)
    inj.set_armed(arm_at == 0)
    out = []
    for i, site in enumerate(pokes):
        if i == arm_at:
            inj.set_armed(True)
        try:
            out.append(inj.poke(site))
        except error_cls as e:
            out.append(("error", e.site))
    return out, inj.stats()


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_injector_fires_on_the_same_pokes(seed):
    """Same seed, same pokes: the same pokes fire in both packages — count
    and after bounds, probabilistic per-site streams, several specs on
    one site, disarmed pokes advancing nothing."""
    specs = ("stage1:error:after=2,count=2", "pack:corrupt:p=0.5",
             "collect:corrupt:p=0.3,count=5", "collect:error:p=0.2",
             "transfer_copy:delay:delay_ms=0", "slot_write:error:count=3")
    rng = np.random.default_rng(seed)
    sites = list(tfaults.SITES)
    pokes = [sites[i] for i in rng.integers(0, len(sites), 400)]
    for arm_at in (0, 50):
        ours = _fire_log(tfaults, FaultInjected, specs, seed, pokes, arm_at)
        ref = _fire_log(jfaults, jserve.FaultInjected, specs, seed, pokes,
                        arm_at)
        assert ours == ref
        assert ours[1]["total_fired"] > 0


# -- circuit breaker and hedging --------------------------------------------

def _walk(mod, script):
    t = [0.0]
    seen = []
    br = mod.CircuitBreaker(failures=2, cooldown_ms=100.0, probes=2,
                            clock=lambda: t[0],
                            on_transition=lambda a, b: seen.append((a, b)))
    states = []
    for op, arg in script:
        if op == "t":
            t[0] = arg
        elif op == "fail":
            br.record_failure()
        elif op == "ok":
            br.record_success()
        states.append((br.state, br.allow()))
    return states, seen, br.stats()


@pytest.mark.parametrize("script", [
    # the reference's full walk: closed -> open -> half-open -> closed
    [("fail", 0), ("fail", 0), ("t", 0.05), ("t", 0.11), ("ok", 0),
     ("ok", 0)],
    # a half-open failure re-opens, the cooldown restarts
    [("fail", 0), ("fail", 0), ("t", 0.2), ("fail", 0), ("t", 0.25),
     ("t", 0.31), ("ok", 0), ("fail", 0), ("t", 0.5), ("ok", 0),
     ("ok", 0)],
    # a success resets the consecutive count; failures while open extend
    [("fail", 0), ("ok", 0), ("fail", 0), ("fail", 0), ("t", 0.09),
     ("fail", 0), ("t", 0.15), ("t", 0.2)],
])
def test_breaker_walks_as_in_the_reference(script):
    assert _walk(trec, script) == _walk(jrec, script)


def test_breaker_call_raises_typed_while_open():
    t = [0.0]
    br = trec.CircuitBreaker(failures=1, cooldown_ms=1000.0,
                             clock=lambda: t[0])
    with pytest.raises(RuntimeError):
        br.call(lambda: (_ for _ in ()).throw(RuntimeError("x")))
    assert br.state == trec.OPEN
    with pytest.raises(CircuitOpenError):
        br.call(lambda: 1)
    t[0] = 2.0
    assert br.call(lambda: 41) == 41 and br.state == trec.CLOSED
    for kw in (dict(failures=0), dict(cooldown_ms=-1), dict(probes=0)):
        with pytest.raises(ValueError):
            trec.CircuitBreaker(**kw)


def test_hedge_policy_deadlines_match_reference():
    for mod_pair in ((thedge, jhedge),):
        ours, ref = (m.HedgePolicy(quantile=0.9, window=32, min_hedge_ms=2.0)
                     for m in mod_pair)
        for i in range(40):
            assert ours.hedge_deadline_ms() == ref.hedge_deadline_ms()
            for p in (ours, ref):
                p.observe(float((i * 7) % 13))
        assert ours.should_hedge(12.0) == ref.should_hedge(12.0)


def test_hedging_pool_exhaustion_runs_inline():
    r = thedge.HedgedRunner(lambda x: x * 2, max_workers=1)
    with r._olock:
        r._outstanding = 1             # a zombie-held worker
    out, outcome = r.run(21)
    assert out == 42 and not outcome.hedged and r.pool_exhausted == 1
    with r._olock:
        r._outstanding = 0
    out, _ = r.run(5)                  # slot free again: normal path
    assert out == 10 and r.pool_exhausted == 1
    r.close()


def test_hedging_no_duplicate_when_pool_full_awaits_primary():
    r = thedge.HedgedRunner(lambda: (time.sleep(0.05), 7)[1],
                            policy=thedge.HedgePolicy(min_hedge_ms=0.1),
                            max_workers=1)
    out, outcome = r.run()
    assert out == 7 and not outcome.hedged
    assert r.hedges_launched == 0 and r.pool_exhausted == 1
    r.close()


def test_hedging_first_result_wins_and_loser_keeps_its_inputs():
    """The primary straggles, the duplicate wins; the abandoned primary
    still finishes with the inputs it was handed."""
    calls, seen = [], []
    gate = threading.Event()

    def fn(box):
        calls.append(threading.current_thread().name)
        if len(calls) == 1:
            gate.wait(5)               # the primary straggles
        seen.append(list(box))
        return sum(box)

    r = thedge.HedgedRunner(fn, thedge.HedgePolicy(min_hedge_ms=0.1))
    out, outcome = r.run([1, 2, 3])
    assert out == 6 and outcome.hedged and outcome.winner == "hedge"
    gate.set()
    for _ in range(100):
        if len(seen) == 2:
            break
        time.sleep(0.01)
    assert seen == [[1, 2, 3], [1, 2, 3]] and r.hedge_wins == 1
    r.close()


# -- the plan: resolution rows and presets ----------------------------------

PLAN_CASES = [
    {"cache": {"device_resident": True}},
    {"cache": {"device_resident": True}, "batch": {"hedging": False}},
    {"cache": {"device_resident": True, "cache_user_reps": False}},
    {"cache": {"device_slots": 8}},
    {"cache": {"device_resident": True, "device_slots": 3}},
    {"ft": {"sites": ["stage1:error"]}},
    {"ft": {"seed": 4}},
    {"ft": {"inject": True, "sites": ["slot_write:error:count=1"],
            "seed": 2}},
    {"ft": {"retry_backoff_ms": 3.0}},
    {"ft": {"retries": 2, "retry_jitter": 0.1}},
    {"ft": {"breaker_failures": 3}},
    {"ft": {"breaker_failures": 3}, "cache": {"device_resident": True}},
    {"ft": {"breaker_cooldown_ms": 5.0, "breaker_probes": 2}},
    {"ft": {"breaker_failures": 2, "breaker_probes": 2},
     "cache": {"device_resident": True}},
    {"batch": {"hedging": False}, "kernel": {"kernel_gather": True}},
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_resolution_matches_reference(case):
    """The same fields resolve the same way, with one warning per
    resolution in both packages."""
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        ref = jserve.ServePlan.from_dict(case)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        ours = tserve.ServePlan.from_dict(case)
    theirs = ref.to_dict()
    for section, fields in ours.to_dict().items():
        for name, value in fields.items():
            assert theirs[section][name] == value, (section, name)
    assert len(ours.resolution_notes) == len(ref.resolution_notes)
    assert len(wt) == len(wj)
    assert all(issubclass(w.category, tserve.PlanResolutionWarning)
               for w in wt)


@pytest.mark.parametrize("bad", [
    {"ft": {"inject": True, "sites": ["stage1:explode"]}},
    {"ft": {"retries": -1}}, {"ft": {"retry_jitter": 1.5}},
    {"ft": {"breaker_probes": 0}}, {"ft": {"breaker_failures": -2}},
    {"ft": {"breaker_cooldown_ms": -1.0}}, {"cache": {"device_slots": 0}},
    {"ft": {"sites": "stage1:error"}}, {"batch": {"hedging": 1}},
    {"ft": {"zap": 1}},
])
def test_plan_rejections_match_reference(bad):
    with pytest.raises(jserve.PlanError):
        jserve.ServePlan.from_dict(bad)
    with pytest.raises(tserve.PlanError):
        tserve.ServePlan.from_dict(bad)


def test_plan_json_round_trip_with_ft():
    p = tserve.ServePlan().evolve(
        batch__hedging=False, cache__device_resident=True,
        cache__device_slots=8, ft__inject=True, ft__seed=7,
        ft__sites=("slot_write:error:count=2",), ft__retries=3,
        ft__breaker_failures=2)
    rt = tserve.ServePlan.from_json(p.to_json())
    assert rt == p and rt.ft.sites == ("slot_write:error:count=2",)


@pytest.mark.parametrize("name", ["paper", "vanilla", "uoi", "tpu"])
def test_presets_equal_the_reference_on_every_ported_section(name):
    ours = tserve.ServePlan.preset(name).to_dict()
    ref = jserve.ServePlan.preset(name).to_dict()
    assert set(ours) == set(ref) == {"graph", "kernel", "batch", "shard",
                                     "cache", "ft", "obs", "mem"}
    for section in ours:
        assert ours[section] == ref[section], section
    assert ours["batch"]["hedging"] is True


# -- the engine's self-healing ----------------------------------------------

@pytest.fixture(scope="module")
def paper():
    jg = j_paper(JPaperCfg().scaled(0.05))[0]
    tg = t_paper(TPaperCfg().scaled(0.05))[0]
    jp = init_graph_params(jg, jax.random.PRNGKey(0))
    return jg, tg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _pair(graph, uid, n, seed, version=0):
    rng = np.random.default_rng(seed)
    user, cand = {}, {}
    for node in graph.input_nodes():
        is_user = node.attrs["domain"] == "user"
        shape = (1 if is_user else n,) + tuple(node.attrs["shape"])
        (user if is_user else cand)[node.name] = rng.standard_normal(
            shape).astype(np.float32)
    return (jserve.ServeRequest(uid, user, cand, version),
            tserve.ServeRequest(uid, user, cand, version))


def _oracle(paper):
    jg, _, jp, _ = paper
    return jserve.ServingEngine(jg, jp, jserve.ServePlan().evolve(
        batch__max_batch=128, batch__hedging=False))


def _engine(paper, **over):
    _, tg, _, np_params = paper
    base = dict(batch__max_batch=128, cache__device_resident=True,
                cache__device_slots=8)
    base.update(over)
    return tserve.ServingEngine(tg, params_from_numpy(np_params, "cpu"),
                                tserve.ServePlan().evolve(**base),
                                device="cpu")


def test_quarantine_then_rebuild(paper):
    ref = _oracle(paper)
    eng = _engine(paper, ft__inject=True,
                  ft__sites=("slot_write:error:count=1",))
    for uid in (0, 1, 2, 0, 1, 2):
        jr, tr = _pair(paper[1], uid, 12, seed=uid)
        np.testing.assert_allclose(eng.score(tr).scores, ref.score(jr).scores,
                                   **TOL)
    st = eng.device_store.stats()
    assert st["quarantines"] == 1 and st["resident"] > 0
    ft = eng.ft_stats()
    assert ft["faults_fired"] == 1 and ft["quarantines"] == 1


def test_breaker_open_fallback_halfopen_close(paper):
    ref = _oracle(paper)
    eng = _engine(paper, ft__inject=True,
                  ft__sites=("slot_write:error:count=3",),
                  ft__breaker_failures=2, ft__breaker_cooldown_ms=40.0)
    seen = []
    eng.breaker._on_transition = lambda a, b: seen.append((a, b))
    clock = [0.0]                      # the breaker's clock, walked by hand
    eng.breaker._clock = lambda: clock[0]

    def score(uid):
        jr, tr = _pair(paper[1], uid, 12, seed=uid)
        np.testing.assert_allclose(eng.score(tr).scores, ref.score(jr).scores,
                                   **TOL)

    score(0)                           # fault 1 -> quarantine
    score(1)                           # fault 2 -> quarantine -> OPEN
    assert eng.breaker.state == trec.OPEN
    fb0 = eng.fallback_packs
    score(2)                           # open: the pack re-stacks
    assert eng.fallback_packs > fb0
    clock[0] = 0.06                    # past the 40 ms cooldown
    score(3)                           # half-open probe: fault 3 reopens
    assert eng.breaker.state == trec.OPEN
    clock[0] = 0.12
    score(4)                           # a clean probe closes it
    assert eng.breaker.state == trec.CLOSED
    assert (trec.CLOSED, trec.OPEN) in seen
    assert (trec.HALF_OPEN, trec.CLOSED) in seen
    assert eng.breaker.stats()["opens"] == 2


@pytest.mark.parametrize("site", ["collect:corrupt:count=1",
                                  "slot_write:corrupt:count=1",
                                  "transfer_copy:corrupt:count=1"])
def test_corruption_detected_never_served(paper, site):
    jr, tr = _pair(paper[1], 5, 12, seed=5)
    want = _oracle(paper).score(jr).scores
    eng = _engine(paper, ft__inject=True, ft__sites=(site,))
    with pytest.raises(FaultInjected, match="corrupt"):
        eng.score_coalesced([tr])
    assert eng.corruptions_detected == 1
    # the slot path quarantines: the poisoned row never serves again
    assert eng.ft_stats()["quarantines"] == 1
    np.testing.assert_allclose(eng.score_coalesced([tr])[0].scores, want,
                               **TOL)


def test_faults_at_engine_sites_fail_typed(paper):
    for site in ("stage1", "pack", "stage2_dispatch"):
        eng = _engine(paper, ft__inject=True,
                      ft__sites=(f"{site}:error:count=1",))
        _, tr = _pair(paper[1], 1, 12, seed=1)
        with pytest.raises(FaultInjected) as e:
            eng.score(tr)
        assert e.value.site == site
        assert eng.score(tr).scores.shape == (12, 2)


def test_retry_through_batcher_and_worker_crash(paper):
    """ft retries ride ``from_plan``: injected dispatch errors are retried
    to the reference's scores; a ``worker_loop`` fault crashes the loop,
    the supervisor retries its victim and respawns."""
    ref = _oracle(paper)
    pairs = [_pair(paper[1], u, 12, seed=u) for u in range(4)]
    want = [ref.score(j).scores for j, _ in pairs]
    plan = tserve.ServePlan().evolve(
        batch__max_batch=128, cache__device_resident=True,
        ft__inject=True, ft__sites=("stage2_dispatch:error:count=2",
                                    "worker_loop:error:count=1"),
        ft__retries=3, ft__retry_backoff_ms=0.5, ft__retry_jitter=0.0)
    _, tg, _, np_params = paper
    eng = tserve.ServingEngine(tg, params_from_numpy(np_params, "cpu"),
                               plan, device="cpu")
    with tserve.CoalescingBatcher.from_plan(eng, plan.batch, plan.ft) as b:
        assert b.retries == 3
        futs = [b.submit(t) for _, t in pairs]
        out = [f.result(timeout=60).scores for f in futs]
    for a, w in zip(out, want):
        np.testing.assert_allclose(a, w, **TOL)
    assert b.worker_crashes == 1 and b.retries_attempted >= 1
    assert eng.ft_stats()["faults_fired"] == 3


def test_retries_exhausted_is_typed(paper):
    plan = tserve.ServePlan().evolve(
        batch__max_batch=128, ft__inject=True,
        ft__sites=("stage2_dispatch:error",), ft__retries=1,
        ft__retry_backoff_ms=0.1)
    _, tg, _, np_params = paper
    eng = tserve.ServingEngine(tg, params_from_numpy(np_params, "cpu"),
                               plan, device="cpu")
    with tserve.CoalescingBatcher.from_plan(eng, plan.batch, plan.ft) as b:
        fut = b.submit(_pair(tg, 0, 8, seed=0)[1])
        with pytest.raises(RetryExhausted) as e:
            fut.result(timeout=60)
    assert isinstance(e.value.__cause__, FaultInjected)


def test_hedged_engine_matches_reference(paper):
    """Hedging on (the ``paper`` preset's default): a 0 ms floor hedges
    every dispatch at a seen shape; scores stay the reference's and
    ``ServeResult.hedged`` counts the duplicates."""
    ref = _oracle(paper)
    _, tg, _, np_params = paper
    eng = tserve.ServingEngine(
        tg, params_from_numpy(np_params, "cpu"),
        tserve.ServePlan().evolve(batch__max_batch=128), device="cpu",
        hedge_policy=thedge.HedgePolicy(min_hedge_ms=0.0))
    assert eng.hedging and not eng.device_resident
    pairs = [_pair(tg, u, 40 + u, seed=u) for u in range(3)]
    want = [ref.score(j).scores for j, _ in pairs]
    hedged = 0
    for _ in range(3):
        res = eng.score_coalesced([t for _, t in pairs])
        for r, w in zip(res, want):
            np.testing.assert_allclose(r.scores, w, **TOL)
        hedged += sum(r.hedged for r in res)
    assert hedged > 0 and eng.ft_stats()["hedges_launched"] > 0
    eng.close()


def test_device_tier_forces_hedging_off(paper):
    eng = _engine(paper)
    assert eng.device_resident and not eng.hedging
    assert eng.ft_stats()["device_store"]["capacity"] == 8


def test_service_reports_ft_counters_and_passes_ft(paper):
    _, tg, _, np_params = paper
    plan = tserve.ServePlan().evolve(
        batch__max_batch=128, cache__device_resident=True,
        cache__device_slots=4, ft__inject=True,
        ft__sites=("slot_write:error:count=1",), ft__retries=2,
        ft__breaker_failures=3)
    with tserve.RankingService(plan, device="cpu") as svc:
        svc.register("paper", graph=tg,
                     params=params_from_numpy(np_params, "cpu"))
        reqs = [("paper", _pair(tg, u, 10, seed=u)[1]) for u in range(3)]
        # the faulted first write quarantines the tier and the call
        # re-stacks; the second pass writes the users' slots
        res = svc.score_many(reqs) + svc.score_many(reqs)
        s = svc.stats()["scenarios"]["paper"]
    assert all(r.scores.shape == (10, 2) for r in res)
    assert s["faults_fired"] == 1 and s["quarantines"] == 1
    assert s["device_resident"] and s["device_store"]["writes"] >= 1
    assert s["breaker"]["failures"] == 1 and not s["hedging"]
    assert svc.engine("paper").plan.ft.retries == 2


def test_errors_are_the_reference_taxonomy():
    for name in ("FaultInjected", "CircuitOpenError", "RetryExhausted",
                 "WorkerCrashedError"):
        assert issubclass(getattr(tserve.errors, name), tserve.ServeError)
        assert issubclass(getattr(jserve.errors, name), jserve.ServeError)
    assert issubclass(WorkerCrashedError, RuntimeError)
