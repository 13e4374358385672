"""The port's memory tier (``repro_torch.mem`` + ``MemPlan``) on the CPU,
held against the JAX reference (``repro.mem``, tests/test_mem_tier.py).

Direct counterparts of the reference's tests run on the port's classes:
the arena's round trip, stale versions, budget overflow without leaked
slabs, LRU refresh and layout drift; the promotion gate, window expiry and
a vanished row; the warmer's memo; ``MemPlan``'s defaults, round trip,
rejects, type contract and resolution rows. Parity: one put / get / evict
sequence through both arenas, the same plan JSON through both packages,
and one scripted serving sequence (warm, hot, cold and recompute requests,
a version bump, an invalidate, ``flush_promotions``) through a reference
engine and a port engine on the same params — equal per-request flags and
counters, scores within fp32 rtol = atol = 2e-4. Within the port a
cold-served score equals a recompute-served one at the same pack shape
bit for bit.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.mem as jmem
import repro.serve as jserve
from repro.graph.executor import init_graph_params as j_init
from repro.models.ranking import PaperRankingConfig as JPaperCfg
from repro.models.ranking import build_paper_ranking_model as j_paper
from repro_torch.common import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.mem import ColdRepStore, PromotionWorker, RepWarmer
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model)
from repro_torch.serve import (MemPlan, PlanError, PlanResolutionWarning,
                               RankingService, ServePlan, ServeRequest,
                               ServingEngine)
from repro_torch.serve.cache import UserRepCache

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def paper():
    """The reference's paper model at scale 0.05 and the port's, on the
    same params (the reference's drawn, carried across as numpy)."""
    jg = j_paper(JPaperCfg().scaled(0.05))[0]
    jp = j_init(jg, jax.random.PRNGKey(0))
    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.05))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    user_in = {n.name for n in graph.input_nodes()
               if n.attrs.get("domain") == "user"}
    return graph, params, user_in, jg, jp


def _request(graph, user_in, uid, n=8, seed=None, version=0,
             cls=ServeRequest):
    rng = np.random.default_rng(uid if seed is None else seed)
    feeds = {}
    for node in graph.input_nodes():
        rows = 1 if node.attrs["domain"] == "user" else n
        feeds[node.name] = rng.standard_normal(
            (rows,) + tuple(node.attrs["shape"])).astype(np.float32)
    return cls(user_id=uid,
               user_feeds={k: v for k, v in feeds.items() if k in user_in},
               candidate_feeds={k: v for k, v in feeds.items()
                                if k not in user_in},
               feature_version=version)


COLD = dict(cache__max_cached_users=2, mem__cold_tier=True,
            mem__cold_bytes=1 << 22, mem__promote_touches=2,
            batch__hedging=False, batch__linger_ms=0.0)


def _cold_plan(**overrides):
    return ServePlan().evolve(**{**COLD, **overrides})


def _engine(paper, plan):
    graph, params = paper[:2]
    return ServingEngine(graph, params, plan=plan, device="cpu")


def _reps(uid, d=8):
    return {"a": np.full((1, d), float(uid), np.float32),
            "b": np.full((1, 2, 3), uid, np.int32)}


# -- ColdRepStore ------------------------------------------------------------

class TestColdRepStore:
    def test_round_trip_bit_exact(self):
        cold = ColdRepStore(1 << 16)
        reps = {"a": np.arange(8, dtype=np.float32)[None] * 0.3,
                "b": np.ones((1, 2, 3), np.int32)}
        cold.put((1, 0), reps)
        got = cold.get((1, 0))
        for k in reps:
            assert got[k].shape == reps[k].shape
            assert got[k].dtype == reps[k].dtype
            assert np.array_equal(got[k], reps[k])
        # reads hand back COPIES: mutating one must not poison the arena
        got["a"][:] = -1
        assert np.array_equal(cold.get((1, 0))["a"], reps["a"])

    def test_tensor_rows_go_in_as_raw_bytes(self):
        """A demoted tensor lands in its slab row byte for byte (NaN
        payloads and -0.0 included) and reads back as numpy."""
        cold = ColdRepStore(1 << 16)
        a = torch.tensor([[0.1, -0.0, float("nan"), 3e-39]])
        a_bits = a.numpy().view(np.uint32).copy()
        b = torch.arange(6, dtype=torch.int32).reshape(1, 2, 3)
        cold.put((1, 0), {"a": a, "b": b})
        got = cold.get((1, 0))
        assert got["a"].dtype == np.float32 and got["b"].dtype == np.int32
        assert np.array_equal(got["a"].view(np.uint32), a_bits)
        assert np.array_equal(got["b"], b.numpy())
        # a numpy row with the same layout lands beside it
        cold.put((2, 0), {"a": a.numpy(), "b": b.numpy()})
        assert np.array_equal(cold.get((2, 0))["a"].view(np.uint32), a_bits)
        with pytest.raises(ValueError, match="layout"):
            cold.put((3, 0), {"a": a.double(), "b": b})

    def test_stale_version_dropped_not_served(self):
        cold = ColdRepStore(1 << 16)
        cold.put((1, 0), _reps(1))
        assert cold.get((1, 7)) is None
        assert (1, 0) not in cold          # stale entry dropped outright
        assert cold.stats()["misses"] == 1

    def test_budget_overflow_evicts_lru_without_leaking_slabs(self):
        per_user = 8 * 4 + 2 * 3 * 4       # bytes of _reps rows
        cold = ColdRepStore(cold_bytes=10 * per_user, slab_rows=4)
        for u in range(50):
            cold.put((u, 0), _reps(u))
        st = cold.stats()
        assert st["capacity"] == 10
        assert st["users"] == 10
        assert st["evictions"] == 40
        assert st["slabs"] == 3
        assert st["slab_bytes"] <= 3 * 4 * per_user
        for u in range(40, 50):
            assert cold.get((u, 0))["a"][0, 0] == float(u)
        for u in range(40):
            assert cold.get((u, 0)) is None

    def test_lru_refresh_on_get(self):
        cold = ColdRepStore(cold_bytes=3 * (8 * 4 + 2 * 3 * 4))
        for u in range(3):
            cold.put((u, 0), _reps(u))
        cold.get((0, 0))                   # refresh user 0
        cold.put((3, 0), _reps(3))         # evicts user 1, not 0
        assert (0, 0) in cold and (1, 0) not in cold

    def test_layout_drift_rejected(self):
        cold = ColdRepStore(1 << 16)
        cold.put((1, 0), _reps(1))
        with pytest.raises(ValueError, match="layout"):
            cold.put((2, 0), {"a": np.zeros((1, 9), np.float32),
                              "b": np.zeros((1, 2, 3), np.int32)})
        with pytest.raises(ValueError, match="leading dim 1"):
            cold.put((2, 0), {"a": np.zeros((2, 8), np.float32),
                              "b": np.zeros((2, 2, 3), np.int32)})

    def test_same_sequence_as_the_reference_arena(self):
        """One put / get / peek / drop sequence through the reference's
        arena and the port's: equal stats (capacity, hits, misses,
        evictions, bytes, slabs) after every step and the same bytes."""
        per_user = 8 * 4 + 2 * 3 * 4
        ours = ColdRepStore(cold_bytes=7 * per_user, slab_rows=3)
        ref = jmem.ColdRepStore(cold_bytes=7 * per_user, slab_rows=3)
        rng = np.random.default_rng(0)
        for step in range(200):
            uid, ver = int(rng.integers(0, 12)), int(rng.integers(0, 2))
            op = rng.integers(0, 4)
            if op == 0:
                r = {"a": rng.standard_normal((1, 8)).astype(np.float32),
                     "b": rng.integers(0, 9, (1, 2, 3)).astype(np.int32)}
                ours.put((uid, ver), r)
                ref.put((uid, ver), r)
            elif op == 1:
                a, b = ours.get((uid, ver)), ref.get((uid, ver))
                assert (a is None) == (b is None)
                if a is not None:
                    for k in a:
                        assert a[k].tobytes() == b[k].tobytes()
            elif op == 2:
                a, b = ours.peek((uid, ver)), ref.peek((uid, ver))
                assert (a is None) == (b is None)
            else:
                assert ours.drop(uid) == ref.drop(uid)
            assert ours.stats() == ref.stats(), step
            assert sorted(ours.keys()) == sorted(ref.keys())


def test_arena_under_concurrent_puts_gets_and_drops():
    """Sixteen threads put, get, peek and drop users of one arena with a
    very short switch interval: every row read back is the one written for
    its key (no recycled slot serves another user's bytes), occupancy never
    passes capacity, and no put is lost from the count."""
    import sys
    import threading
    per_user = 8 * 4 + 2 * 3 * 4
    cold = ColdRepStore(cold_bytes=40 * per_user, slab_rows=8)
    bad, puts = [], [0] * 16

    def rows(uid, ver):
        return {"a": np.full((1, 8), uid * 10 + ver, np.float32),
                "b": np.full((1, 2, 3), uid, np.int32)}

    def work(t):
        rng = np.random.default_rng(t)
        for _ in range(400):
            uid, ver = int(rng.integers(0, 64)), int(rng.integers(0, 3))
            op = rng.integers(0, 4)
            if op == 0:
                cold.put((uid, ver), rows(uid, ver))
                puts[t] += 1
            elif op == 3:
                cold.drop(uid)
            else:
                got = (cold.get if op == 1 else cold.peek)((uid, ver))
                if got is not None and not (
                        np.all(got["a"] == uid * 10 + ver)
                        and np.all(got["b"] == uid)):
                    bad.append((uid, ver))
            if len(cold) > 40:
                bad.append("over capacity")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert bad == []
    st = cold.stats()
    assert st["puts"] == sum(puts) and st["users"] <= st["capacity"] == 40
    assert st["slabs"] == 5


# -- PromotionWorker ---------------------------------------------------------

class TestPromotionWorker:
    def test_k_touches_within_window_promotes(self):
        cold = ColdRepStore(1 << 16)
        cache = UserRepCache(max_users=8)
        t = [0.0]
        pw = PromotionWorker(cold, cache, touches=3, window_s=5.0,
                             clock=lambda: t[0])
        try:
            cold.put((1, 0), _reps(1))
            for _ in range(2):
                pw.touch((1, 0))
            pw.flush()
            assert (1, 0) not in cache     # below threshold
            pw.touch((1, 0))
            pw.flush()
            assert (1, 0) in cache
            assert pw.promotions == 1
            assert np.array_equal(cache.get((1, 0))["a"], _reps(1)["a"])
        finally:
            pw.stop()

    def test_window_expiry_resets_tail_users(self):
        cold = ColdRepStore(1 << 16)
        cache = UserRepCache(max_users=8)
        t = [0.0]
        pw = PromotionWorker(cold, cache, touches=2, window_s=5.0,
                             clock=lambda: t[0])
        try:
            cold.put((1, 0), _reps(1))
            pw.touch((1, 0))
            pw.flush()
            t[0] = 10.0                    # first touch now outside window
            pw.touch((1, 0))
            pw.flush()
            assert (1, 0) not in cache
            pw.touch((1, 0))
            pw.flush()
            assert (1, 0) in cache
        finally:
            pw.stop()

    def test_vanished_cold_row_is_a_noop(self):
        cold = ColdRepStore(1 << 16)
        cache = UserRepCache(max_users=8)
        pw = PromotionWorker(cold, cache, touches=1, window_s=60.0)
        try:
            pw.touch((9, 0))               # never put into cold
            pw.flush()
            assert (9, 0) not in cache and pw.promotions == 0
            assert pw.stats()["errors"] == 0
        finally:
            pw.stop()

    def test_promoted_rows_take_the_hot_form(self):
        """``to_hot`` turns the arena row into the hot cache's form (the
        engine's copy onto its device) before the put."""
        cold = ColdRepStore(1 << 16)
        cache = UserRepCache(max_users=8)
        pw = PromotionWorker(cold, cache, touches=1, window_s=60.0,
                             to_hot=lambda r: {k: torch.from_numpy(v)
                                               for k, v in r.items()})
        try:
            cold.put((1, 0), _reps(1))
            pw.touch((1, 0))
            pw.flush()
            got = cache.get((1, 0))
            assert all(isinstance(v, torch.Tensor) for v in got.values())
            assert np.array_equal(got["b"].numpy(), _reps(1)["b"])
        finally:
            pw.stop()

    def test_failing_promotion_is_counted_not_hidden(self):
        """Best-effort as in the reference (the worker survives, the
        serving path never sees it), but each failure is counted in
        ``errors`` with the last message."""
        cold = ColdRepStore(1 << 16)
        cache = UserRepCache(max_users=8)

        def broken(rows):
            raise RuntimeError("device copy failed")

        pw = PromotionWorker(cold, cache, touches=1, window_s=60.0,
                             to_hot=broken)
        try:
            cold.put((1, 0), _reps(1))
            cold.put((2, 0), _reps(2))
            pw.touch((1, 0))
            pw.touch((2, 0))
            pw.flush()
            st = pw.stats()
            assert st["errors"] == 2 and pw.promotions == 0
            assert "device copy failed" in st["last_error"]
            assert (1, 0) not in cache
            # the worker is still alive
            pw._to_hot = None
            pw.touch((1, 0))
            pw.flush()
            assert (1, 0) in cache and pw.promotions == 1
        finally:
            pw.stop()


# -- RepWarmer ---------------------------------------------------------------

class TestRepWarmer:
    def test_memoizes_shared_feed_objects_per_chunk(self):
        calls = []

        def s1(params, feeds):
            calls.append(1)
            return {"a": feeds["x"] * params}

        cold = ColdRepStore(1 << 20)
        w = RepWarmer(s1, cold, batch=3)
        shared = {"x": np.full((1, 8), 2.0, np.float32)}
        n = w.warm([(u, 0, shared) for u in range(7)], 3.0)
        assert n == 7 and len(cold) == 7
        assert len(calls) == 3
        assert np.allclose(cold.get((4, 0))["a"], 6.0)

    def test_distinct_feeds_each_launch(self):
        def s1(params, feeds):
            return {"a": torch.from_numpy(feeds["x"]) + params}

        syncs = []
        cold = ColdRepStore(1 << 20)
        w = RepWarmer(s1, cold, batch=8, sync=lambda: syncs.append(1))
        items = [(u, 0, {"x": np.full((1, 4), float(u), np.float32)})
                 for u in range(5)]
        w.warm(items, 10.0)
        assert w.stage1_launches == 5 and len(syncs) == 1
        for u in range(5):
            assert np.allclose(cold.get((u, 0))["a"], u + 10.0)

    def test_one_chunk_of_distinct_feeds_through_compiled_stage1(self, paper):
        """A compiled stage 1 overwrites its static outputs on every call;
        a chunk is enqueued before its one sync, so each call must hand
        back tensors of its own. Six distinct users warmed in ONE chunk
        each get their own reps, equal bit for bit to stage 1 run alone."""
        graph, _, user_in = paper[:3]
        eng = _engine(paper, _cold_plan(mem__warm_batch=16))
        try:
            reqs = [_request(graph, user_in, u) for u in range(20, 26)]
            assert eng.warm([(r.user_id, r.user_feeds) for r in reqs]) == 6
            assert eng.mem_stats()["warm"]["stage1_launches"] == 6
            for r in reqs:
                with torch.inference_mode():
                    want = eng._stage1.run(eng.params, {
                        k: torch.from_numpy(v)
                        for k, v in r.user_feeds.items()})
                got = eng._cold.peek((r.user_id, 0))
                for k, v in want.items():
                    assert np.array_equal(got[k], v.numpy()), (r.user_id, k)
            rows = [eng._cold.peek((r.user_id, 0)) for r in reqs]
            assert not np.array_equal(rows[0]["attn_k_proj"],
                                      rows[1]["attn_k_proj"])
        finally:
            eng.close()


# -- MemPlan -----------------------------------------------------------------

class TestMemPlan:
    def test_defaults_off_and_round_trip(self):
        p = ServePlan()
        assert p.mem == MemPlan()
        assert not p.mem.cold_tier
        p2 = p.evolve(mem__cold_tier=True, mem__cold_bytes=1 << 20,
                      mem__promote_touches=3, mem__promote_window_s=5.0,
                      mem__warm_batch=64)
        assert ServePlan.from_json(p2.to_json()) == p2

    @pytest.mark.parametrize("field,value", [
        ("cold_bytes", 0), ("promote_touches", 0),
        ("promote_window_s", 0.0), ("warm_batch", 0)])
    def test_non_positive_knobs_reject(self, field, value):
        with pytest.raises(PlanError, match=field):
            ServePlan().evolve(**{f"mem__{field}": value})
        with pytest.raises(jserve.PlanError, match=field):
            jserve.ServePlan().evolve(**{f"mem__{field}": value})

    @pytest.mark.parametrize("bad", [
        {"cold_bytes": "256MiB"}, {"cold_tier": 1}, {"warm_batch": 2.0},
        {"promote_touches": True}, {"spill": True}])
    def test_type_contract(self, bad):
        with pytest.raises(PlanError):
            ServePlan(mem=bad)
        with pytest.raises(jserve.PlanError):
            jserve.ServePlan(mem=bad)

    def test_cold_tier_without_cache_resolves_off(self):
        with pytest.warns(PlanResolutionWarning, match="cold_tier"):
            p = ServePlan().evolve(cache__cache_user_reps=False,
                                   mem__cold_tier=True)
        assert not p.mem.cold_tier
        assert any("cold_tier" in n for n in p.resolution_notes)

    def test_mem_knobs_without_cold_tier_resolve_to_defaults(self):
        with pytest.warns(PlanResolutionWarning, match="warm_batch"):
            p = ServePlan().evolve(mem__warm_batch=64)
        assert p.mem == MemPlan()

    def test_resolution_idempotent_through_round_trip(self):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", PlanResolutionWarning)
            p = ServePlan().evolve(cache__cache_user_reps=False,
                                   mem__cold_tier=True,
                                   mem__promote_touches=9)
        with warnings.catch_warnings():
            warnings.simplefilter("error", PlanResolutionWarning)
            p2 = ServePlan.from_json(p.to_json())
        assert p2 == p

    @pytest.mark.parametrize("case", [
        {"mem": {"cold_tier": True}},
        {"mem": {"cold_tier": True, "cold_bytes": 1 << 33,
                 "warm_batch": 4096}},
        {"mem": {"cold_tier": True}, "cache": {"cache_user_reps": False}},
        {"mem": {"cold_tier": True, "promote_touches": 5},
         "cache": {"cache_user_reps": False}},
        {"mem": {"promote_window_s": 1.5, "warm_batch": 8}},
        {"mem": {"cold_bytes": 4096}},
        {"mem": {"cold_tier": True}, "cache": {"device_resident": True,
                                               "max_cached_users": 4096,
                                               "device_slots": 256}},
    ])
    def test_same_plan_json_resolves_the_same_in_both_packages(self, case):
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            ref = jserve.ServePlan.from_dict(case)
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            ours = ServePlan.from_dict(case)
        theirs = ref.to_dict()
        for section, fields in ours.to_dict().items():
            assert fields == theirs[section], section
        assert len(ours.resolution_notes) == len(ref.resolution_notes)
        assert len(wt) == len(wj)
        assert ServePlan.from_json(ours.to_json()) == ours


# -- the engine --------------------------------------------------------------

def _run_script(eng, graph, user_in, cls):
    """Warm, hot, cold and recompute requests, a version bump, an
    invalidate and a coalesced mix, with ``flush_promotions`` after every
    call (promotion is asynchronous: flushing makes the flags
    deterministic). Returns the per-request records."""
    out = []

    def req(uid, seed=None, version=0, n=8):
        return _request(graph, user_in, uid, n=n, seed=seed,
                        version=version, cls=cls)

    def score(*reqs):
        res = (eng.score_coalesced(list(reqs)) if len(reqs) > 1
               else [eng.score(reqs[0])])
        eng.flush_promotions()
        out.extend((r.user_id, x.user_cache_hit, x.cold_hit, x.scores)
                   for r, x in zip(reqs, res))

    warm = [req(10), req(11), req(12)]
    assert eng.warm([(r.user_id, r.user_feeds) for r in warm]) == 3
    for uid in (0, 1, 2, 10, 0, 0, 0, 1):   # 2 evicts 0; 0 cold, promoted
        score(req(uid))
    score(req(2, version=1))          # version bump: supersede drops cold
    score(req(2, version=1))
    eng.invalidate_user(11)
    score(req(11))                    # the warmed row was dropped
    score(req(12), req(3, n=5), req(1), req(12))
    score(req(1, n=13))
    return out


class TestEngineMemTier:
    @pytest.mark.parametrize("mode", ["uoi", "mari"])
    def test_scripted_sequence_matches_the_reference(self, paper, mode):
        graph, params, user_in, jg, jp = paper
        fields = dict(COLD, graph__mode=mode)
        ours = _engine(paper, ServePlan().evolve(**fields))
        ref = jserve.ServingEngine(jg, jp, jserve.ServePlan().evolve(
            **fields))
        try:
            got = _run_script(ours, graph, user_in, ServeRequest)
            want = _run_script(ref, graph, user_in, jserve.ServeRequest)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g[:3] == w[:3], (g[:3], w[:3])
                np.testing.assert_allclose(g[3], np.asarray(w[3]), **TOL)
            for name in ("cold_hits", "cold_misses", "demotions",
                         "stage1_calls"):
                assert getattr(ours, name) == getattr(ref, name), name
            m_t, m_j = ours.mem_stats(), ref.mem_stats()
            assert m_t["promote"]["promotions"] == \
                m_j["promote"]["promotions"] > 0
            assert m_t["warm"] == m_j["warm"]
            assert m_t["promote"]["errors"] == 0
            for k in ("users", "capacity", "bytes_per_user", "hits",
                      "misses", "puts", "evictions"):
                assert m_t["cold"][k] == m_j["cold"][k], k
            assert {r[2] for r in got} == {True, False}
            assert {r[1] for r in got} == {True, False}
        finally:
            ours.close()
            ref.close()

    @pytest.mark.parametrize("mode", ["uoi", "mari"])
    def test_cold_served_equals_recompute_bitwise(self, paper, mode):
        """Eviction churn pushes a user to cold; the cold-served scores,
        the post-promotion hot-served ones and a cache-off engine's
        recompute, all at the same pack shape, are equal bit for bit."""
        graph, _, user_in = paper[:3]
        eng = _engine(paper, _cold_plan(graph__mode=mode))
        off = _engine(paper, ServePlan().evolve(
            graph__mode=mode, cache__cache_user_reps=False,
            batch__hedging=False))
        try:
            r0 = _request(graph, user_in, 0)
            base = eng.score(r0)
            for u in (1, 2):
                eng.score(_request(graph, user_in, u))
            assert eng.demotions >= 1
            s1 = eng.stage1_calls
            cold = eng.score(r0)
            assert cold.cold_hit and not cold.user_cache_hit
            assert eng.stage1_calls == s1          # no recompute
            assert np.array_equal(cold.scores, base.scores)
            eng.score(r0)
            eng.flush_promotions()
            hot = eng.score(r0)
            assert hot.user_cache_hit and not hot.cold_hit
            assert np.array_equal(hot.scores, base.scores)
            assert np.array_equal(off.score(r0).scores, base.scores)
        finally:
            eng.close()
            off.close()

    def test_single_stage_disarms_the_tier(self, paper):
        graph, _, user_in = paper[:3]
        eng = _engine(paper, _cold_plan(graph__mode="vani"))
        try:
            assert not eng.cold_tier
            assert eng.mem_stats() == {"cold_tier": False}
            assert not eng.score(_request(graph, user_in, 0)).cold_hit
        finally:
            eng.close()

    def test_cold_hit_never_takes_a_device_slot(self, paper):
        graph, _, user_in = paper[:3]
        eng = _engine(paper, _cold_plan(cache__device_resident=True,
                                        cache__device_slots=4))
        try:
            r0 = _request(graph, user_in, 0)
            base = eng.score(r0)
            for u in (1, 2):
                eng.score(_request(graph, user_in, u))
            store = eng.device_store
            writes = store.stats()["writes"]
            cold = eng.score(r0)
            assert cold.cold_hit
            assert store.stats()["writes"] == writes
            assert store.slot_of(0) is None
            assert np.array_equal(cold.scores, base.scores)
            # a coalesced pack carrying a cold-served user re-stacks whole:
            # its hot, resident user (2) is not read from its slot either
            routes = set(eng._stage2_keys)
            res = eng.score_coalesced([_request(graph, user_in, 2), r0])
            assert res[1].cold_hit and res[0].user_cache_hit
            assert store.stats()["writes"] == writes
            assert all(not slots for _, _, slots in
                       set(eng._stage2_keys) - routes)
            assert eng.stage2_compilations == eng.stage2_routes
        finally:
            eng.close()

    def test_warm_then_serve_first_request_hits(self, paper):
        graph, _, user_in = paper[:3]
        eng = _engine(paper, _cold_plan())
        off = _engine(paper, ServePlan().evolve(
            cache__cache_user_reps=False, batch__hedging=False))
        try:
            reqs = [_request(graph, user_in, u) for u in range(5, 9)]
            assert eng.warm([(r.user_id, r.user_feeds) for r in reqs]) == 4
            s1 = eng.stage1_calls
            for r in reqs:
                res = eng.score(r)
                assert res.cold_hit
                assert np.array_equal(res.scores, off.score(r).scores)
            assert eng.stage1_calls == s1
            assert eng.mem_stats()["warm"]["warmed"] == len(reqs)
        finally:
            eng.close()
            off.close()

    def test_invalidate_drops_warmed_only_user(self, paper):
        graph, _, user_in = paper[:3]
        eng = _engine(paper, _cold_plan())
        try:
            r = _request(graph, user_in, 11)
            eng.warm([(r.user_id, r.user_feeds)])
            eng.invalidate_user(11)
            res = eng.score(r)
            assert not res.cold_hit and not res.user_cache_hit
        finally:
            eng.close()

    def test_version_bump_misses_cold(self, paper):
        graph, _, user_in = paper[:3]
        eng = _engine(paper, _cold_plan())
        try:
            eng.score(_request(graph, user_in, 0))
            for u in (1, 2):
                eng.score(_request(graph, user_in, u))
            res = eng.score(_request(graph, user_in, 0, version=1))
            assert not res.cold_hit
        finally:
            eng.close()

    def test_warm_requires_cold_tier(self, paper):
        graph, _, user_in = paper[:3]
        eng = _engine(paper, ServePlan().evolve(batch__hedging=False))
        try:
            with pytest.raises(RuntimeError, match="cold_tier"):
                eng.warm([(0, _request(graph, user_in, 0).user_feeds)])
        finally:
            eng.close()

    def test_mem_gauges_and_profile(self, paper):
        graph, _, user_in = paper[:3]
        eng = _engine(paper, _cold_plan())
        try:
            r0 = _request(graph, user_in, 0)
            eng.score(r0)
            for u in (1, 2):
                eng.score(_request(graph, user_in, u))
            eng.score(r0)
            eng.score(r0)
            eng.flush_promotions()
            eng.score(r0)
            eng.warm([(5, _request(graph, user_in, 5).user_feeds)])
            snap = eng.metrics.snapshot()
            assert snap["cold_hits"] >= 2 and snap["demotions"] >= 1
            assert snap["promotions"] >= 1 and snap["warmed_users"] == 1
            assert snap["cold_users"] >= 1
            assert snap["cold_tier_bytes"] == \
                snap["cold_users"] * eng._cold.bytes_per_user
            prof = eng.profiler.snapshot()
            assert prof["demote"]["calls"] == eng.demotions
            assert prof["cold_read"]["calls"] == \
                eng.cold_hits + eng.cold_misses
        finally:
            eng.close()

    def test_five_instants_carry_the_reference_names_and_fields(self, paper):
        graph, params, user_in, jg, jp = paper
        fields = dict(COLD, obs__trace=True)
        ours = _engine(paper, ServePlan().evolve(**fields))
        ref = jserve.ServingEngine(jg, jp, jserve.ServePlan().evolve(
            **fields))
        names = ("warm", "cold_hit", "cold_miss", "promote", "demote")
        try:
            _run_script(ours, graph, user_in, ServeRequest)
            _run_script(ref, graph, user_in, jserve.ServeRequest)

            def shape(eng):
                out = {}
                for ph, name, _, _, _, track, args in eng.tracer.events():
                    if name in names:
                        out.setdefault(name, [set(), 0])
                        out[name][0].add((ph, track is not None,
                                          tuple(sorted(args or {}))))
                        out[name][1] += 1
                return out

            got, want = shape(ours), shape(ref)
            assert set(got) == set(names) == set(want)
            for name in names:
                assert got[name][0] == want[name][0], name
                assert got[name][1] == want[name][1], name
        finally:
            ours.close()
            ref.close()


# -- service and launcher ----------------------------------------------------

def test_shared_cache_evictions_stay_in_their_scenario(paper):
    """Two scenarios share one hot LRU; evictions of one scenario's users
    (even when the other's traffic causes them) demote into that
    scenario's arena only."""
    graph, params, user_in = paper[:3]
    plan = _cold_plan()
    with RankingService(plan, shared_cache_users=2, device="cpu") as svc:
        svc.register("a", graph=graph, params=params)
        svc.register("b", graph=graph, params=params)
        svc.score("a", _request(graph, user_in, 0))
        svc.score("a", _request(graph, user_in, 1))
        for u in (0, 1, 2):                  # b's users evict a's
            svc.score("b", _request(graph, user_in, u, seed=50 + u))
        ea, eb = svc.engine("a"), svc.engine("b")
        assert ea.demotions == 2 and eb.demotions == 1
        assert sorted(ea._cold.keys()) == [(("a", 0), 0), (("a", 1), 0)]
        assert eb._cold.keys() == [(("b", 0), 0)]
        res = svc.score("a", _request(graph, user_in, 1))
        assert res.cold_hit
        assert svc.warm("b", [(7, _request(graph, user_in, 7).user_feeds)]) \
            == 1
        st = svc.stats()["scenarios"]
        assert st["a"]["mem"]["cold_hits"] == 1
        assert st["b"]["mem"]["warm"]["warmed"] == 1
        assert st["b"]["mem"]["cold"]["users"] == 2


def test_launcher_cold_tier_reports_the_tiers(capsys):
    launcher.main(["--arch", "din", "--cold-tier", "--requests", "12",
                   "--candidates", "16", "--preset", "tpu",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] warmed 4 users into the cold tier" in out
    line = [ln for ln in out.splitlines() if ln.startswith("[serve] mem")]
    assert line and "promote_errors=0" in line[0]
    kv = dict(p.split("=") for p in line[0].split()[2:])
    assert int(kv["cold_hits"]) >= 4 and int(kv["promotions"]) >= 1


def test_launcher_cold_tier_on_a_service(capsys):
    launcher.main(["--scenario", "fm,deepfm", "--cold-tier", "--requests",
                   "8", "--candidates", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    for sc in ("fm", "deepfm"):
        assert f"[serve] scenario={sc} warmed 4 users" in out
        assert any(ln.startswith(f"[serve] scenario={sc} mem")
                   for ln in out.splitlines())


def test_promotions_and_demotions_on_the_worker_thread_while_serving(paper):
    """Promotions (and the demotions their puts cause) run on the worker
    thread while the request thread serves: every score stays equal to
    the cache-off recompute and no promotion fails."""
    graph, _, user_in = paper[:3]
    eng = _engine(paper, _cold_plan(mem__promote_touches=1))
    off = _engine(paper, ServePlan().evolve(
        cache__cache_user_reps=False, batch__hedging=False))
    try:
        reqs = [_request(graph, user_in, u) for u in range(6)]
        want = [off.score(r).scores for r in reqs]
        for i in range(60):
            res = eng.score(reqs[(i * 5) % 6])
            assert np.array_equal(res.scores, want[(i * 5) % 6]), i
        eng.flush_promotions()
        assert eng.mem_stats()["promote"]["errors"] == 0
        assert eng.demotions > 0 and eng._promoter.promotions > 0
        assert eng.cold_hits > 0
    finally:
        eng.close()
        off.close()
